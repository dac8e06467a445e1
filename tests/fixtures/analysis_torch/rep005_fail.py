"""Must-fail torch fixture for REP005 (linted under the port's
fl/executor.py path): torch.from_numpy keeps numpy's f64."""
import numpy as np
import torch


def weights(device):
    w = np.array([0.5, 1.5])
    return torch.from_numpy(w).to(device)


def widen(x):
    return x.double()
