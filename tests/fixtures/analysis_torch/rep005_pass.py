"""Must-pass twin for REP005: the dtype is spelled out."""
import numpy as np
import torch


def weights(device):
    w = np.array([0.5, 1.5], np.float32)
    return torch.from_numpy(w).to(device)


def narrow(x):
    return x.float()
