"""Must-fail torch fixture for REP003: a torch device op in the worker
call graph."""
import numpy as np
import torch


class Driver:
    def _prefetch_pkg(self, t, bufs):
        xs = self._gather(t)
        return torch.from_numpy(xs).to(self.device)

    def _gather(self, t):
        return np.zeros((4, 4), np.float32)
