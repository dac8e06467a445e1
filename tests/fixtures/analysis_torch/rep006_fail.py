"""Must-fail torch fixture for REP006: host readbacks of device tensors
inside the round loop."""
import torch


class Runner:
    def run(self, rounds, x):
        losses, norms, rows, hist = [], [], [], []
        for t in range(rounds):
            y = torch.relu(x * t)
            losses.append(y.sum().item())
            norms.append(y.norm().tolist())
            rows.append(y.cpu())
            hist.append(y.numpy())
        return losses, norms, rows, hist
