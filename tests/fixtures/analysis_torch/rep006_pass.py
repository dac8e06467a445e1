"""Must-pass twin for REP006: device values collected in the loop, read
back once after it."""
import torch


class Runner:
    def run(self, rounds, x):
        outs = []
        for t in range(rounds):
            y = torch.relu(x * t)
            outs.append(y.sum())
        return torch.stack(outs).cpu().tolist()
