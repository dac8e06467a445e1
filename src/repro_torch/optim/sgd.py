"""The paper's optimizer schedule: mini-batch SGD with exponential LR decay
(momentum is not used by the round engine)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    lr: float = 0.1
    decay: float = 0.993          # per-round multiplicative decay (paper §6.1)
    momentum: float = 0.0


def lr_at(cfg: SGDConfig, t: torch.Tensor) -> torch.Tensor:
    """f32 ``lr · decay**t`` (a 0-dim CPU tensor)."""
    base = torch.tensor(cfg.decay, dtype=torch.float32)
    return cfg.lr * torch.pow(base, t.to(torch.float32))
