"""Server-side aggregation through the tier engine — the port of
``repro.fl.robust``'s upload fold. Only the mean aggregate's fold is
ported; the robust aggregators (trimmed mean, norm clip, median, Krum) come
with the wire boundary (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

import torch


def weighted_row_fold(acc: torch.Tensor, ups: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Left-to-right weighted row accumulation with a FIXED association,
    ``((acc + ups[0]·w[0]) + ups[1]·w[1]) + …``, in place on ``acc``. A
    tree-shaped ``sum`` would change the association with the chunk
    shape; the fold keeps it pinned to the processing order."""
    for i in range(ups.shape[0]):
        acc.add_(ups[i] * w[i])
    return acc
