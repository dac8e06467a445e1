"""Importance-aware upload compression (paper §4.2, Eqs. 4–6), torch on the
CPU in float32, op for op as ``repro.core.importance``.

Importance is computed once before training from static data properties
(sample volume + label distribution); devices are ranked and assigned
upload ratios by rank. Rank 0 (most important) gets θ_u = θ_min.
"""
from __future__ import annotations

import torch


def kl_to_uniform(label_dist: torch.Tensor) -> torch.Tensor:
    """Eq. 4: D_i = KL(Φ_i ‖ uniform) per device. label_dist [n, H] f32.

    The H terms are summed as a left fold, ((t0 + t1) + t2) + …, which is
    the order of XLA's f32 row reduction in the reference at these widths.
    ``torch.sum`` adds in another order and can round a row one ulp away;
    clients whose importances tie in exact arithmetic then swap upload
    ranks. With the fold, KL equals the reference's bit for bit wherever
    the two frameworks' f32 ``log`` agree."""
    h = label_dist.shape[-1]
    e = torch.clamp(label_dist, 1e-12, 1.0)
    terms = e * torch.log(e * h)
    kl = terms[..., 0]
    for j in range(1, h):
        kl = kl + terms[..., j]
    return kl


def importance(volumes: torch.Tensor, label_dist: torch.Tensor,
               lam: float = 0.5) -> torch.Tensor:
    """Eq. 5: C_i = λ·A_i/A_max + (1−λ)·e^{−D_i}."""
    a_max = torch.max(volumes)
    vol_term = volumes.to(torch.float32) / torch.clamp(a_max, min=1.0)
    dist_term = torch.exp(-kl_to_uniform(label_dist))
    return lam * vol_term + (1.0 - lam) * dist_term


def rank_descending(c: torch.Tensor) -> torch.Tensor:
    """Rank(C_i): 0 for the most important device, n−1 for the least; ties
    keep index order (stable sort, as ``jnp.argsort``)."""
    order = torch.argsort(-c, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(c.shape[0])
    return ranks.to(torch.int32)


def upload_ratio(c: torch.Tensor, theta_min: float,
                 theta_max: float) -> torch.Tensor:
    """Eq. 6: θ_u,i = θ_min + (θ_max−θ_min)/|N| · Rank(C_i)."""
    n = c.shape[0]
    return theta_min + (theta_max - theta_min) / n * \
        rank_descending(c).to(torch.float32)
