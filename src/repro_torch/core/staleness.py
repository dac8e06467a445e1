"""Staleness-aware download compression ratios (paper §4.1, Eq. 3) and the
cluster-based ratio grouping — planning math on small [n] vectors, torch on
the CPU in float32, op for op as the reference (``repro.core.staleness``).

``last_round[i] = r_i`` is device i's last participation round (0 = never;
then δ_i = t and θ_d,i = 0 ⇒ full-precision download).
"""
from __future__ import annotations

import torch


def staleness(last_round: torch.Tensor, t: int) -> torch.Tensor:
    """δ_i^t = t − r_i. [n] int32."""
    return (t - last_round).to(torch.int32)


def download_ratio(delta: torch.Tensor, t: int,
                   theta_d_max: float) -> torch.Tensor:
    """Eq. 3: θ_d,i = (1 − δ_i/t)·θ_d_max. Never-participated ⇒ δ=t ⇒ θ=0."""
    tf = torch.tensor(float(max(t, 1)), dtype=torch.float32)
    frac = 1.0 - delta.to(torch.float32) / tf
    return torch.clamp(frac, 0.0, 1.0) * theta_d_max


def update_participation(last_round: torch.Tensor, participants: torch.Tensor,
                         t: int) -> torch.Tensor:
    """Set last_round[i] = t for selected devices (bool mask [n])."""
    return torch.where(participants, torch.tensor(t, dtype=last_round.dtype),
                       last_round)


def cluster_ratios(delta: torch.Tensor, t: int, theta_d_max: float,
                   n_clusters: int, mask: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Group by staleness into ``n_clusters`` quantile buckets built over
    the selected devices (``mask``, the round's participants), each bucket
    sharing the ratio of its mean staleness. Returns (cluster_id [n] int32,
    ratio [n] f32). Never-participated devices (δ = t) are clamped to
    θ_d = 0 after clustering (full-precision first download)."""
    d = delta.to(torch.float32)
    n = d.shape[0]
    m = torch.ones_like(d) if mask is None else mask.to(torch.float32)
    n_sel = torch.clamp(torch.sum(m), min=1.0)
    d_sorted = torch.sort(torch.where(m > 0, d, torch.inf)).values
    qs = torch.linspace(0.0, 1.0, n_clusters + 1,
                        dtype=torch.float32)[1:-1]
    pos = torch.clamp((qs * (n_sel - 1.0)).to(torch.int32), 0, n - 1)
    edges = d_sorted[pos.long()].contiguous()
    cid = torch.searchsorted(edges, d.contiguous(), right=False)
    sums = torch.zeros(n_clusters, dtype=torch.float32).index_add_(
        0, cid, d * m)
    cnts = torch.zeros(n_clusters, dtype=torch.float32).index_add_(0, cid, m)
    mean_d = sums / torch.clamp(cnts, min=1.0)
    per_cluster = download_ratio(mean_d, t, theta_d_max)
    ratios = per_cluster[cid]
    ratios = torch.where(delta >= t, 0.0, ratios)
    return cid.to(torch.int32), ratios
