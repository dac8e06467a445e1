"""Fine-grained batch-size optimization (paper §4.3, Eqs. 7–9) and the
plan-shaped execution tiers — the port of ``repro.core.batchsize``.

Round time model (Eq. 7):
    M_i = θ_d,i·Q/β_d,i  +  θ_u,i·Q/β_u,i  +  τ·b_i·μ_i
(download + upload + compute). The optimizer (Eqs. 8–9) gives b_max to the
fastest participant and sizes everyone else so their round time does not
exceed it. The arithmetic keeps the reference's f32 operation order
(``Q / β`` first, then the multiply by θ), so floor/argmin/clip land on the
same integers.
"""
from __future__ import annotations

import numpy as np
import torch


def _div(q: float, bw):
    """``q / bw`` with true division (``float / Tensor`` in PyTorch is a
    reciprocal-multiply, which rounds differently)."""
    if isinstance(bw, torch.Tensor):
        return torch.full_like(bw, q) / bw
    return q / bw


def round_times(theta_d, theta_u, q_bits: float, bw_down, bw_up, tau,
                batch, mu):
    """Eq. 7 per device (bandwidths in bits/s, μ in s/sample). Works on
    numpy arrays (the simulator's f64 accounting) or f32 tensors (planning),
    with the reference's operator order either way. ``tau`` may be a
    scalar or per-device."""
    comm = theta_d * _div(q_bits, bw_down) + theta_u * _div(q_bits, bw_up)
    b = (batch.to(torch.float32) if isinstance(batch, torch.Tensor)
         else np.asarray(batch).astype(np.float32))
    return comm + tau * b * mu


def optimize_batch_sizes(theta_d: torch.Tensor, theta_u: torch.Tensor,
                         q_bits: float, bw_down: torch.Tensor,
                         bw_up: torch.Tensor, tau: int, mu: torch.Tensor,
                         b_max: int, b_min: int = 1,
                         mask: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, int]:
    """Eqs. 8–9. Returns (batch_sizes [n] int32, leader index). ``mask``
    ([n] bool) scopes the Eq.-8 argmin to the round's participants."""
    comm = theta_d * _div(q_bits, bw_down) + theta_u * _div(q_bits, bw_up)
    full_time = comm + tau * float(b_max) * mu          # Eq. 8 objective
    cand = (full_time if mask is None
            else torch.where(mask, full_time, torch.inf))
    leader = int(torch.argmin(cand))
    m_leader = full_time[leader]
    b = torch.floor((m_leader - comm) / (tau * mu))     # Eq. 9
    b = torch.clamp(b, b_min, b_max).to(torch.int32)
    b[leader] = b_max
    return b, leader


# ---------------------------------------------------------------------------
# Plan-shaped execution tiers: each planned (b_i, τ_i) is quantized UP to a
# rung of a small static lattice and every occupied tier runs at its own
# shape. Host-side numpy, identical to the reference.
# ---------------------------------------------------------------------------

def tier_rungs(lo: int, hi: int) -> np.ndarray:
    """Ascending halving ladder {lo, …, ⌈hi/4⌉, ⌈hi/2⌉, hi} (int32)."""
    if not 1 <= lo <= hi:
        raise ValueError(f"need 1 <= lo <= hi, got ({lo}, {hi})")
    rungs = []
    r = int(hi)
    while r > int(lo):
        rungs.append(r)
        r = (r + 1) // 2
    rungs.append(int(lo))
    return np.array(sorted(set(rungs)), np.int32)


def quantize_plan(batch, taus, b_min: int, b_max: int, tau_max: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Round each planned (b_i, τ_i) UP to its (b, τ) lattice rung. Returns
    (b_tier [P], tau_tier [P]) int32; the plan is a prefix of the tier."""
    b_r = tier_rungs(b_min, b_max)
    t_r = tier_rungs(1, tau_max)
    b = np.clip(np.asarray(batch), b_min, b_max)
    tau = np.clip(np.asarray(taus), 1, tau_max)
    b_tier = b_r[np.searchsorted(b_r, b)]
    tau_tier = t_r[np.searchsorted(t_r, tau)]
    return b_tier.astype(np.int32), tau_tier.astype(np.int32)


def tier_lattice_size(b_min: int, b_max: int, tau_max: int) -> int:
    """Number of (b, τ) tiers — the shape-lattice bound's first factor."""
    return len(tier_rungs(b_min, b_max)) * len(tier_rungs(1, tau_max))
