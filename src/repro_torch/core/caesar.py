"""Caesar round planning: ties Eq. 3/5/6/9 into a per-round plan — the
port of ``repro.core.caesar``. Policy only (no model math), on small [n]
vectors: torch on the CPU in float32.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import batchsize as bs
from repro_torch.core import importance as imp
from repro_torch.core import staleness as st


@dataclasses.dataclass(frozen=True)
class CaesarConfig:
    theta_d_max: float = 0.6      # download-ratio upper bound
    theta_u_min: float = 0.1
    theta_u_max: float = 0.6
    lam: float = 0.5              # Eq. 5 λ
    n_clusters: int = 8           # §4.1 cluster-based grouping (0 = per-device)
    b_max: int = 32               # paper default batch size as the cap
    b_min: int = 1
    tau: int = 30                 # local iterations (paper: 30 / 10 for HAR)
    use_error_feedback: bool = False   # beyond-paper toggle (off = faithful)
    use_batch_opt: bool = True         # §4.3 on/off (off = Caesar-DC ablation)
    use_deviation_compress: bool = True  # §4.1+4.2 on/off (off = Caesar-BR)
    # planning scope: "participants" (paper: Eq. 8–9 leader and §4.1
    # clusters over N^t) | "all" (over every device)
    plan_scope: str = "participants"


@dataclasses.dataclass
class CaesarState:
    last_round: torch.Tensor     # [n] int32, r_i (0 = never participated)
    importance: torch.Tensor     # [n] f32, C_i (static)
    upload_ratio: torch.Tensor   # [n] f32, θ_u,i (static rank-based, Eq. 6)


def init_state(volumes: torch.Tensor, label_dist: torch.Tensor,
               cfg: CaesarConfig) -> CaesarState:
    """Algorithm 1 lines 2–4: rank devices by importance before training."""
    n = volumes.shape[0]
    c = imp.importance(volumes, label_dist, cfg.lam)
    theta_u = imp.upload_ratio(c, cfg.theta_u_min, cfg.theta_u_max)
    return CaesarState(last_round=torch.zeros(n, dtype=torch.int32),
                       importance=c, upload_ratio=theta_u)


@dataclasses.dataclass
class RoundPlan:
    theta_d: torch.Tensor        # [n] f32 download ratios (Eq. 3, clustered)
    theta_u: torch.Tensor        # [n] f32 upload ratios (Eq. 6)
    batch: torch.Tensor          # [n] int32 batch sizes (Eq. 9)
    cluster_id: torch.Tensor     # [n] int32


def plan_round(state: CaesarState, t: int, cfg: CaesarConfig,
               bw_down: torch.Tensor, bw_up: torch.Tensor, mu: torch.Tensor,
               q_bits: float, participants: torch.Tensor | None = None
               ) -> RoundPlan:
    """Algorithm 1 lines 8–10: [n] plan arrays, participant-scoped when
    ``participants`` ([n] bool = N^t) is given."""
    delta = st.staleness(state.last_round, t)
    n = delta.shape[0]
    if cfg.use_deviation_compress:
        if cfg.n_clusters > 0:
            cid, theta_d = st.cluster_ratios(delta, t, cfg.theta_d_max,
                                             cfg.n_clusters,
                                             mask=participants)
        else:
            theta_d = st.download_ratio(delta, t, cfg.theta_d_max)
            cid = torch.arange(n, dtype=torch.int32)
        theta_u = state.upload_ratio
    else:  # Caesar-BR ablation: fixed mid-range ratios for everyone
        mid = 0.5 * (cfg.theta_u_min + cfg.theta_u_max)
        theta_d = torch.full_like(state.importance, mid)
        theta_u = torch.full_like(state.importance, mid)
        cid = torch.zeros(n, dtype=torch.int32)
    if cfg.use_batch_opt:
        batch, _ = bs.optimize_batch_sizes(theta_d, theta_u, q_bits, bw_down,
                                           bw_up, cfg.tau, mu, cfg.b_max,
                                           cfg.b_min, mask=participants)
    else:  # Caesar-DC ablation: identical fixed batch size
        batch = torch.full((n,), cfg.b_max, dtype=torch.int32)
    return RoundPlan(theta_d=theta_d, theta_u=theta_u, batch=batch,
                     cluster_id=cid)


def post_round(state: CaesarState, participants: torch.Tensor,
               t: int) -> CaesarState:
    """Update participation records after the round."""
    return dataclasses.replace(
        state, last_round=st.update_participation(state.last_round,
                                                  participants, t))
