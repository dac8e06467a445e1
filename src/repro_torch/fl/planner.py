"""Planning layer of the Track-A round engine: `RoundPlanner` maps (round,
participant set N^t, capability snapshot) to per-participant (θ_d, θ_u,
batch, τ) arrays — Caesar's Algorithm-1 planning plus the baseline-policy
seam (the port of ``repro.fl.planner``).

Caesar plans are participant-scoped (the Eq. 8–9 leader is the fastest
participant and the §4.1 staleness clusters are built over participants)
unless ``plan_scope="all"``. Caesar's state transition (`advance`) depends
only on WHICH devices participated, so the driver runs plan → advance in
round order on its prefetch worker. A baseline policy (`repro_torch.fl.
baselines`) receives a participant-scoped ctx, including the gradient norms
`observe` keeps (PyramidFL ranks by them), so the driver plans it on the
main thread after the previous round's `observe`; `advance` is Caesar's
only. Planning runs on the CPU whatever the simulator's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import caesar as CA


class RoundPlanner:
    def __init__(self, cfg, volumes, label_dist, model_bits, policy):
        scope = cfg.caesar.plan_scope
        if scope not in ("participants", "all"):
            raise ValueError(f"unknown plan_scope {scope!r}; "
                             "want 'participants' or 'all'")
        self.cfg = cfg
        self.model_bits = model_bits
        self.is_caesar = cfg.scheme == "caesar"
        if self.is_caesar == (policy is not None):
            raise ValueError("a policy is needed for every scheme but caesar, "
                             f"and only there; scheme={cfg.scheme!r}")
        self.policy = policy
        self.caesar_state = CA.init_state(
            torch.as_tensor(np.asarray(volumes), dtype=torch.float32),
            torch.as_tensor(np.asarray(label_dist), dtype=torch.float32),
            cfg.caesar)
        self.grad_norms = np.zeros(cfg.n_clients)   # for PyramidFL ranking

    def _participant_mask(self, parts: np.ndarray) -> torch.Tensor:
        mask = np.zeros(self.cfg.n_clients, bool)
        mask[parts] = True
        return torch.from_numpy(mask)

    def plan(self, t: int, parts: np.ndarray, mu, bw_d, bw_u):
        """Per-participant (theta_d, theta_u, batch, taus) np arrays [P]."""
        cfg = self.cfg
        if not self.is_caesar:
            ctx = {"n": len(parts), "t": t, "total_rounds": cfg.rounds,
                   "mu": mu[parts], "bw_d": bw_d[parts], "bw_u": bw_u[parts],
                   "b_max": cfg.caesar.b_max, "tau": cfg.caesar.tau,
                   "grad_norms": self.grad_norms[parts]}
            p = self.policy.plan(ctx)
            return p.theta_d, p.theta_u, p.batch, p.local_iters
        ccfg = cfg.caesar
        mask = (self._participant_mask(parts)
                if ccfg.plan_scope == "participants" else None)
        f32 = torch.float32
        plan = CA.plan_round(self.caesar_state, int(t), ccfg,
                             torch.as_tensor(bw_d, dtype=f32),
                             torch.as_tensor(bw_u, dtype=f32),
                             torch.as_tensor(mu, dtype=f32),
                             float(self.model_bits), mask)
        return (plan.theta_d.numpy()[parts], plan.theta_u.numpy()[parts],
                plan.batch.numpy()[parts],
                np.full(len(parts), ccfg.tau, np.int32))

    def advance(self, t: int, parts: np.ndarray):
        """Caesar's participation-record transition (Algorithm 1 line 14);
        a no-op for the baseline policies."""
        if self.is_caesar:
            self.caesar_state = CA.post_round(
                self.caesar_state, self._participant_mask(parts), int(t))

    def observe(self, t: int, parts: np.ndarray, gnorms: np.ndarray):
        """Post-aggregation execution feedback (upload-delta norms, which
        PyramidFL ranks by)."""
        self.grad_norms[parts] = gnorms
