"""Compression-policy baselines (paper §6.1): FedAvg, FlexCom, ProWD,
PyramidFL, plus the preliminary-study policies FIC and CAC (§2.2) — a copy of
the reference's numpy-only ``repro.fl.baselines`` (the port imports nothing
of the reference package).

A policy maps this round's participant-scoped context to a per-device
``Plan``; every scheme's model math then runs through the SAME round engine
(`repro_torch.fl.executor`) — the only per-policy switches are the plan
arrays and the class-level ``quantize`` flag, which the executor reads once
at construction. ``quantize=True`` marks ProWD-style bit-width reduction
(modeled as 1-bit hybrid compression of *all* masked elements at ratio θ,
same deviation machinery, different traffic accounting).
"""
from __future__ import annotations

import dataclasses

import numpy as np

THETA_LO, THETA_HI = 0.1, 0.6          # paper bound [36]


@dataclasses.dataclass
class Plan:
    theta_d: np.ndarray     # download compression ratio per device (f32)
    theta_u: np.ndarray     # upload compression ratio per device (f32)
    batch: np.ndarray       # batch size per device (int)
    local_iters: np.ndarray  # τ per device (int)

    def __post_init__(self):
        # fixed dtypes, as the reference's: the plans of both packages
        # compare array for array
        self.theta_d = np.asarray(self.theta_d, np.float32)
        self.theta_u = np.asarray(self.theta_u, np.float32)
        self.batch = np.asarray(self.batch, np.int32)
        self.local_iters = np.asarray(self.local_iters, np.int32)


def _cap_ratio(mu, bw_d, bw_u):
    """Capability score in [0,1]: 1 = weakest (→ most compression)."""
    slow = (mu / mu.max()) * 0.5 + (bw_u.min() / bw_u) * 0.25 \
        + (bw_d.min() / bw_d) * 0.25
    return (slow - slow.min()) / max(slow.max() - slow.min(), 1e-9)


class Policy:
    """Base: no quantization, full batch, fixed τ. Subclasses set the ratios."""
    name = "base"
    quantize = False     # ProWD-style 1-bit transport (executor flag)

    def plan(self, ctx) -> Plan:
        raise NotImplementedError


class FedAvg(Policy):
    """No compression, fixed identical batch size."""
    name = "fedavg"

    def plan(self, ctx) -> Plan:
        n = ctx["n"]
        return Plan(np.zeros(n), np.zeros(n),
                    np.full(n, ctx["b_max"]), np.full(n, ctx["tau"]))


class FIC(Policy):
    """Fixed identical compression (both directions)."""
    name = "fic"

    def __init__(self, ratio=0.35, compress_down=True, compress_up=True):
        self.ratio, self.down, self.up = ratio, compress_down, compress_up

    def plan(self, ctx) -> Plan:
        n = ctx["n"]
        td = np.full(n, self.ratio if self.down else 0.0)
        tu = np.full(n, self.ratio if self.up else 0.0)
        return Plan(td, tu, np.full(n, ctx["b_max"]), np.full(n, ctx["tau"]))


class CAC(Policy):
    """Capability-aware compression: weak devices compress more [25–28]."""
    name = "cac"

    def __init__(self, compress_down=True, compress_up=True):
        self.down, self.up = compress_down, compress_up

    def plan(self, ctx) -> Plan:
        n = ctx["n"]
        r = THETA_LO + (THETA_HI - THETA_LO) * _cap_ratio(
            ctx["mu"], ctx["bw_d"], ctx["bw_u"])
        td = r if self.down else np.zeros(n)
        tu = r if self.up else np.zeros(n)
        return Plan(td, tu, np.full(n, ctx["b_max"]), np.full(n, ctx["tau"]))


class FlexCom(Policy):
    """Top-K upload compression from network condition; batch ramps up [25]."""
    name = "flexcom"

    def plan(self, ctx) -> Plan:
        n = ctx["n"]
        bw = ctx["bw_u"]
        r = THETA_LO + (THETA_HI - THETA_LO) * (1.0 - (bw - bw.min())
                                                / max(bw.max() - bw.min(), 1e-9))
        frac = min(1.0, 0.5 + 0.5 * ctx["t"] / max(ctx["total_rounds"], 1))
        b = np.full(n, max(4, int(ctx["b_max"] * frac)))
        return Plan(np.zeros(n), r, b, np.full(n, ctx["tau"]))


class ProWD(Policy):
    """Bandwidth-determined quantization level on both directions [51]."""
    name = "prowd"
    quantize = True

    def plan(self, ctx) -> Plan:
        n = ctx["n"]
        cap = _cap_ratio(ctx["mu"], ctx["bw_d"], ctx["bw_u"])
        r = THETA_LO + (THETA_HI - THETA_LO) * cap
        return Plan(r, r, np.full(n, ctx["b_max"]), np.full(n, ctx["tau"]))


class PyramidFL(Policy):
    """Rank by gradient norm → compression; adapts local iteration count [36]."""
    name = "pyramidfl"

    def plan(self, ctx) -> Plan:
        n = ctx["n"]
        gn = ctx.get("grad_norms")
        if gn is None or not np.isfinite(gn).all() or gn.max() <= 0:
            rank = np.arange(n)
        else:
            rank = np.zeros(n, int)
            rank[np.argsort(-gn)] = np.arange(n)
        tu = THETA_LO + (THETA_HI - THETA_LO) * rank / max(n, 1)
        # local-iteration scaling to trim stragglers (download ignored — paper §6.2)
        mu = ctx["mu"]
        tau = np.maximum(1, (ctx["tau"] * mu.min() / mu)).astype(int)
        tau = np.maximum(tau, int(ctx["tau"] * 0.3))
        return Plan(np.zeros(n), tu, np.full(n, ctx["b_max"]), tau)


POLICIES = {c.name: c for c in (FedAvg, FIC, CAC, FlexCom, ProWD, PyramidFL)}
