"""Trace-driven client availability — the port's copy of
``repro.fl.availability`` (pure numpy; ``eligible_mask`` is byte-equal to
the reference's for the same (cfg, seed, t)).

The fault engine (fl/faults.py) models *transport* failures of clients
that were sampled; this module models why clients are (un)samplable in the
first place. Real FL populations churn diurnally — devices come online when
their owners sleep/charge them, whole timezones appear and disappear
together, and session lengths are heavy-tailed — and that churn is what
generates the staleness distribution Caesar's §4.1 download policy keys
compression off. Replacing the driver's uniform draw with an
eligibility-aware draw over a deterministic diurnal schedule produces
exactly the correlated, heavy-tailed staleness the greedy policy must
survive.

The schedule is a **pure function of (cfg, seed, t)** — no wall state, no
cross-round carry — so a mid-run checkpoint restore replays the identical
availability schedule, the same guarantee the fault plan gives
(tests/test_availability.py pins both). The model, per client i at round
t (day length ``day_rounds``):

* a **home phase** φᵢ: one of ``n_zones`` timezone blocks plus a small
  within-zone offset (drawn once per run) — clients in the same zone come
  online together, which is what makes the churn *correlated*;
* a **per-day session**: the client is online for a contiguous window of
  the day starting near φᵢ whose length is ``duty`` scaled by a
  mean-one lognormal draw per (client, day) — session-length churn with
  heavy upper tails;
* a **per-round flake**: an online client vanishes for round t with
  probability ``flake_rate`` (short-lived churn inside a session).

Every draw hangs off ``SeedSequence(seed, spawn_key=(KIND_FAULTS, ...))``
(repro_torch.core.rng) — REP010 pins this structurally, the same way REP009
pins the fault modules. The step namespace starts at ``STEP_AVAIL =
1 << 20`` so it can never collide with the fault plan's round-keyed
``(t,)`` / ``(t, client, ...)`` steps (rounds are far below 2^20).
Draw-order contract (what makes the mask a pure function): the static
stream draws zones then offsets; each day stream draws session-start
jitter then session-length factors; each round stream draws flake
uniforms — always for ALL n_clients, in that fixed order, regardless of
who ends up eligible.

Like fl/faults.py this module is **pure numpy**: ``eligible_mask`` runs
inside the pipelined driver's prefetch worker (device ops stay off the
producer thread).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import rng as RNG

KINDS = ("always", "diurnal")

# step namespace under KIND_FAULTS (see module docstring): disjoint from
# the fault plan's (t,)/(t, client, ...) steps because t << 2^20
STEP_AVAIL = 1 << 20        # (STEP_AVAIL,)        static per-client draws
STEP_DAY = STEP_AVAIL + 1   # (STEP_DAY, day)      per-day session draws
STEP_FLAKE = STEP_AVAIL + 2  # (STEP_FLAKE, t)     per-round flake draws


@dataclasses.dataclass(frozen=True)
class AvailabilityConfig:
    """Diurnal availability schedule (default: the paper's always-on
    world — every client eligible every round, bit-identical driver)."""
    kind: str = "always"        # always | diurnal
    day_rounds: int = 24        # simulated rounds per day
    duty: float = 0.4           # mean online fraction of the day
    n_zones: int = 4            # timezone blocks (correlated churn)
    zone_spread: float = 0.05   # within-zone phase jitter (day fraction)
    session_jitter: float = 0.35  # lognormal sigma of session length
    flake_rate: float = 0.02    # per-round in-session dropout

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown availability kind {self.kind!r}; "
                             f"want one of {KINDS}")
        if self.day_rounds < 1:
            raise ValueError(f"day_rounds={self.day_rounds} < 1")
        if not 0.0 < self.duty <= 1.0:
            raise ValueError(f"duty={self.duty} outside (0, 1]")
        if self.n_zones < 1:
            raise ValueError(f"n_zones={self.n_zones} < 1")
        if not 0.0 <= self.flake_rate < 1.0:
            raise ValueError(f"flake_rate={self.flake_rate} outside [0, 1)")

    def enabled(self) -> bool:
        return self.kind != "always"


def client_phases(cfg: AvailabilityConfig, seed: int, n_clients: int
                  ) -> np.ndarray:
    """[n_clients] home phases in [0, 1): timezone block + within-zone
    offset, drawn once per run from the static stream. The driver caches
    this (read-only after init, so the prefetch worker shares it)."""
    rng = RNG.stream(seed, RNG.KIND_FAULTS, STEP_AVAIL)
    zones = rng.integers(0, cfg.n_zones, n_clients)
    offs = rng.normal(0.0, cfg.zone_spread, n_clients)
    return (zones / cfg.n_zones + offs) % 1.0


def eligible_mask(cfg: AvailabilityConfig, seed: int, t: int,
                  n_clients: int, phases: np.ndarray | None = None
                  ) -> np.ndarray:
    """[n_clients] bool — who is online at round t. Pure function of
    (cfg, seed, t): the per-day and per-round streams are keyed by
    day/round index, never by history, so any round's mask can be
    recomputed in isolation (checkpoint resume, post-hoc analysis)."""
    if not cfg.enabled():
        return np.ones(n_clients, bool)
    if phases is None:
        phases = client_phases(cfg, seed, n_clients)
    day, pos = divmod(int(t), cfg.day_rounds)
    pos = pos / cfg.day_rounds
    drng = RNG.stream(seed, RNG.KIND_FAULTS, STEP_DAY, day)
    start = (phases + drng.normal(0.0, cfg.zone_spread, n_clients)) % 1.0
    # mean-one lognormal session-length factor (heavy upper tail)
    sj = cfg.session_jitter
    length = np.clip(cfg.duty * np.exp(
        drng.normal(0.0, sj, n_clients) - 0.5 * sj * sj), 0.0, 1.0)
    on = ((pos - start) % 1.0) < length
    if cfg.flake_rate > 0.0:
        frng = RNG.stream(seed, RNG.KIND_FAULTS, STEP_FLAKE, int(t))
        on &= frng.random(n_clients) >= cfg.flake_rate
    return on


def staleness_stats(staleness: np.ndarray) -> dict:
    """Summary of a participant staleness sample (δ = rounds since last
    participation; δ = t for first-timers, matching the planner's δ=t
    convention) — the distribution fig11 reports against the download
    policy."""
    s = np.asarray(staleness, np.float64)
    if s.size == 0:
        return {"n": 0}
    return {
        "n": int(s.size),
        "mean": float(s.mean()),
        "p50": float(np.percentile(s, 50)),
        "p90": float(np.percentile(s, 90)),
        "p99": float(np.percentile(s, 99)),
        "max": float(s.max()),
    }
