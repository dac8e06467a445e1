"""Fault-injection layer of the wire-boundary engine — the port's copy of
``repro.fl.faults`` (pure numpy; plans and payloads are byte-equal to the
reference's for the same (cfg, seed, t)).

The paper's Eq.-7 sync barrier assumes every sampled device survives its
round; this module injects the failures that assumption hides, following
the SNIPPETS PBFT simulator's taxonomy (non-responsive vs adversarial
replicas) at FL's wire boundary:

* **mid-round dropout** — the participant finishes local training but its
  upload never arrives (device crash / network loss after compute). The
  server renormalizes the aggregate over the survivors and the client's
  state-store row does NOT adopt the partial round (next participation
  resyncs from its stale record, exactly like a crashed device).
* **straggler timeout** — the server closes the round at a deadline
  (``straggler_deadline`` × the round's *median* Eq.-7 finish time); late
  uploads are ``"discard"``-ed (treated like a dropout, but their wire
  traffic still counts — the bytes were sent) or ``"defer"``-red into the
  next round's aggregate.
* **payload corruption** — bit flips on the serialized payload, caught by
  the wire CRC (fl/wire.py): the server requests ONE retry (the retransmit
  is priced as real traffic); a second corruption drops the upload.
* **Byzantine uploads** — a persistent adversarial client fraction attacks
  the *compressed* representation (the sparse top-k payload, not the raw
  gradient). Oblivious attacks keep the honest support: ``sign_flip``
  (−scale·values), ``scale`` (+scale·values), ``random`` (N(0, std·scale)
  at the same support). Adaptive attacks exploit the top-k path itself
  (DESIGN.md §12): ``support_poison`` relocates the payload's mass onto
  coordinates OUTSIDE the client's honest support (where few honest rows
  vote, so a plain mean absorbs the junk undiluted), and ``alie`` is the
  colluding "a little is enough" inner-product attack (Baruch et al.,
  NeurIPS'19): every colluder transmits the same μ − z·σ vector built
  from the round's honest update statistics, truncated to the honest
  median support size and rescaled to the honest median norm — sitting
  just inside norm-clip/trim thresholds by construction.

Every draw hangs off ``SeedSequence(seed, spawn_key=(KIND_FAULTS, ...))``
(repro_torch.core.rng): membership at step 0, round draws at step (t,),
per-client noise at step (t, client), bit-flip positions at step
(t, client, 1 + salt), support-poison coordinates at step (t, client, 3)
— keyed by round, never by wall state, so a mid-run checkpoint restore
replays the identical schedule. (fl/availability.py owns the disjoint
``STEP_AVAIL = 1 << 20`` step namespace under the same kind.)

**Draw-order contract** (what keeps ``plan_faults`` a pure function of
``(cfg, seed, t, parts, times)``): round t's stream emits exactly 3·P
uniforms in a fixed order — P dropout, P first-transmission corruption,
P retry corruption — regardless of any participant's outcome. Outcomes
are applied as *masks afterwards* (a LATE-discarded participant's
corruption uniforms are drawn and thrown away, never skipped), so
changing one client's fate can never shift another client's draws.

This module is **pure numpy** (no torch): ``plan_faults`` runs inside the
pipelined driver's prefetch worker (device ops stay off the producer
thread), which is why it carries its own numpy twin of the Eq.-7 time
model (``round_times_np``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import rng as RNG

ATTACKS = ("sign_flip", "scale", "random", "support_poison", "alie")
LATE_POLICIES = ("discard", "defer")

# FaultPlan.status codes
OK = 0
DROP = 1          # mid-round dropout: trained, never uploaded
LATE = 2          # finish time beyond the round deadline
CORRUPT_DROP = 3  # both the transmission and its retry failed CRC


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Per-round fault rates (all default to the paper's fault-free world).

    ``byzantine_frac`` selects a PERSISTENT adversarial client set (drawn
    once per run at spawn step 0) — the same clients attack every round
    they are sampled, matching the PBFT adversary model. The other rates
    are per-(round, participant) Bernoulli draws."""
    dropout_rate: float = 0.0
    straggler_deadline: float = 0.0       # ×median Eq.-7 time; 0 ⇒ no deadline
    late_policy: str = "discard"          # discard | defer
    corrupt_rate: float = 0.0             # P(payload fails CRC) per transmission
    byzantine_frac: float = 0.0
    # sign_flip | scale | random | support_poison | alie
    attack: str = "sign_flip"
    attack_scale: float = 10.0
    # alie only: the z-score offset of the colluding μ − z·σ vector
    # (attack_scale would be far too blunt — ALIE's whole point is staying
    # inside the trim/clip envelope, z ≈ 0.3–1.5)
    alie_z: float = 1.0

    def __post_init__(self):
        if self.attack not in ATTACKS:
            raise ValueError(f"unknown attack {self.attack!r}; "
                             f"want one of {ATTACKS}")
        if self.late_policy not in LATE_POLICIES:
            raise ValueError(f"unknown late_policy {self.late_policy!r}; "
                             f"want one of {LATE_POLICIES}")
        for name in ("dropout_rate", "corrupt_rate", "byzantine_frac"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}={v} outside [0, 1]")
        if self.alie_z < 0.0:
            raise ValueError(f"alie_z={self.alie_z} must be >= 0")

    def enabled(self) -> bool:
        return (self.dropout_rate > 0 or self.straggler_deadline > 0
                or self.corrupt_rate > 0 or self.byzantine_frac > 0)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One round's fault outcome over the participant array (parts order).

    ``status`` is the transport outcome per participant (OK/DROP/LATE/
    CORRUPT_DROP); ``byz`` flags attackers (orthogonal to status — an
    attacker's upload still travels the wire); ``corrupt_first`` flags
    uploads whose FIRST transmission fails CRC (server retries once;
    ``status == CORRUPT_DROP`` means the retry draw failed too).
    ``adopt`` is the state-store row-write mask: only rounds the server
    actually aggregated (or deferred) may update a client's stale-model
    record — a dropped client's slot must not adopt the partial round."""
    status: np.ndarray          # [P] int8
    byz: np.ndarray             # [P] bool
    corrupt_first: np.ndarray   # [P] bool
    adopt: np.ndarray           # [P] bool — state-store row write mask
    record: np.ndarray          # [P] bool — planner participation record
    deadline: float             # absolute round deadline (inf if none)

    def uploads_sent(self) -> np.ndarray:
        """Participants whose bytes hit the wire at least once."""
        return self.status != DROP

    def aggregated(self) -> np.ndarray:
        """Participants whose upload lands in THIS round's aggregate."""
        return self.status == OK


def round_times_np(theta_d, theta_u, q_bits: float, bw_down, bw_up,
                   tau, batch, mu) -> np.ndarray:
    """Numpy twin of ``core.batchsize.round_times`` (Eq. 7) for the
    prefetch worker — same formula, float64, no device op."""
    theta_d = np.asarray(theta_d, np.float64)
    theta_u = np.asarray(theta_u, np.float64)
    comm = (theta_d * (q_bits / np.asarray(bw_down, np.float64))
            + theta_u * (q_bits / np.asarray(bw_up, np.float64)))
    return comm + (np.asarray(tau, np.float64)
                   * np.asarray(batch, np.float64)
                   * np.asarray(mu, np.float64))


def byzantine_members(cfg: FaultConfig, seed: int, n_clients: int
                      ) -> np.ndarray:
    """[n_clients] bool persistent attacker membership — spawn step 0,
    independent of every per-round stream."""
    members = np.zeros(n_clients, bool)
    k = int(round(cfg.byzantine_frac * n_clients))
    if k:
        rng = RNG.stream(seed, RNG.KIND_FAULTS, 0)
        members[rng.choice(n_clients, size=k, replace=False)] = True
    return members


def plan_faults(cfg: FaultConfig, seed: int, t: int, parts: np.ndarray,
                times: np.ndarray | None, byz_members: np.ndarray
                ) -> FaultPlan:
    """Draw round t's fault outcome. ``times`` are the participants' Eq.-7
    finish times (may be None when no deadline is configured). Draws come
    from the (seed, KIND_FAULTS, t) stream under the module's draw-order
    contract (see docstring): exactly 3·P uniforms — P dropout, P first-
    transmission corruption, P retry corruption — drawn unconditionally
    in that order, with outcomes applied as masks AFTER all draws, so the
    plan is a pure function of (cfg, seed, t, parts, times).

    Corruption never applies to a participant that is already lost to
    this round on the transport: DROP-ped uploads have no bytes to flip,
    and a LATE upload under ``late_policy="discard"`` is past the
    deadline — a server would not request a retry for it, so drawing it
    a corruption (and pricing a pointless retransmission) would be
    charging for a protocol exchange that cannot happen. A LATE upload
    under "defer" IS still wanted (it folds into round t+1), so its
    first transmission can corrupt and be retried like any other."""
    p = len(parts)
    rng = RNG.stream(seed, RNG.KIND_FAULTS, t)
    u_drop = rng.random(p)
    u_c1 = rng.random(p)
    u_c2 = rng.random(p)

    status = np.full(p, OK, np.int8)
    deadline = np.inf
    if cfg.straggler_deadline > 0:
        if times is None:
            raise ValueError("straggler_deadline needs the round's Eq.-7 "
                             "finish times")
        deadline = float(cfg.straggler_deadline
                         * np.median(np.asarray(times, np.float64)))
        status[np.asarray(times, np.float64) > deadline] = LATE
    status[u_drop < cfg.dropout_rate] = DROP   # dropout trumps lateness
    late_lost = (status == LATE) & (cfg.late_policy == "discard")
    corrupt_first = ((status != DROP) & ~late_lost
                     & (u_c1 < cfg.corrupt_rate))
    status[(status == OK) & corrupt_first
           & (u_c2 < cfg.corrupt_rate)] = CORRUPT_DROP

    byz = byz_members[parts]
    ok = status == OK
    late_def = (status == LATE) & (cfg.late_policy == "defer")
    # deferred uploads DID complete: the client's on-device model advanced
    # and the server eventually folds the delta in, so its row adopts and
    # its participation is recorded at t (staleness tracks the client's
    # replica, not the server's receipt time)
    adopt = ok | late_def
    return FaultPlan(status=status, byz=byz, corrupt_first=corrupt_first,
                     adopt=adopt, record=adopt.copy(), deadline=deadline)


def attack_values(cfg: FaultConfig, seed: int, t: int, client: int,
                  values: np.ndarray) -> np.ndarray:
    """Apply a support-preserving attack to one client's compressed upload
    values (the sparse top-k payload — the adversary controls what it
    transmits, not the server's decode). Deterministic per
    (seed, t, client), so replay/resume sees identical attacks."""
    values = np.asarray(values, np.float32)
    if values.size == 0 or cfg.attack == "sign_flip":
        return -np.float32(cfg.attack_scale) * values
    if cfg.attack == "scale":
        return np.float32(cfg.attack_scale) * values
    rng = RNG.stream(seed, RNG.KIND_FAULTS, t, int(client))
    std = float(values.std()) or 1.0
    return rng.normal(0.0, std * cfg.attack_scale,
                      size=values.shape).astype(np.float32)


def attack_payload(cfg: FaultConfig, seed: int, t: int, client: int,
                   indices: np.ndarray, values: np.ndarray, n_params: int,
                   alie: tuple | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """The full adversarial payload — (indices, values) the Byzantine
    client transmits instead of its honest top-k. Support-preserving
    attacks delegate to ``attack_values``; the adaptive attacks rewrite
    the support itself:

    * ``support_poison`` — the attacker keeps its honest value
      *magnitudes* (scaled by ``attack_scale``) but relocates them onto
      coordinates drawn uniformly OUTSIDE its honest support, with random
      signs, from the (seed, t, client, 3) stream. On a sparse top-k
      wire few honest rows vote on any given junk coordinate, so a plain
      mean absorbs the mass undiluted — while a zero-inclusive
      coordinate-wise median still sees a majority of exact zeros there.
    * ``alie`` — all colluders transmit the round's shared ALIE vector
      (``alie``, precomputed by ``alie_payload`` from honest statistics);
      when no honest statistics exist this round (every survivor is a
      colluder), falls back to sign_flip on the honest payload.
    """
    indices = np.asarray(indices)
    values = np.asarray(values, np.float32)
    if cfg.attack == "alie":
        if alie is not None:
            return alie
        return indices, -np.float32(cfg.attack_scale) * values
    if cfg.attack != "support_poison":
        return indices, attack_values(cfg, seed, t, client, values)
    k = len(indices)
    if k == 0 or n_params <= k:
        return indices, attack_values(cfg, seed, t, client, values)
    rng = RNG.stream(seed, RNG.KIND_FAULTS, t, int(client), 3)
    cand = rng.choice(n_params, size=k, replace=False)
    cand = cand[~np.isin(cand, indices)]        # strictly off-support
    signs = rng.choice(np.float32([-1.0, 1.0]), size=len(cand))
    mags = np.sort(np.abs(values))[::-1][:len(cand)]
    return (cand.astype(indices.dtype),
            (signs * np.float32(cfg.attack_scale) * mags)
            .astype(np.float32))


def alie_payload(cfg: FaultConfig, honest_sum: np.ndarray,
                 honest_sumsq: np.ndarray, n_honest: int, k: int,
                 norm_target: float
                 ) -> tuple[np.ndarray, np.ndarray] | None:
    """The round's shared colluding ALIE vector: μ − z·σ over the honest
    uploads (coordinate-wise first and second moments accumulated by the
    caller), truncated to the k largest-|·| coordinates (the honest
    median support size, so the payload blends in) and rescaled to
    ``norm_target`` (the honest median norm — just inside a
    median-of-round norm-clip threshold and inside trimmed-mean's
    per-coordinate envelope for small z). Deterministic with no RNG at
    all: the colluders' knowledge is the honest statistics themselves.
    Returns None when there are no honest uploads to estimate from."""
    if n_honest < 1 or k < 1:
        return None
    mu = np.asarray(honest_sum, np.float64) / n_honest
    var = np.maximum(
        np.asarray(honest_sumsq, np.float64) / n_honest - mu * mu, 0.0)
    v = mu - cfg.alie_z * np.sqrt(var)
    k = min(int(k), v.size)
    idx = np.argpartition(np.abs(v), v.size - k)[v.size - k:]
    idx = np.sort(idx)
    vals = v[idx]
    nrm = float(np.linalg.norm(vals))
    if nrm > 0.0 and norm_target > 0.0:
        vals = vals * (norm_target / nrm)
    return idx.astype(np.int32), vals.astype(np.float32)


def flip_bit(payload: bytes, seed: int, t: int, client: int,
             salt: int = 0) -> bytes:
    """Flip one deterministic bit of a serialized payload (the corruption
    the wire CRC must catch). ``salt`` distinguishes the retry draw.
    The draw is consumed even for a zero-length payload (which has no bit
    to flip and passes through unchanged) so the (t, client, salt) stream
    stays aligned whatever the payload."""
    rng = RNG.stream(seed, RNG.KIND_FAULTS, t, int(client), 1 + salt)
    buf = bytearray(payload)
    bit = int(rng.integers(0, max(len(buf), 1) * 8))
    if not buf:
        return payload
    buf[bit >> 3] ^= 1 << (bit & 7)
    return bytes(buf)
