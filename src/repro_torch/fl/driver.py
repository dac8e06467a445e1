"""Pipelined round driver for Track A (paper Algorithm 1) — the port of
``repro.fl.driver`` for the plan-shaped (ragged) in-process path of every
scheme: Caesar and the baselines of `repro_torch.fl.baselines`.

* `SimConfig` — the simulation config (the reference's, with ``backend``
  replaced by ``device``);
* `History` — eval-aligned metric series + per-round raw samples;
* `RoundPkg` — one round's prefetched inputs;
* `Simulator` — builds data/partition/capability/planner/executor, creates
  the per-run `repro_torch.fl.state.ClientStateStore` pool, and runs the
  (optionally pipelined) round loop with Eq.-7 time/waiting accounting and
  payload-faithful traffic accounting.

Device rule: the simulator runs on ``cfg.device`` (default ``"cuda"``).
When CUDA is asked for and there is no card, the constructor raises — it
never falls back to the CPU; tests pass ``device="cpu"``. On CUDA it turns
TF32 off for convolutions and matrix products (``torch.backends.cudnn.
allow_tf32`` and ``torch.backends.cuda.matmul.allow_tf32``), because the
reference computes in f32, and asks cuDNN for deterministic algorithms so
same-seed runs repeat. Planning and host sampling stay on the CPU.

Pipelining: host producer work for round t+1 runs on a worker thread while
the device executes round t: participant draw, capability snapshot and the
cap-shaped batch-index draw, then for Caesar the plan + participation
advance and a tier-shaped batch gather. A baseline policy's worker gathers
the cap-shaped batch instead, and the main thread plans after the previous
round's `observe` (PyramidFL ranks by the last gradient norms) and slices
the tiers out of it. Every round draws from its own
``SeedSequence(seed, spawn_key=(2, t))`` stream and the index draw is the
same in both paths, so pipelined and synchronous runs consume identical
randomness. The worker never touches the state store.

Configurations outside this slice raise ``NotImplementedError`` naming
their ROADMAP item; none is silently ignored.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import batchsize as BS
from repro_torch.core import caesar as CA
from repro_torch.core import compression as C
from repro_torch.core import rng as RNG
from repro_torch.data import partition, synthetic
from repro_torch.fl import baselines as BL
from repro_torch.fl.capability import CapabilityModel
from repro_torch.fl.executor import RoundExecutor, TierGroup
from repro_torch.fl.planner import RoundPlanner
from repro_torch.fl.state import ClientStateStore
from repro_torch.models import paper_models as PM
from repro_torch.optim import sgd as SGD


@dataclasses.dataclass(frozen=True)
class SimConfig:
    dataset: str = "cifar10"
    model: Optional[str] = None          # default: paper pairing
    scheme: str = "caesar"               # caesar | fedavg | fic | cac | flexcom | prowd | pyramidfl
    n_clients: int = 100
    participation: float = 0.1
    rounds: int = 100
    p_heterogeneity: float = 5.0         # paper's p = 1/δ (default 5)
    data_scale: float = 0.05             # dataset size multiplier
    eval_every: int = 5
    eval_samples: int = 1000
    seed: int = 0
    caesar: CA.CaesarConfig = dataclasses.field(default_factory=CA.CaesarConfig)
    sgd: SGD.SGDConfig = dataclasses.field(default_factory=SGD.SGDConfig)
    # where the round engine runs: "cuda" (default; raises without a card)
    # or "cpu" (the kernels' plain twins — tests and small runs)
    device: str = "cuda"
    # participants per tier chunk; None ⇒ core.compression.auto_chunk
    chunk_size: Optional[int] = None
    # overlap host sampling/planning of round t+1 with round t
    pipelined: bool = True
    # preliminary-study variants (Fig. 1): fic/cac compress one direction
    fic_down_only: bool = False
    fic_up_only: bool = False
    # --- outside this slice: non-default values raise NotImplementedError
    ragged: bool = True                  # masked engine: ROADMAP 1 item 9
    buffer_dtype: str = "float32"        # bf16 pool: ROADMAP 1 item 9
    state_capacity: Optional[int] = None  # >0 eviction: ROADMAP 1 item 10
    sharded: bool = False                # ROADMAP 1 item 13
    multi_host: bool = False             # ROADMAP 1 item 13
    wire: str = "inproc"                 # ROADMAP 1 item 11
    availability: str = "always"         # diurnal: ROADMAP 1 item 11


def _check_slice(cfg: SimConfig) -> None:
    """Raise for every configuration this slice does not run."""
    def nope(what, item):
        raise NotImplementedError(
            f"{what} is not ported to repro_torch yet (ROADMAP queue 1 item "
            f"{item})")
    if cfg.scheme != "caesar" and cfg.scheme not in BL.POLICIES:
        raise ValueError(f"unknown scheme {cfg.scheme!r}; want caesar or "
                         f"one of {sorted(BL.POLICIES)}")
    if not cfg.ragged:
        nope("ragged=False (the masked engine)", 9)
    if cfg.buffer_dtype != "float32":
        nope(f"buffer_dtype={cfg.buffer_dtype!r}", 9)
    if cfg.caesar.use_error_feedback:
        nope("use_error_feedback", 9)
    if cfg.state_capacity not in (None, 0):
        nope("a capped state pool with eviction/offload", 10)
    if cfg.sharded or cfg.multi_host:
        nope("sharded / multi_host execution", 13)
    if cfg.wire != "inproc":
        nope(f"wire={cfg.wire!r} (and the robust aggregations)", 11)
    if cfg.availability != "always":
        nope(f"availability={cfg.availability!r}", 11)
    model = cfg.model or PM.DATASET_MODEL.get(cfg.dataset)
    if model not in PM.MODELS:
        raise ValueError(f"unknown model {model!r} for dataset "
                         f"{cfg.dataset!r}; want one of {sorted(PM.MODELS)}")


def resolve_device(name: str) -> torch.device:
    """The simulator's device. CUDA without a card raises: there is no
    CPU fallback."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={name!r} but torch.cuda.is_available() is False; "
                "pass device='cpu' explicitly to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (want cuda or cpu)")
    return dev


@dataclasses.dataclass
class History:
    """Eval-aligned series: every list has one entry per eval round
    (``rounds[i]`` is the round number of entry i). ``waiting`` is a
    running mean over all rounds so far; ``wall`` the running mean of
    rounds after the first (round 1 also builds kernels and warms caches,
    reported as ``compile_s``). Per-round raw samples are in
    ``*_per_round``."""
    rounds: list = dataclasses.field(default_factory=list)
    sim_time: list = dataclasses.field(default_factory=list)      # cumulative s
    traffic_bits: list = dataclasses.field(default_factory=list)  # cumulative
    accuracy: list = dataclasses.field(default_factory=list)
    waiting: list = dataclasses.field(default_factory=list)       # running mean s
    wall: list = dataclasses.field(default_factory=list)          # warm mean s
    waiting_per_round: list = dataclasses.field(default_factory=list)
    wall_per_round: list = dataclasses.field(default_factory=list)
    compile_s: float = 0.0

    def summary(self) -> dict:
        return {"final_acc": self.accuracy[-1] if self.accuracy else 0.0,
                "total_time_s": self.sim_time[-1] if self.sim_time else 0.0,
                "total_traffic_gb": (self.traffic_bits[-1] / 8e9
                                     if self.traffic_bits else 0.0)}

    def to_target(self, acc: float):
        """(time_s, traffic_gb, round) when ``acc`` first reached, else None."""
        for r, t, tr, a in zip(self.rounds, self.sim_time, self.traffic_bits,
                               self.accuracy):
            if a >= acc:
                return t, tr / 8e9, r
        return None


@dataclasses.dataclass
class RoundPkg:
    """Everything the driver needs to execute one round, produced by the
    prefetch path (worker thread when pipelined). ``plan`` and ``tiers``
    are filled for Caesar (whose planner is execution-independent);
    baseline policies plan on the main thread from ``xs``/``ys``."""
    parts: np.ndarray
    mu: np.ndarray
    bw_d: np.ndarray
    bw_u: np.ndarray
    plan: Optional[tuple] = None      # (theta_d, theta_u, batch, taus) [P]
    xs: Optional[np.ndarray] = None   # cap-shaped [P, τ, b_max, ...]
    ys: Optional[np.ndarray] = None
    tiers: Optional[list] = None      # list[TierGroup]


class Simulator:
    def __init__(self, cfg: SimConfig, init_flat=None):
        """``init_flat``: optional initial [n_params] model (numpy or
        tensor, e.g. the reference's ``Simulator.flat0`` through
        `repro_torch.models.paper_models.from_reference`); default is the
        port's own He-normal init from ``torch.Generator`` seeded with
        ``cfg.seed``."""
        _check_slice(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        ds_fn = synthetic.DATASETS[cfg.dataset]
        self.data = ds_fn(seed=cfg.seed, scale=cfg.data_scale)
        model_name = cfg.model or PM.DATASET_MODEL[cfg.dataset]
        spec_fn, init_fn, self.apply_fn = PM.MODELS[model_name]
        model_kw = {"n_classes": self.data.n_classes}
        if model_name == "lr":
            model_kw["n_features"] = self.data.x_train.shape[-1]
        self.spec = spec_fn(**model_kw)
        if init_flat is None:
            gen = torch.Generator().manual_seed(cfg.seed)
            self.flat0 = init_fn(gen, **model_kw)
        else:
            flat0 = (init_flat if isinstance(init_flat, torch.Tensor)
                     else torch.from_numpy(np.asarray(init_flat, np.float32)))
            self.flat0 = flat0.detach().to("cpu", torch.float32).reshape(
                -1).clone()
        if self.flat0.shape != (self.spec.n_params,):
            raise ValueError(f"init_flat must have {self.spec.n_params} "
                             f"parameters, got {self.flat0.numel()}")
        self.n_params = self.spec.n_params
        self.model_bits = self.n_params * C.FULL_BITS

        splits, label_dist, volumes = partition.dirichlet_partition(
            self.data.y_train, cfg.n_clients, cfg.p_heterogeneity, cfg.seed)
        self._split_off = np.zeros(cfg.n_clients + 1, np.int64)
        self._split_off[1:] = np.cumsum([len(s) for s in splits])
        self._split_idx = np.concatenate(splits).astype(np.int64)
        del splits
        self.volumes = volumes
        self.label_dist = label_dist
        self.cap = CapabilityModel(cfg.n_clients, cfg.seed)
        self.n_part = max(1, int(round(cfg.participation * cfg.n_clients)))
        self.policy = (None if cfg.scheme == "caesar"
                       else self._make_policy(cfg.scheme))
        self.planner = RoundPlanner(cfg, volumes, label_dist, self.model_bits,
                                    self.policy)
        self.executor = RoundExecutor(
            cfg, self.apply_fn, self.spec, self.n_part, self.device,
            quantize=bool(getattr(self.policy, "quantize", False)))
        self.store: Optional[ClientStateStore] = None
        self.round_log: list = []
        ne = min(cfg.eval_samples, len(self.data.y_test))
        self._eval_x = torch.from_numpy(self.data.x_test[:ne]).to(self.device)
        self._eval_y = torch.from_numpy(
            self.data.y_test[:ne].astype(np.int64)).to(self.device)

    def _make_policy(self, name):
        if name == "fic":
            return BL.FIC(compress_down=not self.cfg.fic_up_only,
                          compress_up=not self.cfg.fic_down_only)
        if name == "cac":
            return BL.CAC(compress_down=not self.cfg.fic_up_only,
                          compress_up=not self.cfg.fic_down_only)
        return BL.POLICIES[name]()

    def _make_store(self) -> ClientStateStore:
        return ClientStateStore(self.cfg.n_clients, self.n_params, self.flat0,
                                capacity=self.cfg.state_capacity,
                                cohort=self.n_part, device=self.device)

    def _eval(self, flat: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
        """Accuracy of one flat model on (x, y), as a 0-dim device tensor."""
        with torch.no_grad():
            params = C.unflatten_vector(flat[None], self.spec)
            logits = self.apply_fn(params, x[None])[0]
            return torch.mean((torch.argmax(logits, -1) == y).to(
                torch.float32))

    # ------------------------------------------------------------------
    # Host-side producer work (pure numpy + CPU planning).
    # ------------------------------------------------------------------

    def _round_rng(self, t: int) -> np.random.Generator:
        """Deterministic per-round stream: SeedSequence(seed, (2, t))."""
        return RNG.stream(self.cfg.seed, RNG.KIND_SAMPLING, t)

    def _select_participants(self, rng: np.random.Generator, t: int
                             ) -> np.ndarray:
        """Round t's cohort: a uniform draw without replacement (the
        reference's availability-"always" draw, byte-identical)."""
        return rng.choice(self.cfg.n_clients, self.n_part, replace=False)

    def _draw_indices(self, rng: np.random.Generator,
                      parts: np.ndarray) -> np.ndarray:
        """Cap-shaped batch-index draw [P, τ, b_max] — always at the caps,
        so the randomness stream is plan-independent; tiers consume a
        [:τ_tier, :b_tier] prefix."""
        b_cap, tau_cap = self.cfg.caesar.b_max, self.cfg.caesar.tau
        off, pool = self._split_off, self._split_idx
        idx = np.empty((len(parts), tau_cap, b_cap), np.intp)
        for i, ci in enumerate(parts):
            idx[i] = rng.choice(pool[off[ci]:off[ci + 1]],
                                size=(tau_cap, b_cap), replace=True)
        return idx

    def _gather_cap(self, idx: np.ndarray, out):
        """Gather the cap-shaped training batches for ``idx`` into ``out``
        (a preallocated (xs, ys) pair, filled in place so the pipelined
        driver's two buffer sets are reused every round)."""
        xtr, ytr = self.data.x_train, self.data.y_train
        xs, ys = out
        flat = idx.reshape(-1)
        np.take(xtr, flat, axis=0, out=xs.reshape((-1,) + xtr.shape[1:]))
        np.take(ytr, flat, axis=0, out=ys.reshape((-1,) + ytr.shape[1:]))
        return xs, ys

    def _alloc_batch_buffers(self, n_parts: int):
        """One cap-shaped (xs, ys) buffer set [P, τ, b_max, ...]."""
        b_cap, tau_cap = self.cfg.caesar.b_max, self.cfg.caesar.tau
        xtr, ytr = self.data.x_train, self.data.y_train
        return (np.empty((n_parts, tau_cap, b_cap) + xtr.shape[1:],
                         xtr.dtype),
                np.empty((n_parts, tau_cap, b_cap) + ytr.shape[1:],
                         ytr.dtype))

    def _plan_tiers(self, batch: np.ndarray, taus: np.ndarray) -> list:
        """Quantize the plan to the (b, τ) lattice and group participants
        by tier: tiers descending by (τ, b), participants in parts order."""
        ccfg = self.cfg.caesar
        bt, tt = BS.quantize_plan(batch, taus, ccfg.b_min, ccfg.b_max,
                                  ccfg.tau)
        groups = []
        for tau_t, b_t in sorted(set(zip(tt.tolist(), bt.tolist())),
                                 reverse=True):
            pos = np.flatnonzero((tt == tau_t) & (bt == b_t))
            groups.append((int(b_t), int(tau_t), pos))
        return groups

    def _tier_masks(self, batch, taus, pos, b_t, tau_t, g_pad):
        """Rung-padded (ws [g_pad,τ,b], ims [g_pad,τ]) realizing the exact
        planned (b_i, τ_i) inside the tier shape."""
        g = len(pos)
        ws = np.zeros((g_pad, tau_t, b_t), np.float32)
        ws[:g] = (np.arange(b_t)[None, None, :]
                  < np.asarray(batch)[pos, None, None])
        ims = np.zeros((g_pad, tau_t), np.float32)
        ims[:g] = (np.arange(tau_t)[None, :] < np.asarray(taus)[pos, None])
        return ws, ims

    def _ensure_flat_buffers(self, bufs: dict, x_rows: int):
        """Grow-on-demand flat sample pools the tier gather carves into —
        persistent per slot, so the steady state allocates nothing."""
        xtr, ytr = self.data.x_train, self.data.y_train
        cur = bufs.get("flat")
        if cur is None or cur[0].shape[0] < x_rows:
            bufs["flat"] = (np.empty((x_rows,) + xtr.shape[1:], xtr.dtype),
                            np.empty((x_rows,) + ytr.shape[1:], ytr.dtype))
        return bufs["flat"]

    def _tiers_from_idx(self, idx: np.ndarray, batch, taus,
                        bufs: dict) -> list:
        """Tier-shaped batch gather: for each tier, gather ONLY the
        [:τ_t, :b_t] prefix of the cap-shaped index draw."""
        groups = self._plan_tiers(batch, taus)
        layouts = [self.executor.tier_layout(len(pos))
                   for _, _, pos in groups]
        total = sum(gl[0] * tau_t * b_t
                    for (b_t, tau_t, _), gl in zip(groups, layouts))
        xflat, yflat = self._ensure_flat_buffers(bufs, total)
        xtr, ytr = self.data.x_train, self.data.y_train
        feat = xtr.shape[1:]
        tiers, off = [], 0
        for (b_t, tau_t, pos), (g_pad, slices) in zip(groups, layouts):
            rows = g_pad * tau_t * b_t
            xv = xflat[off:off + rows]
            yv = yflat[off:off + rows]
            off += rows
            sel = idx[pos, :tau_t, :b_t].reshape(-1)
            np.take(xtr, sel, axis=0, out=xv[:sel.size])
            np.take(ytr, sel, axis=0, out=yv[:sel.size])
            if rows > sel.size:          # zero the rung padding
                xv[sel.size:] = 0
                yv[sel.size:] = 0
            ws, ims = self._tier_masks(batch, taus, pos, b_t, tau_t, g_pad)
            tiers.append(TierGroup(
                b=b_t, tau=tau_t, pos=pos, g_pad=g_pad, slices=slices,
                xs=xv.reshape((g_pad, tau_t, b_t) + feat),
                ys=yv.reshape((g_pad, tau_t, b_t)), ws=ws, ims=ims))
        return tiers

    def _tiers_from_cap(self, xs: np.ndarray, ys: np.ndarray, batch,
                        taus) -> list:
        """Tier groups sliced out of an already cap-gathered batch (the
        policy-scheme path, where the plan needs execution feedback and is
        only known on the main thread after the worker gathered)."""
        tiers = []
        for b_t, tau_t, pos in self._plan_tiers(batch, taus):
            g = len(pos)
            g_pad, slices = self.executor.tier_layout(g)
            xs_t = np.zeros((g_pad, tau_t, b_t) + xs.shape[3:], xs.dtype)
            xs_t[:g] = xs[pos, :tau_t, :b_t]
            ys_t = np.zeros((g_pad, tau_t, b_t), ys.dtype)
            ys_t[:g] = ys[pos, :tau_t, :b_t]
            ws, ims = self._tier_masks(batch, taus, pos, b_t, tau_t, g_pad)
            tiers.append(TierGroup(b=b_t, tau=tau_t, pos=pos, g_pad=g_pad,
                                   slices=slices, xs=xs_t, ys=ys_t, ws=ws,
                                   ims=ims))
        return tiers

    def _prefetch_pkg(self, t: int, bufs: dict) -> RoundPkg:
        """The producer step for round t (worker thread when pipelined):
        draw → capability snapshot → [Caesar: plan + participation advance
        → tier-shaped batch gather | policy: cap-shaped batch gather].
        Never touches the state store."""
        rng = self._round_rng(t)
        parts = self._select_participants(rng, t)
        idx = self._draw_indices(rng, parts)
        mu, bw_d, bw_u = self.cap.snapshot(t)
        if self.planner.is_caesar:
            plan = self.planner.plan(t, parts, mu, bw_d, bw_u)
            self.planner.advance(t, parts)
            tiers = self._tiers_from_idx(idx, plan[2], plan[3], bufs)
            return RoundPkg(parts, mu, bw_d, bw_u, plan=plan, tiers=tiers)
        if "cap" not in bufs:
            bufs["cap"] = self._alloc_batch_buffers(self.n_part)
        xs, ys = self._gather_cap(idx, bufs["cap"])
        return RoundPkg(parts, mu, bw_d, bw_u, xs=xs, ys=ys)

    def _init_global(self) -> torch.Tensor:
        """Fresh [n_params] f32 global vector on the device (`flat0` itself
        stays intact)."""
        return self.flat0.to(self.device, copy=True)

    # ------------------------------------------------------------------
    def run(self, log: Callable[[str], None] = lambda s: None) -> History:
        """Simulate rounds 1..cfg.rounds from a fresh pool."""
        cfg = self.cfg
        q_bits = float(self.model_bits)
        hist = History()
        global_f = self._init_global()
        store = self.store = self._make_store()
        cum_time, cum_bits, waiting_sum = 0.0, 0.0, 0.0
        # one dict per round: participants, plan and payload bits (host
        # arrays) — the record parity checks compare across devices and
        # against the reference
        self.round_log = []
        # double-buffered producer: the worker fills round t+1's package
        # into the OFF buffer slot while the device runs round t
        pool = (ThreadPoolExecutor(max_workers=1) if cfg.pipelined
                else None)
        n_bufs = 2 if pool else 1
        bufs = [dict() for _ in range(n_bufs)]

        def prefetch(t):
            return self._prefetch_pkg(t, bufs[t % n_bufs])

        try:
            pending = pool.submit(prefetch, 1) if pool else None
            for t in range(1, cfg.rounds + 1):
                wall0 = time.perf_counter()
                if pool:
                    pkg = pending.result()
                    if t < cfg.rounds:
                        pending = pool.submit(prefetch, t + 1)
                else:
                    pkg = prefetch(t)
                parts = pkg.parts
                mu, bw_d, bw_u = pkg.mu, pkg.bw_d, pkg.bw_u
                lr = SGD.lr_at(cfg.sgd, torch.tensor(float(t - 1)))
                if pkg.plan is not None:
                    theta_d, theta_u, batch, taus = pkg.plan
                    tiers = pkg.tiers
                else:   # a policy plans here, after round t-1's observe
                    theta_d, theta_u, batch, taus = self.planner.plan(
                        t, parts, mu, bw_d, bw_u)
                    tiers = self._tiers_from_cap(pkg.xs, pkg.ys, batch, taus)
                self.round_log.append({
                    "round": t, "parts": parts.copy(), "theta_d": theta_d,
                    "theta_u": theta_u, "batch": batch, "taus": taus})
                td32 = np.asarray(theta_d, np.float32)
                tu32 = np.asarray(theta_u, np.float32)
                (global_f, down_bits, up_bits,
                 gnorms) = self.executor.step_ragged(
                    global_f, store, parts, tiers, lr, td32, tu32, t=t)
                self.planner.observe(t, parts, gnorms)

                # --- accounting: payload bits on the wire. step_ragged
                # returned host arrays after the round's one device sync,
                # so wall_per_round is an honest per-round wall clock
                down_b = np.asarray(down_bits, np.float64)  # repro: noqa=REP006
                up_b = np.asarray(up_bits, np.float64)  # repro: noqa=REP006
                cum_bits += float(down_b.sum() + up_b.sum())
                self.round_log[-1].update(down_bits=down_b, up_bits=up_b)
                # time + barrier waiting: the Eq.-7 θ·Q/β model at the
                # PLANNED (b_i, τ_i), in f64 numpy as the reference
                times = BS.round_times(
                    np.asarray(theta_d, np.float64),
                    np.asarray(theta_u, np.float64), q_bits,
                    bw_d[parts], bw_u[parts],
                    np.asarray(taus, np.float64),
                    np.asarray(batch, np.float64), mu[parts])
                close = float(times.max())
                cum_time += close
                waiting = float(np.mean(np.maximum(close - times, 0.0)))
                waiting_sum += waiting
                hist.waiting_per_round.append(waiting)
                hist.wall_per_round.append(time.perf_counter() - wall0)
                if t == 1:
                    hist.compile_s = hist.wall_per_round[0]

                if t % cfg.eval_every == 0 or t == cfg.rounds:
                    # eval boundary, cadence-limited by cfg.eval_every
                    acc = float(self._eval(global_f,  # repro: noqa=REP006
                                           self._eval_x, self._eval_y))
                    hist.rounds.append(t)
                    hist.sim_time.append(cum_time)
                    hist.traffic_bits.append(cum_bits)
                    hist.accuracy.append(acc)
                    hist.waiting.append(waiting_sum / t)
                    warm = hist.wall_per_round[1:] or hist.wall_per_round
                    hist.wall.append(float(np.mean(warm)))
                    log(f"[{cfg.scheme}/{cfg.dataset}] round {t:4d} "
                        f"acc={acc:.4f} time={cum_time:,.0f}s "
                        f"traffic={cum_bits/8e9:.3f}GB "
                        f"wait={waiting_sum / t:.1f}s")
        finally:
            if pool:
                pool.shutdown(wait=True, cancel_futures=True)
        self.global_flat = global_f          # final flat model (device)
        self._acct = (cum_time, cum_bits, waiting_sum)
        return hist

    def state_dict(self) -> dict:
        raise NotImplementedError(
            "checkpoint/resume is not ported to repro_torch yet (ROADMAP "
            "queue 1 item 10)")

    def load_state_dict(self, d: dict) -> None:
        raise NotImplementedError(
            "checkpoint/resume is not ported to repro_torch yet (ROADMAP "
            "queue 1 item 10)")

    def reset(self):
        """Reset planner state so `run` can be repeated on the SAME
        simulator (`run` builds a fresh pool each call)."""
        self.planner = RoundPlanner(self.cfg, self.volumes, self.label_dist,
                                    self.model_bits, self.policy)

    def global_params(self) -> dict:
        """Final global model as {name: view} (unflatten at the boundary)."""
        flat = getattr(self, "global_flat", self.flat0)
        return C.unflatten_vector(flat, self.spec)
