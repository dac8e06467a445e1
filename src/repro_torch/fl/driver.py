"""Pipelined round driver for Track A (paper Algorithm 1) — the port of
``repro.fl.driver`` for every scheme (Caesar and the baselines of
`repro_torch.fl.baselines`), on the plan-shaped (ragged) or uniform-cap
(masked) engine, with an f32 or bf16 pool, optional error feedback, the
wire boundary (serialized uploads, faults, robust aggregation), diurnal
availability, and sharded over a ``torch.distributed`` world.

* `SimConfig` — the simulation config (the reference's, with ``backend``
  replaced by ``device``);
* `History` — eval-aligned metric series + per-round raw samples;
* `RoundPkg` — one round's prefetched inputs;
* `Simulator` — builds data/partition/capability/planner/executor, creates
  the per-run `repro_torch.fl.state.ClientStateStore` pool, and runs the
  (optionally pipelined) round loop with Eq.-7 time/waiting accounting and
  payload-faithful traffic accounting; with ``wire != "inproc"`` each round
  goes through `Simulator._wire_round`.

Device rule: the simulator runs on ``cfg.device`` (default ``"cuda"``).
When CUDA is asked for and there is no card, the constructor raises — it
never falls back to the CPU; tests pass ``device="cpu"``. On CUDA it turns
TF32 off for convolutions and matrix products (``torch.backends.cudnn.
allow_tf32`` and ``torch.backends.cuda.matmul.allow_tf32``), because the
reference computes in f32, and asks cuDNN for deterministic algorithms so
same-seed runs repeat. Planning and host sampling stay on the CPU.

Pipelining: host producer work for round t+1 runs on a worker thread while
the device executes round t: participant draw, capability snapshot and the
cap-shaped batch-index draw, then for ragged Caesar the plan, the round's
fault draw, the participation advance and a tier-shaped batch gather. A
baseline policy's worker (and masked Caesar's) gathers the cap-shaped batch
instead, and the main thread plans after the previous round's `observe`
(PyramidFL ranks by the last gradient norms) and slices the tiers out of
it, or builds the masks of the masked engine. Every round draws from its own
``SeedSequence(seed, spawn_key=(2, t))`` stream and the index draw is the
same in both paths, so pipelined and synchronous runs consume identical
randomness. The worker never touches the state store.

Checkpoint/resume: `Simulator.state_dict` after a run is a tree of numpy
arrays and Python scalars (global model, the client-state store with its
eviction metadata and offloaded rows, the planner's state, the accounting
counters and the wire state — deferred uploads, ``fault_log``,
``avail_log`` and the participation record) that
`repro_torch.checkpoint.manager.CheckpointManager` saves; a fresh simulator
of the same config takes it through `load_state_dict` and
``run(start_round=t_done + 1)`` replays the tail bit for bit.

Sharding (``sharded``; DESIGN.md §7): the client-state pool and the
participant chunks are split over the 1-D "data" layout of
`repro_torch.launch.mesh`, one rank per shard — the ranks of the process
group when one is up (``multi_host=True`` brings it up from the torchrun
environment, `mesh.init_distributed`), else a world of 1, which runs
exactly the unsharded path. Every rank runs this same-seed host loop
(draws, planning, batch gathers, accounting), participants are drawn
stratified per shard (``p_shard`` from each shard's clients; with one
shard the draw is the uniform one), the cohort is cut to a multiple of the
shard count (with the reference's warning), and each rank holds only its
own pool segment on its own device (``cuda:{LOCAL_RANK % cards}``). The
global model is replicated, and the History and ``round_log`` come out the
same on every rank (``wall*`` and ``compile_s`` are each rank's own
clock). The wire engine and diurnal availability are single-mesh, as in
the reference; `state_dict` gathers the pool from every rank, so every
rank calls it.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import batchsize as BS
from repro_torch.core import caesar as CA
from repro_torch.core import compression as C
from repro_torch.core import rng as RNG
from repro_torch.data import partition, synthetic
from repro_torch.fl import availability as AV
from repro_torch.fl import baselines as BL
from repro_torch.fl import faults as F
from repro_torch.fl import robust as RB
from repro_torch.fl import state as ST
from repro_torch.fl import wire as W
from repro_torch.fl.capability import CapabilityModel
from repro_torch.fl.executor import RoundExecutor, TierGroup
from repro_torch.fl.planner import RoundPlanner
from repro_torch.fl.state import ClientStateStore
from repro_torch.launch import mesh as MESH
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
    # against chunk_budget_mb (and the EF carry); 0 ⇒ one chunk of all
    chunk_size: Optional[int] = None
    # working-set budget (MB) the auto-tuned chunk targets
    chunk_budget_mb: float = 1024.0
    # overlap host sampling/planning of round t+1 with round t
    pipelined: bool = True
    # preliminary-study variants (Fig. 1): fic/cac compress one direction
    fic_down_only: bool = False
    fic_up_only: bool = False
    # plan-shaped ragged execution; False runs the uniform-cap masked
    # engine (every participant at [τ, b_max] with zero-weight masks)
    ragged: bool = True
    # storage dtype of the client-state pool rows: "float32" | "bfloat16"
    # (compute stays f32: gathers upcast, scatters downcast)
    buffer_dtype: str = "float32"
    # bf16 pools: stochastically round the scatter downcast (unbiased,
    # per-(round, chunk) seed) instead of round-to-nearest-even
    stochastic_round: bool = True
    # synthetic-task overrides (e.g. {"n_features": 64} for oppo_ts)
    dataset_kwargs: Optional[dict] = None
    # --- wire boundary: "inproc" folds uploads in process; "loopback"
    # serializes every upload through the wire codec and an in-process FIFO
    # (bit-identical at zero faults); "queue" through a multiprocessing
    # queue. Faults and non-mean aggregation need a wire.
    wire: str = "inproc"
    faults: F.FaultConfig = dataclasses.field(default_factory=F.FaultConfig)
    # server aggregation: mean | trimmed_mean | norm_clip | median | krum
    aggregation: str = "mean"
    trim_frac: float = 0.1               # trimmed_mean: trimmed per extreme
    clip_norm: Optional[float] = None    # norm_clip: None ⇒ median norm
    # wire value precision: float32 (exact) | bfloat16 (truncated, lossy)
    wire_value_dtype: str = "float32"
    # who is samplable each round: "always" (every client) or diurnal
    availability: AV.AvailabilityConfig = dataclasses.field(
        default_factory=AV.AvailabilityConfig)
    # krum: assumed attackers f (None ⇒ round(trim_frac·cohort)) and the
    # multi-Krum selection size m (None ⇒ cohort − f − 2)
    krum_f: Optional[int] = None
    krum_m: Optional[int] = None
    # client-state pool sizing: None ⇒ grow on demand (no eviction); 0 ⇒
    # dense [n_clients] pool; int > 0 ⇒ hard row cap with staleness-tiered
    # LRU eviction onto volume-weighted centroids (must cover the cohort)
    state_capacity: Optional[int] = None
    # what eviction does with the exact row: "none" keeps only the tier
    # centroid; "host" / "memmap" also spill the exact row (numpy / a file
    # on disk), so re-activation is exact paging
    state_offload: str = "none"
    # directory for "memmap" spill files (default: a fresh temp dir)
    state_dir: Optional[str] = None
    # record ||restored − true|| / ||true|| at every centroid restore
    # (executor.telemetry()["restore_error"])
    measure_eviction_error: bool = False
    # shard the client-state pool and the participant chunks over the
    # "data" layout, one rank of the process group per shard (a world of 1
    # without one); n_clients must divide over the shards, and participants
    # are drawn stratified per shard
    sharded: bool = False
    # bring up torch.distributed from the torchrun environment
    # (launch.mesh.init_distributed) before building the layout; requires
    # sharded=True; without a multi-process runtime it warns and runs in
    # a world of 1
    multi_host: bool = False


def _check_slice(cfg: SimConfig) -> None:
    """Raise for every configuration the simulator does not run, with the
    reference's exception types and messages."""
    if cfg.multi_host and not cfg.sharded:
        raise ValueError("multi_host=True requires sharded=True (the "
                         "multi-host mesh is the sharded 'data' axis)")
    if cfg.scheme != "caesar" and cfg.scheme not in BL.POLICIES:
        raise ValueError(f"unknown scheme {cfg.scheme!r}; want caesar or "
                         f"one of {sorted(BL.POLICIES)}")
    if cfg.state_offload not in ST.STATE_OFFLOADS:
        raise ValueError(f"unknown state_offload {cfg.state_offload!r}; "
                         f"want one of {ST.STATE_OFFLOADS}")
    if cfg.wire not in ("inproc", "loopback", "queue"):
        raise ValueError(f"unknown wire {cfg.wire!r} "
                         "(want inproc|loopback|queue)")
    if cfg.aggregation not in RB.AGGREGATIONS:
        raise ValueError(f"unknown aggregation {cfg.aggregation!r}; "
                         f"want one of {RB.AGGREGATIONS}")
    if cfg.wire == "inproc" and (cfg.faults.enabled()
                                 or cfg.aggregation != "mean"):
        raise ValueError(
            "fault injection and non-mean aggregation act on SERIALIZED "
            "payloads — set wire='loopback' (or 'queue')")
    if cfg.wire != "inproc":
        if cfg.scheme != "caesar":
            raise ValueError("the wire engine supports scheme='caesar' only")
        if not cfg.ragged:
            raise ValueError("the wire engine requires ragged=True (it "
                             "replays the tier-chunk stream)")
        if cfg.sharded:
            raise ValueError("the wire engine is single-mesh "
                             "(set sharded=False)")
    if cfg.availability.enabled() and cfg.sharded:
        raise ValueError(
            "diurnal availability is single-mesh (the stratified shard "
            "draw has no per-shard forced-wake story yet); set "
            "sharded=False")
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
    # wire engine only: cumulative SERIALIZED bytes×8 actually sent
    # (headers, bitpacked indices, CRC, retransmissions); empty inproc
    wire_bits: list = dataclasses.field(default_factory=list)

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
    fplan: Optional[F.FaultPlan] = None   # wire engine: round fault draw
    n_eligible: int = 0               # availability: online client count
    n_forced: int = 0                 # cohort shortfall force-woken


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
        if cfg.multi_host and not MESH.init_distributed(
                device=self.device):
            # N processes simulating in isolation would look like a
            # successful multi-process run: say so
            warnings.warn(
                "multi_host=True but no multi-process torch.distributed "
                "runtime was detected; running in a world of 1",
                stacklevel=2)
        self.layout = (MESH.make_data_group(self.device) if cfg.sharded
                       else None)
        self.n_dev = 1 if self.layout is None else self.layout.world
        if self.layout is not None:
            self.device = self.layout.device
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        ds_fn = synthetic.DATASETS[cfg.dataset]
        self.data = ds_fn(seed=cfg.seed, scale=cfg.data_scale,
                          **(cfg.dataset_kwargs or {}))
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
        if cfg.n_clients % self.n_dev:
            raise ValueError(f"n_clients ({cfg.n_clients}) must divide over "
                             f"{self.n_dev} shards")
        n_part = max(1, int(round(cfg.participation * cfg.n_clients)))
        # sharded rounds need equal per-shard cohorts
        self.n_part = max(self.n_dev, (n_part // self.n_dev) * self.n_dev)
        if self.n_part != n_part:
            warnings.warn(
                f"sharded mode adjusted the cohort from {n_part} to "
                f"{self.n_part} participants/round ({self.n_dev} shards "
                "need equal per-shard cohorts); pick a participation whose "
                "cohort divides the device count to silence this",
                stacklevel=2)
        self.policy = (None if cfg.scheme == "caesar"
                       else self._make_policy(cfg.scheme))
        self.planner = RoundPlanner(cfg, volumes, label_dist, self.model_bits,
                                    self.policy)
        self.executor = RoundExecutor(
            cfg, self.apply_fn, self.spec, self.n_part, self.device,
            quantize=bool(getattr(self.policy, "quantize", False)),
            use_ef=cfg.caesar.use_error_feedback, layout=self.layout)
        self.store: Optional[ClientStateStore] = None
        self.round_log: list = []
        # --- wire boundary: persistent attacker set and the aggregator
        self._wire_on = cfg.wire != "inproc"
        if self._wire_on:
            self._byz_members = F.byzantine_members(
                cfg.faults, cfg.seed, cfg.n_clients)
            self._aggregator = RB.make_aggregator(
                cfg.aggregation, cohort=self.n_part,
                trim_frac=cfg.trim_frac, clip_norm=cfg.clip_norm,
                krum_f=cfg.krum_f, krum_m=cfg.krum_m, device=self.device)
        # uploads deferred from round t-1 under late_policy="defer":
        # (client id, WireUpload)
        self._deferred: list = []
        self._transport = None
        # one dict per round: fault status, attackers and byte counts
        self.fault_log: list = []
        # --- availability: static per-client home phases, read-only after
        # init (the prefetch worker shares them)
        self._avail_on = cfg.availability.enabled()
        self._avail_phases = (AV.client_phases(cfg.availability, cfg.seed,
                                               cfg.n_clients)
                              if self._avail_on else None)
        # one dict per round: eligibility counts + participant staleness
        self.avail_log: list = []
        self._last_part = np.zeros(cfg.n_clients, np.int64)
        self._t_done = 0
        ne = min(cfg.eval_samples, len(self.data.y_test))
        self._eval_x = torch.from_numpy(self.data.x_test[:ne]).to(self.device)
        self._eval_y = torch.from_numpy(
            self.data.y_test[:ne].astype(np.int64)).to(self.device)

    # planner-owned state, exposed for tests and benchmarks
    @property
    def caesar_state(self):
        return self.planner.caesar_state

    @property
    def grad_norms(self):
        return self.planner.grad_norms

    @property
    def splits(self):
        """Per-client sample-index views over the CSR split storage."""
        return [self._split_idx[self._split_off[i]:self._split_off[i + 1]]
                for i in range(self.cfg.n_clients)]

    def _make_policy(self, name):
        if name == "fic":
            return BL.FIC(compress_down=not self.cfg.fic_up_only,
                          compress_up=not self.cfg.fic_down_only)
        if name == "cac":
            return BL.CAC(compress_down=not self.cfg.fic_up_only,
                          compress_up=not self.cfg.fic_down_only)
        return BL.POLICIES[name]()

    def _make_store(self) -> ClientStateStore:
        cfg = self.cfg
        return ClientStateStore(
            cfg.n_clients, self.n_params, self.flat0,
            capacity=cfg.state_capacity, cohort=self.n_part,
            device=self.device, ef_width=self.executor.ef_width,
            dtype=self.executor.buf_dtype, n_shards=self.n_dev,
            layout=self.layout, offload=cfg.state_offload,
            offload_dir=cfg.state_dir, volumes=self.volumes,
            measure_restore_error=cfg.measure_eviction_error)

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
                             ) -> tuple[np.ndarray, int, int]:
        """Round t's cohort draw → (parts, n_eligible, n_forced): a uniform
        draw without replacement over every client ("always"; stratified
        per shard when sharded, each shard's ``n_part / D`` from its own
        clients, shard-major), or over the round's eligible set (diurnal
        availability), force-waking the shortfall uniformly from the
        offline clients when fewer are online than the cohort needs — the
        reference's draw, byte-identical."""
        n, d = self.cfg.n_clients, self.n_dev
        if not self._avail_on:
            if d <= 1:
                return rng.choice(n, self.n_part, replace=False), n, 0
            rows, ps = n // d, self.n_part // d
            return np.concatenate([
                rng.choice(np.arange(s * rows, (s + 1) * rows), ps,
                           replace=False)
                for s in range(d)]), n, 0
        mask = AV.eligible_mask(self.cfg.availability, self.cfg.seed, t, n,
                                self._avail_phases)
        el = np.flatnonzero(mask)
        if len(el) >= self.n_part:
            return rng.choice(el, self.n_part, replace=False), len(el), 0
        forced = rng.choice(np.flatnonzero(~mask), self.n_part - len(el),
                            replace=False)
        return np.concatenate([el, forced]), len(el), len(forced)

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

    @staticmethod
    def _batch_masks(batch_sizes, taus, b_cap, tau_cap):
        """Per-participant (sample-weight [P,τ,b], iter-mask [P,τ]) masks
        realizing the planned batch sizes and local-iteration counts on the
        cap-shaped batches (the masked engine)."""
        p = len(batch_sizes)
        ws = np.zeros((p, tau_cap, b_cap), np.float32)
        for i, b in enumerate(batch_sizes):
            ws[i, :, :int(b)] = 1.0
        ims = (np.arange(tau_cap)[None, :]
               < np.asarray(taus)[:, None]).astype(np.float32)
        return ws, ims

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

    def _plan_faults(self, t: int, parts: np.ndarray, plan: tuple, mu,
                     bw_d, bw_u) -> Optional[F.FaultPlan]:
        """Round t's fault draw (pure numpy, on the prefetch worker), or
        None when the wire engine is off."""
        if not self._wire_on:
            return None
        cfg = self.cfg
        times = None
        if cfg.faults.straggler_deadline > 0.0:
            theta_d, theta_u, batch, taus = plan
            times = F.round_times_np(
                np.asarray(theta_d, np.float64),
                np.asarray(theta_u, np.float64),
                float(self.model_bits), bw_d[parts], bw_u[parts],
                np.asarray(taus, np.float64),
                np.asarray(batch, np.float64), mu[parts])
        return F.plan_faults(cfg.faults, cfg.seed, t, parts, times,
                             self._byz_members)

    def _prefetch_pkg(self, t: int, bufs: dict) -> RoundPkg:
        """The producer step for round t (worker thread when pipelined):
        draw → capability snapshot → [ragged Caesar: plan + fault draw +
        participation advance → tier-shaped batch gather | otherwise:
        cap-shaped batch gather]. Never touches the state store."""
        rng = self._round_rng(t)
        parts, n_el, n_forced = self._select_participants(rng, t)
        idx = self._draw_indices(rng, parts)
        mu, bw_d, bw_u = self.cap.snapshot(t)
        if self.planner.is_caesar and self.cfg.ragged:
            plan = self.planner.plan(t, parts, mu, bw_d, bw_u)
            fplan = self._plan_faults(t, parts, plan, mu, bw_d, bw_u)
            # failed rounds never advance their clients' participation
            # record (their pool rows roll back too)
            self.planner.advance(
                t, parts if fplan is None else parts[fplan.record])
            tiers = self._tiers_from_idx(idx, plan[2], plan[3], bufs)
            return RoundPkg(parts, mu, bw_d, bw_u, plan=plan, tiers=tiers,
                            fplan=fplan, n_eligible=n_el, n_forced=n_forced)
        if "cap" not in bufs:
            bufs["cap"] = self._alloc_batch_buffers(self.n_part)
        xs, ys = self._gather_cap(idx, bufs["cap"])
        return RoundPkg(parts, mu, bw_d, bw_u, xs=xs, ys=ys,
                        n_eligible=n_el, n_forced=n_forced)

    # ------------------------------------------------------------------
    # The wire-boundary round: deferred tier-chunk step → per-client
    # serialize (+ attack/corrupt) → transport → server decode + robust
    # aggregate. It replays the chunk stream the in-process engine folds,
    # so zero faults + mean + f32 values is bit-identical to it.
    # ------------------------------------------------------------------

    def _wire_round(self, global_f, store, pkg: RoundPkg, tiers, lr,
                    td32, tu32, t: int):
        cfg = self.cfg
        fp = pkg.fplan
        parts = pkg.parts
        chunks, db_o, ub_o, gn_o = self.executor.step_ragged_deferred(
            global_f, store, parts, tiers, lr, td32, tu32, t=t,
            wmask=fp.adopt)

        # -- client side: serialize each surviving upload, in chunk-stream
        # order (send order is part of the bit-identity contract). Pass 1
        # collects the honest sparse uploads (one host copy per chunk),
        # pass 2 swaps in the adversarial payloads and transmits: the
        # colluding ALIE vector needs the round's honest statistics first.
        tr = self._transport
        wire_bytes = 0
        resent = np.zeros(len(parts), bool)
        sent = []        # pos (parts order) in send order
        retained = {}    # pos -> clean payload, for the retry-once path
        rows = []        # (pos, idx [k], vals [k]) in chunk-stream order
        for pos_c, slots, c, ups in chunks:
            ups_np = ups.cpu().numpy()
            for row_i, pos in zip(slots, pos_c):
                pos = int(pos)
                if fp.status[pos] == F.DROP:
                    continue
                row = ups_np[row_i]
                idx = np.flatnonzero(row)
                rows.append((pos, idx, row[idx]))
        alie = None
        if cfg.faults.attack == "alie" and bool(fp.byz.any()):
            hsum = np.zeros(self.n_params, np.float64)
            hsq = np.zeros(self.n_params, np.float64)
            hn, hks, hnorms = 0, [], []
            for pos, idx, vals in rows:
                if fp.byz[pos]:
                    continue
                v64 = vals.astype(np.float64)
                hsum[idx] += v64
                hsq[idx] += v64 * v64
                hn += 1
                hks.append(len(idx))
                hnorms.append(float(np.linalg.norm(v64)))
            if hn:
                alie = F.alie_payload(cfg.faults, hsum, hsq, hn,
                                      int(np.median(hks)),
                                      float(np.median(hnorms)))
        for pos, idx, vals in rows:
            if fp.byz[pos]:
                idx, vals = F.attack_payload(
                    cfg.faults, cfg.seed, t, int(parts[pos]), idx, vals,
                    self.n_params, alie=alie)
            payload = W.encode_upload(
                idx, vals, client=int(parts[pos]), round_=t,
                n_params=self.n_params, value_dtype=cfg.wire_value_dtype)
            retained[pos] = payload
            wire_bytes += len(payload)
            if fp.corrupt_first[pos]:
                payload = F.flip_bit(payload, cfg.seed, t, int(parts[pos]),
                                     salt=0)
            tr.send(payload)
            sent.append(pos)
        payloads = (tr.drain(len(sent)) if cfg.wire == "queue"
                    else tr.drain())

        # -- server side: decode + CRC check, retry-once, deadline sort
        accepted = []        # (pos, WireUpload) folded THIS round
        deferred_next = []   # (client, WireUpload) arriving next round
        n_crc_drop = 0
        for pos, payload in zip(sent, payloads):
            try:
                u = W.decode_upload(payload)
            except W.WireCRCError:
                # retry-once: the client retransmits its retained payload
                # (priced as real traffic); a corrupted retry drops it
                p2 = retained[pos]
                wire_bytes += len(p2)
                resent[pos] = True
                if fp.status[pos] == F.CORRUPT_DROP:
                    p2 = F.flip_bit(p2, cfg.seed, t, int(parts[pos]),
                                    salt=1)
                try:
                    u = W.decode_upload(p2)
                except W.WireCRCError:
                    n_crc_drop += 1
                    continue
            if fp.status[pos] == F.LATE:
                if cfg.faults.late_policy == "defer":
                    deferred_next.append((int(parts[pos]), u))
                continue
            accepted.append((pos, u))
        defer_in = self._deferred
        self._deferred = deferred_next

        # -- robust aggregate: replay the chunk stream + late arrivals
        agg = self._aggregator
        if agg.needs_norms:
            norms = np.asarray(
                [float(np.linalg.norm(u.values)) for _, u in accepted]
                + [float(np.linalg.norm(u.values)) for _, u in defer_in])
            sc = agg.scales(norms)
            w_of = dict(zip([pos for pos, _ in accepted], sc.tolist()))
            w_defer = sc[len(accepted):].tolist()
        else:
            w_of = {pos: 1.0 for pos, _ in accepted}
            w_defer = [1.0] * len(defer_in)
        by_pos = dict(accepted)
        carry = agg.init(self.n_params)
        cnt = 0
        for pos_c, slots, c, _ups in chunks:
            dense = np.zeros((c, self.n_params), np.float32)
            w = np.zeros(c, np.float32)
            for row_i, pos in zip(slots, pos_c):
                u = by_pos.get(int(pos))
                if u is None:
                    continue
                dense[row_i, u.indices] = u.values
                w[row_i] = w_of[int(pos)]
                cnt += 1
            carry = agg.update(carry, dense, w)
        if defer_in:
            # deferred arrivals fold after the live chunks, rung-padded
            d = len(defer_in)
            d_pad = 1 << (d - 1).bit_length()
            dense = np.zeros((d_pad, self.n_params), np.float32)
            w = np.zeros(d_pad, np.float32)
            for i, (_cl, u) in enumerate(defer_in):
                dense[i, u.indices] = u.values
                w[i] = w_defer[i]
            carry = agg.update(carry, dense, w)
            cnt += d
        new_global = agg.finalize(global_f, carry, cnt)

        self.fault_log.append({
            "round": t, "parts": parts.copy(),
            "status": fp.status.copy(), "byz": fp.byz.copy(),
            "corrupt_first": fp.corrupt_first.copy(),
            "n_aggregated": len(accepted), "n_deferred_in": len(defer_in),
            "n_deferred_out": len(deferred_next),
            "n_crc_dropped": n_crc_drop, "wire_bytes": wire_bytes})
        # modeled upload traffic: only bytes that hit the wire count, and
        # a CRC retry pays twice
        up_eff = (ub_o * fp.uploads_sent().astype(np.float32)
                  * (1.0 + resent.astype(np.float32)))
        return new_global, db_o, up_eff, gn_o, wire_bytes

    def _init_global(self) -> torch.Tensor:
        """Fresh [n_params] f32 global vector on the device — sharded, a
        replica on this rank's device (`flat0` itself stays intact)."""
        return self.flat0.to(self.device, copy=True)

    # ------------------------------------------------------------------
    def run(self, log: Callable[[str], None] = lambda s: None,
            start_round: int = 1) -> History:
        """Simulate rounds [start_round, cfg.rounds]; 1 starts from a fresh
        pool. ``start_round > 1`` continues a checkpoint installed by
        `load_state_dict` (store, planner, global model, accounting and
        wire state); every per-round draw — sampling, stochastic rounding,
        faults, availability — is keyed by (seed, kind, t), so the tail
        replays the rounds the uninterrupted run simulated."""
        cfg = self.cfg
        q_bits = float(self.model_bits)
        hist = History()
        ccfg = cfg.caesar
        # one dict per round: participants, plan and payload bits (host
        # arrays) — the record parity checks compare across devices and
        # against the reference
        self.round_log = []
        if start_round > 1:
            rs = getattr(self, "_resume", None)
            if rs is None or rs["t_done"] != start_round - 1:
                raise ValueError(
                    f"start_round={start_round} needs a checkpoint of "
                    f"{start_round - 1} completed rounds loaded via "
                    "load_state_dict")
            global_f = torch.from_numpy(rs["global_flat"].copy()).to(
                self.device)
            store = self.store
            cum_time, cum_bits, waiting_sum = rs["acct"]
            wire_bits_cum = rs["wire_bits"]
        else:
            global_f = self._init_global()
            store = self.store = self._make_store()
            cum_time, cum_bits, waiting_sum = 0.0, 0.0, 0.0
            wire_bits_cum = 0.0
            self._deferred = []
            self.fault_log = []
            self.avail_log = []
            self._last_part = np.zeros(cfg.n_clients, np.int64)
        self._transport = (W.make_transport(cfg.wire) if self._wire_on
                           else None)
        # double-buffered producer: the worker fills round t+1's package
        # into the OFF buffer slot while the device runs round t
        pool = (ThreadPoolExecutor(max_workers=1) if cfg.pipelined
                else None)
        n_bufs = 2 if pool else 1
        bufs = [dict() for _ in range(n_bufs)]

        def prefetch(t):
            return self._prefetch_pkg(t, bufs[t % n_bufs])

        try:
            pending = pool.submit(prefetch, start_round) if pool else None
            for t in range(start_round, cfg.rounds + 1):
                wall0 = time.perf_counter()
                if pool:
                    pkg = pending.result()
                    if t < cfg.rounds:
                        pending = pool.submit(prefetch, t + 1)
                else:
                    pkg = prefetch(t)
                parts = pkg.parts
                mu, bw_d, bw_u = pkg.mu, pkg.bw_d, pkg.bw_u
                # participant staleness at draw time (δ = t − last recorded
                # participation; δ = t for first-timers), logged with the
                # availability counts; main thread only, in round order
                self.avail_log.append({
                    "round": t, "n_eligible": int(pkg.n_eligible),
                    "n_forced": int(pkg.n_forced),
                    "staleness": AV.staleness_stats(
                        t - self._last_part[parts])})
                rec = (parts if pkg.fplan is None
                       else parts[pkg.fplan.record])
                self._last_part[rec] = t
                lr = SGD.lr_at(cfg.sgd, torch.tensor(float(t - 1)))
                if pkg.plan is not None:
                    theta_d, theta_u, batch, taus = pkg.plan
                else:   # planned here, after round t-1's observe
                    theta_d, theta_u, batch, taus = self.planner.plan(
                        t, parts, mu, bw_d, bw_u)
                    # masked Caesar: the participation record advances
                    # right after planning (a no-op for the policies)
                    self.planner.advance(t, parts)
                self.round_log.append({
                    "round": t, "parts": parts.copy(), "theta_d": theta_d,
                    "theta_u": theta_u, "batch": batch, "taus": taus})
                td32 = np.asarray(theta_d, np.float32)
                tu32 = np.asarray(theta_u, np.float32)
                wire_bytes = 0
                if cfg.ragged:
                    tiers = (pkg.tiers if pkg.tiers is not None else
                             self._tiers_from_cap(pkg.xs, pkg.ys, batch,
                                                  taus))
                    if self._wire_on:
                        (global_f, down_bits, up_bits, gnorms,
                         wire_bytes) = self._wire_round(
                            global_f, store, pkg, tiers, lr, td32, tu32, t)
                    else:
                        (global_f, down_bits, up_bits,
                         gnorms) = self.executor.step_ragged(
                            global_f, store, parts, tiers, lr, td32, tu32,
                            t=t)
                else:
                    ws, ims = self._batch_masks(batch, taus, ccfg.b_max,
                                                ccfg.tau)
                    (global_f, down_bits, up_bits,
                     gnorms) = self.executor.step(
                        global_f, store, parts, pkg.xs, pkg.ys, ws, ims, lr,
                        td32, tu32, t=t)
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
                # under the wire engine a straggler deadline closes the
                # round early; with no deadline (inf) this is the barrier
                close = float(times.max())
                if pkg.fplan is not None:
                    close = min(close, float(pkg.fplan.deadline))
                cum_time += close
                waiting = float(np.mean(np.maximum(close - times, 0.0)))
                waiting_sum += waiting
                wire_bits_cum += wire_bytes * 8.0
                self._t_done = t
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
                    if self._wire_on:
                        hist.wire_bits.append(wire_bits_cum)
                    warm = hist.wall_per_round[1:] or hist.wall_per_round
                    hist.wall.append(float(np.mean(warm)))
                    log(f"[{cfg.scheme}/{cfg.dataset}] round {t:4d} "
                        f"acc={acc:.4f} time={cum_time:,.0f}s "
                        f"traffic={cum_bits/8e9:.3f}GB "
                        f"wait={waiting_sum / t:.1f}s")
        finally:
            if pool:
                pool.shutdown(wait=True, cancel_futures=True)
            if self._transport is not None:
                self._transport.close()
                self._transport = None
        self.global_flat = global_f          # final flat model (device)
        self.ef_flat = store.ef_pool         # [capacity, ef_width] residuals
        self._acct = (cum_time, cum_bits, waiting_sum)
        self._wire_bits_cum = wire_bits_cum
        return hist

    # ------------------------------------------------------------------
    # Checkpoint / resume: everything the resumed tail needs to replay bit
    # for bit. The fault and availability schedules need no state: they
    # are pure functions of (seed, kind, t).
    # ------------------------------------------------------------------

    def state_dict(self) -> dict:
        """Portable (numpy and Python scalars) checkpoint after `run`
        simulated ``self._t_done`` rounds — the reference's keys. Feed it to
        a FRESH Simulator of the same config via `load_state_dict`, then
        `run(start_round=t_done + 1)`."""
        cs = self.planner.caesar_state
        return {
            "t_done": int(self._t_done),
            "global_flat": self.global_flat.detach().cpu().numpy().copy(),
            "store": self.store.state_dict(),
            "caesar_leaves": [getattr(cs, f.name).numpy().copy()
                              for f in dataclasses.fields(cs)],
            "grad_norms": self.planner.grad_norms.copy(),
            "acct": tuple(getattr(self, "_acct", (0.0, 0.0, 0.0))),
            "wire_bits": float(getattr(self, "_wire_bits_cum", 0.0)),
            "deferred": [(int(cl), int(u.round), u.indices.copy(),
                          u.values.copy()) for cl, u in self._deferred],
            "fault_log": [dict(e) for e in self.fault_log],
            "last_part": self._last_part.copy(),
            "avail_log": [dict(e) for e in self.avail_log],
        }

    def load_state_dict(self, d: dict) -> None:
        """Install a `state_dict` checkpoint (also one restored through
        `CheckpointManager`, whose scalars come back as 0-d arrays): a new
        store from `_make_store` takes the store's state, the planner its
        state, and `run(start_round=t_done + 1)` is armed."""
        cs = self.planner.caesar_state
        self.planner.caesar_state = dataclasses.replace(cs, **{
            f.name: torch.from_numpy(np.array(x)).to(getattr(cs, f.name).dtype)
            for f, x in zip(dataclasses.fields(cs), d["caesar_leaves"])})
        self.planner.grad_norms = np.array(d["grad_norms"], np.float64)
        store = self._make_store()
        store.load_state_dict(d["store"])
        self.store = store
        self.global_flat = torch.from_numpy(
            np.array(d["global_flat"], np.float32)).to(self.device)
        self._deferred = [
            (int(cl), W.WireUpload(client=int(cl), round=int(r),
                                   n_params=self.n_params,
                                   indices=np.asarray(ix, np.int32),
                                   values=np.asarray(v, np.float32)))
            for cl, r, ix, v in d["deferred"]]
        self.fault_log = [_host_scalars(e) for e in d["fault_log"]]
        self._last_part = np.array(
            d.get("last_part", np.zeros(self.cfg.n_clients)), np.int64)
        self.avail_log = [_host_scalars(e) for e in d.get("avail_log", [])]
        self._t_done = int(d["t_done"])
        self._acct = tuple(float(x) for x in d["acct"])
        self._wire_bits_cum = float(d["wire_bits"])
        self._resume = {"t_done": self._t_done,
                        "global_flat": np.array(d["global_flat"],
                                                np.float32),
                        "acct": self._acct,
                        "wire_bits": self._wire_bits_cum}

    def reset(self):
        """Reset planner state so `run` can be repeated on the SAME
        simulator (`run` builds a fresh pool each call)."""
        self.planner = RoundPlanner(self.cfg, self.volumes, self.label_dist,
                                    self.model_bits, self.policy)

    def global_params(self) -> dict:
        """Final global model as {name: view} (unflatten at the boundary)."""
        flat = getattr(self, "global_flat", self.flat0)
        return C.unflatten_vector(flat, self.spec)


def _host_scalars(entry):
    """A log entry with 0-d arrays (what a checkpoint restores Python
    scalars as) turned back into Python scalars, recursively."""
    if isinstance(entry, dict):
        return {k: _host_scalars(v) for k, v in entry.items()}
    if isinstance(entry, np.ndarray) and entry.ndim == 0:
        return entry.item()
    return entry
