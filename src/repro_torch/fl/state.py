"""Client-state store: the participation-keyed pool of client-local model
rows — the port of ``repro.fl.state.ClientStateStore`` (one shard).

The paper's stale-local-model semantics (§4.1) need one [n_params] row per
client, but only clients that have EVER participated hold anything besides
the initial model. The pool is a device tensor ``[capacity, n_params]`` at
the storage dtype (f32 or bf16) plus an f32 ``ef_pool [capacity,
ef_width]`` residual carry, with host maps:

* ``slot_of [n_clients]`` (−1 = not resident), ``client_of [capacity]``
  (−1 = free), ``last_used [n_clients]`` (round of last participation),
  ``evicted_tier [n_clients]`` (−1 = never evicted);
* ``centroids [n_tiers, n_params]`` f32: volume-weighted running means of
  evicted rows, bucketed by log2-staleness tier. A re-activated client
  whose exact row was dropped restores its tier centroid; a first-timer
  restores the initial model row.

Capacity policies (``SimConfig.state_capacity``):

* ``None`` (default) — grow on demand: start at the smallest power of two
  ≥ 4 × cohort (at most n_clients) and double until every
  ever-participated client fits; nothing is evicted, so trajectories are
  identical to a dense buffer.
* ``0`` — dense: capacity = n_clients, ``slot_of`` = identity, every row
  pre-materialized.
* ``int > 0`` — hard cap with staleness-tiered LRU eviction: when the pool
  is full, the coldest resident non-participants (oldest ``last_used``,
  client id breaking ties) are folded into their tier centroid and their
  slots recycled. The round's participants are never evicted, so the cap
  must cover the cohort (``ValueError`` otherwise).

``offload`` keeps evicted rows EXACTLY besides the centroid fold: ``"host"``
spills to numpy, ``"memmap"`` to a file on disk, and re-activation restores
the exact row (and residual), so a capped pool with offload is paging, not
an approximation. ``measure_restore_error`` shadows evicted rows on the
host (without offload) and records ||centroid − true|| / ||true|| at each
centroid restore.

The host arithmetic (victim order, tiers, the f64-weighted centroid fold,
restore priority) is the reference's numpy, verbatim, so slot maps, tiers
and centroids are bit-equal to the reference's. The device side gathers
only the victims' rows to the host (never the whole pool) and writes
restored rows in place (``index_copy_``).

Checkpointing: `state_dict` is a flat dict of numpy arrays (pool cast to
f32, so a bf16 pool round-trips losslessly) that
`repro_torch.checkpoint.manager.CheckpointManager` saves and restores; it
carries the slot maps, eviction metadata and offloaded rows, and has the
reference's keys.

Sharded segments (``n_shards > 1``) are not ported: ROADMAP queue 1 item
13. All calls run on the MAIN thread: the executor gathers and scatters
the pool in place between `prepare` and the next round.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

STATE_OFFLOADS = ("none", "host", "memmap")
# fresh pools start at this multiple of the cohort (pow2-rounded)
GROW_COHORT_FACTOR = 4
DEFAULT_N_TIERS = 8


def _pow2(n: int) -> int:
    """Smallest power of two ≥ n (n ≥ 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


class _OffloadStore:
    """Exact cold-row spill: evicted rows keep their full contents on the
    host ("host": plain numpy) or on disk ("memmap"), so re-activation
    restores bit-exact state instead of the staleness-tier centroid. Rows
    are [n_params + ef_width] f32; a free list recycles row indices. The
    spill grows to a power of two of rows, at least BLOCK_BYTES' worth (the
    reference grows by 256 rows, 23 GB for ResNet-18's 89 MB rows)."""

    BLOCK_BYTES = 64 << 20   # growth granularity

    def __init__(self, kind: str, n_params: int, ef_width: int,
                 directory=None):
        if kind not in ("host", "memmap"):
            raise ValueError(f"unknown offload kind {kind!r}")
        self.kind = kind
        self.n_params = n_params
        self.width = n_params + ef_width
        self.block_rows = max(1, self.BLOCK_BYTES // (4 * self.width))
        self.row_of: dict[int, int] = {}     # client -> spill row
        self._free: list[int] = []
        self._rows = np.empty((0, self.width), np.float32)
        if kind == "memmap":
            self.dir = directory or tempfile.mkdtemp(prefix="caesar_cold_")
            os.makedirs(self.dir, exist_ok=True)
            self.path = os.path.join(self.dir, "cold_rows.f32")

    def _ensure(self, n: int):
        if self._rows.shape[0] >= n:
            return
        alloc = max(self.block_rows, _pow2(n))
        if self.kind == "memmap":
            with open(self.path, "a+b") as f:
                f.truncate(alloc * self.width * 4)
            grown = np.memmap(self.path, np.float32, mode="r+",
                              shape=(alloc, self.width))
        else:
            grown = np.empty((alloc, self.width), np.float32)
        grown[:self._rows.shape[0]] = self._rows[:]
        self._rows = grown

    def put(self, client: int, row: np.ndarray, ef: np.ndarray):
        i = self.row_of.get(client)
        if i is None:
            i = self._free.pop() if self._free else len(self.row_of)
            self._ensure(i + 1)
            self.row_of[client] = i
        self._rows[i, :self.n_params] = row
        self._rows[i, self.n_params:] = ef

    def pop(self, client: int):
        """(row, ef) f32 copies, or None if the client was never spilled."""
        i = self.row_of.pop(client, None)
        if i is None:
            return None
        self._free.append(i)
        out = np.array(self._rows[i])
        return out[:self.n_params], out[self.n_params:]

    def export(self):
        """(clients [k] i64, rows [k, width] f32) in client order."""
        cids = np.array(sorted(self.row_of), np.int64)
        rows = np.stack([self._rows[self.row_of[c]] for c in cids]) \
            if len(cids) else np.empty((0, self.width), np.float32)
        return cids, rows

    def load(self, cids: np.ndarray, rows: np.ndarray):
        self.row_of.clear()
        self._free.clear()
        self._ensure(len(cids))
        for i, c in enumerate(np.asarray(cids, np.int64)):
            self.row_of[int(c)] = i
            self._rows[i] = rows[i]


class ClientStateStore:
    """Participation-keyed row pool for the per-client local models and EF
    residuals. The executor's contract, per round on the main thread:

        slots = store.prepare(parts, t)    # activate / evict, host side
        <chunk steps read and write store.pool / store.ef_pool in place>
    """

    def __init__(self, n_clients: int, n_params: int,
                 init_row: torch.Tensor, *, capacity: int | None = None,
                 cohort: int = 1, device, ef_width: int = 0,
                 dtype: torch.dtype = torch.float32, n_shards: int = 1,
                 offload: str = "none", offload_dir=None,
                 n_tiers: int = DEFAULT_N_TIERS, volumes=None,
                 measure_restore_error: bool = False):
        if n_shards != 1:
            raise NotImplementedError(
                "sharded client-state segments (n_shards > 1) are not "
                "ported to repro_torch yet (ROADMAP queue 1 item 13)")
        if offload not in STATE_OFFLOADS:
            raise ValueError(f"unknown state_offload {offload!r}; want one "
                             f"of {STATE_OFFLOADS}")
        self.n_clients = int(n_clients)
        self.n_params = int(n_params)
        self.device = torch.device(device)
        self.ef_width = int(ef_width)
        self.dtype = dtype
        self.n_shards = 1
        self.rows_per_shard = self.n_clients
        self.cohort_per_shard = max(int(cohort), 1)
        self.n_tiers = int(n_tiers)
        # the initial model AT the storage dtype (round to nearest even, as
        # the reference pre-quantizes it), so activation writes are exact
        self.init_row = (init_row.to(self.device, torch.float32).reshape(-1)
                         .to(dtype).to(torch.float32))
        if self.init_row.shape != (self.n_params,):
            raise ValueError("init_row must be [n_params]")

        self.dense = capacity == 0
        self.growable = capacity is None
        if self.dense:
            self.cap_per_shard = self.rows_per_shard
        elif self.growable:
            self.cap_per_shard = min(
                self.rows_per_shard,
                _pow2(GROW_COHORT_FACTOR * self.cohort_per_shard))
        else:
            self.cap_per_shard = min(int(capacity), self.rows_per_shard)
            if self.cap_per_shard < self.cohort_per_shard:
                raise ValueError(
                    f"state_capacity={capacity} cannot hold the cohort "
                    f"({self.cohort_per_shard}); the current round's "
                    "participants are never evicted")

        # host maps
        self.slot_of = np.full(self.n_clients, -1, np.int64)
        self.last_used = np.zeros(self.n_clients, np.int64)
        self.evicted_tier = np.full(self.n_clients, -1, np.int8)
        self.centroids = np.zeros((self.n_tiers, self.n_params), np.float32)
        self.centroid_n = np.zeros(self.n_tiers, np.int64)
        self.centroid_w = np.zeros(self.n_tiers, np.float64)
        # centroid fold weights: client sample volume over the population
        # mean, so uniform volumes are EXACTLY weight 1.0 (the unweighted
        # fold)
        if volumes is None:
            self.row_weight = np.ones(self.n_clients, np.float64)
        else:
            v = np.asarray(volumes, np.float64)
            if v.shape != (self.n_clients,):
                raise ValueError("volumes must be [n_clients]")
            self.row_weight = v / v.mean()
        self.offloader = (None if offload == "none" else
                          _OffloadStore(offload, self.n_params,
                                        self.ef_width, offload_dir))
        # eviction-error telemetry: shadow the exact evicted rows on the
        # host so a later centroid restore can record its relative error.
        # Diagnostic only — the restore still hands out the centroid.
        self.measure_restore_error = bool(measure_restore_error)
        self.restore_errors: list[float] = []
        self._shadow: dict[int, np.ndarray] = {}
        # telemetry
        self.n_evictions = 0
        self.n_grows = 0
        self.n_restore_fresh = 0
        self.n_restore_centroid = 0
        self.n_restore_offload = 0
        self._init_pool()

    @property
    def capacity(self) -> int:
        return self.cap_per_shard

    def _init_pool(self):
        cap, w = self.capacity, self.n_params
        if self.dense:
            self.pool = self.init_row.to(self.dtype).expand(cap, w).clone()
            self.slot_of = np.arange(self.n_clients, dtype=np.int64)
            self.client_of = np.arange(cap, dtype=np.int64)
        else:
            self.pool = torch.zeros((cap, w), dtype=self.dtype,
                                    device=self.device)
            self.client_of = np.full(cap, -1, np.int64)
        self.ef_pool = torch.zeros((cap, self.ef_width), dtype=torch.float32,
                                   device=self.device)

    # -- activation / eviction ----------------------------------------------

    def prepare(self, parts: np.ndarray, t: int) -> np.ndarray:
        """Make every client in ``parts`` resident; returns their pool
        slots [P] int32 in parts order."""
        parts = np.asarray(parts, np.int64)
        if not self.dense:
            missing = parts[self.slot_of[parts] < 0]
            if missing.size:
                self._activate(np.unique(missing), parts, t)
        self.last_used[parts] = t
        return self.slot_of[parts].astype(np.int32)

    def _free_slots(self) -> np.ndarray:
        return np.flatnonzero(self.client_of < 0)

    def _staleness_tier(self, clients, t: int) -> np.ndarray:
        delta = np.maximum(t - self.last_used[clients], 1)
        return np.minimum(np.log2(delta).astype(np.int64),
                          self.n_tiers - 1).astype(np.int8)

    def _activate(self, missing: np.ndarray, protected: np.ndarray, t: int):
        need = len(missing)
        free = self._free_slots()
        if self.growable and need > len(free):
            used = self.cap_per_shard - len(free)
            self._grow(_pow2(used + need))
            free = self._free_slots()
        if need > len(free):
            self._evict(need - len(free), protected, t)
            free = self._free_slots()
        # missing is sorted, free slots ascending: a deterministic
        # assignment, the reference's
        self._restore(missing, free[:need])

    def _grow(self, new_cap: int):
        new_cap = min(new_cap, self.rows_per_shard)
        if new_cap <= self.cap_per_shard:
            return
        extra = new_cap - self.cap_per_shard
        self.pool = torch.cat([self.pool, torch.zeros(
            (extra, self.n_params), dtype=self.pool.dtype,
            device=self.device)])
        self.ef_pool = torch.cat([self.ef_pool, torch.zeros(
            (extra, self.ef_width), dtype=torch.float32,
            device=self.device)])
        grown = np.full(new_cap, -1, np.int64)
        grown[:self.cap_per_shard] = self.client_of
        self.client_of = grown
        self.cap_per_shard = new_cap
        self.n_grows += 1

    def _evict(self, short: int, protected: np.ndarray, t: int):
        """Free ``short`` slots by folding the coldest resident
        non-participants onto their staleness-tier centroid."""
        prot = np.zeros(self.n_clients, bool)
        prot[protected] = True
        seg = self.client_of
        cands = seg[(seg >= 0) & ~prot[np.maximum(seg, 0)]]
        if len(cands) < short:
            raise RuntimeError(
                f"need {short} slots but only {len(cands)} evictable rows "
                "(capacity too small for the cohort)")
        # coldest first: staleness tiers are monotone in last_used, so an
        # ascending last_used sort IS tier-major + LRU-within-tier; client
        # id breaks exact ties deterministically
        order = np.lexsort((cands, self.last_used[cands]))
        victims = cands[order[:short]]
        slots_v = self.slot_of[victims]
        rows = self._read_rows(self.pool, slots_v)
        efs = (self._read_rows(self.ef_pool, slots_v) if self.ef_width
               else np.zeros((len(victims), 0), np.float32))
        tier = self._staleness_tier(victims, t)
        for k in np.unique(tier):
            m = tier == k
            sel = rows[m]
            wv = self.row_weight[victims[m]]
            w0 = self.centroid_w[k]
            sw = wv.sum()
            self.centroids[k] = (w0 * self.centroids[k]
                                 + (sel * wv[:, None]).sum(axis=0)) \
                / (w0 + sw)
            self.centroid_w[k] = w0 + sw
            self.centroid_n[k] += int(m.sum())
        if self.offloader is not None:
            for i, c in enumerate(victims):
                self.offloader.put(int(c), rows[i], efs[i])
        if self.measure_restore_error and self.offloader is None:
            for i, c in enumerate(victims):
                self._shadow[int(c)] = rows[i].copy()
        self.evicted_tier[victims] = tier
        self.client_of[slots_v] = -1
        self.slot_of[victims] = -1
        self.n_evictions += len(victims)

    def _read_rows(self, pool: torch.Tensor, slots: np.ndarray) -> np.ndarray:
        """f32 host copy of ``pool[slots]``: a device gather of those rows
        only, never a copy of the whole pool."""
        idx = torch.from_numpy(np.asarray(slots, np.int64)).to(self.device)
        return pool.index_select(0, idx).to(torch.float32).cpu().numpy()

    def _restore(self, clients: np.ndarray, slots: np.ndarray):
        """Materialize rows for newly resident clients: exact offloaded
        copy > staleness-tier centroid > initial-model row. Residual rows
        restart at zero unless the offloaded copy carries them."""
        host_i, host_rows, host_efs, fresh_i = [], [], [], []
        for i, c in enumerate(clients):
            got = self.offloader.pop(int(c)) if self.offloader else None
            if got is not None:
                host_i.append(i)
                host_rows.append(got[0])
                host_efs.append(got[1])
                self.n_restore_offload += 1
            elif self.evicted_tier[c] >= 0:
                row = self.centroids[self.evicted_tier[c]]
                host_i.append(i)
                host_rows.append(row)
                host_efs.append(None)
                self.n_restore_centroid += 1
                true = self._shadow.pop(int(c), None)
                if true is not None:
                    tn = float(np.linalg.norm(true))
                    self.restore_errors.append(
                        float(np.linalg.norm(row - true)) / max(tn, 1e-30))
            else:
                fresh_i.append(i)
                self.n_restore_fresh += 1
        slots = np.asarray(slots, np.int64)

        def dev(sel):
            return torch.from_numpy(slots[sel]).to(self.device)

        if fresh_i:
            self.pool.index_copy_(0, dev(fresh_i), self.init_row.to(
                self.dtype).expand(len(fresh_i), self.n_params))
        if host_i:
            rows = torch.from_numpy(np.stack(host_rows)).to(self.device)
            self.pool.index_copy_(0, dev(host_i), rows.to(self.dtype))
        if self.ef_width:
            # a recycled slot holds its previous owner's residual
            self.ef_pool.index_fill_(0, dev(slice(None)), 0.0)
            off = [(i, e) for i, e in zip(host_i, host_efs) if e is not None]
            if off:
                self.ef_pool.index_copy_(0, dev([i for i, _ in off]),
                                         torch.from_numpy(np.stack(
                                             [e for _, e in off])).to(
                                                 self.device))
        self.slot_of[clients] = slots
        self.client_of[slots] = clients

    # -- checkpoint / introspection -----------------------------------------

    def state_dict(self) -> dict:
        """Flat dict of numpy arrays for `CheckpointManager`, with the
        reference's keys. The pool is cast to f32 (bf16 → f32 is lossless;
        npz has no bf16 dtype)."""
        off_cids, off_rows = (self.offloader.export() if self.offloader
                              else (np.empty(0, np.int64),
                                    np.empty((0, self.n_params
                                              + self.ef_width),
                                             np.float32)))
        return {
            "pool": self.pool.to(torch.float32).cpu().numpy(),
            "ef_pool": self.ef_pool.cpu().numpy(),
            "slot_of": self.slot_of.copy(),
            "client_of": self.client_of.copy(),
            "last_used": self.last_used.copy(),
            "evicted_tier": self.evicted_tier.astype(np.int8).copy(),
            "centroids": self.centroids.copy(),
            "centroid_n": self.centroid_n.copy(),
            "centroid_w": self.centroid_w.copy(),
            "offload_clients": off_cids,
            "offload_rows": off_rows,
            "counters": np.array([self.n_evictions, self.n_grows,
                                  self.n_restore_fresh,
                                  self.n_restore_centroid,
                                  self.n_restore_offload], np.int64),
            "cap_per_shard": np.array([self.cap_per_shard], np.int64),
        }

    def load_state_dict(self, d: dict):
        cap = int(np.asarray(d["cap_per_shard"])[0])
        pool = np.asarray(d["pool"], np.float32)
        if pool.shape != (cap, self.n_params):
            raise ValueError(f"pool shape {pool.shape} does not match "
                             f"capacity {cap}")
        self.cap_per_shard = cap
        self.pool = torch.from_numpy(pool).to(self.device).to(self.dtype)
        self.ef_pool = torch.from_numpy(
            np.asarray(d["ef_pool"], np.float32)).to(self.device)
        self.slot_of = np.asarray(d["slot_of"], np.int64).copy()
        self.client_of = np.asarray(d["client_of"], np.int64).copy()
        self.last_used = np.asarray(d["last_used"], np.int64).copy()
        self.evicted_tier = np.asarray(d["evicted_tier"], np.int8).copy()
        self.centroids = np.asarray(d["centroids"], np.float32).copy()
        self.centroid_n = np.asarray(d["centroid_n"], np.int64).copy()
        # checkpoints without centroid_w folded at unit weight: the count
        # IS the accumulated weight
        self.centroid_w = np.asarray(
            d.get("centroid_w", self.centroid_n), np.float64).copy()
        (self.n_evictions, self.n_grows, self.n_restore_fresh,
         self.n_restore_centroid, self.n_restore_offload) = (
            int(x) for x in np.asarray(d["counters"]))
        if self.offloader is not None:
            self.offloader.load(np.asarray(d["offload_clients"]),
                                np.asarray(d["offload_rows"], np.float32))

    def telemetry(self) -> dict:
        itemsize = self.pool.element_size()
        return {
            "capacity": self.capacity,
            "resident": int((self.slot_of >= 0).sum()),
            "ever_active": int((self.last_used > 0).sum()),
            "registered": self.n_clients,
            "evictions": self.n_evictions,
            "grows": self.n_grows,
            "restores": {"fresh": self.n_restore_fresh,
                         "centroid": self.n_restore_centroid,
                         "offload": self.n_restore_offload},
            "offloaded": (len(self.offloader.row_of) if self.offloader
                          else 0),
            **({"restore_error": {
                "count": len(self.restore_errors),
                "mean": (float(np.mean(self.restore_errors))
                         if self.restore_errors else 0.0),
                "max": (float(np.max(self.restore_errors))
                        if self.restore_errors else 0.0)}}
               if self.measure_restore_error else {}),
            "pool_mb": self.capacity * (self.n_params * itemsize
                                        + self.ef_width * 4) / 2**20,
            "dense_mb": self.n_clients * (self.n_params * itemsize
                                          + self.ef_width * 4) / 2**20,
        }
