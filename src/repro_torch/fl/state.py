"""Client-state store: the participation-keyed pool of client-local model
rows — the port of ``repro.fl.state.ClientStateStore``.

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

Sharding (``n_shards > 1``): the pool is row-partitioned over the 1-D
"data" layout (`repro_torch.launch.mesh`); slot ids are ``shard *
cap_per_shard + local``, so each shard's segment has its own free list,
growth and eviction, and a client's slot lives in its own shard (the
stratified participant draw, DESIGN.md §7). The host bookkeeping (maps,
tiers, centroids, offloaded rows, restore-error shadow) is the same on
every rank. The device rows are not: without a process group (a world of
1) the store holds every segment in one tensor, as the reference does in
one process; under a group of ``n_shards`` ranks (``layout``) each rank
holds only its own ``[cap_per_shard, n_params]`` segment (and residual
segment) on its device. Either way one code path indexes the owned rows
from ``row0``: restores write only owned slots, eviction gathers the
victims' rows from every rank (so every rank folds the same centroids),
growth regrows each owned segment in place on the device, and
`state_dict` gathers the whole pool.

All calls run on the MAIN thread: the executor gathers and scatters the
pool in place between `prepare` and the next round. Under a group every
rank makes the same calls in the same order (eviction and `state_dict`
are collectives).
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from repro_torch.launch import mesh as MESH

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
        <chunk steps read and write store.pool / store.ef_pool in place,
         at rows slots - store.row0 of the owned segments>
    """

    def __init__(self, n_clients: int, n_params: int,
                 init_row: torch.Tensor, *, capacity: int | None = None,
                 cohort: int = 1, device, ef_width: int = 0,
                 dtype: torch.dtype = torch.float32, n_shards: int = 1,
                 layout: MESH.DataGroup | None = None,
                 offload: str = "none", offload_dir=None,
                 n_tiers: int = DEFAULT_N_TIERS, volumes=None,
                 measure_restore_error: bool = False):
        if n_clients % max(n_shards, 1):
            raise ValueError(f"n_clients ({n_clients}) must divide over "
                             f"{n_shards} shards")
        if offload not in STATE_OFFLOADS:
            raise ValueError(f"unknown state_offload {offload!r}; want one "
                             f"of {STATE_OFFLOADS}")
        self.n_clients = int(n_clients)
        self.n_params = int(n_params)
        self.device = torch.device(device)
        self.ef_width = int(ef_width)
        self.dtype = dtype
        self.n_shards = max(int(n_shards), 1)
        # the shards whose rows this process holds: all of them in a world
        # of 1, its own one under a group of n_shards ranks
        self.layout = layout
        world = 1 if layout is None else layout.world
        if world == 1:
            self.seg_lo, self.n_owned = 0, self.n_shards
        elif world == self.n_shards:
            self.seg_lo, self.n_owned = layout.rank, 1
        else:
            raise ValueError(f"{self.n_shards} shards over a world of "
                             f"{world} ranks: want one rank per shard")
        self.rows_per_shard = self.n_clients // self.n_shards
        self.cohort_per_shard = max(-(-int(cohort) // self.n_shards), 1)
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
            self.cap_per_shard = min(-(-int(capacity) // self.n_shards),
                                     self.rows_per_shard)
            if self.cap_per_shard < self.cohort_per_shard:
                raise ValueError(
                    f"state_capacity={capacity} cannot hold the per-shard "
                    f"cohort ({self.cohort_per_shard} × {self.n_shards} "
                    "shards); the current round's participants are never "
                    "evicted")

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
        """Slots over every shard; the out-of-range pad slot."""
        return self.cap_per_shard * self.n_shards

    @property
    def row0(self) -> int:
        """The first slot of this process's pool tensor (its row 0)."""
        return self.seg_lo * self.cap_per_shard

    def _owned(self, slots: np.ndarray) -> np.ndarray:
        """Mask of the ``slots`` whose rows this process holds."""
        return ((slots >= self.row0)
                & (slots < self.row0 + self.n_owned * self.cap_per_shard))

    def _rows(self, slots) -> torch.Tensor:
        """Device row indices of owned ``slots`` in the pool tensor."""
        return MESH.to_device(torch.from_numpy(
            np.asarray(slots, np.int64) - self.row0), self.device)

    def _init_pool(self):
        cap, w = self.capacity, self.n_params
        rows = self.n_owned * self.cap_per_shard
        if self.dense:
            self.pool = self.init_row.to(self.dtype).expand(rows, w).clone()
            self.slot_of = np.arange(self.n_clients, dtype=np.int64)
            self.client_of = np.arange(cap, dtype=np.int64)
        else:
            self.pool = torch.zeros((rows, w), dtype=self.dtype,
                                    device=self.device)
            self.client_of = np.full(cap, -1, np.int64)
        self.ef_pool = torch.zeros((rows, self.ef_width),
                                   dtype=torch.float32, device=self.device)

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

    def _shard_of_client(self, clients):
        return clients // self.rows_per_shard

    def _free_slots(self, shard: int) -> np.ndarray:
        seg0 = shard * self.cap_per_shard
        seg = self.client_of[seg0:seg0 + self.cap_per_shard]
        return np.flatnonzero(seg < 0) + seg0

    def _staleness_tier(self, clients, t: int) -> np.ndarray:
        delta = np.maximum(t - self.last_used[clients], 1)
        return np.minimum(np.log2(delta).astype(np.int64),
                          self.n_tiers - 1).astype(np.int8)

    def _activate(self, missing: np.ndarray, protected: np.ndarray, t: int):
        shard = self._shard_of_client(missing)
        need = np.bincount(shard, minlength=self.n_shards)
        free = [self._free_slots(s) for s in range(self.n_shards)]
        short = need - np.array([len(f) for f in free])
        if self.growable and (short > 0).any():
            used = self.cap_per_shard - np.array([len(f) for f in free])
            self._grow(_pow2(int((used + need).max())))
            free = [self._free_slots(s) for s in range(self.n_shards)]
            short = need - np.array([len(f) for f in free])
        if (short > 0).any():
            self._evict(short, protected, t)
            free = [self._free_slots(s) for s in range(self.n_shards)]
        # missing is sorted ⇒ shard-major ⇒ aligned with the per-shard
        # ascending free slots: a deterministic assignment, the reference's
        slots = np.concatenate([
            free[s][:need[s]] for s in range(self.n_shards)])
        self._restore(missing, slots)

    def _grow(self, new_cap_per: int):
        """Grow every shard's segment to ``new_cap_per`` rows. Slots move
        (slot = shard · cap_per_shard + local): each owned segment is
        regrown in place on the device and the slot maps are remapped."""
        new_cap_per = min(new_cap_per, self.rows_per_shard)
        if new_cap_per <= self.cap_per_shard:
            return
        old_per, k = self.cap_per_shard, self.n_owned

        def regrow(dev):
            out = dev.new_zeros((k, new_cap_per, dev.shape[1]))
            out[:, :old_per] = dev.view(k, old_per, dev.shape[1])
            return out.view(k * new_cap_per, dev.shape[1])

        self.pool = regrow(self.pool)
        self.ef_pool = regrow(self.ef_pool)
        res = self.slot_of >= 0
        sh, loc = np.divmod(self.slot_of[res], old_per)
        self.slot_of[res] = sh * new_cap_per + loc
        self.client_of = np.full(self.n_shards * new_cap_per, -1, np.int64)
        self.client_of[self.slot_of[res]] = np.flatnonzero(res)
        self.cap_per_shard = new_cap_per
        self.n_grows += 1

    def _evict(self, short: np.ndarray, protected: np.ndarray, t: int):
        """Free ``short[s]`` slots in each shard s by folding the coldest
        resident non-participants onto their staleness-tier centroid."""
        prot = np.zeros(self.n_clients, bool)
        prot[protected] = True
        victims = []
        for s in np.flatnonzero(short > 0):
            seg0 = s * self.cap_per_shard
            seg = self.client_of[seg0:seg0 + self.cap_per_shard]
            cands = seg[(seg >= 0) & ~prot[np.maximum(seg, 0)]]
            if len(cands) < short[s]:
                raise RuntimeError(
                    f"shard {s}: need {short[s]} slots but only "
                    f"{len(cands)} evictable rows (capacity too small for "
                    "the cohort)")
            # coldest first: staleness tiers are monotone in last_used, so
            # an ascending last_used sort IS tier-major + LRU-within-tier;
            # client id breaks exact ties deterministically
            order = np.lexsort((cands, self.last_used[cands]))
            victims.append(cands[order[:short[s]]])
        victims = np.concatenate(victims)
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
        """f32 host copy of the rows at ``slots`` (a device gather of those
        rows only, never a copy of the whole pool). Under a group each rank
        gathers the rows it holds and the ranks exchange them (the
        reference's `fetch_global`), so every rank gets every row."""
        slots = np.asarray(slots, np.int64)
        if self.layout is None or self.layout.world == 1:
            return pool.index_select(0, self._rows(slots)).to(
                torch.float32).cpu().numpy()
        own = self._owned(slots)
        mine = torch.zeros((len(slots), pool.shape[1]), dtype=torch.float32,
                           device=self.device)
        sel = torch.from_numpy(np.flatnonzero(own)).to(self.device)
        mine.index_copy_(0, sel, pool.index_select(
            0, self._rows(slots[own])).to(torch.float32))
        per_rank = MESH.fetch_global(mine, self.layout)
        holder = slots // (self.n_owned * self.cap_per_shard)
        out = np.empty((len(slots), pool.shape[1]), np.float32)
        # the rows go to the host by design (a spill or a checkpoint): one
        # copy of each rank's part
        for r, got in enumerate(per_rank):
            at = np.flatnonzero(holder == r)
            if len(at):
                out[at] = got[torch.from_numpy(at).to(  # repro: noqa=REP006
                    got.device)].cpu().numpy()
        return out

    def _restore(self, clients: np.ndarray, slots: np.ndarray):
        """Materialize rows for newly resident clients: exact offloaded
        copy > staleness-tier centroid > initial-model row. Residual rows
        restart at zero unless the offloaded copy carries them. The host
        bookkeeping runs for every client; only owned slots are written."""
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
        own = self._owned(slots)
        fresh_i = [i for i in fresh_i if own[i]]
        if fresh_i:
            self.pool.index_copy_(0, self._rows(slots[fresh_i]),
                                  self.init_row.to(self.dtype).expand(
                                      len(fresh_i), self.n_params))
        kept = [j for j, i in enumerate(host_i) if own[i]]
        host_i = [host_i[j] for j in kept]
        host_rows = [host_rows[j] for j in kept]
        host_efs = [host_efs[j] for j in kept]
        if host_i:
            rows = MESH.to_device(torch.from_numpy(np.stack(host_rows)),
                                  self.device)
            self.pool.index_copy_(0, self._rows(slots[host_i]),
                                  rows.to(self.dtype))
        if self.ef_width and own.any():
            # a recycled slot holds its previous owner's residual
            self.ef_pool.index_fill_(0, self._rows(slots[own]), 0.0)
            off = [(i, e) for i, e in zip(host_i, host_efs) if e is not None]
            if off:
                self.ef_pool.index_copy_(
                    0, self._rows(slots[[i for i, _ in off]]),
                    MESH.to_device(torch.from_numpy(
                        np.stack([e for _, e in off])), self.device))
        self.slot_of[clients] = slots
        self.client_of[slots] = clients

    # -- checkpoint / introspection -----------------------------------------

    def _gather_pool(self, pool: torch.Tensor) -> np.ndarray:
        """The whole [capacity, width] pool as f32 numpy, every segment in
        slot order (gathered from every rank under a group)."""
        if pool.shape[1] == 0:
            return np.zeros((self.capacity, 0), np.float32)
        segs = MESH.fetch_global(pool.to(torch.float32), self.layout)
        return torch.cat([s.cpu() for s in segs]).numpy()

    def state_dict(self) -> dict:
        """Flat dict of numpy arrays for `CheckpointManager`, with the
        reference's keys. The pool is cast to f32 (bf16 → f32 is lossless;
        npz has no bf16 dtype) and gathered whole: under a group every rank
        must call it."""
        off_cids, off_rows = (self.offloader.export() if self.offloader
                              else (np.empty(0, np.int64),
                                    np.empty((0, self.n_params
                                              + self.ef_width),
                                             np.float32)))
        return {
            "pool": self._gather_pool(self.pool),
            "ef_pool": self._gather_pool(self.ef_pool),
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
        """Install a `state_dict`: the host maps whole, and of the pool
        only the rows of the owned segments, placed on this device."""
        cap_per = int(np.asarray(d["cap_per_shard"])[0])
        pool = np.asarray(d["pool"], np.float32)
        if pool.shape != (cap_per * self.n_shards, self.n_params):
            raise ValueError(f"pool shape {pool.shape} does not match "
                             f"capacity {cap_per} × {self.n_shards} shards")
        self.cap_per_shard = cap_per
        mine = slice(self.row0, self.row0 + self.n_owned * cap_per)
        self.pool = torch.from_numpy(np.ascontiguousarray(pool[mine])).to(
            self.device).to(self.dtype)
        self.ef_pool = torch.from_numpy(np.ascontiguousarray(
            np.asarray(d["ef_pool"], np.float32)[mine])).to(self.device)
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
