"""Client-state store: the participation-keyed pool of client-local model
rows — the port of ``repro.fl.state.ClientStateStore`` in its two exact
modes.

The paper's stale-local-model semantics (§4.1) need one [n_params] row per
client, but only clients that have EVER participated hold anything besides
the initial model. The pool is a device tensor ``[capacity, n_params]``
(f32) with host slot maps:

* ``slot_of [n_clients]`` (−1 = not resident), ``client_of [capacity]``
  (−1 = free), ``last_used [n_clients]`` (round of last participation).

Capacity policies (``SimConfig.state_capacity``):

* ``None`` (default) — grow on demand: start at the smallest power of two
  ≥ 4 × cohort (at most n_clients) and double until every
  ever-participated client fits; nothing is evicted, so trajectories are
  identical to a dense buffer.
* ``0`` — dense: capacity = n_clients, ``slot_of`` = identity, every row
  pre-materialized.

Capped pools with staleness-tiered eviction, host/memmap offload and
checkpointing are not ported yet (they raise). All calls run on the MAIN
thread: the executor gathers and scatters the pool in place
(``index_copy_``) between `prepare` and the next round.
"""
from __future__ import annotations

import numpy as np
import torch

GROW_COHORT_FACTOR = 4


def _pow2(n: int) -> int:
    """Smallest power of two ≥ n (n ≥ 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


class ClientStateStore:
    def __init__(self, n_clients: int, n_params: int,
                 init_row: torch.Tensor, *, capacity: int | None = None,
                 cohort: int = 1, device, ef_width: int = 0,
                 dtype: torch.dtype = torch.float32):
        if capacity not in (None, 0):
            raise NotImplementedError(
                "state_capacity > 0 (capped pool with staleness-tiered "
                "eviction) is not ported yet: ROADMAP queue 1 item 10")
        self.n_clients = int(n_clients)
        self.n_params = int(n_params)
        self.device = torch.device(device)
        self.ef_width = int(ef_width)
        self.dtype = dtype
        # the initial model AT the storage dtype (round to nearest even, as
        # the reference pre-quantizes it), so activation writes are exact
        self.init_row = (init_row.to(self.device, torch.float32).reshape(-1)
                         .to(dtype).to(torch.float32))
        if self.init_row.shape != (self.n_params,):
            raise ValueError("init_row must be [n_params]")
        self.dense = capacity == 0
        self.growable = capacity is None
        self.cohort = max(int(cohort), 1)
        self.n_grows = 0
        self.n_restore_fresh = 0
        self.last_used = np.zeros(self.n_clients, np.int64)
        if self.dense:
            self._capacity = self.n_clients
            self.pool = self.init_row.to(dtype).expand(
                self.n_clients, self.n_params).clone()
            self.slot_of = np.arange(self.n_clients, dtype=np.int64)
            self.client_of = np.arange(self.n_clients, dtype=np.int64)
        else:
            self._capacity = min(self.n_clients,
                                 _pow2(GROW_COHORT_FACTOR * self.cohort))
            self.pool = torch.zeros((self._capacity, self.n_params),
                                    dtype=dtype, device=self.device)
            self.slot_of = np.full(self.n_clients, -1, np.int64)
            self.client_of = np.full(self._capacity, -1, np.int64)
        self.ef_pool = torch.zeros((self._capacity, self.ef_width),
                                   dtype=torch.float32, device=self.device)

    @property
    def capacity(self) -> int:
        return self._capacity

    def prepare(self, parts: np.ndarray, t: int) -> np.ndarray:
        """Make every client in ``parts`` resident; returns their pool
        slots [P] int32 in parts order."""
        parts = np.asarray(parts, np.int64)
        if not self.dense:
            missing = parts[self.slot_of[parts] < 0]
            if missing.size:
                self._activate(np.unique(missing))
        self.last_used[parts] = t
        return self.slot_of[parts].astype(np.int32)

    def _activate(self, missing: np.ndarray):
        free = np.flatnonzero(self.client_of < 0)
        if len(free) < len(missing):
            used = self._capacity - len(free)
            self._grow(_pow2(used + len(missing)))
            free = np.flatnonzero(self.client_of < 0)
        # missing is sorted, free slots ascending: a deterministic
        # assignment, the reference's
        slots = free[:len(missing)]
        self._restore(missing, slots)

    def _grow(self, new_cap: int):
        new_cap = min(new_cap, self.n_clients)
        if new_cap <= self._capacity:
            return
        extra = torch.zeros((new_cap - self._capacity, self.n_params),
                            dtype=self.pool.dtype, device=self.device)
        self.pool = torch.cat([self.pool, extra])
        self.ef_pool = torch.cat([self.ef_pool, torch.zeros(
            (new_cap - self._capacity, self.ef_width), dtype=torch.float32,
            device=self.device)])
        grown = np.full(new_cap, -1, np.int64)
        grown[:self._capacity] = self.client_of
        self.client_of = grown
        self._capacity = new_cap
        self.n_grows += 1

    def _restore(self, clients: np.ndarray, slots: np.ndarray):
        """First-time residents start from the initial-model row (their
        residual row is still the zero it was made with: without eviction
        no slot is reused)."""
        idx = torch.from_numpy(slots.astype(np.int64)).to(self.device)
        rows = self.init_row.to(self.dtype).expand(len(slots), self.n_params)
        self.pool.index_copy_(0, idx, rows)
        self.n_restore_fresh += len(clients)
        self.slot_of[clients] = slots
        self.client_of[slots] = clients

    def telemetry(self) -> dict:
        itemsize = self.pool.element_size()
        return {
            "capacity": self.capacity,
            "resident": int((self.slot_of >= 0).sum()),
            "ever_active": int((self.last_used > 0).sum()),
            "registered": self.n_clients,
            "grows": self.n_grows,
            "restores": {"fresh": self.n_restore_fresh},
            "pool_mb": self.capacity * (self.n_params * itemsize
                                        + self.ef_width * 4) / 2**20,
            "dense_mb": self.n_clients * (self.n_params * itemsize
                                          + self.ef_width * 4) / 2**20,
        }
