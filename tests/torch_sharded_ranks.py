"""Rank bodies of the sharded port's CPU tests (tests/test_torch_mesh.py and
tests/test_torch_sharded.py), started by `repro_torch.launch.mesh.spawn`.

Each rank brings up a gloo group through a file store (no ports, so
parallel test workers never collide) with one intra-op thread, does its
part, pickles what the test checks to ``<out>.<rank>.pkl`` and takes the
group down. This module imports torch and repro_torch only, never JAX, so a
rank starts in about a second.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch import mesh as MESH

TIMEOUT_S = 60.0


def _init(rank: int, world: int, store: str) -> bool:
    torch.set_num_threads(1)
    return MESH.init_distributed(f"file://{store}", world, rank,
                                 backend="gloo", timeout_s=TIMEOUT_S)


def _dump(out: str, rank: int, obj) -> None:
    with open(f"{out}.{rank}.pkl", "wb") as f:
        pickle.dump(obj, f)


def load(out: str, world: int) -> list:
    """Every rank's pickled results, in rank order."""
    res = []
    for r in range(world):
        with open(f"{out}.{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


def mesh_rank(rank: int, world: int, store: str, out: str) -> None:
    """init_distributed's explicit path, its idempotence, the layout, and
    the two collectives on rank-dependent f32 vectors."""
    first = _init(rank, world, store)
    again = MESH.init_distributed()
    layout = MESH.make_data_group("cpu")
    gen = torch.Generator().manual_seed(100 + rank)
    x = torch.randn(1000, generator=gen) * 10.0 ** rank
    _dump(out, rank, {
        "first": first, "again": again, "rank": layout.rank,
        "world": layout.world, "device": str(layout.device), "x": x,
        "gathered": [g.clone() for g in MESH.fetch_global(x, layout)],
        "sum": MESH.fixed_order_sum(x, layout)})
    dist.destroy_process_group()


def env_rank(rank: int, world: int, port: int, out: str) -> None:
    """init_distributed from the torchrun environment, no arguments."""
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    up = MESH.init_distributed(backend="gloo", timeout_s=TIMEOUT_S)
    layout = MESH.make_data_group("cpu")
    total = MESH.fixed_order_sum(torch.full((3,), float(rank + 1)), layout)
    _dump(out, rank, {"up": up, "rank": layout.rank, "world": layout.world,
                      "sum": total})
    dist.destroy_process_group()


def store_rank(rank: int, world: int, store: str, out: str, kw: dict,
               seq: list, n_params: int) -> None:
    """A two-shard ClientStateStore holding only this rank's segment, fed
    the same prepare/write sequence as tests/test_torch_state_store.py's
    `_write`: maps, counters, the owned segment and the gathered
    state_dict after every round."""
    from repro_torch.fl import state as TS
    _init(rank, world, store)
    layout = MESH.make_data_group("cpu")
    st = TS.ClientStateStore(16, n_params,
                             torch.arange(n_params, dtype=torch.float32),
                             device="cpu", n_shards=world, layout=layout,
                             **kw)
    rounds = []
    for t, parts in enumerate(seq, 1):
        slots = st.prepare(np.asarray(parts), t)
        rows = (np.asarray(parts, np.float32)[:, None] * 100.0 + t
                + np.arange(n_params, dtype=np.float32)[None, :])
        own = st._owned(slots.astype(np.int64))
        idx = torch.from_numpy(slots[own].astype(np.int64) - st.row0)
        st.pool.index_copy_(0, idx, torch.from_numpy(rows[own]))
        st.ef_pool.index_copy_(0, idx, torch.from_numpy(
            -rows[own][:, :st.ef_width]))
        rounds.append({"slots": slots, "state": st.state_dict(),
                       "pool_rows": st.pool.shape[0], "row0": st.row0})
    _dump(out, rank, rounds)
    dist.destroy_process_group()


def _history(h) -> dict:
    return {k: list(getattr(h, k)) for k in (
        "rounds", "sim_time", "traffic_bits", "accuracy", "waiting",
        "waiting_per_round", "wire_bits")}


def _sim(cfg, init, state):
    from repro_torch.fl.simulation import Simulator
    sim = Simulator(cfg, init_flat=init)
    for k, v in (state or {}).items():
        setattr(sim.planner.caesar_state, k, torch.from_numpy(v))
    return sim


def sim_rank(rank: int, world: int, store: str, out: str, cases: dict,
             refusals: dict, resume: tuple) -> None:
    """Each case ``name: (SimConfig, init_flat, planner state)`` run
    sharded on this rank — the planner state, where given, a dict of
    ``caesar_state`` fields (numpy) installed before the run; then the
    case ``resume = (name, cut)`` run to round ``cut``, its state_dict
    loaded into a fresh simulator and run on from ``cut + 1``; then each
    refusal ``name: SimConfig`` built and its exception or warning
    recorded."""
    from repro_torch.fl.simulation import Simulator
    _init(rank, world, store)
    res = {}
    for name, (cfg, init, state) in cases.items():
        sim = _sim(cfg, init, state)
        hist = sim.run()
        res[name] = {
            "history": _history(hist), "round_log": sim.round_log,
            "global": sim.global_flat.numpy().copy(),
            "pool_shape": tuple(sim.store.pool.shape),
            "pool_dtype": str(sim.store.pool.dtype),
            "ef_shape": tuple(sim.store.ef_pool.shape),
            "cap_per_shard": sim.store.cap_per_shard,
            "row0": sim.store.row0, "n_dev": sim.n_dev,
            "p_shard": sim.executor.p_shard, "chunk": sim.executor.chunk,
            "launches": sim.executor.kernel_launches(),
            "evictions": sim.store.n_evictions,
            "restores": sim.store.telemetry()["restores"],
            "state_pool": sim.state_dict()["store"]["pool"]}
    name, cut = resume
    cfg, init, state = cases[name]
    first = _sim(dataclasses.replace(cfg, rounds=cut), init, state)
    first.run()
    again = Simulator(cfg, init_flat=init)
    again.load_state_dict(first.state_dict())
    hist = again.run(start_round=cut + 1)
    res["resume"] = {"global": again.global_flat.numpy().copy(),
                     "history": _history(hist),
                     "pool_shape": tuple(again.store.pool.shape)}
    for name, cfg in refusals.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                Simulator(cfg)
                got = None
            except Exception as e:    # the refusal under test
                got = (type(e).__name__, str(e))
        res[name] = {"raised": got, "warnings": [
            str(w.message) for w in caught
            if issubclass(w.category, UserWarning)]}
    _dump(out, rank, res)
    dist.destroy_process_group()


def build_rank(rank: int, out_dir: str, cuda_home: str) -> None:
    """`build.build` of one kernel into ``out_dir`` with the compiler at
    ``cuda_home/bin/nvcc`` (a stand-in that logs each call)."""
    from pathlib import Path

    from repro_torch.kernels import build
    os.environ["CUDA_HOME"] = cuda_home
    build.build_dir = lambda: Path(out_dir)
    build.build(["recover"])
