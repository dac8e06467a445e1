"""Rank bodies of tests/test_torch_dryrun.py: one world of 4 gloo ranks on
the CPU, the ("pod", "data", "model") mesh (2, 2, 1), started by
`repro_torch.launch.mesh.spawn`.

Each rank takes one Track-B step of the smoke Qwen1.5-4B config and
records, in order, every collective its mesh runs during the step: the
all-gathers of `Mesh._gather`, the all-to-alls of `Mesh._exchange` (a
sum's first phase) and the MAX all-reduces of `Mesh.max_axis`, each with
its group size and the bytes of the rank's operand
(`launch.mesh.CollectiveCensus`'s terms), and the bytes of the
state it holds. Imports torch and repro_torch only, never JAX.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch import mesh as MESH

TIMEOUT_S = 60.0
SHAPE = (2, 2, 1)
NAMES = ("pod", "data", "model")
BATCH, SEQ = 8, 32


def count_collectives(calls: list):
    """Wrap `Mesh._gather`, `Mesh._exchange` and `Mesh.max_axis`
    (class-wide) so that every collective run appends (op, group size,
    operand bytes) to ``calls``; returns the undo."""
    gather, exchange, mx = (MESH.Mesh._gather, MESH.Mesh._exchange,
                            MESH.Mesh.max_axis)

    def _gather(self, x, live):
        calls.append(("all-gather", self.size_over(live),
                      x.numel() * x.element_size()))
        return gather(self, x, live)

    def _exchange(self, x, live):
        calls.append(("all-to-all", self.size_over(live),
                      x.numel() * x.element_size()))
        return exchange(self, x, live)

    def max_axis(self, x, axes):
        live = self.live_axes(axes)
        if live:
            calls.append(("all-reduce", self.size_over(live),
                          x.numel() * x.element_size()))
        return mx(self, x, axes)

    MESH.Mesh._gather, MESH.Mesh._exchange, MESH.Mesh.max_axis = (
        _gather, _exchange, max_axis)

    def undo():
        MESH.Mesh._gather, MESH.Mesh._exchange, MESH.Mesh.max_axis = (
            gather, exchange, mx)
    return undo


def census_rank(rank: int, world: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    MESH.init_distributed(f"file://{store}", world, rank, backend="gloo",
                          timeout_s=TIMEOUT_S)
    import repro_torch.configs as TC
    from repro_torch.fl import distributed as D
    from repro_torch.models import model as M
    cfg = TC.get("qwen1p5_4b").smoke()
    dcfg = D.DistConfig(use_error_feedback=True)
    mesh = MESH.make_mesh(SHAPE, NAMES, "cpu")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = D.init_state(params, dcfg, mesh, cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (BATCH, SEQ)).astype(np.int32))
    step = D.make_train_step(cfg, dcfg, mesh, "cpu")
    calls: list = []
    undo = count_collectives(calls)
    try:
        state, _ = step(state, {"tokens": toks, "labels": toks.clone()})
    finally:
        undo()
    held = {f: sum(x.numel() * x.element_size() for x in D.tree_leaves(v))
            for f, v in (("params", state.params),
                         ("prev_params", state.prev_params),
                         ("ef", state.ef))}
    with open(f"{out}.{rank}.pkl", "wb") as f:
        pickle.dump({"calls": calls, "held": held, "coords": mesh.coords},
                    f)
    dist.barrier()
    dist.destroy_process_group()
