"""Rank bodies of tests/test_torch_tensor_parallel.py, started by
`repro_torch.launch.mesh.spawn` on gloo ranks on the CPU.

* `sum_rank` (4 ranks, the ("data", "model") mesh (2, 2)): `Mesh.sum_axis`
  and the all-gather fold it replaced (`old_fold`) on every rank's seeded
  tensor, for each dtype, shape and axis order of ``SUM_CASES``; then, on
  the mesh (1, 4), `sharding.regroup_model` of each rank's contiguous
  block of a leaf of ``groups`` segments (``REGROUP_GROUPS``) and the
  gradient it sends back (`regroup_case`).
* `tp_rank` (2 ranks, the mesh (1, 2)): per case, the loss and the
  gathered per-leaf gradients of `models.model.loss_fn` on this rank's
  shards, and, for the decoding cases, the logits of a few
  `decode_step`s and of `prefill` on a cache laid out by
  `launch.specs.cache_specs`.

Every rank pickles what the tests check to ``<out>.<rank>.pkl``. Each rank
has one intra-op thread and imports torch and repro_torch only, never
JAX; the ranks meet at a barrier before they take the group down.
"""
from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch import mesh as MESH

TIMEOUT_S = 60.0
SUM_SHAPE, SUM_NAMES = (2, 2), ("data", "model")
SUM_CASES = [(dt, shape, axes)
             for dt in ("float32", "bfloat16")
             for shape in ((), (3,), (5, 7), (1000,))
             for axes in (("model",), ("data", "model"), ("model", "data"))]
TP_SHAPE, TP_NAMES = (1, 2), ("data", "model")
REGROUP_GROUPS = (2, 3)
REGROUP_ROWS, REGROUP_PIECE = 5, 3


def sum_input(rank: int, dtype: str, shape: tuple) -> torch.Tensor:
    """Rank ``rank``'s seeded operand: wide-ranging f32 values (so that
    the order of a sum shows in its bits), cast to ``dtype``."""
    rng = np.random.default_rng(1000 + rank)
    x = rng.standard_normal(shape).astype(np.float32) * np.exp(
        3 * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(np.asarray(x)).to(getattr(torch, dtype))


def old_fold(mesh, x: torch.Tensor, axes) -> torch.Tensor:
    """The sum `Mesh.sum_axis` ran before: every rank's whole ``x``
    gathered, folded left in rank order (row-major over ``axes``)."""
    parts = mesh._parts(x, axes)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def regroup_case(rank: int, world: int, groups: int, regroup=None) -> dict:
    """A [rows, groups·world·q] leaf W and an upstream gradient U (seeded
    integers, exact in f32): this rank's contiguous block of W through
    ``regroup`` (`sharding.regroup_model` on a mesh of ``world`` "model"
    ranks) and back with U's block of every segment as the gradient of
    its output; the output and the block's gradient, and what they must
    be (rank r's q columns of each segment; U's contiguous block)."""
    q, seg = REGROUP_PIECE, REGROUP_PIECE * world
    rng = np.random.default_rng(7 + groups)
    w, u = (torch.from_numpy(rng.integers(-50, 50, (
        REGROUP_ROWS, groups * seg)).astype(np.float32)) for _ in range(2))
    blk = groups * q

    def mine(t):
        return torch.cat([t[:, g * seg + rank * q:g * seg + (rank + 1) * q]
                          for g in range(groups)], dim=1)

    out = {"want": mine(w), "want_grad": u[:, rank * blk:(rank + 1) * blk]}
    if regroup is not None:
        local = w[:, rank * blk:(rank + 1) * blk].clone().requires_grad_(
            True)
        got = regroup(local)
        (got * mine(u)).sum().backward()
        out.update(got=got.detach(), grad=local.grad)
    return out


def _setup(rank, world, store):
    torch.set_num_threads(1)
    MESH.init_distributed(f"file://{store}", world, rank, backend="gloo",
                          timeout_s=TIMEOUT_S)


def _finish(out, rank, res) -> None:
    with open(f"{out}.{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def sum_rank(rank: int, world: int, store: str, out: str) -> None:
    _setup(rank, world, store)
    mesh = MESH.make_mesh(SUM_SHAPE, SUM_NAMES, "cpu")
    res = {"coords": mesh.coords, "sums": []}
    for dt, shape, axes in SUM_CASES:
        x = sum_input(rank, dt, shape)
        res["sums"].append((mesh.sum_axis(x, axes), old_fold(mesh, x, axes)))
    from repro_torch.launch import sharding as SH
    row = MESH.make_mesh((1, world), SUM_NAMES, "cpu")
    res["regroup"] = [regroup_case(rank, world, g, lambda t, g=g: (
        SH.regroup_model(t, g, row))) for g in REGROUP_GROUPS]
    _finish(out, rank, res)


def _grads(cfg, params, batch, mesh, M, SH, D):
    """(loss, {path: whole gradient}) of `loss_fn` on this rank's shards
    (every rank's rows: the mesh has one data rank)."""
    specs = M.param_specs(cfg, mesh)
    local = SH.shard_tree(params, specs, mesh)
    leaves = D.tree_leaves(local)
    for x in leaves:
        x.requires_grad_(True)
    loss = M.loss_fn(local, batch, cfg, "cpu", mesh)
    it = iter(torch.autograd.grad(loss, leaves))
    whole = SH.gather_tree(D.tree_map(lambda _a: next(it), local), specs,
                           mesh)
    return float(loss), {"/".join(p): g.numpy().copy() for p, g in zip(
        D._leaf_paths(whole), D.tree_leaves(whole))}


def _serve(cfg, params, case, mesh, M, SH, SP):
    """Logits of ``case["steps"]`` decode steps (a cache of ``case["seq"]``
    positions laid out by `cache_specs`, fed ``case["tokens"]``) and of
    `prefill` on the same tokens."""
    specs = M.param_specs(cfg, mesh)
    local = SH.shard_tree(params, specs, mesh)
    tokens = torch.from_numpy(case["tokens"])
    b = tokens.shape[0]
    cache = SP.init_sharded_cache(cfg, mesh, b, case["seq"], "cpu")
    length = torch.zeros(b, dtype=torch.int32)
    logits = []
    with torch.no_grad():
        for i in range(tokens.shape[1]):
            lg, cache = M.decode_step(local, cache, {"tokens": tokens[:, i:i
                                                                      + 1]},
                                      length, cfg, "cpu", mesh)
            logits.append(lg.numpy().copy())
            length = length + 1
        pre = M.prefill(local, {"tokens": tokens}, cfg, "cpu", mesh)
    return np.stack(logits), pre.numpy().copy()


def tp_rank(rank: int, world: int, store: str, out: str, cases: list
            ) -> None:
    _setup(rank, world, store)
    import repro_torch.configs as TC
    from repro_torch.fl import distributed as D
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import specs as SP
    from repro_torch.models import model as M
    mesh = MESH.make_mesh(TP_SHAPE, TP_NAMES, "cpu")
    res = {"coords": mesh.coords}
    for case in cases:
        cfg = dataclasses.replace(TC.get(case["arch"]).smoke(),
                                  **case["cfg"])
        params = M.from_reference(case["params"], cfg, "cpu")
        batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
        got = {"grads": _grads(cfg, params, batch, mesh, M, SH, D)}
        if "tokens" in case:
            got["serve"] = _serve(cfg, params, case, mesh, M, SH, SP)
        res[case["name"]] = got
    _finish(out, rank, res)
