"""Rank bodies of tests/test_torch_serve_mesh.py: one world of 4 gloo ranks
on the CPU, as the ("data", "model") mesh (2, 2), started by
`repro_torch.launch.mesh.spawn`.

Every rank runs every case: it keeps its shards of the case's parameters
(`param_specs`) and of its cache (`launch.specs.shard_cache`), feeds its
rows of the tokens through ``make_serve_step`` for the case's steps and its
rows of the prompt through ``make_prefill``, gathers the cache, and pickles
what the tests check to ``<out>.<rank>.pkl``. Each rank has one intra-op
thread and imports torch and repro_torch only, never JAX. The ranks meet at
a barrier before they take the group down.
"""
from __future__ import annotations

import pickle
import time

import torch
import torch.distributed as dist

from repro_torch.launch import mesh as MESH

TIMEOUT_S = 120.0
SHAPE = (2, 2)
NAMES = ("data", "model")


def rows(n_rows: int, mesh) -> slice:
    """This rank's rows of a batch of ``n_rows``: its block over "data"
    when that divides the batch, else every row."""
    n_dp = mesh.axis_size("data")
    if n_rows % n_dp:
        return slice(0, n_rows)
    r = n_rows // n_dp
    return slice(mesh.axis_index("data") * r, (mesh.axis_index("data") + 1)
                 * r)


def _case(case: dict, mesh, D, M, SP, SH, TC) -> dict:
    cfg = TC.get(case["arch"]).smoke()
    params = SH.shard_tree(M.from_reference(case["params"], cfg, "cpu"),
                           M.param_specs(cfg, mesh), mesh)
    mine = rows(case["batch"], mesh)
    out = {"coords": mesh.coords, "rows": (mine.start, mine.stop)}
    with torch.no_grad():
        if "cache" in case:
            b, s = case["batch"], case["seq"]
            whole = D.tree_map(lambda a: torch.from_numpy(a.copy()),
                               case["cache"])
            cache = SP.shard_cache(whole, cfg, mesh, b, s)
            out["local_cache_shapes"] = {
                "/".join(p): tuple(x.shape) for p, x in zip(
                    D._leaf_paths(cache), D.tree_leaves(cache))}
            zeros = SP.init_sharded_cache(cfg, mesh, b, s, "cpu")
            out["zeros_like_shards"] = zeros.specs == cache.specs and all(
                z.shape == x.shape and z.dtype == x.dtype and not z.any()
                for z, x in zip(D.tree_leaves(zeros), D.tree_leaves(cache)))
            step = D.make_serve_step(cfg, mesh, "cpu")
            length = torch.from_numpy(case["length"].copy())[mine]
            logits = []
            for tok in case["tokens"]:
                lg, cache = step(params, cache,
                                 torch.from_numpy(tok.copy())[mine], length)
                logits.append(lg.numpy().copy())
                length = length + 1
            out["logits"] = logits
            out["cache"] = D.tree_map(lambda a: a.numpy().copy(),
                                      SP.gather_cache(cache, mesh))
        prompt = {k: torch.from_numpy(v.copy())[mine]
                  for k, v in case["prompt"].items()}
        out["prefill"] = D.make_prefill(cfg, mesh, "cpu")(
            params, prompt).numpy().copy()
    return out


def serve_mesh_rank(rank: int, world: int, store: str, out: str,
                    cases: str) -> None:
    """Every case of the pickle ``cases`` (read from a file: large
    arguments make the spawned ranks start slowly)."""
    torch.set_num_threads(1)
    with open(cases, "rb") as f:
        cases = pickle.load(f)
    MESH.init_distributed(f"file://{store}", world, rank, backend="gloo",
                          timeout_s=TIMEOUT_S)
    import repro_torch.configs as TC
    from repro_torch.fl import distributed as D
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import specs as SP
    from repro_torch.models import model as M
    mesh = MESH.make_mesh(SHAPE, NAMES, "cpu")
    res = {"coords": mesh.coords, "seconds": {}}
    for name, case in cases.items():
        t0 = time.perf_counter()
        res[name] = _case(case, mesh, D, M, SP, SH, TC)
        res["seconds"][name] = time.perf_counter() - t0
    with open(f"{out}.{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def load(out: str, world: int) -> list:
    res = []
    for r in range(world):
        with open(f"{out}.{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res
