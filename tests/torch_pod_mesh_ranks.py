"""Rank bodies of tests/test_torch_pod_mesh.py: one world of 8 gloo ranks
on the CPU, as the ("pod", "data", "model") mesh (2, 2, 2), started by
`repro_torch.launch.mesh.spawn`.

Every rank runs every case and pickles what the tests check to
``<out>.<rank>.pkl``. Each rank has one intra-op thread and imports torch and
repro_torch only, never JAX. The ranks meet at a barrier before they take
the group down, so that no rank leaves while another still holds it.
"""
from __future__ import annotations

import dataclasses
import pickle
import time

import torch
import torch.distributed as dist

from repro_torch.launch import mesh as MESH

TIMEOUT_S = 120.0
SHAPE = (2, 2, 2)
NAMES = ("pod", "data", "model")


def _state_numpy(state, D) -> dict:
    return {f: (None if getattr(state, f) is None else D.tree_map(
        lambda a: a.detach().numpy().copy(), getattr(state, f)))
        for f in ("params", "prev_params", "ef")}


def _train_case(case: dict, mesh, D, M, TC) -> dict:
    """``case["steps"]`` pod-mesh steps from the reference's params on the
    given batches; the gathered state after them, and the losses."""
    cfg = dataclasses.replace(TC.get(case["arch"]).smoke(), **case["cfg"])
    dcfg = D.DistConfig(**case["dist"])
    params = M.from_reference(case["params"], cfg, device="cpu")
    state = D.init_state(params, dcfg, mesh, cfg)
    step = D.make_train_step(cfg, dcfg, mesh, device="cpu")
    losses = []
    for b in case["batches"]:
        state, m = step(state, {k: torch.from_numpy(v.copy())
                                for k, v in b.items()})
        losses.append(float(m["loss"]))
    whole = D.gather_state(state, cfg, dcfg, mesh)
    return {"losses": losses, "state": _state_numpy(whole, D),
            "local_shapes": [tuple(x.shape) for x in
                             D.tree_leaves(state.params)]}


def _moe_case(case: dict, mesh, MOE, SH, M, TC) -> dict:
    """The sharded ``moe_ffn`` at the config's own capacity factor on this
    rank's data shard of ``x``, with each rank's drop mask."""
    cfg = TC.get(case["arch"]).smoke()
    specs = M.param_specs(cfg, mesh)["moe_layers"]["ffn"]
    p = {}
    for k, v in case["p"].items():
        if isinstance(v, dict):
            p[k] = {kk: SH.shard_leaf(torch.from_numpy(vv),
                                      specs[k][kk][1:], mesh).contiguous()
                    for kk, vv in v.items()}
        else:
            p[k] = SH.shard_leaf(torch.from_numpy(v), specs[k][1:],
                                 mesh).contiguous()
    x = torch.from_numpy(case["x"])
    n_dp = mesh.axis_size("data")
    r = x.shape[0] // n_dp
    xd = x[mesh.axis_index("data") * r:(mesh.axis_index("data") + 1) * r]
    MOE.record_routes = []
    y = MOE.moe_ffn(xd, p, cfg, mesh)
    (ids, drops), = MOE.record_routes
    MOE.record_routes = None
    # a token is dropped when any model rank dropped one of its experts
    drops = mesh.max_axis(drops.to(torch.int32), "model").bool()
    return {"y": y.numpy(), "ids": ids.numpy(), "drops": drops.numpy(),
            "coords": mesh.coords}


def _compression_case(case: dict, mesh, C, SH, KT) -> dict:
    """A leaf split by each of ``case["specs"]``: the shards' histogram,
    thresholds, compress outputs, top-k and payload bits against the whole
    leaf's (every rank holds the whole leaf too)."""
    out = []
    for spec in case["specs"]:
        whole = torch.from_numpy(case["x"])
        shard = SH.shard_leaf(whole, spec, mesh).contiguous()
        group = mesh.group(SH.spec_axes(spec))
        row, wrow = C._leaf_row(shard), C._leaf_row(whole)
        max_abs = group.max(torch.linalg.vector_norm(row, float("inf"),
                                                     dim=-1))
        hist = group.sum(KT.magnitude_histogram(row, max_abs).to(torch.int64))
        cdf_w, max_w = C.fused_histogram_cdf(wrow)
        res = {"spec": spec, "max": (max_abs.numpy(), max_w.numpy()),
               "cdf": (torch.cumsum(hist, -1).to(torch.float32).numpy(),
                       cdf_w.numpy()), "thr": [], "compress": [], "topk": []}
        for ratio in case["ratios"]:
            rr = C._ratio_row(ratio, "cpu")
            thr = C._group_threshold(row, rr, group)
            thr_w = C.fused_threshold(wrow, rr)
            res["thr"].append((thr.numpy(), thr_w.numpy()))
            kept, sign, count, sum_abs, cmax = C.fused_compress(row, thr)
            kw, sw, cw, saw, mw = C.fused_compress(wrow, thr_w)
            res["compress"].append({
                "kept": (kept.reshape(shard.shape).numpy(),
                         SH.shard_leaf(kw.reshape(whole.shape), spec,
                                       mesh).numpy()),
                "sign": (sign.reshape(shard.shape).numpy(),
                         SH.shard_leaf(sw.reshape(whole.shape), spec,
                                       mesh).numpy()),
                "count": (group.sum(count.to(torch.int64)).numpy(),
                          cw.numpy()),
                "sum_abs": (group.sum(sum_abs).numpy(), saw.numpy()),
                "max": (group.max(cmax).numpy(), mw.numpy())})
            sp, bits = C.fused_topk(shard, ratio, group)
            spw, bw = C.fused_topk(whole, ratio)
            res["topk"].append({
                "sparse": (sp.numpy(), SH.shard_leaf(spw, spec,
                                                     mesh).numpy()),
                "bits": (bits.numpy(), bw.numpy())})
            _, hbits = C.fused_hybrid_roundtrip(shard, shard * 0.5, ratio,
                                                group)
            _, hbw = C.fused_hybrid_roundtrip(whole, whole * 0.5, ratio)
            res["compress"][-1]["bits"] = (hbits.numpy(), hbw.numpy())
        out.append(res)
    return out


def _resume_case(case: dict, mesh, train, D) -> dict:
    """`train.run` on the mesh: straight, then cut at ``cut`` steps and
    resumed through its checkpoint."""
    import repro_torch.configs as TC
    cfg = dataclasses.replace(TC.get("qwen1p5_4b").smoke(), **case["cfg"])
    base = ["--device", "cpu", "--batch", "8", "--seq", "16",
            "--error-feedback", "--ckpt-every", str(case["cut"])]
    quiet = (lambda s: None)

    def go(extra):
        return train.run(train.parser().parse_args(base + extra), log=quiet,
                         cfg=cfg, mesh=mesh)

    straight = go(["--steps", str(case["steps"])])
    ck = ["--ckpt-dir", case["dir"]]
    go(ck + ["--steps", str(case["cut"])])
    resumed = go(ck + ["--steps", str(case["steps"])])
    same = all(torch.equal(a, b) for f in ("params", "prev_params", "ef")
               for a, b in zip(D.tree_leaves(getattr(resumed["state"], f)),
                               D.tree_leaves(getattr(straight["state"], f))))
    return {"start": resumed["start"], "losses": (straight["losses"],
                                                  resumed["losses"]),
            "same_state": same}


def pod_mesh_rank(rank: int, world: int, store: str, out: str,
                  cases: str) -> None:
    """Every case of the pickle ``cases`` (read from a file: large
    arguments make the spawned ranks start slowly)."""
    torch.set_num_threads(1)
    with open(cases, "rb") as f:
        cases = pickle.load(f)
    MESH.init_distributed(f"file://{store}", world, rank, backend="gloo",
                          timeout_s=TIMEOUT_S)
    import repro_torch.configs as TC
    import repro_torch.kernels.topk_threshold as KT
    from repro_torch.core import compression as C
    from repro_torch.fl import distributed as D
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    mesh = MESH.make_mesh(SHAPE, NAMES, "cpu")
    res = {"coords": mesh.coords, "seconds": {}}
    for name, case in cases.items():
        t0 = time.perf_counter()
        if case["kind"] == "train":
            res[name] = _train_case(case, mesh, D, M, TC)
        elif case["kind"] == "moe":
            res[name] = _moe_case(case, mesh, MOE, SH, M, TC)
        elif case["kind"] == "compression":
            res[name] = _compression_case(case, mesh, C, SH, KT)
        elif case["kind"] == "resume":
            res[name] = _resume_case(case, mesh, train, D)
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

