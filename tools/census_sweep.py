#!/usr/bin/env python3
"""The census of every production cell (`repro_torch.launch.dryrun`, rank 0,
default variant) on (16, 16) and (2, 16, 16), with the bytes a rank
receives per set of mesh axes and the leaves gathered over "model".

    python3 tools/census_sweep.py --out census.json [--src DIR] [--jobs 4]
        [--arch ID ...]

``--src`` is the ``src`` directory whose ``repro_torch`` is counted (this
checkout's by default; another commit unpacked with ``git archive`` to
compare two trees); ``--arch`` keeps only the named archs' cells. Per
cell: status (and the reference's ``why`` for a
skipped one), peak bytes, flops, the bytes received in one step in all
and per set of live axes (summed from the mesh's `CollectiveCensus`
calls, which every tree records with their axes), and each whole-leaf
gather over "model" (`launch.sharding.gather_leaf` with "model" in the
spec: a leaf used whole by every model rank) with its shape and bytes.
Runs on the CPU only, ``--jobs`` cells at a time (one intra-op thread
each); the slowest cells, the 32k prefills and 4k train steps, take a few
minutes each.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _init(src: str) -> None:
    sys.path.insert(0, src)
    import torch
    torch.set_num_threads(1)


def _cell(arch: str, shape: str, multi_pod: bool) -> dict:
    import repro_torch.configs as configs
    from repro_torch.fl import distributed as D
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import specs as S
    cfg = configs.get(arch)
    name, mshape, names = DR.PRODUCTION[multi_pod]
    rec = {"arch": cfg.name, "shape": shape, "mesh": name}
    ok, why = S.cell_supported(cfg, shape)
    if not ok:
        return dict(rec, status="skipped", why=why)
    gathered = []
    orig = SH.gather_leaf

    def gather_leaf(local, spec, mesh):
        if "model" in SH.spec_axes(spec):
            out = orig(local, spec, mesh)
            gathered.append({"shape": list(out.shape),
                             "bytes": out.numel() * out.element_size()})
            return out
        return orig(local, spec, mesh)

    SH.gather_leaf = gather_leaf
    t0 = time.perf_counter()
    try:
        mesh = MESH.census_mesh(mshape, names, 0)
        out = DR.census(cfg, shape, mesh, D.DistConfig())
    except Exception as e:  # noqa: BLE001 — record it, keep sweeping
        return dict(rec, status="error", error=f"{type(e).__name__}: {e}")
    finally:
        SH.gather_leaf = orig
    by_axes: dict = {}
    for c in mesh.census.calls:
        key = "+".join(c["axes"])
        by_axes[key] = by_axes.get(key, 0) + c["received"]
    return dict(rec, status="ok", peak_bytes=out["memory"]["peak_bytes"],
                flops=out["flops"],
                received=out["collectives"]["total"]["received"],
                received_by_axes=by_axes,
                calls=len(mesh.census.calls), model_leaf_gathers=gathered,
                seconds=time.perf_counter() - t0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--arch", nargs="*", default=None,
                    help="arch ids to keep (all by default)")
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import repro_torch.configs as configs
    from repro_torch.launch import specs as S
    # the long cells first, so the pool ends together
    cost = {"prefill_32k": 0, "train_4k": 1, "decode_32k": 2, "long_500k": 3}
    archs = args.arch or configs.ARCH_IDS
    cells = sorted(((a, s, mp) for mp in (False, True)
                    for a in archs for s in S.SHAPES),
                   key=lambda c: cost[c[1]])
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            args.jobs, mp_context=ctx, initializer=_init,
            initargs=(src,)) as pool:
        futs = {pool.submit(_cell, *c): c for c in cells}
        out = []
        for f in concurrent.futures.as_completed(futs):
            rec = f.result()
            out.append(rec)
            print(json.dumps({k: v for k, v in rec.items()
                              if k != "model_leaf_gathers"}), flush=True)
    out.sort(key=lambda r: (r["mesh"], r["arch"], r["shape"]))
    with open(args.out, "w") as f:
        json.dump({"src": src, "seconds": time.perf_counter() - t0,
                   "cells": out}, f, indent=1)


if __name__ == "__main__":
    main()
