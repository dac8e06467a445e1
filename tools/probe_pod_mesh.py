#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 11 (Track B over a pod mesh, 4 gloo ranks
on one NVIDIA card) with the mesh's collectives timed, one full-width
point per spawn.

    python3 tools/probe_pod_mesh.py 8          # Qwen1.5-4B at 8 layers
    python3 tools/probe_pod_mesh.py 12 llama   # 12 layers, then Llama-4

The first argument is Qwen1.5-4B's depth on (pod 2, data 2, model 1)
with error feedback; a second argument adds Llama-4-Scout at depth 1 on
(1, 2, 2) without it. Every rank wraps ``Mesh._gather`` and
``Mesh._exchange`` (the all-gathers and all-to-alls under every gather
and sum) in a card synchronise and a host clock and
prints, after each training step, its cumulative collective seconds,
calls and bytes received; phase 11's own checks and results follow
(`phase_pod_mesh`). A point that fails (out of memory, say) prints its
traceback and the next one runs. Results go to ``probe_pod_mesh_<i>.json``
in ``chip_smoke.py``'s output directory. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402


def _rank(rank, world, store, out_dir, full):
    """`chip_smoke._pod_rank` with the mesh's collectives timed."""
    import repro_torch.launch.train as train
    from repro_torch.launch import mesh as MESH
    orig = {"_gather": MESH.Mesh._gather, "_exchange": MESH.Mesh._exchange}
    acc = {"s": 0.0, "calls": 0, "bytes_in": 0}

    def timed(name, keep):
        def run(self, x, live):
            if x.is_cuda:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig[name](self, x, live)
            if x.is_cuda:
                torch.cuda.synchronize()
            n = self.size_over(live)
            acc["s"] += time.perf_counter() - t
            acc["calls"] += 1
            acc["bytes_in"] += x.numel() * x.element_size() * (n - 1) // keep(
                n)
            return out
        return run

    # an all-gather receives (n − 1)·b; an all-to-all (n − 1)/n·b
    MESH.Mesh._gather = timed("_gather", lambda n: 1)
    MESH.Mesh._exchange = timed("_exchange", lambda n: n)
    run = train.run

    def counted(*a, **k):
        per_step, hook = [], k.get("on_step")

        def on_step(t, state, loss):
            per_step.append(dict(acc))
            if hook:
                hook(t, state, loss)
        k["on_step"] = on_step
        out = run(*a, **k)
        print(f"rank {rank} collectives after each step (cumulative): "
              f"{per_step}", flush=True)
        return out

    train.run = counted
    CS._pod_rank(rank, world, store, out_dir, full)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_pod_mesh: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as MESH
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    plans = [{"pod_qwen": ("qwen1.5-4b", int(sys.argv[1]), (2, 2, 1),
                           ["--error-feedback"])}]
    if len(sys.argv) > 2:
        plans.append({"pod_llama4": ("llama4-scout-17b-a16e", 1,
                                     (1, 2, 2), [])})
    spawn = MESH.spawn
    MESH.spawn = lambda fn, world, args, timeout_s: spawn(
        _rank, world, args, timeout_s)
    os.makedirs(CS.OUT_DIR, exist_ok=True)
    for i, full in enumerate(plans):
        t = time.perf_counter()
        try:
            out = CS.phase_pod_mesh(torch, CS._pod_shard_sizes(full), full)
            with open(os.path.join(CS.OUT_DIR, f"probe_pod_mesh_{i}.json"),
                      "w") as f:
                json.dump(out, f, indent=1)
        except Exception:               # the next point still runs
            traceback.print_exc()
        print(f"point {list(full)}: {time.perf_counter() - t:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
