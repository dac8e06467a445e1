#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s mesh phases alone on one NVIDIA card: the
kernels' build, phase 11 (Track B over a pod mesh), phase 12 (serving
under a mesh), phase 13 (the census held to both, its worker started
beside them as the script starts it) and the "tensor parallel" lines
(bytes received per step per axis set, ms per step).

    python3 tools/probe_mesh_phases.py

About 4 minutes on an H100, against ~13 for the whole script. The
phases' results go to ``probe_mesh_phases.json`` in ``chip_smoke.py``'s
output directory; a failed gate raises as it does in the script. Needs a
CUDA card and nvcc.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_mesh_phases: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, torch.__version__, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    census_dir = os.path.join(ROOT, "build", "census")
    shutil.rmtree(census_dir, ignore_errors=True)
    os.makedirs(census_dir)
    proc = multiprocessing.get_context("spawn").Process(
        target=CS._census_worker, args=(census_dir,), daemon=True)
    proc.start()
    out, seconds = {}, {}
    t = time.perf_counter()
    out["pod_mesh"] = CS.phase_pod_mesh(torch, CS._pod_shard_sizes())
    seconds["pod_mesh"] = time.perf_counter() - t
    t = time.perf_counter()
    out["serve_mesh"] = CS.phase_serve_mesh(torch, smi)
    seconds["serve_mesh"] = time.perf_counter() - t
    try:
        res = CS._census_results(proc, census_dir)
    finally:
        shutil.rmtree(census_dir, ignore_errors=True)
    out["census"] = CS.phase_census(torch, res, out["pod_mesh"],
                                    out["serve_mesh"], smi)
    out["tp_traffic"] = CS.phase_tp_traffic(out["pod_mesh"],
                                            out["serve_mesh"], smi)
    out["seconds"] = seconds
    print("phase seconds: " + json.dumps(seconds))
    os.makedirs(CS.OUT_DIR, exist_ok=True)
    with open(os.path.join(CS.OUT_DIR, "probe_mesh_phases.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
