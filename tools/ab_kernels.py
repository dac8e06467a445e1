#!/usr/bin/env python3
"""Time the port's four CUDA kernels (flash decode, magnitude histogram,
hybrid compress, recover) of two or more checkouts in turns on one NVIDIA
card.

    python3 tools/ab_kernels.py --trees . build/parent . build/parent

Each tree is a checkout (``git archive`` of a commit unpacked anywhere);
it is measured in a subprocess that imports that tree's ``repro_torch``
and builds its kernels into that tree's ``build/kernels``, so two commits
are compared through their own wrappers on the same card in one run.
Timings use ``chip_smoke.py``'s timer (flushed L2, card kept busy while
the host enqueues) and its profiled ``kernel_only_ms``, at the shapes of
``chip_smoke.py``'s phases 3 and 4 (compress on the shared global vector
and recover at 1 row and a full tier chunk), each checked against its
plain version first, with the library yardsticks beside them
(scaled_dot_product_attention, torch.histc) and two streaming yardsticks
at the chunk's [rows, n]: ``fill`` (PyTorch's fills of compress's two
outputs, the bytes it writes) and ``add`` (``torch.add`` of two f32
batches into a third, 12 of recover's 13 bytes per element). Prints, per
tree and shape, [ms, kernel_only_ms] in µs, and writes all to
``ab_kernels.json`` in ``chip_smoke.py``'s output directory. Needs a CUDA
card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a tree's measuring process is started again if it fails: in a few
# processes torch.profiler records nothing, and chip_smoke's profiled
# window then fails
ATTEMPTS = 3


def measure(tree: str) -> dict:
    """Every timed shape of one tree, in this process."""
    sys.path.insert(0, ROOT)
    import chip_smoke as CS                       # the timing harness
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import hybrid_compress as HC
    from repro_torch.kernels import recover as RC
    from repro_torch.kernels import topk_threshold as TT

    build.build(["decode_attention", "magnitude_histogram", "hybrid_compress",
                 "recover"])
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev)
    timer = CS._Timer(torch, flush, windows=11)
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {"tree": tree}
    for name, (b, h, hkv, d, s, dt, lens) in CS.DECODE_SHAPES.items():
        dtype = getattr(torch, dt)
        q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
        length = torch.tensor(list(lens) if lens else [s] * b,
                              dtype=torch.int32, device=dev)
        got = FA.decode_attention(q, k, v, length)
        want = FA.decode_attention_plain(q, k, v, length)
        tol = CS.DECODE_TOL[dt]
        CS.check(bool(((got.float() - want.float()).abs()
                       <= tol + tol * want.float().abs()).all()),
                 f"{tree} decode {name}: kernel vs plain")
        out[f"decode_{name}"] = _times(
            CS, torch, timer, flush,
            lambda: FA.decode_attention(q, k, v, length))
        mask = (torch.arange(s, device=dev)[None, :] < length[:, None]
                )[:, None, None, :]
        out[f"sdpa_{name}"] = _times(
            CS, torch, timer, flush, lambda: CS._sdpa(torch, q, k, v, mask))
    for rows in (1, CS.CHUNK):
        x = torch.randn(rows, CS.N_PARAMS, generator=gen, device=dev) * 0.05
        mx = torch.amax(x.abs(), dim=-1)
        CS.check(torch.equal(TT.magnitude_histogram(x, mx),
                             TT.magnitude_histogram_plain(x, mx)),
                 f"{tree} histogram rows={rows}: counts differ")
        out[f"histogram_rows{rows}"] = _times(
            CS, torch, timer, flush, lambda: TT.magnitude_histogram(x, mx))
        if rows == 1:
            m = float(mx[0])
            out["histc_rows1"] = _times(
                CS, torch, timer, flush,
                lambda: torch.histc(x[0].abs(), bins=256, min=0.0, max=m))
        # compress: the shared global vector at per-row thresholds, the
        # |x| quantiles of download ratios across [0, 0.6] (one row: 0.3)
        g = x[0].contiguous()
        ratio = torch.linspace(0.0, 0.6, rows) if rows > 1 else \
            torch.tensor([0.3])
        thr = torch.quantile(g.abs().cpu(), ratio).to(dev)
        ck = HC.hybrid_compress(g, thr)
        cp = HC.hybrid_compress_plain(g, thr)
        CS.check(all(torch.equal(ck[i], cp[i]) for i in (0, 1, 2, 4))
                 and bool(((ck[3] - cp[3]).abs()
                           <= CS.SUM_RTOL * cp[3].abs()).all()),
                 f"{tree} compress rows={rows}: kernel vs plain")
        CS.check(bool((ck[2][ratio.to(dev) > 0] > 0).all()),
                 f"{tree} compress rows={rows}: a row compressed nothing")
        out[f"compress_rows{rows}"] = _times(
            CS, torch, timer, flush, lambda: HC.hybrid_compress(g, thr))
        # recover: stale local rows with the compress scalars
        kept, sign, cnt, ssum, smax = ck
        mean = ssum / torch.clamp(cnt, min=1).float()
        local = g + torch.randn(rows, CS.N_PARAMS, generator=gen,
                                device=dev) * 0.01
        CS.check(torch.equal(RC.recover(kept, sign, local, mean, smax),
                             RC.recover_plain(kept, sign, local, mean, smax)),
                 f"{tree} recover rows={rows}: kernel vs plain")
        out[f"recover_rows{rows}"] = _times(
            CS, torch, timer, flush,
            lambda: RC.recover(kept, sign, local, mean, smax))
        # streaming yardsticks (PyTorch's own kernels)
        c = torch.empty_like(local)
        out[f"fill_rows{rows}"] = _times(
            CS, torch, timer, flush, lambda: (c.zero_(), sign.zero_()))
        out[f"add_rows{rows}"] = _times(
            CS, torch, timer, flush, lambda: torch.add(kept, local, out=c))
    return out


def _times(CS, torch, timer, flush, fn) -> dict:
    """chip_smoke's timer, then its profiled kernel-only time (the order
    chip_smoke.py uses)."""
    ms = timer.ms(fn)
    own = CS._kernel_only(torch, flush, fn)
    return {"ms": ms, "kernel_only_ms": own["kernel_only_ms"],
            "profile": own["kernels"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", required=True,
                    help="checkouts to measure, in this order")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    results = []
    for tree in args.trees:
        for _ in range(ATTEMPTS):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   "--trees", tree, "--measure", tree],
                                  capture_output=True, text=True, cwd=ROOT,
                                  timeout=900)
            if proc.returncode == 0:
                break
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        else:
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append(res)
        brief = {k: [round(v[x] * 1e3, 2) for x in ("ms", "kernel_only_ms")]
                 for k, v in res.items() if isinstance(v, dict)}
        print(f"{tree}: {json.dumps(brief)}", flush=True)
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    os.makedirs(CS.OUT_DIR, exist_ok=True)
    with open(os.path.join(CS.OUT_DIR, "ab_kernels.json"), "w") as f:
        json.dump({"card": smi, "runs": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
