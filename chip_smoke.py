#!/usr/bin/env python3
"""Drive the PyTorch port's Track-A Caesar round on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (and nvcc).
Phases, each of which fails the script on any error:

1. environment: the card's name and power limit (nvidia-smi); TF32 off;
2. build: compiles the three CUDA kernels from src/repro_torch/kernels/csrc;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (n = 164,134; 1 row and a chunk of rows), with
   CUDA-event timings of kernel, plain version and, for the histogram,
   torch.histc as a yardstick, beside the bytes bound at 3.35 TB/s;
4. parity: the small HAR config (12 clients) on cuda and on cpu within
   the port from one initial vector — participants, plans and sim_time
   identical, the global vector within a stated tolerance; and pipelined
   vs synchronous on cuda bit-identical (deterministic kernels and cuDNN);
5. main path: the dense HAR point (1000 clients, participation 0.5,
   τ = 5, b_max = 32, 4 rounds) with the launch counters zeroed just
   before and read just after — each must equal what the tier layout
   implies; then a profiled 2-round rerun for the time breakdown.

The line before the last is a JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}. It exits non-zero without a CUDA device
or outside a checkout (it needs src/repro_torch beside it).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
N_PARAMS = 164134                # cnn_har
CHUNK = 25                       # auto_chunk at the dense HAR point
SUM_RTOL = 1e-5                  # kernel vs plain Σ|x|: summation order
PARITY_REL_L2 = 1e-4             # cuda vs cpu global vector after 3 rounds


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


class _Timer:
    """Device milliseconds of one call, from CUDA events.

    Each window is ``iters`` calls, each after an L2 flush (a 64 MiB
    memset), recorded between two events while a leading ``_sleep``
    kernel keeps the card busy long enough for the host to enqueue the
    whole window — so host dispatch never leaks into the measurement. A
    flush-only window follows each one; the result is the median over
    ``windows`` pairs of (window − flush-only window) / iters."""

    def __init__(self, torch, flush, windows: int = 21, iters: int = 10,
                 lead_ms: float = 50.0):
        self.torch, self.flush = torch, flush
        self.windows, self.iters, self.lead_ms = windows, iters, lead_ms
        probe = 10_000_000
        a, b = self._events()
        a.record()
        torch.cuda._sleep(probe)
        b.record()
        b.synchronize()
        self.cycles = int(probe * lead_ms / max(a.elapsed_time(b), 1e-3))

    def _events(self):
        ev = self.torch.cuda.Event
        return ev(enable_timing=True), ev(enable_timing=True)

    def _window(self, fn) -> float:
        a, b = self._events()
        self.torch.cuda._sleep(self.cycles)
        t0 = time.perf_counter()
        a.record()
        for _ in range(self.iters):
            self.flush.zero_()
            if fn is not None:
                fn()
        b.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.synchronize()
        check(host_ms < self.lead_ms, f"the host took {host_ms:.1f} ms to "
              "enqueue one timing window; the card may have idled")
        return a.elapsed_time(b)

    def ms(self, fn) -> float:
        for _ in range(3):
            fn()
        self.torch.cuda.synchronize()
        per = sorted((self._window(fn) - self._window(None)) / self.iters
                     for _ in range(self.windows))
        return per[len(per) // 2]


def _bound(bytes_moved: float, f32_ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = f32_ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, K, timer):
    """Each kernel vs its plain version at the main path's shapes."""
    from repro_torch.core import compression as C
    from repro_torch.kernels import hybrid_compress as HC
    from repro_torch.kernels import recover as RC
    from repro_torch.kernels import topk_threshold as TT

    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    n = N_PARAMS
    results = {}
    for rows in (1, CHUNK):
        x = (torch.randn(rows, n, generator=gen) * 0.05).to(dev)
        mx = torch.amax(x.abs(), dim=-1)
        # histogram (global model at rows=1, upload deltas at rows=CHUNK)
        hk = TT.magnitude_histogram(x, mx)
        hp = TT.magnitude_histogram_plain(x, mx)
        torch.cuda.synchronize()
        check(torch.equal(hk, hp), f"histogram rows={rows}: counts differ")
        check(int(hk.sum()) == rows * n, "histogram lost elements")
        ms = timer.ms(lambda: TT.magnitude_histogram(x, mx))
        plain = timer.ms(lambda: TT.magnitude_histogram_plain(x, mx))
        lib = None
        if rows == 1:
            m = float(mx[0])
            lib = timer.ms(lambda: torch.histc(x[0].abs(), bins=256, min=0.0,
                                               max=m))
        bms, by = _bound(rows * n * 4 + rows * 4 + rows * 256 * 4,
                         2.0 * rows * n)
        results[("magnitude_histogram", rows)] = dict(
            max_abs_err=float((hk - hp).abs().max()), ms=ms, plain_ms=plain,
            library_ms=lib, bound_ms=bms, bound_by=by)

        # compress of the shared global vector at per-row thresholds
        g = x[0].contiguous()
        gcdf, gmx = C.fused_histogram_cdf(g)
        thr = C.threshold_from_cdf(gcdf, gmx,
                                   torch.linspace(0.0, 0.6, rows, device=dev))
        ck = HC.hybrid_compress(g, thr)
        cp = HC.hybrid_compress_plain(g, thr)
        torch.cuda.synchronize()
        for i, name in ((0, "kept"), (1, "sign"), (2, "count"), (4, "max")):
            check(torch.equal(ck[i], cp[i]), f"compress rows={rows}: {name} "
                  "differs from the plain version")
        sum_err = (ck[3] - cp[3]).abs()
        check(bool((sum_err <= SUM_RTOL * cp[3].abs() + 1e-30).all()),
              f"compress rows={rows}: sum_abs outside rtol {SUM_RTOL}")
        ms = timer.ms(lambda: HC.hybrid_compress(g, thr))
        plain = timer.ms(lambda: HC.hybrid_compress_plain(g, thr))
        bms, by = _bound(n * 4 + rows * 4 + rows * n * 5 + rows * 12,
                         3.0 * rows * n)
        results[("hybrid_compress", rows)] = dict(
            max_abs_err=float(sum_err.max()), ms=ms, plain_ms=plain,
            library_ms=None, bound_ms=bms, bound_by=by)

        # recover against stale local rows, with the compress scalars
        kept, sign, cnt, ssum, smax = ck
        mean = ssum / torch.clamp(cnt, min=1).float()
        local = (g + torch.randn(rows, n, generator=gen).to(dev) * 0.01
                 ).contiguous()
        rk = RC.recover(kept, sign, local, mean, smax)
        rp = RC.recover_plain(kept, sign, local, mean, smax)
        torch.cuda.synchronize()
        check(torch.equal(rk, rp), f"recover rows={rows}: output differs")
        ms = timer.ms(lambda: RC.recover(kept, sign, local, mean, smax))
        plain = timer.ms(lambda: RC.recover_plain(kept, sign, local, mean,
                                                  smax))
        bms, by = _bound(rows * n * 9 + rows * 8 + rows * n * 4,
                         4.0 * rows * n)
        results[("recover", rows)] = dict(
            max_abs_err=float((rk - rp).abs().max()), ms=ms, plain_ms=plain,
            library_ms=None, bound_ms=bms, bound_by=by)
    for (name, rows), r in sorted(results.items()):
        print(f"kernel {name} rows={rows} n={n}: " + json.dumps(r))
    return results


def phase_parity(torch, SimConfig, Simulator, CaesarConfig):
    """The fast HAR config on cuda and on cpu from one initial vector."""
    from repro_torch.models.paper_models import cnn_har_init
    init = cnn_har_init(torch.Generator().manual_seed(1))
    runs = {}
    for dev, pipelined in (("cuda", True), ("cuda-sync", False),
                           ("cpu", True)):
        cfg = SimConfig(dataset="har", n_clients=12, participation=0.25,
                        rounds=3, data_scale=0.2, seed=1, eval_every=1,
                        caesar=CaesarConfig(tau=2, b_max=8),
                        device=dev.split("-")[0], pipelined=pipelined)
        sim = Simulator(cfg, init_flat=init)
        hist = sim.run()
        runs[dev] = (sim, hist)
    (sg, hg), (sc, hc) = runs["cuda"], runs["cpu"]
    ss, hs = runs["cuda-sync"]
    check(torch.equal(sg.global_flat, ss.global_flat)
          and hg.traffic_bits == hs.traffic_bits,
          "pipelined and synchronous runs differ on the card")
    for a, b in zip(sg.round_log, sc.round_log):
        check((a["parts"] == b["parts"]).all(), "participants differ")
        for k in ("theta_d", "theta_u", "batch", "taus"):
            check((a[k] == b[k]).all(), f"round {a['round']}: plan {k} differs")
    check(hg.sim_time == hc.sim_time, "sim_time differs cuda vs cpu")
    check(hg.waiting == hc.waiting, "waiting differs cuda vs cpu")
    gg = sg.global_flat.cpu()
    gc = sc.global_flat
    rel = float(torch.linalg.vector_norm(gg - gc) / torch.linalg.vector_norm(gc))
    tr = max(abs(a - b) / b for a, b in zip(hg.traffic_bits, hc.traffic_bits))
    out = {"rel_l2_global": rel, "max_rel_traffic": tr,
           "acc_cuda": hg.accuracy, "acc_cpu": hc.accuracy,
           "sim_time": hg.sim_time}
    print("parity cuda vs cpu: " + json.dumps(out))
    check(math.isfinite(rel) and rel <= PARITY_REL_L2,
          f"global vector rel L2 {rel} > {PARITY_REL_L2}")
    return out


def phase_main(torch, K, SimConfig, Simulator, CaesarConfig):
    """The dense HAR point through the port's entry points."""
    cfg = SimConfig(dataset="har", n_clients=1000, participation=0.5,
                    data_scale=1.0, rounds=4,
                    caesar=CaesarConfig(tau=5, b_max=32), device="cuda")
    t0 = time.perf_counter()
    sim = Simulator(cfg)
    setup_s = time.perf_counter() - t0
    K.reset_launch_counts()
    hist = sim.run(log=print)
    counts = K.launch_counts()
    tel = sim.executor.telemetry()
    calls, rounds = tel["chunk_calls"], tel["rounds"]
    expect = {"magnitude_histogram": rounds + calls,
              "hybrid_compress": calls, "recover": calls}
    print("main path launches: " + json.dumps(counts) + " expected "
          + json.dumps(expect))
    check(rounds == cfg.rounds, f"ran {rounds} rounds, want {cfg.rounds}")
    for name, want in expect.items():
        check(counts[name] > 0, f"{name} never launched on the main path")
        check(counts[name] == want, f"{name}: {counts[name]} launches, "
              f"tier layout implies {want}")
    check(sim.store.pool.is_cuda and sim.global_flat.is_cuda,
          "pool/global vector not on the card")
    check(bool(torch.isfinite(sim.global_flat).all()), "non-finite global")
    check(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in hist.accuracy),
          "bad accuracy")
    out = {"setup_s": setup_s, "wall_per_round_s": hist.wall_per_round,
           "accuracy": hist.accuracy, "traffic_bits": hist.traffic_bits,
           "sim_time": hist.sim_time, "telemetry": tel,
           "store": sim.store.telemetry(), "chunk": sim.executor.chunk,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    print("main path: " + json.dumps(out))
    return cfg, counts, out


def phase_profile(torch, cfg, Simulator, wall_per_round):
    """Where the dense point's round time goes: a 2-round rerun under
    torch.profiler. Device time is summed over CUDA kernel events only
    (operator rows would count their kernels twice); the busy share is
    that kernel time per round over the UNPROFILED median wall of the
    main run's rounds after the first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sim = Simulator(dataclasses.replace(cfg, rounds=2))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.run()
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and not getattr(ev, "is_user_annotation", False)]
    check(bool(kernels), "the profiler recorded no CUDA kernel")
    total_us = sum(ev.self_device_time_total for ev in kernels)
    kernels.sort(key=lambda ev: ev.self_device_time_total, reverse=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile_dense_har.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))
    per_round = total_us / 1e6 / 2
    warm = sorted(wall_per_round[1:] or wall_per_round)
    wall = warm[len(warm) // 2]
    out = {"device_kernel_s_per_round": per_round,
           "median_round_wall_s": wall,
           "device_busy_share": per_round / wall,
           "top_kernels": [{"name": ev.key[:90],
                            "ms_per_round": ev.self_device_time_total / 2e3,
                            "launches_per_round": ev.count / 2}
                           for ev in kernels[:15]]}
    print("profile (dense HAR, per round): " + json.dumps(out))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    import repro_torch.kernels as K
    from repro_torch.core.caesar import CaesarConfig
    from repro_torch.fl.simulation import SimConfig, Simulator
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    build_s = build.build()
    print(f"build: {build_s:.2f} s for {len(build.SOURCES)} kernels "
          f"(phase {time.perf_counter() - t0:.2f} s)")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")
    kres = phase_kernels(torch, K, _Timer(torch, flush))
    del flush
    parity = phase_parity(torch, SimConfig, Simulator, CaesarConfig)
    cfg, counts, main_out = phase_main(torch, K, SimConfig, Simulator,
                                       CaesarConfig)
    prof = phase_profile(torch, cfg, Simulator,
                         main_out["wall_per_round_s"])

    replaces = {
        "magnitude_histogram": "src/repro/kernels/topk_threshold.py:34",
        "hybrid_compress": "src/repro/kernels/hybrid_compress.py:21",
        "recover": "src/repro/kernels/recover.py:18",
    }
    shape_rows = {"magnitude_histogram": 1, "hybrid_compress": CHUNK,
                  "recover": CHUNK}
    kernels = []
    for name, rows in shape_rows.items():
        r = kres[(name, rows)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{build.SOURCES[name]}",
            "replaces": replaces[name], "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": f"[{rows}, {N_PARAMS}]"})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "build_s": build_s,
                   "kernels_all_shapes": {f"{k[0]}[rows={k[1]}]": v
                                          for k, v in kres.items()},
                   "parity": parity, "main": main_out, "profile": prof,
                   "kernels": kernels}, f, indent=1)
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
