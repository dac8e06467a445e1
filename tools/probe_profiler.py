#!/usr/bin/env python3
"""Time torch.profiler's own work on a CUDA card: a window of n tiny
kernels (an in-place add on 1,024 floats) profiled with CUDA activity
only, as ``chip_smoke.py`` profiles, for n = 1,000, 10,000 and 30,000
(twice). For each window it prints the seconds of entering the profiler,
of the run, of leaving it, of reading the trace's raw events
(``prof.profiler.kineto_results.events()``) and walking them once, of
``key_averages()`` (which builds torch's tree of FunctionEvents first),
of ``events()`` and of the table, with the count of events by device.

    python3 tools/probe_profiler.py

Needs a CUDA card; builds nothing.
"""
from __future__ import annotations

import os
import time

os.environ.setdefault("TEARDOWN_CUPTI", "0")

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

WINDOWS = (1000, 10000, 30000, 30000)


def main() -> None:
    x = torch.randn(1024, device="cuda")
    print(torch.cuda.get_device_name(0), torch.__version__)
    for n in WINDOWS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        t1 = time.perf_counter()
        for _ in range(n):
            x.add_(1.0)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        prof.__exit__(None, None, None)
        t3 = time.perf_counter()
        raw = prof.profiler.kineto_results.events()
        t4 = time.perf_counter()
        kinds: dict = {}
        for ev in raw:
            kinds[str(ev.device_type())] = kinds.get(str(ev.device_type()),
                                                     0) + 1
        t5 = time.perf_counter()
        averages = prof.key_averages()
        t6 = time.perf_counter()
        cuda = [ev for ev in prof.events()
                if ev.device_type == DeviceType.CUDA]
        t7 = time.perf_counter()
        averages.table(sort_by="self_device_time_total", row_limit=40)
        t8 = time.perf_counter()
        print(f"n={n} enter={t1 - t0:.3f} run={t2 - t1:.3f} "
              f"exit={t3 - t2:.3f} raw={t4 - t3:.3f} "
              f"raw_walk={t5 - t4:.3f} events_by_device={kinds} "
              f"key_averages={t6 - t5:.3f} events={t7 - t6:.3f} "
              f"cuda_events={len(cuda)} table={t8 - t7:.3f}", flush=True)


if __name__ == "__main__":
    main()
