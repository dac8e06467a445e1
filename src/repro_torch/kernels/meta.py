"""The kernels' ``meta`` branch: the card's path with the data left out.

A wrapper given ``meta`` tensors runs no kernel and no plain version. It
makes the checks of its cuda branch, allocates on ``meta`` the outputs
and the per-call scratch (partials) its launch plan would hold on the
card, planned for `SM_COUNT` SMs, and reports one launch to every sink
of `recording` with the bytes the kernel reads and writes (each input
read once, each output written once: the bytes PERF.md's bounds divide
by the card's memory rate). It leaves the launch counters alone: those
count launches on the card. ``launch.dryrun`` drives the model's steps
this way to count a rank's memory, bytes and launches without a card.

The zeroed scratch of `build.zeroed_scratch` (ticket counters, a few KiB
kept across launches) is not allocated here.
"""
from __future__ import annotations

import contextlib

# the SMs of an H100 SXM5 (NVIDIA H100 80GB HBM3), for the launch plans
SM_COUNT = 132

_SINKS: list = []


def record(name: str, read: int, written: int) -> None:
    """One launch of kernel ``name`` reading and writing these bytes."""
    for sink in _SINKS:
        sink(name, int(read), int(written))


@contextlib.contextmanager
def recording(sink):
    """Call ``sink(name, read, written)`` for every meta launch inside."""
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)
