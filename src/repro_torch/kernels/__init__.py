"""Hand-written CUDA kernels of the port, each with a plain PyTorch twin.

* `topk_threshold.magnitude_histogram` — 256-bin |x| histogram per row;
* `hybrid_compress.hybrid_compress` — Fig.-3 sender, one threshold per row;
* `recover.recover` — Fig.-3 receiver, scalars per row;
* `flash_attention.decode_attention` — single-query GQA flash decode over a
  KV cache with a length mask (the serve path).

Each wrapper dispatches on its input's device (CUDA → kernel, CPU → twin
in `ref`) and counts its kernel launches in a plain integer attribute
``launches``; `launch_counts` / `reset_launch_counts` read and zero them.
The histogram, compress and recover wrappers also count their launches by
batch rows (``launches_by_rows``, read by `launch_counts_by_rows`): the
round path calls them once per tier chunk, at the chunk sizes of its
rung ladder (and the histogram once per round at one row).
Kernels are built from ``csrc/`` at first use (see `build`).
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import hybrid_compress as _hc
from repro_torch.kernels import recover as _rc
from repro_torch.kernels import topk_threshold as _tt

WRAPPERS = {
    "magnitude_histogram": _tt.magnitude_histogram,
    "hybrid_compress": _hc.hybrid_compress,
    "recover": _rc.recover,
    "decode_attention": _fa.decode_attention,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def launch_counts_by_rows() -> dict:
    return {name: dict(sorted(fn.launches_by_rows.items()))
            for name, fn in WRAPPERS.items()
            if hasattr(fn, "launches_by_rows")}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_rows"):
            fn.launches_by_rows = {}
