"""Magnitude histogram for O(n) top-k threshold selection (CUDA kernel).

Replaces ``repro.kernels.topk_threshold`` (the TPU ``_hist_kernel``). The
wrapper takes a ``[rows, n]`` f32 batch with one ``max_abs`` per row and
returns ``[rows, 256]`` int32 counts, so a tier chunk's upload histograms
are one launch. CUDA tensors launch ``csrc/magnitude_histogram.cu``; CPU
tensors take the plain version (`magnitude_histogram_plain`). There is no
fallback from the kernel to the plain version.

One launch per call, with no fill kernel: `hist_plan` spreads each row
over enough blocks to fill the card, and the blocks of a row merge their
counts through `build.zeroed_scratch`, zeroed once when allocated and
left zeroed by every launch.

The threshold lookup in the histogram's cdf is plain PyTorch
(`ref.threshold_from_cdf`, used through `repro_torch.core.compression`),
as the reference leaves it to XLA.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

N_BINS = ref.N_BINS
magnitude_histogram_plain = ref.magnitude_histogram
_C = ctypes.c_void_p
# grid plan: about BLOCKS_PER_SM blocks per SM over all rows, each block at
# least MIN_PER_BLOCK elements (a multiple of 4: whole float4 loads)
BLOCKS_PER_SM = 2
MIN_PER_BLOCK = 1024


def _lib():
    lib = build.load("magnitude_histogram")
    fn = lib.magnitude_histogram
    if fn.argtypes is None:
        fn.argtypes = [_C, _C, _C, _C, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, _C]
        fn.restype = ctypes.c_int
    return fn


def hist_plan(rows: int, n: int, sm_count: int) -> tuple[int, int]:
    """(per_block, blocks_per_row): each row cut in slices of per_block
    elements (a multiple of 4), so that the grid has about BLOCKS_PER_SM
    blocks per SM."""
    return build.slice_plan(rows, n, sm_count, BLOCKS_PER_SM, MIN_PER_BLOCK)


def _check(x: torch.Tensor, max_abs: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be a non-empty [rows, n] batch, got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32 or max_abs.dtype != torch.float32:
        raise TypeError(f"want float32 x and max_abs, got {x.dtype}, "
                        f"{max_abs.dtype}")
    if tuple(max_abs.shape) != (x.shape[0],):
        raise ValueError(f"max_abs must be [rows]={x.shape[0]}, got "
                         f"{tuple(max_abs.shape)}")
    if max_abs.device != x.device:
        raise ValueError("x and max_abs must be on one device")
    if not (x.is_contiguous() and max_abs.is_contiguous()):
        raise ValueError("x and max_abs must be contiguous")


def magnitude_histogram(x: torch.Tensor, max_abs: torch.Tensor
                        ) -> torch.Tensor:
    """[rows, 256] int32 histogram of |x| over [0, max_abs] per row."""
    _check(x, max_abs)
    if x.device.type == "cpu":
        return magnitude_histogram_plain(x, max_abs)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.shape[0] > 65535:
        raise ValueError("at most 65535 rows per launch")
    fn = _lib()
    rows, n = x.shape
    per_block, blocks = hist_plan(rows, n,
                                  build.sm_count(x.device.index or 0))
    hist = torch.empty((rows, N_BINS), dtype=torch.int32, device=x.device)
    stream = build.stream_of(x)
    # per row: 256 accumulators and a ticket (see the kernel's note)
    scratch = (build.zeroed_scratch("magnitude_histogram", x.device,
                                    rows * (N_BINS + 1), stream).data_ptr()
               if blocks > 1 else None)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), max_abs.data_ptr(), hist.data_ptr(), scratch,
                  rows, n, per_block, blocks, stream)
    build.check_launch(code, "magnitude_histogram")
    magnitude_histogram.launches += 1
    by_rows = magnitude_histogram.launches_by_rows
    by_rows[rows] = by_rows.get(rows, 0) + 1
    return hist


magnitude_histogram.launches = 0
magnitude_histogram.launches_by_rows = {}
