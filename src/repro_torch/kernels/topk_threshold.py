"""Magnitude histogram for O(n) top-k threshold selection (CUDA kernel).

Replaces ``repro.kernels.topk_threshold`` (the TPU ``_hist_kernel``). The
wrapper takes a ``[rows, n]`` f32 batch with one ``max_abs`` per row and
returns ``[rows, 256]`` int32 counts, so a tier chunk's upload histograms
are one launch. CUDA tensors launch ``csrc/magnitude_histogram.cu``; CPU
tensors take the plain version (`magnitude_histogram_plain`). There is no
fallback from the kernel to the plain version.

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


def _lib():
    lib = build.load("magnitude_histogram")
    fn = lib.magnitude_histogram
    if fn.argtypes is None:
        fn.argtypes = [_C, _C, _C, ctypes.c_int, ctypes.c_longlong, _C]
        fn.restype = ctypes.c_int
    return fn


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
    hist = torch.zeros((x.shape[0], N_BINS), dtype=torch.int32,
                       device=x.device)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), max_abs.data_ptr(), hist.data_ptr(),
                  x.shape[0], x.shape[1], build.stream_of(x))
    build.check_launch(code, "magnitude_histogram")
    magnitude_histogram.launches += 1
    return hist


magnitude_histogram.launches = 0
