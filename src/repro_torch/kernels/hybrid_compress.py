"""Fig.-3 sender pass (CUDA kernel): hybrid compress, one threshold per row.

Replaces ``repro.kernels.hybrid_compress`` (the TPU ``_compress_kernel``).
``x`` is one ``[n]`` vector shared by every row (the global model against
each participant's θ_d threshold) or a ``[rows, n]`` batch; ``thr`` is
``[rows]``. Returns (kept [rows, n] f32, sign [rows, n] int8, count [rows]
int32, sum_abs [rows] f32, max_abs [rows] f32) over the compressed set
``|x| < thr``. CUDA tensors launch ``csrc/hybrid_compress.cu``; CPU tensors
take the plain version (`hybrid_compress_plain`), with no fallback between
them. On the card ``sum_abs`` is summed in another order than the plain
version (stated rtol 1e-5); everything else is exact.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

hybrid_compress_plain = ref.hybrid_compress
_C = ctypes.c_void_p


def _lib():
    lib = build.load("hybrid_compress")
    fn = lib.hybrid_compress
    if fn.argtypes is None:
        fn.argtypes = [_C, ctypes.c_longlong, _C, _C, _C, _C, _C, _C, _C,
                       ctypes.c_int, ctypes.c_longlong, _C]
        fn.restype = ctypes.c_int
        lib.hybrid_compress_scratch_bytes.argtypes = [ctypes.c_int,
                                                      ctypes.c_longlong]
        lib.hybrid_compress_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _check(x: torch.Tensor, thr: torch.Tensor) -> None:
    if x.dim() not in (1, 2) or x.shape[-1] < 1:
        raise ValueError(f"x must be [n] or [rows, n], got {tuple(x.shape)}")
    if thr.dim() != 1 or thr.shape[0] < 1:
        raise ValueError(f"thr must be [rows], got {tuple(thr.shape)}")
    if x.dim() == 2 and x.shape[0] != thr.shape[0]:
        raise ValueError(f"x has {x.shape[0]} rows but thr {thr.shape[0]}")
    if x.dtype != torch.float32 or thr.dtype != torch.float32:
        raise TypeError(f"want float32 x and thr, got {x.dtype}, {thr.dtype}")
    if thr.device != x.device:
        raise ValueError("x and thr must be on one device")
    if not (x.is_contiguous() and thr.is_contiguous()):
        raise ValueError("x and thr must be contiguous")


def hybrid_compress(x: torch.Tensor, thr: torch.Tensor):
    """(kept, sign_i8, count, sum_abs, max_abs), one row per threshold."""
    _check(x, thr)
    if x.device.type == "cpu":
        return hybrid_compress_plain(x, thr)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    rows, n = thr.shape[0], x.shape[-1]
    if rows > 65535:
        raise ValueError("at most 65535 rows per launch")
    lib = _lib()
    dev = x.device
    kept = torch.empty((rows, n), dtype=torch.float32, device=dev)
    sign = torch.empty((rows, n), dtype=torch.int8, device=dev)
    count = torch.empty(rows, dtype=torch.int32, device=dev)
    sum_abs = torch.empty(rows, dtype=torch.float32, device=dev)
    max_abs = torch.empty(rows, dtype=torch.float32, device=dev)
    scratch = torch.empty(lib.hybrid_compress_scratch_bytes(rows, n),
                          dtype=torch.uint8, device=dev)
    stride = 0 if x.dim() == 1 else n
    with torch.cuda.device(dev):
        code = lib.hybrid_compress(
            x.data_ptr(), stride, thr.data_ptr(), kept.data_ptr(),
            sign.data_ptr(), count.data_ptr(), sum_abs.data_ptr(),
            max_abs.data_ptr(), scratch.data_ptr(), rows, n,
            build.stream_of(x))
    build.check_launch(code, "hybrid_compress")
    hybrid_compress.launches += 1
    return kept, sign, count, sum_abs, max_abs


hybrid_compress.launches = 0
