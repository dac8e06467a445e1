"""Fig.-3 receiver pass (CUDA kernel): model recovery, scalars per row.

Replaces ``repro.kernels.recover`` (the TPU ``_recover_kernel``). Inputs
are ``[rows, n]`` (kept f32, sign int8, local f32) with ``mean_abs`` and
``max_abs`` ``[rows]``; the output is ``[rows, n]`` f32. CUDA tensors
launch ``csrc/recover.cu``; CPU tensors take the plain version
(`recover_plain`), with no fallback between them. Given the same scalars
the two agree exactly.

One launch per call. `recover_plan` cuts each row in slices of
``per_block`` elements (a multiple of 4) so that the grid has about
BLOCKS_PER_SM blocks per SM; the kernel reads each slice as a scalar head
up to the first 16-byte boundary of the flat ``[rows, n]`` index, whole
16-byte vectors (4-byte for ``sign``), and a scalar tail. The vectors of
all four streams line up because their bases are aligned: the wrapper
refuses an input whose data pointer is not (``kept``, ``local`` on 16
bytes, ``sign`` on 4; fresh allocations are) and allocates ``out`` itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, meta, ref

recover_plain = ref.recover
_C = ctypes.c_void_p
# grid plan: about BLOCKS_PER_SM blocks per SM over all rows, each block at
# least MIN_PER_BLOCK elements (a multiple of 4: whole vectors)
BLOCKS_PER_SM = 16
MIN_PER_BLOCK = 1024


def _lib():
    fn = build.load("recover").recover
    if fn.argtypes is None:
        fn.argtypes = [_C, _C, _C, _C, _C, _C, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _C]
        fn.restype = ctypes.c_int
    return fn


def recover_plan(rows: int, n: int, sm_count: int) -> tuple[int, int]:
    """(per_block, blocks_per_row): each row cut in slices of per_block
    elements (a multiple of 4), so that the grid has about BLOCKS_PER_SM
    blocks per SM."""
    return build.slice_plan(rows, n, sm_count, BLOCKS_PER_SM, MIN_PER_BLOCK)


def _check(kept, sign, local, mean_abs, max_abs) -> None:
    if local.dim() != 2 or local.shape[0] < 1 or local.shape[1] < 1:
        raise ValueError(f"local must be a non-empty [rows, n] batch, got "
                         f"{tuple(local.shape)}")
    if kept.shape != local.shape or sign.shape != local.shape:
        raise ValueError("kept, sign and local must share one [rows, n] shape")
    rows = (local.shape[0],)
    if tuple(mean_abs.shape) != rows or tuple(max_abs.shape) != rows:
        raise ValueError("mean_abs and max_abs must be [rows]")
    if sign.dtype != torch.int8:
        raise TypeError(f"sign must be int8, got {sign.dtype}")
    for name, t in (("kept", kept), ("local", local), ("mean_abs", mean_abs),
                    ("max_abs", max_abs)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    ts = (kept, sign, local, mean_abs, max_abs)
    if any(t.device != local.device for t in ts):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("all inputs must be contiguous")


def recover(kept: torch.Tensor, sign: torch.Tensor, local: torch.Tensor,
            mean_abs: torch.Tensor, max_abs: torch.Tensor) -> torch.Tensor:
    """Fig.-3 recovery of every row against its stale ``local`` row."""
    _check(kept, sign, local, mean_abs, max_abs)
    if local.device.type == "cpu":
        return recover_plain(kept, sign, local, mean_abs, max_abs)
    if local.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {local.device}")
    rows, n = local.shape
    if rows > 65535:
        raise ValueError("at most 65535 rows per launch")
    if local.device.type == "meta":
        meta.record("recover", rows * n * 9 + rows * 8, rows * n * 4)
        return torch.empty((rows, n), dtype=torch.float32,
                           device=local.device)
    for name, t, to in (("kept", kept, 16), ("local", local, 16),
                        ("sign", sign, 4)):
        if t.data_ptr() % to:
            raise ValueError(f"{name} must start on a {to}-byte boundary")
    fn = _lib()
    per_block, blocks = recover_plan(rows, n,
                                     build.sm_count(local.device.index or 0))
    out = torch.empty((rows, n), dtype=torch.float32, device=local.device)
    with torch.cuda.device(local.device):
        code = fn(kept.data_ptr(), sign.data_ptr(), local.data_ptr(),
                  mean_abs.data_ptr(), max_abs.data_ptr(), out.data_ptr(),
                  rows, n, per_block, blocks, build.stream_of(local))
    build.check_launch(code, "recover")
    recover.launches += 1
    by_rows = recover.launches_by_rows
    by_rows[rows] = by_rows.get(rows, 0) + 1
    return out


recover.launches = 0
recover.launches_by_rows = {}
