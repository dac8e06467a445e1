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

One launch per call. `compress_plan` cuts the columns in ``col_blocks``
slices of ``per_block`` elements (a multiple of 4) and the rows in groups:
with a shared ``x`` one group holds up to MAX_GROUP rows, so a block reads
its slice of ``x`` once and writes every row of the group from it; with
``x`` per row a group is one row. Inside a block each row's slice is cut
in ``split`` sub-slices, one warp's unit each, so that the NWARP warps
share the units evenly. Each block stores a row's slice as a
scalar head up to the first 16-byte boundary of the flat ``[rows, n]``
index, whole vectors (float4 ``kept``, 4-byte ``sign``) and a scalar tail.
The blocks of a group fold their per-row partials in a fixed order in the
same launch, through a ticket counter per group in `build.zeroed_scratch`
that every launch leaves zeroed.
"""
from __future__ import annotations

import ctypes
from fractions import Fraction

import torch

from repro_torch.kernels import build, ref

hybrid_compress_plain = ref.hybrid_compress
_C = ctypes.c_void_p
# grid plan: about BLOCKS_PER_SM blocks per SM, each slice at least
# MIN_PER_BLOCK and at most MAX_PER_BLOCK elements (the shared-memory
# stage). MAX_PER_BLOCK, MAX_GROUP and NWARP are also the kernel's own
# limits (csrc/hybrid_compress.cu), which it checks.
BLOCKS_PER_SM = 1
MIN_PER_BLOCK = 512
MAX_PER_BLOCK = 4096
MAX_GROUP = 32
# inside a block: NWARP warps, each emitting one (row, sub-slice) unit at a
# time, at most MAX_SPLIT sub-slices per row once there are NWARP rows or more
NWARP = 8
MAX_SPLIT = 2


def _lib():
    fn = build.load("hybrid_compress").hybrid_compress
    if fn.argtypes is None:
        fn.argtypes = [_C, ctypes.c_longlong, _C, _C, _C, _C, _C, _C, _C, _C,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, _C]
        fn.restype = ctypes.c_int
    return fn


def _idle_share(units: int) -> Fraction:
    """Share of the warps' unit slots left idle by ``units`` units."""
    slots = -(-units // NWARP) * NWARP
    return Fraction(slots - units, slots)


def compress_plan(rows: int, n: int, sm_count: int,
                  shared: bool = True) -> tuple[int, int, int, int]:
    """(per_block, col_blocks, group, split): columns cut in col_blocks
    slices of per_block elements (a multiple of 4, at most MAX_PER_BLOCK),
    so that the grid has about BLOCKS_PER_SM blocks per SM; rows in groups
    of ``group`` (all rows up to MAX_GROUP when x is shared, else 1); each
    row's slice in ``split`` sub-slices: with fewer rows than warps enough
    for every warp to work, else the split up to MAX_SPLIT that leaves the
    least share of the warps' slots idle (25 rows: 2, 50 units on 8 warps)."""
    group = min(rows, MAX_GROUP) if shared else 1
    per_block, col_blocks = build.slice_plan(
        -(-rows // group), n, sm_count, BLOCKS_PER_SM, MIN_PER_BLOCK,
        MAX_PER_BLOCK)
    if group < NWARP:
        split = NWARP // group
    else:
        split = min(range(1, MAX_SPLIT + 1),
                    key=lambda s: _idle_share(group * s))
    return per_block, col_blocks, group, split


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
    fn = _lib()
    dev = x.device
    shared = x.dim() == 1
    per_block, col_blocks, group, split = compress_plan(
        rows, n, build.sm_count(dev.index or 0), shared)
    kept = torch.empty((rows, n), dtype=torch.float32, device=dev)
    sign = torch.empty((rows, n), dtype=torch.int8, device=dev)
    count = torch.empty(rows, dtype=torch.int32, device=dev)
    sum_abs = torch.empty(rows, dtype=torch.float32, device=dev)
    max_abs = torch.empty(rows, dtype=torch.float32, device=dev)
    stream = build.stream_of(x)
    partials = tickets = None
    if col_blocks > 1:
        # per row and slice: count, sum, max (held until the launch is
        # enqueued, so the allocator cannot hand its memory to the tickets);
        # a ticket per row group
        partials = torch.empty(3 * rows * col_blocks, dtype=torch.int32,
                               device=dev)
        tickets = build.zeroed_scratch("hybrid_compress", dev,
                                       -(-rows // group), stream)
    with torch.cuda.device(dev):
        code = fn(x.data_ptr(), 0 if shared else n, thr.data_ptr(),
                  kept.data_ptr(), sign.data_ptr(), count.data_ptr(),
                  sum_abs.data_ptr(), max_abs.data_ptr(),
                  None if partials is None else partials.data_ptr(),
                  None if tickets is None else tickets.data_ptr(),
                  rows, n, per_block, col_blocks, group, split, stream)
    build.check_launch(code, "hybrid_compress")
    hybrid_compress.launches += 1
    by_rows = hybrid_compress.launches_by_rows
    by_rows[rows] = by_rows.get(rows, 0) + 1
    return kept, sign, count, sum_abs, max_abs


hybrid_compress.launches = 0
hybrid_compress.launches_by_rows = {}
