"""Flash-decode attention (CUDA kernel): one query token per sequence over a
KV cache, with a length mask.

Replaces ``repro.kernels.flash_attention.decode_attention`` (the TPU
``_decode_kernel``). q is ``[B, H, D]``, the cache k/v ``[B, S, Hkv, D]``
(all f32 or all bf16) and ``length`` ``[B]`` int32 the valid cache length;
the output is ``[B, H, D]`` in q's dtype. Query head h reads kv head
``h // (H / Hkv)``. Given ``lse``, an f32 ``[B, H]`` tensor, the same
launch also writes each row's log-sum-exp of its scaled logits there (−inf
for a row of length 0), and the output is bit-equal to the call without
it. ``out_dtype=torch.float32`` on bf16 inputs writes that output in f32
(its bf16 rounding is the bf16 output, bit for bit). Both serve the
softmax partial of a cache whose positions are split over ranks, which
`merge_partials` combines in f32. CUDA tensors launch
``csrc/decode_attention.cu``; CPU
tensors take the plain version (`decode_attention_plain`), with no fallback
between them. Lengths run 0..S (the kernel clamps others to [0, S]); a
row of length 0 comes out as zeros.

A long cache is split across blocks so that every SM has work, in one
launch: each split writes its partial softmax state to scratch and the
last block of each (b, kv-head group) to finish merges them in fixed order
(same inputs, same bits). A short one runs unsplit, where the merge would
cost more than it saves. The plan depends on the
shapes and the card's SM count only, never on the data, so no host sync is
needed. The merge's ticket counters live in `build.zeroed_scratch`, zeroed
once when allocated and left zeroed by every launch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

decode_attention_plain = ref.decode_attention
_C = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
F32_OUT = 2                    # the C code of bf16 inputs with an f32 output
# the split plan: aim at BLOCKS_PER_SM blocks per SM, splits of a multiple
# of MIN_CHUNK positions, at most MAX_SPLIT splits (the merging block reads
# every split's partial). Three blocks fit on an SM, so 2 keeps the whole
# grid resident at once with long splits: on the H100 it beat 4, 8 and 16
# at the long-cache and example shapes (PERF.md). A split must also stream
# at least MIN_SPLIT_BYTES of K and V: its partial, fence, ticket and the
# merge cost a few µs, more than a shorter stream saves, so a short cache
# (the serve loop's 48 positions) runs as one split.
BLOCKS_PER_SM = 2
MIN_CHUNK = 16
MAX_SPLIT = 64
MIN_SPLIT_BYTES = 128 * 1024
GROUPS = (1, 2, 4, 8)          # query heads per block the kernel is built for
MAX_GROUP_REGS = 64            # f32 registers per lane for q and acc each


class Plan(NamedTuple):
    gt: int                    # query heads per block (a GROUPS entry)
    n_gblk: int                # blocks per kv head's group of query heads
    chunk: int                 # positions per split
    n_split: int

    def pairs(self, b: int, hkv: int) -> int:
        """(b, kv-head group) pairs: one ticket counter each."""
        return b * hkv * self.n_gblk

    def blocks(self, b: int, hkv: int) -> int:
        return self.pairs(b, hkv) * self.n_split


def _lib():
    fn = build.load("decode_attention").decode_attention
    if fn.argtypes is None:
        fn.argtypes = [_C, _C, _C, _C, _C, _C, _C, _C, _I, _I, _I, _I, _I,
                       _I, _I, _I, _I, _I, _C]
        fn.restype = ctypes.c_int
    return fn


def lane_elements(d: int, itemsize: int) -> int:
    """Elements of a row each lane holds (the kernel's Plan::EPL): rows are
    16-byte chunks over a sub-warp of the largest power of two <= chunks
    (at most 32) lanes."""
    cpr = d * itemsize // 16
    lpr = min(32, 1 << (cpr.bit_length() - 1))
    return -(-cpr // lpr) * (16 // itemsize)


def group_plan(g: int, d: int, itemsize: int) -> tuple[int, int]:
    """(gt, n_gblk): the block's query heads, the smallest GROUPS entry that
    holds the group (capped so q and acc fit in registers), and how many
    blocks share one kv head's group."""
    cap = max(x for x in GROUPS
              if x * lane_elements(d, itemsize) <= MAX_GROUP_REGS)
    gt = min(x for x in GROUPS if x >= min(g, cap))
    return gt, -(-g // gt)


def plan(b: int, h: int, hkv: int, d: int, s: int, itemsize: int,
         sm_count: int) -> Plan:
    """The launch: group blocking, then S split so that the grid has about
    BLOCKS_PER_SM blocks per SM, in splits of at least MIN_SPLIT_BYTES."""
    gt, n_gblk = group_plan(h // hkv, d, itemsize)
    pairs = b * hkv * n_gblk
    want = min(MAX_SPLIT, max(1, -(-BLOCKS_PER_SM * sm_count // pairs)))
    chunk = max(-(-MIN_SPLIT_BYTES // (2 * d * itemsize)), -(-s // want))
    chunk = -(-chunk // MIN_CHUNK) * MIN_CHUNK
    return Plan(gt, n_gblk, chunk, -(-s // chunk))


def _check(q, k, v, length, lse=None, out_dtype=None) -> None:
    if q.dim() != 3:
        raise ValueError(f"q must be [B, H, D], got {tuple(q.shape)}")
    b, h, d = q.shape
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError("k and v must share one [B, S, Hkv, D] shape")
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] < 1:
        raise ValueError(f"cache {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    hkv = k.shape[2]
    if hkv < 1 or h % hkv:
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv}")
    if tuple(length.shape) != (b,):
        raise ValueError(f"length must be [B={b}], got {tuple(length.shape)}")
    if length.dtype != torch.int32:
        raise TypeError(f"length must be int32, got {length.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if out_dtype not in (None, q.dtype, torch.float32):
        raise TypeError(f"out_dtype must be q's dtype or float32, got "
                        f"{out_dtype}")
    ts = (q, k, v, length) + (() if lse is None else (lse,))
    if lse is not None and (tuple(lse.shape) != (b, h)
                            or lse.dtype != torch.float32):
        raise ValueError(f"lse must be float32 [B={b}, H={h}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if any(t.device != q.device for t in ts):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("all inputs must be contiguous")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor,
                     lse: torch.Tensor | None = None,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """softmax(q·kᵀ/√D over the first length[b] positions)·v per head, in
    ``out_dtype`` (q's dtype by default, or f32); with ``lse`` (f32
    [B, H]) also the rows' log-sum-exp, written there."""
    _check(q, k, v, length, lse, out_dtype)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, length, lse, out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if d % 32 or not 32 <= d <= 256:
        raise ValueError(f"the kernel takes D in 32..256, a multiple of 32; "
                         f"got {d}")
    if b > 65535:
        raise ValueError("at most 65535 sequences")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    fn = _lib()
    p = plan(b, h, hkv, d, s, q.element_size(),
             build.sm_count(q.device.index or 0))
    out = torch.empty_like(q, dtype=out_dtype or q.dtype)
    kind = _DTYPES[q.dtype] if out.dtype == q.dtype else F32_OUT
    part = ticket = None
    stream = build.stream_of(q)
    if p.n_split > 1:
        part = torch.empty(p.blocks(b, hkv) * p.gt * (d + 2),
                           dtype=torch.float32, device=q.device)
        ticket = build.zeroed_scratch("decode_attention", q.device,
                                      p.pairs(b, hkv), stream)
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
                  out.data_ptr(), None if lse is None else lse.data_ptr(),
                  part.data_ptr() if part is not None
                  else None, ticket.data_ptr() if ticket is not None
                  else None, b, h, hkv, s, d, p.gt, p.n_gblk, p.chunk,
                  p.n_split, kind, stream)
    build.check_launch(code, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def merge_partials(out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """One softmax from R partials over disjoint position sets: ``out``
    [R, ..., D] (each normalized over its own positions) and ``lse``
    [R, ...] (each one's log-sum-exp, −inf where it held no position), in
    the order of R (the ranks' order along the axes that split the
    sequence). With m = max_r lse_r and w_r = exp(lse_r − m) (0 for −inf),
    Σ_r w_r·out_r / Σ_r w_r, folded left in f32 and returned in f32 (the
    caller rounds it once): a partial with no position weighs exactly 0,
    and a row no partial holds comes out 0."""
    m = torch.amax(lse, dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    num = torch.zeros(out.shape[1:], dtype=torch.float32, device=out.device)
    den = torch.zeros(lse.shape[1:], dtype=torch.float32, device=out.device)
    for r in range(out.shape[0]):
        w = torch.where(lse[r] == float("-inf"), 0.0,
                        torch.exp(lse[r] - m))
        num = num + w[..., None] * out[r].to(torch.float32)
        den = den + w
    return num / torch.clamp(den, min=1e-30)[..., None]
