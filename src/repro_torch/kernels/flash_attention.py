"""Flash-decode attention (CUDA kernel): one query token per sequence over a
KV cache, with a length mask.

Replaces ``repro.kernels.flash_attention.decode_attention`` (the TPU
``_decode_kernel``). q is ``[B, H, D]``, the cache k/v ``[B, S, Hkv, D]``
(all f32 or all bf16) and ``length`` ``[B]`` int32 the valid cache length;
the output is ``[B, H, D]`` in q's dtype. Query head h reads kv head
``h // (H / Hkv)``. CUDA tensors launch ``csrc/decode_attention.cu``; CPU
tensors take the plain version (`decode_attention_plain`), with no fallback
between them. Lengths are expected in 1..S: the kernel clamps them to
[0, S], and a row of length 0 comes out as zeros.

Long caches are split across blocks so that every SM has work; the
splits' partial softmax states are merged by a second kernel in fixed
order (same inputs, same bits). The split size depends on the shapes and
the card's SM count only, never on the data, so no host sync is needed.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

decode_attention_plain = ref.decode_attention
_C = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# one split covers at least this many positions, so short caches run in
# one pass; splits are chunks of whole warp tiles (4 warps x 8 positions)
MIN_CHUNK = 256
_TILE_POS = 32


def _lib():
    fn = build.load("decode_attention").decode_attention
    if fn.argtypes is None:
        fn.argtypes = [_C, _C, _C, _C, _C, _C, _C, _C, _I, _I, _I, _I, _I,
                       _I, _I, _I, _C]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(b: int, h: int, hkv: int, s: int, sm_count: int
               ) -> tuple[int, int]:
    """(chunk, n_split): split S so that the launch has about two blocks
    per SM, each split at least MIN_CHUNK positions long."""
    g = h // hkv
    blocks = b * hkv * -(-g // 4)
    want = max(1, -(-2 * sm_count // blocks))
    chunk = max(MIN_CHUNK, -(-s // want))
    chunk = -(-chunk // _TILE_POS) * _TILE_POS
    return chunk, -(-s // chunk)


def _check(q, k, v, length) -> None:
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
    ts = (q, k, v, length)
    if any(t.device != q.device for t in ts):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("all inputs must be contiguous")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ/√D over the first length[b] positions)·v per head."""
    _check(q, k, v, length)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, length)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if d % 32 or not 32 <= d <= 256:
        raise ValueError(f"the kernel takes D in 32..256, a multiple of 32; "
                         f"got {d}")
    if b > 65535 or hkv * -(-(h // hkv) // 4) > 65535:
        raise ValueError("at most 65535 sequences and kv-head groups")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    fn = _lib()
    chunk, n_split = split_plan(b, h, hkv, s, _sm_count(q.device.index
                                                        or 0))
    out = torch.empty_like(q)
    if n_split > 1:
        f32 = dict(dtype=torch.float32, device=q.device)
        part_m = torch.empty((b, h, n_split), **f32)
        part_l = torch.empty((b, h, n_split), **f32)
        part_acc = torch.empty((b, h, n_split, d), **f32)
        ptrs = (part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr())
    else:
        ptrs = (None, None, None)
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
                  out.data_ptr(), *ptrs, b, h, hkv, s, d, chunk, n_split,
                  _DTYPES[q.dtype], build.stream_of(q))
    build.check_launch(code, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
