"""Caesar's fused compression operators on flat parameter vectors (paper
§4.1 Fig. 3) and the top-k upload transport — the port of the hot-path half
of ``repro.core.compression``.

Thresholds come from a 256-bin magnitude histogram (O(n), one pass), so
per-participant thresholds for the SAME tensor are O(1) lookups in a shared
cdf. Every operator is batched over rows (one row per participant) and
dispatches by the tensor's device: CUDA tensors go to the hand-written
kernels in `repro_torch.kernels`, CPU tensors to their plain twins. That
replaces the reference's string ``backend`` switch; there is no fallback
from a kernel to its twin.

"Compression" in the simulator is *semantic*: the deviation is applied
exactly as the wire format would, and the wire size is accounted
analytically in bits (`hybrid_payload_bits`, `topk_payload_bits`).

ratio θ ∈ [0, 1] is the *compressed fraction*: the θ·n smallest-magnitude
elements are degraded (1-bit signs for the download; zeroed for the top-k
upload). θ=0 ⇒ lossless.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import hybrid_compress as _hc
from repro_torch.kernels import recover as _rc
from repro_torch.kernels import ref as KREF
from repro_torch.kernels import topk_threshold as _tt

FULL_BITS = 32          # full-precision element width (paper transmits fp32)
SIGN_BITS = 1           # 1-bit sign for compressed elements
STAT_BITS = 2 * 32      # (mean_abs, max_abs) scalars per tensor
INDEX_BITS = 32         # index cost per surviving top-k element (upload path)
N_BINS = KREF.N_BINS


# ---------------------------------------------------------------------------
# Flat-parameter representation: the global model is ONE [n_params] f32
# vector and every client-local model a row of a [capacity, n_params] pool.
# FlatSpec is the static layout of the parameter dict inside that vector, in
# the reference's leaf order (sorted names), so offsets match one to one.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static layout of a {name: tensor} dict inside a flat f32 vector."""
    names: tuple
    shapes: tuple
    offsets: tuple
    n_params: int


def flat_spec(shapes: dict) -> FlatSpec:
    """Layout of ``{name: shape}`` with leaves in sorted-name order."""
    names = tuple(sorted(shapes))
    shp = tuple(tuple(shapes[k]) for k in names)
    offsets, off = [], 0
    for s in shp:
        offsets.append(off)
        size = 1
        for d in s:
            size *= d
        off += size
    return FlatSpec(names=names, shapes=shp, offsets=tuple(offsets),
                    n_params=off)


def flatten_vector(tree: dict, spec: FlatSpec) -> torch.Tensor:
    """Concatenate a dict matching ``spec`` into an [n_params] f32 vector."""
    if (tuple(sorted(tree)) != spec.names
            or any(tuple(tree[k].shape) != s
                   for k, s in zip(spec.names, spec.shapes))):
        raise ValueError("tree layout does not match FlatSpec")
    return torch.cat([tree[k].reshape(-1).to(torch.float32)
                      for k in spec.names])


def unflatten_vector(flat: torch.Tensor, spec: FlatSpec) -> dict:
    """{name: view} into ``flat`` ([..., n_params]; leading dims are kept,
    so a [c, n_params] batch gives [c, *shape] views). No copies: writes
    through a view write the flat vector, and autograd flows back to it."""
    lead = tuple(flat.shape[:-1])
    out = {}
    for name, shape, off in zip(spec.names, spec.shapes, spec.offsets):
        size = 1
        for d in shape:
            size *= d
        out[name] = flat[..., off:off + size].view(*lead, *shape)
    return out


# ---------------------------------------------------------------------------
# Chunking of participants (the executor's [chunk, n_params] working set)
# ---------------------------------------------------------------------------

def chunk_layout(n_items: int, chunk: int | None) -> tuple[int, int, int]:
    """(chunk, n_padded, n_chunks) for fixed-size chunking of ``n_items``.
    ``chunk`` is clamped to [1, n_items]; None/0 means one chunk of all."""
    chunk = max(1, min(chunk, n_items) if chunk else n_items)
    n_chunks = -(-n_items // chunk)
    return chunk, n_chunks * chunk, n_chunks


# Live [chunk, n_params] f32 intermediates per in-flight participant in the
# round step (kept / recovered / delta / upload; sign is i8).
ROUND_WORKSET_ARRAYS = 4
MIN_AUTO_CHUNK = 8
# the reference's locality cap, kept so the port picks the same chunk (and
# so the same tier-chunk stream and fold order) for the same config
CACHE_TARGET_MB = 64.0


def auto_chunk(n_params: int, n_items: int, budget_mb: float = 1024.0) -> int:
    """Participant chunk size from the model size and a working-set budget:

        chunk = min(budget_mb, CACHE_TARGET_MB)·2²⁰
                / (ROUND_WORKSET_ARRAYS · 4 · n_params)

    clamped to [min(MIN_AUTO_CHUNK, n_items), n_items] — the reference's
    rule (without its error-feedback term), so both packages run the same
    chunk stream."""
    if n_items <= 0:
        raise ValueError(f"n_items must be positive, got {n_items}")
    if n_params <= 0:
        raise ValueError(f"n_params must be positive, got {n_params}")
    bytes_per_item = ROUND_WORKSET_ARRAYS * 4 * n_params
    chunk = int(min(budget_mb, CACHE_TARGET_MB) * 2 ** 20 // bytes_per_item)
    return max(min(MIN_AUTO_CHUNK, n_items), min(chunk, n_items))


# ---------------------------------------------------------------------------
# Fused hot-path operators, batched over rows
# ---------------------------------------------------------------------------

def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(1, -1) if x.dim() == 1 else x


def fused_histogram_cdf(x: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cdf [rows, N_BINS] f32, max_abs [rows]) of |x| per row ([n] counts
    as one row). The cdf is shared state: thresholds for the SAME tensor at
    many ratios are `threshold_from_cdf` lookups."""
    xr = _rows(x).to(torch.float32).contiguous()
    max_abs = torch.amax(xr.abs(), dim=-1)
    hist = _tt.magnitude_histogram(xr, max_abs)
    return torch.cumsum(hist, dim=-1).to(torch.float32), max_abs


threshold_from_cdf = KREF.threshold_from_cdf


def fused_threshold(x: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """[rows] histogram threshold ≈ quantile(|x_r|, ratio_r) within one bin
    width, one histogram per row."""
    cdf, max_abs = fused_histogram_cdf(x)
    return threshold_from_cdf(cdf, max_abs, ratio)


def fused_compress(x: torch.Tensor, thr: torch.Tensor):
    """Fig.-3 sender per row: (kept, sign_i8, count, sum_abs, max_abs).
    ``x`` is a shared [n] vector or a [rows, n] batch; ``thr`` is [rows]."""
    return _hc.hybrid_compress(x.contiguous(), thr.contiguous())


def fused_recover(kept, sign, local, mean_abs, max_abs) -> torch.Tensor:
    """Fig.-3 receiver per row (sign == 0 marks full-precision slots)."""
    return _rc.recover(kept, sign, local.contiguous(), mean_abs.contiguous(),
                       max_abs.contiguous())


def hybrid_payload_bits(n: int, count: torch.Tensor) -> torch.Tensor:
    """Wire bits of the hybrid format: fp32 survivors + 1-bit signs + stats."""
    count = count.to(torch.float32)
    return (n - count) * FULL_BITS + count * SIGN_BITS + STAT_BITS


def topk_payload_bits(n_keep: torch.Tensor) -> torch.Tensor:
    """Wire bits of sparse top-k: (index, fp32 value) per survivor."""
    return n_keep.to(torch.float32) * (FULL_BITS + INDEX_BITS)


def topk_sparsify_at(g: torch.Tensor, thr: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k sparsify each row at its precomputed threshold (strict
    ``|g| < thr`` is dropped). ``g`` [rows, n] (or [n] with a 1-element
    ``thr``); returns (sparse, payload bits [rows])."""
    g2 = _rows(g).to(torch.float32)
    dropped = g2.abs() < thr.reshape(-1, 1)
    sparse = torch.where(dropped, 0.0, g2).to(g.dtype).reshape(g.shape)
    n_keep = g2.shape[-1] - dropped.sum(dim=-1)
    return sparse, topk_payload_bits(n_keep)
