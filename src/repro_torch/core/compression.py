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


def auto_chunk(n_params: int, n_items: int, budget_mb: float = 1024.0,
               extra_arrays: float = 0.0) -> int:
    """Participant chunk size from the model size and a working-set budget:

        chunk = min(budget_mb, CACHE_TARGET_MB)·2²⁰
                / ((ROUND_WORKSET_ARRAYS + extra_arrays) · 4 · n_params)

    clamped to [min(MIN_AUTO_CHUNK, n_items), n_items] — the reference's
    rule, so both packages run the same chunk stream. ``extra_arrays``
    counts step variants that keep more [chunk, n_params] f32 arrays live:
    error feedback adds ~2 (the gathered residual rows and the new ones)."""
    if n_items <= 0:
        raise ValueError(f"n_items must be positive, got {n_items}")
    if n_params <= 0:
        raise ValueError(f"n_params must be positive, got {n_params}")
    if extra_arrays < 0:
        raise ValueError(f"extra_arrays must be >= 0, got {extra_arrays}")
    bytes_per_item = (ROUND_WORKSET_ARRAYS + extra_arrays) * 4 * n_params
    chunk = int(min(budget_mb, CACHE_TARGET_MB) * 2 ** 20 // bytes_per_item)
    return max(min(MIN_AUTO_CHUNK, n_items), min(chunk, n_items))


# ---------------------------------------------------------------------------
# Stochastic rounding for the bf16 pool (plain torch: the reference leaves
# the cast to XLA)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for int64 ``x`` in [0, 2³²): split in 16-bit halves
    so no int64 product overflows."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash ("lowbias32": xorshift-multiply)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def sr_noise(seed: int, rows: int, n: int, device) -> torch.Tensor:
    """[rows, n] int64 noise in [0, 2¹⁶): the top 16 bits of a counter hash
    of (seed, row, column), ``hash(hash(seed ^ (row+1)·φ) ^ column)`` with
    φ = 0x9E3779B9. Integer ops only, so the CPU and the card draw the same
    bits, and a rerun with the same seed draws them again."""
    seed = int(seed) & _M32
    r = torch.arange(1, rows + 1, dtype=torch.int64, device=device)
    h_row = _hash32(_mul32(r, 0x9E3779B9) ^ seed)
    col = torch.arange(n, dtype=torch.int64, device=device)
    return _hash32(h_row[:, None] ^ col[None, :]) >> 16


def stochastic_round_cast(x: torch.Tensor, dtype: torch.dtype,
                          seed: int) -> torch.Tensor:
    """f32 → ``dtype`` downcast with stochastic rounding (bf16 only).

    Rounds |x| up to the next bf16 with probability equal to its fractional
    position between its two bf16 neighbours (E[round(x)] = x): 16 random
    bits are added below the bf16 mantissa of x's f32 bit pattern before the
    low half is dropped — the reference's
    ``repro.core.compression.stochastic_round_cast``. Exactly representable
    values are fixed points (their low 16 bits are zero, so no carry can
    reach the kept half), which is why masked and padded rows rewrite their
    row unchanged. Non-bf16 targets are a plain cast.

    ``x`` is [rows, n]. The noise comes from `sr_noise` (seed, row,
    column), not from ``jax.random.bits``, so a port bf16 run is NOT bit-
    equal to the reference's; it is bit-equal between the CPU and the card,
    across same-seed reruns and between pipelined and synchronous runs (the
    seed is the (round, chunk) SeedSequence draw)."""
    if dtype != torch.bfloat16:
        return x.to(dtype)
    x2 = _rows(x).to(torch.float32).contiguous()
    bits = x2.view(torch.int32).to(torch.int64) & _M32
    noise = sr_noise(seed, x2.shape[0], x2.shape[1], x2.device)
    r = ((bits + noise) >> 16) & 0xFFFF
    r = r - ((r >> 15) << 16)          # two's complement int16 pattern
    return r.to(torch.int16).view(torch.bfloat16).reshape(x.shape)


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
    # max |x| per row (exact: no abs temporary the size of x)
    max_abs = torch.linalg.vector_norm(xr, float("inf"), dim=-1)
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


# counted in slices of this many elements: a bool sum promotes its input
# to int64 first, 8 bytes per element of a leaf of up to 2^31
_COUNT_SLICE = 1 << 26


def _topk_at(g2: torch.Tensor, thr: torch.Tensor):
    """(sparse [rows, n] in g2's dtype, kept count [rows] int64) at
    ``thr``. ``|g| < thr`` is taken as ``-thr < g < thr`` (the same set
    for thr ≥ 0, NaN never dropped), compared in f32 element by element:
    no f32 copy or |g| of the whole row is made."""
    t = thr.reshape(-1, 1)
    dropped = (g2 < t) & (g2 > -t)
    sparse = torch.where(dropped, 0.0, g2)
    n = g2.shape[-1]
    n_drop = sum(dropped[:, i:i + _COUNT_SLICE].sum(dim=-1)
                 for i in range(0, n, _COUNT_SLICE))
    return sparse, n - n_drop


def topk_sparsify_at(g: torch.Tensor, thr: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k sparsify each row at its precomputed threshold (strict
    ``|g| < thr`` is dropped). ``g`` [rows, n] (or [n] with a 1-element
    ``thr``); returns (sparse, payload bits [rows])."""
    sparse, n_keep = _topk_at(_rows(g), thr)
    return sparse.reshape(g.shape), topk_payload_bits(n_keep)


# ---------------------------------------------------------------------------
# Whole-tensor operators of Track B (one parameter leaf of any shape)
#
# ``group`` (a `launch.mesh.AxisGroup`: ``.size``, a fixed-order ``.sum``
# and an exact ``.max`` over the ranks holding the other shards) makes a
# leaf SHARD's compression that of the whole leaf: max |x| is the max of
# the shards' maxima, the histogram against it is the sum of the shards'
# int32 counts (in int64), so the threshold is the whole leaf's bit for
# bit; the compressed set's count, Σ|x| and max combine the same way and
# the kernels run on the shard. With ``group=None`` (or a group of one
# rank) the leaf is whole.
# ---------------------------------------------------------------------------

def _leaf_row(x: torch.Tensor) -> torch.Tensor:
    """A leaf (or a leaf's shard) as one f32 row [1, numel]: the reference
    thresholds the whole leaf (its ``_bisect_threshold`` reshapes to
    [-1])."""
    n = x.numel()
    if n >= 2 ** 31:
        # the compress kernel counts the compressed set in int32
        raise ValueError(f"a leaf of {n} elements overflows the int32 count "
                         "of the compressed set; shard it")
    return x.reshape(1, n).to(torch.float32)


def _ratio_row(ratio, device) -> torch.Tensor:
    return torch.as_tensor(ratio, dtype=torch.float32).reshape(1).to(device)


def _split(group) -> bool:
    return group is not None and group.size > 1


def _group_threshold(xr: torch.Tensor, ratio: torch.Tensor, group
                     ) -> torch.Tensor:
    """`fused_threshold` of the whole leaf whose shard is ``xr`` [1, n]."""
    max_abs = group.max(torch.linalg.vector_norm(xr, float("inf"), dim=-1))
    hist = group.sum(_tt.magnitude_histogram(xr, max_abs).to(torch.int64))
    cdf = torch.cumsum(hist, dim=-1).to(torch.float32)
    return threshold_from_cdf(cdf, max_abs, ratio)


def fused_hybrid_roundtrip(x: torch.Tensor, local: torch.Tensor, ratio,
                           group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused compress→recover of one leaf against the stale ``local`` (same
    shape), in f32: the threshold from one histogram of the whole leaf,
    then the Fig.-3 sender and receiver. Returns (recovered f32 [x.shape],
    payload bits [1]). With ``group``, ``x`` and ``local`` are this rank's
    shards of the leaf and the bits are the whole leaf's."""
    xr = _leaf_row(x)
    rr = _ratio_row(ratio, xr.device)
    if not _split(group):
        thr = fused_threshold(xr, rr)
        kept, sign, count, sum_abs, max_abs = fused_compress(xr, thr)
        n = x.numel()
    else:
        thr = _group_threshold(xr, rr, group)
        kept, sign, count, sum_abs, max_abs = fused_compress(xr, thr)
        count = group.sum(count.to(torch.int64))
        sum_abs, max_abs = group.sum(sum_abs), group.max(max_abs)
        n = x.numel() * group.size
    del xr
    mean_abs = sum_abs / torch.clamp(count, min=1).to(torch.float32)
    rec = fused_recover(kept, sign, _leaf_row(local), mean_abs, max_abs)
    return rec.reshape(x.shape), hybrid_payload_bits(n, count)


def fused_topk(g: torch.Tensor, ratio, group=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k sparsify one leaf at its whole-leaf histogram threshold.
    Returns (sparse [g.shape] in g's dtype, payload bits [1]); with
    ``group``, of this rank's shard at the whole leaf's threshold, and the
    whole leaf's bits."""
    gr = _leaf_row(g)
    rr = _ratio_row(ratio, g.device)
    split = _split(group)
    thr = (_group_threshold(gr, rr, group) if split
           else fused_threshold(gr, rr))
    del gr                          # the selection reads g in its dtype
    sparse, n_keep = _topk_at(g.reshape(1, -1), thr)
    return (sparse.reshape(g.shape),
            topk_payload_bits(group.sum(n_keep) if split else n_keep))
