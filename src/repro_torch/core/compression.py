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

# the compress kernel counts its row's compressed set in int32 (and the
# histogram each bin): a longer leaf row goes through the kernels in
# pieces of at most this many elements (a multiple of 1024, so every piece
# starts on a 16-byte boundary), combined as the shards of a group are
_PIECE = 2 ** 31 - 2 ** 20


def _leaf_row(x: torch.Tensor) -> torch.Tensor:
    """A leaf (or a leaf's shard) as one f32 row [1, numel]: the reference
    thresholds the whole leaf (its ``_bisect_threshold`` reshapes to
    [-1])."""
    return x.reshape(1, x.numel()).to(torch.float32)


def _pieces(xr: torch.Tensor) -> list:
    """[1, n] as views [1, m] of at most `_PIECE` elements each."""
    n = xr.shape[1]
    if n <= _PIECE:
        return [xr]
    m = -(-n // -(-n // _PIECE))
    m = -(-m // 1024) * 1024
    return [xr[:, i:i + m] for i in range(0, n, m)]


def _ratio_row(ratio, device) -> torch.Tensor:
    return torch.as_tensor(ratio, dtype=torch.float32).reshape(1).to(device)


def _split(group) -> bool:
    return group is not None and group.size > 1


def _fold(xs: list) -> torch.Tensor:
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc


def _max(xs: list) -> torch.Tensor:
    return xs[0] if len(xs) == 1 else torch.amax(torch.stack(xs), dim=0)


def _group_threshold(xr: torch.Tensor, ratio: torch.Tensor, group
                     ) -> torch.Tensor:
    """`fused_threshold` of the whole leaf whose shard is ``xr`` [1, n]
    (its pieces' maxima and int64 histograms combined, then the shards',
    over ``group`` where it splits the leaf)."""
    pieces = _pieces(xr)
    max_abs = _max([torch.linalg.vector_norm(p, float("inf"), dim=-1)
                    for p in pieces])
    if _split(group):
        max_abs = group.max(max_abs)
    hist = _fold([_tt.magnitude_histogram(p, max_abs).to(torch.int64)
                  for p in pieces])
    if _split(group):
        hist = group.sum(hist)
    cdf = torch.cumsum(hist, dim=-1).to(torch.float32)
    return threshold_from_cdf(cdf, max_abs, ratio)


def fused_hybrid_roundtrip(x: torch.Tensor, local: torch.Tensor, ratio,
                           group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused compress→recover of one leaf against the stale ``local`` (same
    shape), in f32: the threshold from one histogram of the whole leaf,
    then the Fig.-3 sender and receiver. Returns (recovered f32 [x.shape],
    payload bits [1]). With ``group``, ``x`` and ``local`` are this rank's
    shards of the leaf and the bits are the whole leaf's. A row of more
    than `_PIECE` elements goes through the kernels in pieces whose
    counts, sums and maxima combine as the shards' do."""
    xr = _leaf_row(x)
    rr = _ratio_row(ratio, xr.device)
    split = _split(group)
    if not split and xr.shape[1] <= _PIECE:
        thr = fused_threshold(xr, rr)
        kept, sign, count, sum_abs, max_abs = fused_compress(xr, thr)
        n = x.numel()
        outs = [(kept, sign)]
    else:
        thr = _group_threshold(xr, rr, group)
        parts = [fused_compress(p, thr) for p in _pieces(xr)]
        outs = [pt[:2] for pt in parts]
        count = _fold([pt[2].to(torch.int64) for pt in parts])
        sum_abs = _fold([pt[3] for pt in parts])
        max_abs = _max([pt[4] for pt in parts])
        del parts
        n = x.numel()
        if split:
            count = group.sum(count)
            sum_abs, max_abs = group.sum(sum_abs), group.max(max_abs)
            n *= group.size
    del xr
    mean_abs = sum_abs / torch.clamp(count, min=1).to(torch.float32)
    lr = _leaf_row(local)
    if len(outs) == 1:
        rec = fused_recover(outs[0][0], outs[0][1], lr, mean_abs, max_abs)
    else:
        rec = torch.cat([fused_recover(k, sg, lp, mean_abs, max_abs)
                         for (k, sg), lp in zip(outs, _pieces(lr))], dim=1)
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
    thr = (_group_threshold(gr, rr, group)
           if split or gr.shape[1] > _PIECE else fused_threshold(gr, rr))
    del gr                          # the selection reads g in its dtype
    sparse, n_keep = _topk_at(g.reshape(1, -1), thr)
    return (sparse.reshape(g.shape),
            topk_payload_bits(group.sum(n_keep) if split else n_keep))


# ---------------------------------------------------------------------------
# Exact-quantile operators: the reference's "reference operators"
# (``repro.core.compression`` :48–147 and :316–360), which define the
# semantics its property tests pin down and its round benchmark times.
# Plain torch on any device: O(n log n) sorts, no kernel (the reference
# computes them outside any Pallas kernel too). The fused operators above
# are the hot path.
#
# The threshold is ``jnp.quantile(|x|, clip(ratio, 0, 1))`` as XLA computes
# it, bit for bit: q·(n − 1) in f32, its floor and ceil as the ranks, the
# weight w = q·(n − 1) − floor, and the linear blend that XLA on the CPU
# evaluates as fma(high, w, round(low·(1 − w))). A one-ulp threshold moves
# elements across the strict ``|x| < thr``, so the blend keeps that FMA's
# single rounding (`_fma32`) rather than two products and a sum.
# ---------------------------------------------------------------------------

_VELTKAMP = 4097.0      # 2^12 + 1: splits a 24-bit significand in halves


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """(s, e) with s = RN(a + b) and a + b = s + e exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """(p, e) with p = RN(a·b) and a·b = p + e exactly (Dekker, with
    Veltkamp's split of each factor into two 12-bit halves)."""
    p = a * b
    ca, cb = a * _VELTKAMP, b * _VELTKAMP
    ah, bh = ca - (ca - a), cb - (cb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
           ) -> torch.Tensor:
    """f32 a·b + c rounded once, as a fused multiply-add rounds it.

    PyTorch has no fma, Python 3.12 no ``math.fma``, and an f64 sum
    rounded to f32 can round twice, so the single rounding is built from
    f32 operations only (Boldo and Melquiond, "Emulation of FMA and
    correctly rounded sums: proved algorithms using rounding to odd",
    IEEE TC 2008): the exact product a·b = uh + ul and the exact sum
    c + uh = th + tl, then v = tl + ul rounded to odd (of the two f32
    values around the exact sum, the one with an odd significand, when
    the sum is inexact), and RN(th + v) is RN(a·b + c). Every step is one
    IEEE f32 operation in its own PyTorch op, so the CPU and the card
    give the same bits and no f64 value touches a device buffer. Exact
    while nothing underflows or overflows (|a|, |b| under 8e34)."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, e = _two_sum(tl, ul)
    even = (v.view(torch.int32) & 1) == 0
    toward = torch.nextafter(v, torch.where(e > 0, torch.full_like(
        v, float("inf")), torch.full_like(v, float("-inf"))))
    v = torch.where((e != 0) & even, toward, v)
    return th + v


def _ratio_scalar(ratio, device) -> torch.Tensor:
    """``ratio`` as a 0-d f32 tensor on ``device`` (a Python number is
    rounded to f32 once, as jnp rounds it; no host-to-device copy)."""
    if isinstance(ratio, torch.Tensor):
        return ratio.reshape(()).to(device=device, dtype=torch.float32)
    return torch.full((), float(ratio), dtype=torch.float32, device=device)


def magnitude_threshold(x: torch.Tensor, ratio) -> torch.Tensor:
    """0-d f32 |x| value below which elements fall into the compressed
    set: the exact ``ratio`` quantile of |x| (``jnp.quantile``'s linear
    method, bit for bit; NaN if any |x| is NaN). One sort, so any size
    (``torch.quantile`` refuses more than 2^24 elements)."""
    mag = torch.abs(x.reshape(-1)).to(torch.float32)
    dev, n = mag.device, mag.numel()
    q = torch.clamp(_ratio_scalar(ratio, dev), 0.0, 1.0)
    last = torch.full((), float(n), dtype=torch.float32, device=dev) - 1
    pos = q * last
    low, high = torch.floor(pos), torch.ceil(pos)
    w = pos - low
    # the ranks as jnp takes them: clamped in f32 to [0, f32(n) − 1], then
    # to the last element (a gather clamps its start index)
    ranks = torch.stack([torch.clamp(low, min=0.0), torch.clamp(high,
                                                                min=0.0)])
    ranks = torch.minimum(ranks, last).to(torch.int64).clamp_(0, n - 1)
    lo_v, hi_v = torch.sort(mag).values.index_select(0, ranks)
    thr = _fma32(hi_v, w, lo_v * (1 - w))
    return torch.where(torch.isnan(mag).any(),
                       torch.full_like(thr, float("nan")), thr)


def compress_mask(x: torch.Tensor, ratio) -> torch.Tensor:
    """Bool mask, True where the element is in the *compressed* (small)
    set. Strict < keeps at least the max element at ratio 1 and makes
    ratio 0 (thr = min|x|) compress nothing when all magnitudes differ."""
    thr = magnitude_threshold(x, ratio)
    # compared in f32 as jnp promotes it (torch would round a 0-d f32
    # threshold to a bf16 x's dtype)
    return torch.abs(x).to(torch.float32) < thr


@dataclasses.dataclass
class HybridCompressed:
    """Semantic form of the Fig.-3 wire format for one tensor."""
    kept: torch.Tensor       # x where full precision, 0 where compressed
    sign: torch.Tensor       # int8 sign (+1/-1) where compressed, else 0
    mean_abs: torch.Tensor   # 0-d f32: mean |x| over the compressed set
    max_abs: torch.Tensor    # 0-d f32: max |x| over the compressed set
    mask: torch.Tensor       # bool: True where compressed

    def payload_bits(self) -> torch.Tensor:
        """0-d int64 (the reference's int32 overflows past 2^26 elements)."""
        n_comp = torch.sum(self.mask)
        n_keep = self.mask.numel() - n_comp
        return n_keep * FULL_BITS + n_comp * SIGN_BITS + STAT_BITS


def hybrid_compress(x: torch.Tensor, ratio) -> HybridCompressed:
    """Compress: the θ smallest-|x| elements → 1-bit sign + (mean, max)
    stats. ``mean_abs`` sums in PyTorch's order, not XLA's (rtol 1e-5);
    everything else is the reference's bit for bit."""
    mask = compress_mask(x, ratio)
    absx = torch.abs(x)
    n = torch.clamp(torch.sum(mask), min=1)
    small = torch.where(mask, absx, 0.0)
    mean_abs = torch.sum(small) / n
    max_abs = torch.amax(small)
    sign = torch.where(mask, torch.sign(x), 0.0).to(torch.int8)
    kept = torch.where(mask, 0.0, x).to(x.dtype)
    return HybridCompressed(kept=kept, sign=sign,
                            mean_abs=mean_abs.to(torch.float32),
                            max_abs=max_abs.to(torch.float32), mask=mask)


def hybrid_recover(c: HybridCompressed, local: torch.Tensor) -> torch.Tensor:
    """Fig.-3 recovery with the receiver's stale ``local`` tensor: a
    compressed slot takes the local value unless its sign contradicts the
    transmitted sign (a local zero agrees) or its magnitude exceeds
    max_abs; then sign·mean_abs."""
    sgn = c.sign.to(local.dtype)
    sign_bad = torch.sign(local) * sgn < 0
    mag_bad = torch.abs(local) > c.max_abs
    fallback = sgn * c.mean_abs.to(local.dtype)
    approx = torch.where(sign_bad | mag_bad, fallback, local)
    return torch.where(c.mask, approx, c.kept.to(local.dtype))


def hybrid_roundtrip(x: torch.Tensor, local: torch.Tensor, ratio
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """compress→recover in one call: (recovered, payload bits)."""
    c = hybrid_compress(x, ratio)
    return hybrid_recover(c, local), c.payload_bits()


def topk_sparsify(g: torch.Tensor, ratio
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero the θ smallest-|g| elements: (sparse g, payload bits), an
    (index, f32 value) pair per survivor."""
    mask = compress_mask(g, ratio)                 # True = dropped
    sparse = torch.where(mask, 0.0, g).to(g.dtype)
    n_keep = g.numel() - torch.sum(mask)
    return sparse, n_keep * (FULL_BITS + INDEX_BITS)


# Trees: nested dicts of tensors in sorted-key order, a None an empty
# subtree (`fl.distributed.tree_map`'s trees), flattened to one f32 vector
# so the ratio is one of the whole model payload, as the paper's.

def _tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    return [tree]


def _flatten(tree) -> torch.Tensor:
    return torch.cat([x.reshape(-1).to(torch.float32)
                      for x in _tree_leaves(tree)])


def _unflatten(flat: torch.Tensor, like):
    """``flat`` cut back into ``like``'s leaves, shapes and dtypes."""
    off = 0

    def rebuild(t):
        nonlocal off
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: rebuild(t[k]) for k in sorted(t)}
        out = flat[off:off + t.numel()].reshape(t.shape).to(t.dtype)
        off += t.numel()
        return out

    return rebuild(like)


def tree_hybrid_roundtrip(tree, local_tree, ratio):
    """Whole-model download compression with one global threshold:
    (recovered tree, payload bits)."""
    rec, bits = hybrid_roundtrip(_flatten(tree), _flatten(local_tree), ratio)
    return _unflatten(rec, tree), bits


def tree_topk_sparsify(tree, ratio):
    sparse, bits = topk_sparsify(_flatten(tree), ratio)
    return _unflatten(sparse, tree), bits


def tree_payload_bits_dense(tree) -> int:
    """Uncompressed fp32 payload of a tree, in bits."""
    return sum(x.numel() for x in _tree_leaves(tree)) * FULL_BITS


def _tree_zip(fn, a, b):
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: _tree_zip(fn, a[k], b[k]) for k in sorted(a)}
    return fn(a, b)


def ef_compress(g, ef, ratio, enabled: bool = True):
    """Error-feedback top-k: compress (g + ef), stash the residual back in
    ef. Returns (sparse tree, new ef, payload bits)."""
    if not enabled:
        sparse, bits = tree_topk_sparsify(g, ratio)
        return sparse, ef, bits
    corrected = _tree_zip(lambda a, b: a + b, g, ef)
    sparse, bits = tree_topk_sparsify(corrected, ratio)
    return sparse, _tree_zip(lambda c, s: c - s, corrected, sparse), bits
