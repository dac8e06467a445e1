"""Server-side aggregation through the tier engine — the port of
``repro.fl.robust``.

The wire-boundary round replays the EXACT chunk stream the in-process
engine folds — same tier order, same ``[c, n_params]`` chunk shapes, same
weighted left fold — but from *decoded* uploads, so an aggregation policy
can reject or reweight individual clients without ever materializing a
dense ``[P, n_params]`` matrix:

* ``mean`` — the paper's aggregate (Algorithm 1 line 13), the same
  `weighted_row_fold` the in-process step runs, so a zero-fault round is
  bit-identical to it. The divisor is the count of uploads the server
  actually aggregated.
* ``trimmed_mean`` — per-coordinate trimmed mean, streamed: the carry holds
  the running sum plus the ``trim_k`` largest/smallest values seen per
  coordinate (a [trim_k, n_params] pair), merged chunk by chunk.
* ``norm_clip`` — each accepted upload is scaled by min(1, C/‖u‖) before
  the mean fold; ``C=None`` is the round's median accepted-upload norm.
* ``median`` — exact coordinate-wise median over the re-sparsified rows,
  column tile by column tile (zero-inclusive: a top-k upload is exactly
  zero off its support).
* ``krum`` — multi-Krum over the same sparse rows, from the Gram matrix
  accumulated column tile by column tile.

mean, trimmed_mean and norm_clip fold on the aggregator's device in torch
(f32, the carry updated in place); median and Krum are host-side numpy, as
in the reference, and bit-exact whatever the chunk size (their finalize
never sees chunk boundaries). The device folds are chunking-invariant to
rounding: each is a fixed left fold over the row stream, cut where the
chunks fall.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.fl import wire as W

AGGREGATIONS = ("mean", "trimmed_mean", "norm_clip", "median", "krum")


def weighted_row_fold(acc: torch.Tensor, ups: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Left-to-right weighted row accumulation with a FIXED association,
    ``((acc + ups[0]·w[0]) + ups[1]·w[1]) + …``, in place on ``acc``. A
    tree-shaped ``sum`` would change the association with the chunk
    shape; the fold keeps it pinned to the processing order, which is what
    keeps zero-fault wire rounds bit-identical to the in-process step."""
    for i in range(ups.shape[0]):
        acc.add_(ups[i] * w[i])
    return acc


def _mean_finalize(global_f: torch.Tensor, acc: torch.Tensor,
                   cnt: int) -> torch.Tensor:
    """``global − acc / max(cnt, 1)``: the executor's finalizer."""
    denom = torch.full((), float(max(cnt, 1)), dtype=torch.float32,
                       device=global_f.device)
    return global_f - acc / denom


class MeanAggregator:
    """The in-process engine's upload fold, replayed server-side on
    ``device``."""

    needs_norms = False

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            self.device)

    def init(self, n_params: int):
        return torch.zeros(n_params, dtype=torch.float32, device=self.device)

    def update(self, carry, ups, w):
        return weighted_row_fold(carry, self._dev(ups), self._dev(w))

    def finalize(self, global_f, carry, cnt: int):
        return _mean_finalize(global_f, carry, cnt)


class TrimmedMeanAggregator(MeanAggregator):
    """Per-coordinate trimmed mean over the chunk stream. The carry is
    (sum [n], hi [trim_k, n], lo [trim_k, n]); each chunk merges its valid
    rows into the extreme buffers (masked rows enter as ∓inf so they never
    survive). Finalize subtracts the finite extremes per coordinate and
    renormalizes by the surviving count."""

    def __init__(self, trim_k: int, device="cuda"):
        super().__init__(device)
        if trim_k < 1:
            raise ValueError(f"trim_k must be >= 1, got {trim_k}")
        self.trim_k = int(trim_k)

    def init(self, n_params: int):
        full = lambda v: torch.full((self.trim_k, n_params), v,  # noqa: E731
                                    dtype=torch.float32, device=self.device)
        return (super().init(n_params), full(-torch.inf), full(torch.inf))

    def update(self, carry, ups, w):
        s, hi, lo = carry
        ups, w = self._dev(ups), self._dev(w)
        weighted_row_fold(s, ups, w)
        valid = w[:, None] > 0
        k = self.trim_k
        hi = torch.topk(torch.cat([hi, torch.where(valid, ups, -torch.inf)]),
                        k, dim=0).values
        lo = torch.topk(torch.cat([lo, torch.where(valid, ups, torch.inf)]),
                        k, dim=0, largest=False).values
        return s, hi, lo

    def finalize(self, global_f, carry, cnt: int):
        s, hi, lo = carry
        hi_fin, lo_fin = torch.isfinite(hi), torch.isfinite(lo)
        trimmed = (s - torch.where(hi_fin, hi, 0.0).sum(0)
                   - torch.where(lo_fin, lo, 0.0).sum(0))
        kept = float(cnt) - (hi_fin.sum(0) + lo_fin.sum(0)).to(torch.float32)
        return global_f - trimmed / torch.clamp(kept, min=1.0)


class NormClipAggregator(MeanAggregator):
    """Mean fold with per-upload norm clipping: the server computes each
    accepted upload's norm from its decoded sparse values and folds
    min(1, C/‖u‖) into the row weight. A clipped row still counts as one
    upload in the divisor."""

    needs_norms = True

    def __init__(self, clip_norm: float | None = None, device="cuda"):
        super().__init__(device)
        self.clip_norm = clip_norm

    def scales(self, norms: np.ndarray) -> np.ndarray:
        """Per-upload weights for this round, given every accepted
        upload's norm (median-of-round when no fixed C is configured)."""
        norms = np.asarray(norms, np.float64)
        if not len(norms):
            return np.zeros(0, np.float32)
        c = (float(np.median(norms)) if self.clip_norm is None
             else float(self.clip_norm))
        return np.minimum(1.0, c / np.maximum(norms, 1e-30)) \
            .astype(np.float32)


class SparseRowAggregator:
    """Shared base for the order-statistic aggregators (median, Krum):
    ``update`` re-sparsifies each valid chunk row back to (indices,
    values), so the carry is the round's sparse row list, never a dense
    ``[P, n_params]`` matrix; ``_tiles`` densifies ``[n_rows, tile]``
    column blocks for finalize. Rows are appended in chunk-stream order,
    the same total order whatever the chunk sizes."""

    needs_norms = False

    def __init__(self, tile: int = 4096):
        if tile < 1:
            raise ValueError(f"tile={tile} < 1")
        self.tile = int(tile)

    def init(self, n_params: int):
        return {"n": int(n_params), "rows": []}

    def update(self, carry, ups: np.ndarray, w: np.ndarray):
        ups = np.asarray(ups, np.float32)
        for i in np.flatnonzero(np.asarray(w) > 0):
            row = ups[i]
            idx = np.flatnonzero(row).astype(np.int64)
            carry["rows"].append((idx, row[idx].astype(np.float32)))
        return carry

    def add_sparse(self, carry, indices: np.ndarray, values: np.ndarray):
        """Append one already-sparse upload."""
        order = np.argsort(indices, kind="stable")
        carry["rows"].append((np.asarray(indices, np.int64)[order],
                              np.asarray(values, np.float32)[order]))
        return carry

    def _tiles(self, carry):
        """Yield (j0, j1, block [n_rows, j1-j0] f32) column tiles."""
        rows, n = carry["rows"], carry["n"]
        for j0 in range(0, n, self.tile):
            j1 = min(j0 + self.tile, n)
            block = np.zeros((len(rows), j1 - j0), np.float32)
            for r, (idx, vals) in enumerate(rows):
                lo, hi = np.searchsorted(idx, (j0, j1))
                block[r, idx[lo:hi] - j0] = vals[lo:hi]
            yield j0, j1, block

    @staticmethod
    def _apply(global_f: torch.Tensor, delta: np.ndarray) -> torch.Tensor:
        return global_f - torch.from_numpy(delta).to(global_f.device)


class MedianAggregator(SparseRowAggregator):
    """Exact coordinate-wise median over the round's accepted uploads,
    computed per column tile at finalize."""

    def finalize(self, global_f, carry, cnt: int):
        med = np.zeros(carry["n"], np.float32)
        if carry["rows"]:
            for j0, j1, block in self._tiles(carry):
                med[j0:j1] = np.median(block, axis=0).astype(np.float32)
        return self._apply(global_f, med)


class KrumAggregator(SparseRowAggregator):
    """Multi-Krum over the round's accepted uploads: each upload is scored
    by the sum of its n−f−2 smallest squared distances to the others (from
    the Gram matrix over column tiles); the aggregate is the mean of the
    ``m`` best-scoring uploads (default m = n−f−2)."""

    def __init__(self, f: int, m: int | None = None, tile: int = 4096):
        super().__init__(tile=tile)
        if f < 0:
            raise ValueError(f"krum f={f} must be >= 0")
        if m is not None and m < 1:
            raise ValueError(f"krum m={m} must be >= 1")
        self.f = int(f)
        self.m = None if m is None else int(m)

    def finalize(self, global_f, carry, cnt: int):
        rows, n = carry["rows"], carry["n"]
        r = len(rows)
        out = np.zeros(n, np.float32)
        if r == 0:
            return self._apply(global_f, out)
        gram = np.zeros((r, r), np.float64)
        for _j0, _j1, block in self._tiles(carry):
            gram += block @ block.T
        sq = np.diag(gram).copy()
        d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * gram, 0.0)
        np.fill_diagonal(d2, np.inf)            # self-distance never counts
        n_neigh = max(1, r - self.f - 2)
        neigh = np.sort(d2, axis=1)[:, :min(n_neigh, r - 1)] if r > 1 \
            else np.zeros((1, 1))
        scores = neigh.sum(axis=1)
        m = self.m if self.m is not None else max(1, r - self.f - 2)
        m = min(m, r)
        sel = set(np.argsort(scores, kind="stable")[:m].tolist())
        mask = np.array([i in sel for i in range(r)], bool)
        for j0, j1, block in self._tiles(carry):
            out[j0:j1] = (block[mask].sum(axis=0) / np.float32(m))
        return self._apply(global_f, out)


def make_aggregator(name: str, *, cohort: int, trim_frac: float = 0.1,
                    clip_norm: float | None = None,
                    krum_f: int | None = None, krum_m: int | None = None,
                    device="cuda"):
    """The aggregator ``name`` for a cohort of ``cohort``; the device folds
    run on ``device``."""
    if name == "mean":
        return MeanAggregator(device)
    if name == "trimmed_mean":
        trim_k = max(1, int(round(trim_frac * cohort)))
        if 2 * trim_k >= cohort:
            raise ValueError(
                f"trim_frac={trim_frac} trims 2×{trim_k} of a {cohort}-"
                "participant cohort — nothing left to average")
        return TrimmedMeanAggregator(trim_k, device)
    if name == "norm_clip":
        return NormClipAggregator(clip_norm, device)
    if name == "median":
        return MedianAggregator()
    if name == "krum":
        if cohort < 3:
            raise ValueError(f"krum needs a cohort of >= 3 "
                             f"(got {cohort}) to score neighbors")
        f = (max(1, int(round(trim_frac * cohort)))
             if krum_f is None else int(krum_f))
        if f > cohort - 3:
            raise ValueError(
                f"krum f={f} leaves no neighbors in a {cohort}-participant "
                "cohort (need f <= cohort - 3)")
        return KrumAggregator(f=f, m=krum_m)
    raise ValueError(f"unknown aggregation {name!r}; "
                     f"want one of {AGGREGATIONS}")


def decode_and_aggregate(payloads, n_params: int, agg=None,
                         chunk: int = 64, device="cuda"):
    """Server hot loop over a batch of serialized uploads: decode + CRC
    check each, fold through the aggregator (default: the mean on
    ``device``). Returns (aggregate delta [n_params] numpy, n_ok, n_bad).

    Sparse aggregators (median, Krum) take each decoded upload via
    ``add_sparse``; ``needs_norms`` aggregators (norm_clip) buffer the
    decoded uploads sparse until every norm is known; everything else
    streams through [chunk, n_params] dense blocks."""
    agg = agg or MeanAggregator(device)
    carry = agg.init(n_params)
    n_ok = n_bad = 0

    def decoded():
        nonlocal n_ok, n_bad
        for payload in payloads:
            try:
                u = W.decode_upload(payload)
            except W.WireError:
                n_bad += 1
                continue
            n_ok += 1
            yield u

    if isinstance(agg, SparseRowAggregator):
        for u in decoded():
            carry = agg.add_sparse(carry, u.indices, u.values)
    else:
        if agg.needs_norms:
            pend = [(u.indices, u.values) for u in decoded()]
            scales = agg.scales(np.array(
                [np.linalg.norm(np.asarray(v, np.float64))
                 for _idx, v in pend]))
            batches = ((pend[s:s + chunk], scales[s:s + chunk])
                       for s in range(0, len(pend), chunk))
        else:
            def _stream():
                buf = []
                for u in decoded():
                    buf.append((u.indices, u.values))
                    if len(buf) == chunk:
                        yield buf, np.ones(chunk, np.float32)
                        buf = []
                if buf:
                    yield buf, np.ones(len(buf), np.float32)
            batches = _stream()
        dense = np.zeros((chunk, n_params), np.float32)
        w = np.zeros(chunk, np.float32)
        for rows, ws in batches:
            dense[:] = 0.0
            w[:] = 0.0
            for r, (idx, vals) in enumerate(rows):
                dense[r, idx] = vals
            w[:len(rows)] = ws
            carry = agg.update(carry, dense, w)
    # the device folds finalize on their device, median/Krum on the host
    dev = getattr(agg, "device", torch.device("cpu"))
    zero = torch.zeros(n_params, dtype=torch.float32, device=dev)
    delta = agg.finalize(zero, carry, max(n_ok, 1)).cpu().numpy()
    return -delta, n_ok, n_bad
