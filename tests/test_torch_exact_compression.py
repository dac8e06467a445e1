"""The exact-quantile operators of repro_torch.core.compression against
repro.core.compression's reference operators, on seeded numpy inputs of
n = 7, 1,000 and 164,134 at ratios 0, 1 and between, on the CPU.

Thresholds, masks, kept values, signs, max_abs, payload bits, top-k and
error feedback are bit-equal; mean_abs (and so the recovered fallback
slots, sign·mean_abs) is held to rtol 1e-5, the kernels' bound for Σ|x|
summed in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import compression as RC  # noqa: E402
from repro_torch.core import compression as TC  # noqa: E402

SIZES = [7, 1000, 164134]
RATIOS = [0.0, 0.05, 0.3, 0.5, 0.77, 0.999, 1.0]
MEAN_RTOL = 1e-5


def _vec(n, seed):
    """Heavy-tailed f32 magnitudes with exact zeros (ties at the bottom)."""
    rng = np.random.default_rng(np.random.SeedSequence(seed, spawn_key=(5,)))
    x = (rng.standard_normal(n) * np.exp(rng.standard_normal(n))
         ).astype(np.float32)
    x[::13] = 0.0
    return x


def _bits(a) -> bytes:
    return np.asarray(a, np.float32).tobytes()


@pytest.mark.parametrize("n", SIZES)
def test_thresholds_and_masks_are_the_references(n):
    x = _vec(n, n)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for r in RATIOS:
        got = TC.magnitude_threshold(xt, r)
        assert got.dtype == torch.float32 and got.shape == ()
        assert _bits(got.numpy()) == _bits(RC.magnitude_threshold(xj, r)), r
        np.testing.assert_array_equal(TC.compress_mask(xt, r).numpy(),
                                      np.asarray(RC.compress_mask(xj, r)))
    # a tensor ratio is the same ratio
    assert _bits(TC.magnitude_threshold(xt, torch.tensor(0.3)).numpy()) == \
        _bits(RC.magnitude_threshold(xj, 0.3))


def test_the_blend_keeps_the_fmas_single_rounding():
    """Where two rounded products and a sum miss the reference by an ulp,
    the port does not: the single rounding matters."""
    x = np.random.default_rng(0).standard_normal(7).astype(np.float32)
    want = np.float32(RC.magnitude_threshold(jnp.asarray(x), 0.05))
    mag = np.sort(np.abs(x))
    pos = np.float32(0.05) * np.float32(6)
    w = pos - np.floor(pos)
    naive = (mag[int(np.floor(pos))] * (np.float32(1) - w)
             + mag[int(np.ceil(pos))] * w).astype(np.float32)
    assert naive != want
    assert _bits(TC.magnitude_threshold(torch.from_numpy(x), 0.05).numpy()
                 ) == _bits(want)


def test_fma_emulation_rounds_once():
    """`_fma32` against the exact product and sum (Python's rationals)
    rounded once to f32, on values whose two-step rounding differs."""
    from fractions import Fraction
    rng = np.random.default_rng(3)
    a, b, c = (rng.standard_normal(4000).astype(np.float32)
               for _ in range(3))
    got = TC._fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        # the nearest f32 to the exact value (ties to even)
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        errs = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(errs)
        near = [v for v, e in zip(cands, errs) if e == best]
        want = near[0] if len(near) == 1 else next(
            v for v in near if not np.float32(v).view(np.int32) & 1)
        assert got[i] == want, (a[i], b[i], c[i])


@pytest.mark.parametrize("n", SIZES)
def test_hybrid_compress_and_recover(n):
    x = _vec(n, 10 + n)
    rng = np.random.default_rng(n)
    local = (x + rng.standard_normal(n).astype(np.float32)
             * np.float32(0.3)).astype(np.float32)
    local[::17] = 0.0
    xt, lt = torch.from_numpy(x), torch.from_numpy(local)
    xj, lj = jnp.asarray(x), jnp.asarray(local)
    for r in RATIOS:
        c, cr = TC.hybrid_compress(xt, r), RC.hybrid_compress(xj, r)
        np.testing.assert_array_equal(c.mask.numpy(), np.asarray(cr.mask))
        np.testing.assert_array_equal(c.kept.numpy(), np.asarray(cr.kept))
        np.testing.assert_array_equal(c.sign.numpy(), np.asarray(cr.sign))
        assert c.sign.dtype == torch.int8
        assert _bits(c.max_abs.numpy()) == _bits(cr.max_abs)
        np.testing.assert_allclose(float(c.mean_abs), float(cr.mean_abs),
                                   rtol=MEAN_RTOL)
        assert int(c.payload_bits()) == int(cr.payload_bits())
        rec = TC.hybrid_recover(c, lt).numpy()
        want = np.asarray(RC.hybrid_recover(cr, lj))
        sign = np.asarray(cr.sign).astype(np.float32)
        fallback = np.asarray(cr.mask) & (
            (np.sign(local) * sign < 0) | (np.abs(local) > float(cr.max_abs)))
        np.testing.assert_array_equal(rec[~fallback], want[~fallback])
        np.testing.assert_allclose(rec[fallback], want[fallback],
                                   rtol=MEAN_RTOL)
        rec2, bits = TC.hybrid_roundtrip(xt, lt, r)
        np.testing.assert_array_equal(rec2.numpy(), rec)
        assert int(bits) == int(RC.hybrid_roundtrip(xj, lj, r)[1])


@pytest.mark.parametrize("n", SIZES)
def test_topk_sparsify(n):
    g = _vec(n, 20 + n)
    for r in RATIOS:
        sp, bits = TC.topk_sparsify(torch.from_numpy(g), r)
        spr, bitsr = RC.topk_sparsify(jnp.asarray(g), r)
        np.testing.assert_array_equal(sp.numpy(), np.asarray(spr))
        assert int(bits) == int(bitsr)


def _trees(seed, scale=1.0):
    """The same nested dict with an empty (None) subtree, for each side."""
    rng = np.random.default_rng(seed)
    leaves = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    arr = {k: (rng.standard_normal(s) * scale).astype(np.float32)
           for k, s in leaves.items()}
    tree = {"z": arr["b"], "m": {"w": arr["a"], "empty": None, "k": arr["c"]}}

    def conv(t, f):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: conv(v, f) for k, v in t.items()}
        return f(t)
    return conv(tree, torch.from_numpy), conv(tree, jnp.asarray)


def _equal_trees(got, want):
    if want is None:
        assert got is None
        return
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal_trees(got[k], want[k])
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tree_wrappers_over_a_tree_with_an_empty_subtree():
    (tt, tj), (lt, lj) = _trees(1), _trees(2, 0.5)
    assert TC.tree_payload_bits_dense(tt) == RC.tree_payload_bits_dense(tj)
    for r in (0.0, 0.4, 1.0):
        sp, bits = TC.tree_topk_sparsify(tt, r)
        spr, bitsr = RC.tree_topk_sparsify(tj, r)
        _equal_trees(sp, spr)
        assert int(bits) == int(bitsr)
        rec, bits = TC.tree_hybrid_roundtrip(tt, lt, r)
        recr, bitsr = RC.tree_hybrid_roundtrip(tj, lj, r)
        assert int(bits) == int(bitsr)
        _equal_trees(rec["m"]["empty"], None)
        for k in ("z",):
            np.testing.assert_allclose(rec[k].numpy(), np.asarray(recr[k]),
                                       rtol=MEAN_RTOL)
        for k in ("w", "k"):
            np.testing.assert_allclose(rec["m"][k].numpy(),
                                       np.asarray(recr["m"][k]),
                                       rtol=MEAN_RTOL)


@pytest.mark.parametrize("enabled", [True, False])
def test_ef_compress(enabled):
    (gt, gj), (et, ej) = _trees(3), _trees(4, 0.1)
    sp, ef, bits = TC.ef_compress(gt, et, 0.35, enabled)
    spr, efr, bitsr = RC.ef_compress(gj, ej, 0.35, enabled)
    _equal_trees(sp, spr)
    _equal_trees(ef, efr)
    assert int(bits) == int(bitsr)
