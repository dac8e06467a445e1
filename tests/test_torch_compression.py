"""repro_torch.core.compression against repro.core.compression: fused
thresholds, compress/recover round trip, top-k transport, payload bits,
chunk layout and the flat-parameter views. All on the CPU (the kernels'
plain twins); exact unless a comparison says otherwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import compression as RC  # noqa: E402
from repro_torch.core import compression as TC  # noqa: E402

RATIOS = np.array([0.0, 0.1, 0.3, 0.6, 0.9, 1.0], np.float32)


def _vec(n, seed, rows=None):
    rng = np.random.default_rng(np.random.SeedSequence(seed, spawn_key=(97,)))
    shape = (n,) if rows is None else (rows, n)
    x = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    x[..., ::31] = 0.0
    return x


@pytest.mark.parametrize("n", [1000, 5000, 164134])
def test_shared_cdf_thresholds_equal_reference(n):
    """One histogram of the global vector, one threshold per ratio — the
    download path — equals the reference's Pallas-histogram lookup."""
    x = _vec(n, 1)
    cdf, mx = TC.fused_histogram_cdf(torch.from_numpy(x))
    got = TC.threshold_from_cdf(cdf, mx, torch.from_numpy(RATIOS)).numpy()
    rcdf, rmx = RC.fused_histogram_cdf(jnp.asarray(x), backend="interpret")
    np.testing.assert_array_equal(cdf[0].numpy(), np.asarray(rcdf))
    assert float(mx[0]) == float(rmx)
    for i, r in enumerate(RATIOS):
        assert got[i] == float(RC.threshold_from_cdf(rcdf, rmx,
                                                     jnp.float32(r)))


def test_per_row_thresholds_equal_reference():
    """One histogram per row — the upload path — equals the reference's
    histogram threshold row by row, and its bisection twin (backend
    "jnp") to within one bin width."""
    x = _vec(3001, 2, rows=len(RATIOS))
    got = TC.fused_threshold(torch.from_numpy(x),
                             torch.from_numpy(RATIOS)).numpy()
    for i, r in enumerate(RATIOS):
        hist_thr = float(RC.fused_threshold(jnp.asarray(x[i]), jnp.float32(r),
                                            backend="interpret"))
        assert got[i] == hist_thr
        bis = float(RC.fused_threshold(jnp.asarray(x[i]), jnp.float32(r),
                                       backend="jnp"))
        assert abs(got[i] - bis) <= np.abs(x[i]).max() / 256 * 1.0001


def test_theta_zero_lossless_and_theta_one_keeps_max():
    x = _vec(5000, 3)
    xt = torch.from_numpy(x)
    cdf, mx = TC.fused_histogram_cdf(xt)
    thr = TC.threshold_from_cdf(cdf, mx, torch.tensor([0.0, 1.0]))
    kept, sign, cnt, ssum, smax = TC.fused_compress(xt, thr)
    # θ = 0: nothing compressed, the payload is the full vector
    assert int(cnt[0]) == 0 and torch.equal(kept[0], xt)
    assert not sign[0].any()
    # θ = 1: the largest-magnitude element always stays full precision
    i = int(np.argmax(np.abs(x)))
    assert sign[1, i] == 0 and kept[1, i] == xt[i]
    assert int(cnt[1]) < x.size
    sparse, bits = TC.topk_sparsify_at(xt[None], thr[:1])
    assert torch.equal(sparse[0], xt)
    assert float(bits[0]) == x.size * 64


@pytest.mark.parametrize("seed", [4, 5])
def test_roundtrip_and_payload_bits_equal_reference(seed):
    x, local = _vec(4099, seed), _vec(4099, seed + 10)
    ratios = np.array([0.2, 0.5], np.float32)
    xt = torch.from_numpy(x)
    cdf, mx = TC.fused_histogram_cdf(xt)
    thr = TC.threshold_from_cdf(cdf, mx, torch.from_numpy(ratios))
    kept, sign, cnt, ssum, smax = TC.fused_compress(xt, thr)
    mean = ssum / torch.clamp(cnt, min=1).float()
    loc = torch.from_numpy(np.stack([local, local]))
    rec = TC.fused_recover(kept, sign, loc, mean, smax)
    bits = TC.hybrid_payload_bits(x.size, cnt)
    for r, ratio in enumerate(ratios):
        t = RC.threshold_from_cdf(*RC.fused_histogram_cdf(jnp.asarray(x)),
                                  jnp.float32(ratio))
        assert float(thr[r]) == float(t)
        rk, rs, rn, rss, rm = RC.fused_compress(jnp.asarray(x), t, "jnp")
        assert int(cnt[r]) == int(rn)
        assert float(bits[r]) == float(RC.hybrid_payload_bits(x.size, rn))
        # recovery given the SAME scalars is exact (the reference's mean
        # differs from ours only by the order of Σ|x|)
        rrec = RC.fused_recover(rk, rs, jnp.asarray(local), mean[r].numpy(),
                                rm, "jnp")
        np.testing.assert_array_equal(rec[r].numpy(), np.asarray(rrec))


def test_topk_sparsify_at_equals_reference():
    g = _vec(3001, 6, rows=3)
    thr = np.array([0.0, 0.02, 0.08], np.float32)
    sparse, bits = TC.topk_sparsify_at(torch.from_numpy(g),
                                       torch.from_numpy(thr))
    for r in range(3):
        rs, rb = RC.topk_sparsify_at(jnp.asarray(g[r]), jnp.float32(thr[r]))
        np.testing.assert_array_equal(sparse[r].numpy(), np.asarray(rs))
        assert float(bits[r]) == float(rb)
        assert float(RC.topk_payload_bits(jnp.int32(7))) == \
            float(TC.topk_payload_bits(torch.tensor(7)))


@pytest.mark.parametrize("n_items,chunk", [(500, None), (3, None), (7, 2),
                                           (10, 0), (64, 25)])
def test_chunk_layout_and_auto_chunk_equal_reference(n_items, chunk):
    assert TC.chunk_layout(n_items, chunk) == RC.chunk_layout(n_items, chunk)
    for n_params in (164134, 1000, 50_000_000):
        assert TC.auto_chunk(n_params, n_items) == \
            RC.auto_chunk(n_params, n_items)


def test_flat_spec_views_share_storage():
    spec = TC.flat_spec({"b": (2, 3), "a": (4,), "c": (1, 2, 2)})
    assert spec.names == ("a", "b", "c") and spec.offsets == (0, 4, 10)
    flat = torch.arange(14, dtype=torch.float32)
    views = TC.unflatten_vector(flat, spec)
    views["b"][1, 2] = -1.0
    assert flat[9] == -1.0
    assert torch.equal(TC.flatten_vector(views, spec), flat)
    batch = torch.zeros(3, 14)
    bv = TC.unflatten_vector(batch, spec)
    assert bv["c"].shape == (3, 1, 2, 2)
    bv["a"][2, 0] = 5.0
    assert batch[2, 0] == 5.0
    with pytest.raises(ValueError):
        TC.flatten_vector({"a": torch.zeros(4)}, spec)
