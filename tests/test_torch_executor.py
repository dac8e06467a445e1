"""repro_torch RoundExecutor against the reference executor: one tier chunk
with identical inputs (global vector, stale pool rows, batches, masks, ratios,
lr), and the tier/chunk layout.

The reference runs at backend="interpret" — the Pallas kernels through the
interpreter, as tests/test_kernels.py runs them — so both sides pick the
upload threshold from a histogram. Tolerances:
* download bits: EXACT (one histogram of identical global vectors, count of
  a strict compare);
* uploads and new pool rows: atol 1e-6 — τ SGD steps through two
  frameworks' convolutions differ by f32 rounding (measured ≤ 9e-8 here);
* upload bits: rtol 1e-5 — the upload threshold is a histogram bin edge of
  a delta that differs by rounding, so an element on a bin edge may land on
  the other side (64 bits of ~10^7; measured exact here);
* upload-delta norms: rtol 2e-5 — XLA sums 164k squares in another order
  than PyTorch's norm (measured 2.6e-6).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.caesar import CaesarConfig as RCaesar  # noqa: E402
from repro.fl import simulation as RSIM  # noqa: E402
from repro_torch.core.caesar import CaesarConfig as TCaesar  # noqa: E402
from repro_torch.fl import simulation as TSIM  # noqa: E402
from repro_torch.fl.state import ClientStateStore  # noqa: E402
from repro_torch.models.paper_models import from_reference  # noqa: E402

KW = dict(dataset="har", n_clients=12, participation=0.25, rounds=1,
          data_scale=0.2, seed=1)


@pytest.fixture(scope="module")
def pair():
    ref = RSIM.Simulator(RSIM.SimConfig(backend="interpret",
                                        caesar=RCaesar(tau=2, b_max=8), **KW))
    port = TSIM.Simulator(TSIM.SimConfig(device="cpu",
                                         caesar=TCaesar(tau=2, b_max=8), **KW),
                          init_flat=from_reference(np.asarray(ref.flat0)))
    return ref, port


def _inputs(n, seed=3, c=4, tau=2, b=8, cap=6):
    rng = np.random.default_rng(np.random.SeedSequence(seed, spawn_key=(90,)))
    f32 = np.float32
    g = (rng.standard_normal(n) * 0.05).astype(f32)
    pool = (g + rng.standard_normal((cap, n)) * 0.02).astype(f32)
    ims = np.ones((c, tau), f32)
    ims[1, 1] = 0.0                                 # a τ_i < τ_tier row
    return dict(
        g=g, pool=pool, ims=ims,
        xs=rng.standard_normal((c, tau, b, 128, 9)).astype(f32),
        ys=rng.integers(0, 6, (c, tau, b)).astype(np.int32),
        ws=(rng.random((c, tau, b)) < 0.8).astype(f32),
        td=np.array([0.0, 0.2, 0.4, 0.6], f32),
        tu=np.array([0.1, 0.3, 0.5, 0.6], f32),
        slots=np.array([4, 0, 2, cap], np.int32),   # last row: padding
        pmask=np.array([1, 1, 1, 0], f32), lr=np.float32(0.1))


def test_tier_chunk_matches_reference(pair):
    ref, port = pair
    a = _inputs(ref.n_params)
    ex = ref.executor
    g_cdf, g_max = ex._hist(jnp.asarray(a["g"]))
    buf, _, ups, db, ub, gn = ex._tier_chunk_defer(
        jnp.asarray(a["pool"]), jnp.zeros((len(a["pool"]), 0), jnp.float32),
        jnp.asarray(a["g"]), g_cdf, g_max, jnp.asarray(a["slots"]),
        jnp.asarray(a["pmask"]), jnp.asarray(a["xs"]), jnp.asarray(a["ys"]),
        jnp.asarray(a["ws"]), jnp.asarray(a["ims"]), jnp.float32(a["lr"]),
        jnp.asarray(a["td"]), jnp.asarray(a["tu"]), jnp.uint32(0))

    store = ClientStateStore(len(a["pool"]), ref.n_params,
                             torch.from_numpy(a["g"]), capacity=0,
                             device="cpu")
    store.pool.copy_(torch.from_numpy(a["pool"]))
    tex = port.executor
    gc, gm = tex._hist(torch.from_numpy(a["g"]))
    np.testing.assert_array_equal(gc[0].numpy(), np.asarray(g_cdf))
    tups, tdb, tub, tgn = tex._tier_chunk_defer(
        store, torch.from_numpy(a["g"]), gc, gm, a["slots"], 3,
        torch.from_numpy(a["xs"]), torch.from_numpy(a["ys"]).long(),
        torch.from_numpy(a["ws"]), torch.from_numpy(a["ims"]),
        torch.tensor(a["lr"]), torch.from_numpy(a["td"]),
        torch.from_numpy(a["tu"]))
    v = 3                                            # valid rows
    np.testing.assert_array_equal(tdb.numpy()[:v], np.asarray(db)[:v])
    np.testing.assert_allclose(tub.numpy()[:v], np.asarray(ub)[:v],
                               rtol=1e-5)
    np.testing.assert_allclose(tgn.numpy()[:v], np.asarray(gn)[:v],
                               rtol=2e-5)
    np.testing.assert_allclose(tups.numpy()[:v], np.asarray(ups)[:v],
                               atol=1e-6, rtol=0)
    # every pool row: participants' new rows, untouched rows unchanged
    np.testing.assert_allclose(store.pool.numpy(), np.asarray(buf),
                               atol=1e-6, rtol=0)
    untouched = [1, 3, 5]
    np.testing.assert_array_equal(store.pool.numpy()[untouched],
                                  a["pool"][untouched])


@pytest.mark.parametrize("g", [1, 3, 8, 25, 26, 77])
def test_tier_layout_and_rungs_equal_reference(pair, g):
    ref, port = pair
    for chunk in (None, 4, 25):
        rc = RSIM.SimConfig(backend="jnp", chunk_size=chunk, **KW)
        tc = TSIM.SimConfig(device="cpu", chunk_size=chunk, **KW)
        rex = RSIM.RoundExecutor(rc, ref.apply_fn, ref.spec, "jnp",
                                 quantize=False, n_part=80)
        tex = TSIM.RoundExecutor(tc, port.apply_fn, port.spec, 80, "cpu")
        assert tex.chunk == rex.chunk
        assert tex.chunk_rungs() == rex.chunk_rungs()
        assert tex.tier_layout(g) == rex.tier_layout(g)
        assert tex.shape_lattice_bound() == rex.shape_lattice_bound()
