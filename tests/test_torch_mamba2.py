"""repro_torch's Mamba2 / SSD (models/mamba2.py) and the gated RMSNorm
(models/layers.py) against the reference's, on the same numpy inputs, on
the CPU; and the chunked scan against the naive one-token recurrence.

Tolerances (f32):
* ``ssd_chunked``, ``ssd_decode``, ``causal_conv``, ``mamba_block`` and
  ``gated_rms_norm`` against the reference: atol 1e-5 (exp/cumsum and the
  einsums round in other orders); ``ssd_chunked`` also rtol 1e-5, as a
  chunk of 40 positions gives outputs up to ~5 (measured 5.7e-6
  relative);
* ``ssd_chunked`` against the naive recurrence: atol 2e-3, the reference's
  own bound for the same check (tests/test_models.py), as the two forms
  sum the decays in other orders;
* gradients of a Mamba2 block: relative L2 1e-5 per leaf, the dense
  Track-B bound.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as R_CFG  # noqa: E402
import repro_torch.configs as T_CFG  # noqa: E402
from repro.models import layers as R_L  # noqa: E402
from repro.models import mamba2 as R_M2  # noqa: E402
from repro_torch.models import layers as T_L  # noqa: E402
from repro_torch.models import mamba2 as T_M2  # noqa: E402

ATOL = 1e-5
NAIVE_ATOL = 2e-3
GRAD_REL = 1e-5


def _rng(seed):
    return np.random.default_rng(np.random.SeedSequence(seed,
                                                        spawn_key=(103,)))


def _ssd_inputs(seed, b=2, l=32, h=3, p=8, n=4):
    rng = _rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, l, h)), 0).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    bb = rng.standard_normal((b, l, n)).astype(np.float32)
    cc = rng.standard_normal((b, l, n)).astype(np.float32)
    return x, dt, a, bb, cc


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("l,chunk", [(32, 8), (32, 32), (24, 16), (40, 64),
                                     (7, 4)])
def test_ssd_chunked_matches_reference(l, chunk):
    """Including chunk sizes that do not divide L (the chunk halves until it
    does, as in the reference: 24/16 → 8, 7/4 → 1)."""
    ins = _ssd_inputs(l + chunk, l=l)
    want = jax.jit(R_M2.ssd_chunked, static_argnames="chunk")(*_j(*ins),
                                                              chunk=chunk)
    got = T_M2.ssd_chunked(*_t(*ins), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL,
                               atol=ATOL)


def test_ssd_chunked_matches_naive_recurrence():
    """Chunked SSD == step-by-step state recurrence (mirror of
    tests/test_models.py's check)."""
    x, dt, a, bb, cc = _t(*_ssd_inputs(0))
    y_chunk = T_M2.ssd_chunked(x, dt, a, bb, cc, chunk=8)
    state = torch.zeros((2, 3, 8, 4))
    ys = []
    for t in range(x.shape[1]):
        y_t, state = T_M2.ssd_decode(x[:, t], dt[:, t], a, bb[:, t],
                                     cc[:, t], state)
        ys.append(y_t)
    np.testing.assert_allclose(y_chunk.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=NAIVE_ATOL, atol=NAIVE_ATOL)


def test_ssd_decode_matches_reference():
    x, dt, a, bb, cc = _ssd_inputs(1)
    state = _rng(2).standard_normal((2, 3, 8, 4)).astype(np.float32)
    ry, rs = R_M2.ssd_decode(*_j(x[:, 0], dt[:, 0], a, bb[:, 0], cc[:, 0],
                                 state))
    ty, ts = T_M2.ssd_decode(*_t(x[:, 0], dt[:, 0], a, bb[:, 0], cc[:, 0],
                                 state))
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), atol=ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), atol=ATOL)


def test_segsum_masks_above_the_diagonal_and_its_backward_is_finite():
    x = torch.from_numpy(_rng(3).standard_normal((2, 6)).astype(np.float32))
    x.requires_grad_(True)
    out = T_M2._segsum(x)
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(R_M2._segsum(jnp.asarray(
            x.detach().numpy()))), atol=1e-6)
    assert bool(torch.isinf(out[:, 0, 1:]).all())
    (g,) = torch.autograd.grad(torch.exp(out).sum(), x)
    assert bool(torch.isfinite(g).all())


def test_ssd_gradients_are_finite_and_match_reference():
    ins = _ssd_inputs(4, l=16)

    def ref(x, dt, a, b, c):
        return jnp.sum(R_M2.ssd_chunked(x, dt, a, b, c, chunk=8) ** 2)
    g_r = jax.jit(jax.grad(ref, argnums=(0, 1, 2, 3, 4)))(*_j(*ins))
    args = [t.requires_grad_(True) for t in _t(*ins)]
    g_t = torch.autograd.grad(
        torch.sum(T_M2.ssd_chunked(*args, chunk=8) ** 2), args)
    for a, b in zip(g_r, g_t):
        assert bool(torch.isfinite(b).all())
        a = np.asarray(a)
        assert np.linalg.norm(b.numpy() - a) <= GRAD_REL * np.linalg.norm(a)


def test_causal_conv_and_its_carry_match_reference():
    """The whole sequence at once equals two halves with the carried state
    in between, and both equal the reference."""
    rng = _rng(5)
    x = rng.standard_normal((2, 10, 6)).astype(np.float32)
    w = (rng.standard_normal((4, 6)) * 0.5).astype(np.float32)
    ry, rprev = R_M2.causal_conv(*_j(x, w))
    ty, tprev = T_M2.causal_conv(*_t(x, w))
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), atol=ATOL)
    np.testing.assert_array_equal(tprev.numpy(), np.asarray(rprev))
    y1, p1 = T_M2.causal_conv(*_t(x[:, :7], w))
    y2, p2 = T_M2.causal_conv(*_t(x[:, 7:], w), prev=p1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), ty.numpy(),
                               atol=1e-6)
    assert torch.equal(p2, tprev)


def test_softplus_is_logaddexp_above_twenty():
    """dt = softplus(raw + dt_bias) as jax.nn.softplus computes it: exact
    log(1 + e^x) where torch's F.softplus would switch to x above 20."""
    cfg = T_CFG.get("mamba2_780m").smoke()
    rcfg = R_CFG.get("mamba2_780m").smoke()
    make = T_L.ParamMaker(torch.Generator().manual_seed(0), "cpu")
    p = T_M2.init_mamba_params(make, cfg, torch.float32)
    p["dt_bias"] = torch.linspace(-30, 30, cfg.ssm_heads)
    x = torch.from_numpy(_rng(6).standard_normal(
        (1, 3, cfg.d_model)).astype(np.float32))
    dt = T_M2._projections(x, p, cfg)[-1]
    rp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    want = R_M2._projections(jnp.asarray(x.numpy()), rp, rcfg)[-1]
    np.testing.assert_allclose(dt.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.fixture(scope="module")
def block():
    rcfg = R_CFG.get("zamba2_1p2b").smoke()
    tcfg = T_CFG.get("zamba2_1p2b").smoke()
    rp = R_M2.init_mamba_params(jax.random.PRNGKey(0), rcfg, jnp.float32)
    rp = dict(rp, a_log=jnp.linspace(-1.0, 1.0, rcfg.ssm_heads),
              dt_bias=jnp.linspace(-2.0, 2.0, rcfg.ssm_heads))
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in rp.items()}
    x = _rng(7).standard_normal((2, 16, rcfg.d_model)).astype(np.float32)
    return rcfg, tcfg, rp, tp, x


def test_mamba_params_layout_matches_reference(block):
    rcfg, tcfg, rp, _, _ = block
    make = T_L.ParamMaker(torch.Generator().manual_seed(0), "cpu")
    tp = T_M2.init_mamba_params(make, tcfg, torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in rp.items()}
    assert tp["a_log"].dtype == tp["dt_bias"].dtype == torch.float32
    assert tp["w_zx"].dtype == tp["d_skip"].dtype == torch.bfloat16
    ssm, conv = T_M2.init_mamba_cache(3, tcfg, torch.bfloat16, "cpu", 5)
    rs, rc = R_M2.init_mamba_cache(3, rcfg, jnp.bfloat16)
    assert tuple(ssm.shape) == (5,) + rs.shape and ssm.dtype == torch.float32
    assert tuple(conv.shape) == (5,) + rc.shape
    assert conv.dtype == torch.bfloat16


def test_mamba_block_train_and_decode_match_reference(block):
    rcfg, tcfg, rp, tp, x = block
    want, _ = jax.jit(lambda x: R_M2.mamba_block(x, rp, rcfg))(
        jnp.asarray(x))
    got, _ = T_M2.mamba_block(torch.from_numpy(x), tp, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    rs, rc = R_M2.init_mamba_cache(2, rcfg, jnp.float32)
    ts, tc = T_M2.init_mamba_cache(2, tcfg, torch.float32, "cpu")
    step = jax.jit(lambda x, s, c: R_M2.mamba_block(x, rp, rcfg, state=s,
                                                    conv_state=c))
    outs = []
    for i in range(x.shape[1]):
        a, (rs, rc) = step(jnp.asarray(x[:, i:i + 1]), rs, rc)
        o, (ts, tc) = T_M2.mamba_block(torch.from_numpy(x[:, i:i + 1]), tp,
                                       tcfg, state=ts, conv_state=tc)
        np.testing.assert_allclose(o.numpy(), np.asarray(a), atol=ATOL)
        outs.append(o)
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(rc), atol=ATOL)
    # the recurrence equals the chunked scan
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), got.numpy(),
                               atol=NAIVE_ATOL)


def test_mamba_block_gradients_match_reference(block):
    rcfg, tcfg, rp, tp, x = block
    g_r = jax.jit(jax.grad(lambda p: jnp.sum(R_M2.mamba_block(
        jnp.asarray(x), p, rcfg)[0] ** 2)))(rp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    out, _ = T_M2.mamba_block(torch.from_numpy(x), leaves, tcfg)
    g_t = torch.autograd.grad(torch.sum(out ** 2), list(leaves.values()))
    for k, b in zip(leaves, g_t):
        a = np.asarray(g_r[k])
        assert np.linalg.norm(b.numpy() - a) <= GRAD_REL * np.linalg.norm(a), k


def test_gated_rms_norm_matches_reference():
    rng = _rng(8)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    gate = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        T_L.gated_rms_norm(*_t(x, gate, scale)).numpy(),
        np.asarray(R_L.gated_rms_norm(*_j(x, gate, scale))), atol=ATOL)
