"""repro_torch cnn_har against the reference's cnn_har: flat layout, weight
transfer, logits and the gradient of the round engine's ce_loss.

Tolerances: logits and gradients agree to atol 1e-5 / rtol 1e-4 (f32). The
two frameworks' convolutions, dot products and mean/variance reductions sum
in different orders, and XLA's and PyTorch's f32 rsqrt differ by an ulp.
Measured on these inputs: logits within 1.8e-6 (of magnitudes up to 3),
gradients within 2.4e-7, so the bound leaves margin without admitting a
layout or padding error (those give O(1) differences).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import compression as RC  # noqa: E402
from repro.models import paper_models as RPM  # noqa: E402
from repro_torch.core import compression as TC  # noqa: E402
from repro_torch.fl.executor import RoundExecutor  # noqa: E402
from repro_torch.models import paper_models as TPM  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4


def _ref_params(seed):
    return RPM.cnn_har_init(jax.random.PRNGKey(seed))


def _batch(b, seed):
    rng = np.random.default_rng(np.random.SeedSequence(seed, spawn_key=(96,)))
    x = rng.standard_normal((b, 128, 9)).astype(np.float32)
    y = rng.integers(0, 6, b).astype(np.int32)
    w = (rng.random(b) < 0.7).astype(np.float32)
    return x, y, w


def test_flat_layout_matches_reference():
    spec = TPM.cnn_har_spec()
    params = _ref_params(0)
    rflat, rspec = RC.flatten_tree(params)
    assert spec.names == ("c1", "c2", "c3", "f1_b", "f1_w", "f2_b", "f2_w")
    assert spec.offsets == (0, 1440, 11680, 32160, 32288, 163360, 163366)
    assert spec.offsets == rspec.offsets and spec.n_params == 164134
    assert spec.shapes == rspec.shapes
    a = TPM.from_reference(np.asarray(rflat))
    b = TPM.from_reference({k: np.asarray(v) for k, v in params.items()})
    np.testing.assert_array_equal(a.numpy(), np.asarray(rflat))
    np.testing.assert_array_equal(b.numpy(), np.asarray(rflat))
    with pytest.raises(ValueError):
        TPM.from_reference(np.zeros(10, np.float32))


def test_own_init_is_he_normal_with_zero_biases():
    flat = TPM.cnn_har_init(torch.Generator().manual_seed(0))
    v = TC.unflatten_vector(flat, TPM.cnn_har_spec())
    assert float(v["f1_b"].abs().sum()) == 0.0
    assert abs(float(v["f1_w"].std()) - (2.0 / 1024) ** 0.5) < 2e-3
    again = TPM.cnn_har_init(torch.Generator().manual_seed(0))
    assert torch.equal(flat, again)


@pytest.mark.parametrize("seed", [0, 3])
def test_logits_match_reference(seed):
    params = _ref_params(seed)
    flat = TPM.from_reference(np.asarray(RC.flatten_tree(params)[0]))
    x, _, _ = _batch(16, seed)
    want = np.asarray(RPM.cnn_har_apply(params, jnp.asarray(x)))
    views = TC.unflatten_vector(flat[None], TPM.cnn_har_spec())
    got = TPM.cnn_har_apply(views, torch.from_numpy(x)[None])[0]
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=RTOL)


def test_ce_loss_gradient_matches_jax_grad():
    params = _ref_params(1)
    rflat, spec_r = RC.flatten_tree(params)
    x, y, w = _batch(12, 1)

    def ce_loss(flat):
        logits = RPM.cnn_har_apply(RC.unflatten_vector(flat, spec_r),
                                   jnp.asarray(x))
        logp = jax.nn.log_softmax(logits)
        ll = jnp.take_along_axis(logp, jnp.asarray(y)[:, None], axis=-1)[:, 0]
        return -jnp.sum(ll * w) / jnp.maximum(jnp.sum(w), 1.0)

    want_loss, want_g = jax.value_and_grad(ce_loss)(rflat)
    spec = TPM.cnn_har_spec()
    q = TPM.from_reference(np.asarray(rflat))[None].requires_grad_(True)
    logits = TPM.cnn_har_apply(TC.unflatten_vector(q, spec),
                               torch.from_numpy(x)[None])
    loss = RoundExecutor._ce_loss(logits, torch.from_numpy(y).long()[None],
                                  torch.from_numpy(w)[None])
    (g,) = torch.autograd.grad(loss.sum(), q)
    np.testing.assert_allclose(float(loss[0].detach()), float(want_loss),
                               rtol=1e-6)
    np.testing.assert_allclose(g[0].numpy(), np.asarray(want_g), atol=ATOL,
                               rtol=RTOL)


def test_batched_models_are_independent():
    """c participants in one grouped apply == each participant alone, and a
    participant's loss moves only its own parameter row."""
    spec = TPM.cnn_har_spec()
    gen = torch.Generator().manual_seed(2)
    flats = torch.stack([TPM.cnn_har_init(gen) for _ in range(3)])
    x = torch.from_numpy(np.stack([_batch(5, s)[0] for s in range(3)]))
    joint = TPM.cnn_har_apply(TC.unflatten_vector(flats, spec), x)
    for i in range(3):
        alone = TPM.cnn_har_apply(TC.unflatten_vector(flats[i:i + 1], spec),
                                  x[i:i + 1])
        torch.testing.assert_close(joint[i:i + 1], alone, atol=ATOL,
                                   rtol=RTOL)
    q = flats.clone().requires_grad_(True)
    out = TPM.cnn_har_apply(TC.unflatten_vector(q, spec), x)
    (g,) = torch.autograd.grad(out[1].sum(), q)
    assert float(g[0].abs().sum()) == 0.0 and float(g[2].abs().sum()) == 0.0
    assert float(g[1].abs().sum()) > 0.0
