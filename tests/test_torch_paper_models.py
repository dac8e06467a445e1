"""repro_torch's ResNet-18 (widths 8 and 64), cnn_cifar (ResNet-18 at width
16), cnn_speech and lr against the reference's paper models: flat layout,
weight transfer, and the logits and per-participant gradients of c = 3
participants batched in one apply against the reference's ``apply`` and
``jax.grad`` of the round engine's ce_loss, participant by participant.

Tolerances (f32), with their reasons. The two frameworks' convolutions,
dot products and mean/variance reductions sum in different orders, and
XLA's and PyTorch's f32 rsqrt differ by an ulp; a layout, padding or
stride error gives O(1) differences instead.
* logits and loss: |port − reference| ≤ 1e-5 + 1e-4·|reference|.
* gradients: relative L2 ≤ 2e-4 per participant, and every element within
  2e-4 of the participant's largest gradient element. The norm layers can
  be ill-conditioned at 2 samples per participant (a channel's variance
  over a 4×4 map near zero), where an f32 gradient of either framework
  strays from an f64 evaluation of the same model by more than the two
  frameworks' usual agreement; the bound leaves room for that and is
  still far below a layout error's O(1).
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
GRAD_REL = 2e-4
C_PART = 3          # participants batched in one apply
B = 2               # samples per participant
# name: (port model, spec kwargs, reference init kwargs, input shape,
#        classes, n_params)
CASES = {
    "resnet18-w8": ("resnet18", {"width": 8}, {"width": 8}, (32, 32, 3), 10,
                    175202),
    "resnet18-w64": ("resnet18", {}, {}, (32, 32, 3), 10, 11164362),
    "cnn_cifar": ("cnn_cifar", {}, {}, (32, 32, 3), 10, 699066),
    "cnn_speech": ("cnn_speech", {}, {}, (4000, 1), 35, 62323),
    "lr": ("lr", {}, {}, (1024,), 2, 2050),
}


def _ref(case, seed):
    model, _, rkw, *_ = CASES[case]
    init, apply = RPM.MODELS[model]
    params = init(jax.random.PRNGKey(seed), **rkw)
    flat, spec = RC.flatten_tree(params)
    return params, flat, spec, apply


def _batch(case, seed, b=B):
    _, _, _, shape, n_classes, _ = CASES[case]
    rng = np.random.default_rng(np.random.SeedSequence(seed,
                                                       spawn_key=(95,)))
    x = rng.standard_normal((C_PART, b) + shape).astype(np.float32)
    y = rng.integers(0, n_classes, (C_PART, b)).astype(np.int32)
    w = np.ones((C_PART, b), np.float32)
    w[:, -1] = (rng.random(C_PART) < 0.5)
    return x, y, w


@pytest.mark.parametrize("case", list(CASES))
def test_flat_layout_and_from_reference(case):
    model, kw, *_, n_params = CASES[case]
    params, rflat, rspec, _ = _ref(case, 0)
    spec = TPM.MODELS[model][0](**kw)
    assert spec.n_params == rspec.n_params == n_params
    assert spec.offsets == rspec.offsets
    assert spec.shapes == rspec.shapes
    a = TPM.from_reference(np.asarray(rflat), model, **kw)
    b = TPM.from_reference(jax.tree.map(np.asarray, params), model, **kw)
    np.testing.assert_array_equal(a.numpy(), np.asarray(rflat))
    np.testing.assert_array_equal(b.numpy(), np.asarray(rflat))
    with pytest.raises(ValueError):
        TPM.from_reference(np.zeros(10, np.float32), model, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_logits_and_gradients_match_reference(case):
    """c participants with their own parameters and batches in ONE batched
    apply and backward, each against the reference alone."""
    model, kw, *_ = CASES[case]
    x, y, w = _batch(case, 1)
    refs = [_ref(case, seed) for seed in range(C_PART)]
    _, _, rspec, apply = refs[0]

    def ce_loss(flat, xi, yi, wi):
        logits = apply(RC.unflatten_vector(flat, rspec), xi)
        logp = jax.nn.log_softmax(logits)
        ll = jnp.take_along_axis(logp, yi[:, None], axis=-1)[:, 0]
        return -jnp.sum(ll * wi) / jnp.maximum(jnp.sum(wi), 1.0), logits

    grad_fn = jax.jit(jax.value_and_grad(ce_loss, has_aux=True))
    spec = TPM.MODELS[model][0](**kw)
    q = torch.stack([TPM.from_reference(np.asarray(r[1]), model, **kw)
                     for r in refs]).requires_grad_(True)
    logits = TPM.MODELS[model][2](TC.unflatten_vector(q, spec),
                                  torch.from_numpy(x))
    loss = RoundExecutor._ce_loss(logits, torch.from_numpy(y).long(),
                                  torch.from_numpy(w))
    (g,) = torch.autograd.grad(loss.sum(), q)
    for i, (_, rflat, _, _) in enumerate(refs):
        (want_loss, want_logits), want_g = grad_fn(
            rflat, jnp.asarray(x[i]), jnp.asarray(y[i]), jnp.asarray(w[i]))
        np.testing.assert_allclose(logits[i].detach().numpy(),
                                   np.asarray(want_logits), atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(float(loss[i].detach()), float(want_loss),
                                   atol=ATOL, rtol=RTOL)
        want_g = np.asarray(want_g)
        diff = g[i].numpy() - want_g
        assert np.linalg.norm(diff) <= GRAD_REL * np.linalg.norm(want_g)
        np.testing.assert_allclose(
            g[i].numpy(), want_g, rtol=0,
            atol=GRAD_REL * float(np.abs(want_g).max()))


@pytest.mark.parametrize("model", list(TPM.MODELS))
def test_own_init_is_seeded_with_zero_biases(model):
    flat = TPM.MODELS[model][1](torch.Generator().manual_seed(0))
    again = TPM.MODELS[model][1](torch.Generator().manual_seed(0))
    assert torch.equal(flat, again) and bool(torch.isfinite(flat).all())
    views = TC.unflatten_vector(flat, TPM.MODELS[model][0]())
    for name, v in views.items():
        if name.endswith("b") and v.dim() == 1:
            assert float(v.abs().sum()) == 0.0, name
        else:
            assert float(v.abs().sum()) > 0.0, name


@pytest.mark.parametrize("size,k,stride,want", [
    (32, 3, 1, (1, 1)), (32, 3, 2, (0, 1)), (32, 1, 2, (0, 0)),
    (4000, 9, 4, (2, 3)), (1000, 9, 4, (2, 3)), (250, 9, 4, (3, 4)),
    (63, 9, 4, (3, 3)), (128, 5, 2, (1, 2))])
def test_same_padding_is_jax_rule(size, k, stride, want):
    assert TPM._same_pad(size, k, stride) == want


def test_resnet18_gradient_gap_at_8_samples_is_f32_conditioning():
    """ResNet-18 (width 64) at B = 8 samples per participant: the f32
    gradients of both frameworks against an f64 evaluation of the port's
    model. The reference's own f32 gradient strays from it by more than
    1e-4 for some participant (two runs on the CPU, per participant:
    5.9e-4–6.1e-4, 1.1e-6–1.2e-3 and 6.8e-4 — XLA's CPU sums vary between
    processes; the port's 1.4e-4, 4.9e-4 and 6.4e-4 in both; port vs
    reference 6.0e-4, 4.9e-4–1.3e-3, 2.1e-4), so a 1e-4 bound between the
    frameworks
    cannot hold at 8 samples: the gap is the f32 conditioning of the
    model (the parameter-free spatial norm on the 4×4 maps of the last
    stage), not the 2 samples of the test above. Bounds: each f32
    gradient within 5e-3 of the f64 one and of the other framework's
    (~7× the largest measured). The measured values are printed."""
    case = "resnet18-w64"
    model, kw, *_ = CASES[case]
    x, y, w = _batch(case, 1, b=8)
    refs = [_ref(case, seed) for seed in range(C_PART)]
    _, _, rspec, apply = refs[0]

    def ce_loss(flat, xi, yi, wi):
        logits = apply(RC.unflatten_vector(flat, rspec), xi)
        logp = jax.nn.log_softmax(logits)
        ll = jnp.take_along_axis(logp, yi[:, None], axis=-1)[:, 0]
        return -jnp.sum(ll * wi) / jnp.maximum(jnp.sum(wi), 1.0)

    spec = TPM.MODELS[model][0](**kw)

    def port_grad(dtype):
        q = torch.stack([TPM.from_reference(np.asarray(r[1]), model, **kw)
                         for r in refs]).to(dtype).requires_grad_(True)
        logits = TPM.MODELS[model][2](TC.unflatten_vector(q, spec),
                                      torch.from_numpy(x).to(dtype))
        loss = RoundExecutor._ce_loss(logits, torch.from_numpy(y).long(),
                                      torch.from_numpy(w).to(dtype))
        (g,) = torch.autograd.grad(loss.sum(), q)
        return g.double().numpy()

    g32, g64 = port_grad(torch.float32), port_grad(torch.float64)
    grad_fn = jax.jit(jax.grad(ce_loss))
    ref_stray = []
    for i, (_, rflat, _, _) in enumerate(refs):
        r32 = np.asarray(grad_fn(rflat, jnp.asarray(x[i]), jnp.asarray(y[i]),
                                 jnp.asarray(w[i])), np.float64)
        n64 = np.linalg.norm(g64[i])
        ref_stray.append(np.linalg.norm(r32 - g64[i]) / n64)
        port_stray = np.linalg.norm(g32[i] - g64[i]) / n64
        gap = np.linalg.norm(g32[i] - r32) / np.linalg.norm(r32)
        print(f"participant {i}: reference vs f64 {ref_stray[-1]:.3g}, "
              f"port vs f64 {port_stray:.3g}, port vs reference {gap:.3g}")
        assert ref_stray[-1] <= 5e-3 and port_stray <= 5e-3 and gap <= 5e-3
    assert max(ref_stray) > 1e-4
