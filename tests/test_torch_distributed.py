"""Track B on the port: `models.model.loss_fn`, `fl.distributed` and
`launch.elastic` against the reference on the qwen1.5-4b smoke config (f32,
2 layers), the reference's weights carried across.

Tolerances, with their reasons:
* loss within rtol 2e-6 and each gradient leaf within relative L2 1e-5 of
  ``jax.value_and_grad(loss_fn)`` — f32 rounding of the two frameworks'
  matmuls and softmax sums (measured ≤ 3e-7 and ≤ 1.8e-6);
* two train steps of `make_train_step` against the reference's (mesh None,
  backend "jnp"): every leaf of params and stale model within relative
  L2 1e-5 (measured ≤ 1.8e-6). The reference's "jnp" backend finds
  the histogram threshold by bisection over the same bin edges; an
  element within f32 rounding of an edge may flip (F4), which this bound
  absorbs at two steps;
* the residuals (EF) of those steps within relative L2 5e-4 (measured
  ≤ 1.1e-4, with no element kept by one framework and dropped by the
  other): a residual holds the small dropped elements of the delta
  w_init − w_fin, a difference of nearly equal f32 numbers that keeps
  ~7 fewer bits than the weights at lr 1e-2, so the 1e-6 gradient gap
  grows ~100× there.
"""
import concurrent.futures
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.fl import distributed as RD  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.fl import distributed as TD  # noqa: E402
from repro_torch.launch import elastic  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

LOSS_RTOL = 2e-6
LEAF_REL = 1e-5
EF_REL = 5e-4


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """This module's torch work is small ops beside the other test
    workers' JAX and torch threads: with one intra-op thread they do not
    wait on a pool the other workers' threads crowd out (under six xdist
    workers a step that takes 0.9 s alone took 44 s with eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(tau=2, dtype="float32"):
    """Shared by the tests, which never write into these tensors."""
    cfg_r = dataclasses.replace(RC.get("qwen1p5_4b").smoke(),
                                local_iters=tau, dtype=dtype)
    cfg_t = dataclasses.replace(TC.get("qwen1p5_4b").smoke(),
                                local_iters=tau, dtype=dtype)
    params = RM.init_params(jax.random.PRNGKey(0), cfg_r)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0,
                                         cfg_r.vocab))
    batch_r = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    batch_t = {"tokens": torch.from_numpy(toks.copy()),
               "labels": torch.from_numpy(toks.copy())}
    pt = TM.from_reference(jax.tree.map(np.asarray, params), cfg_t,
                           device="cpu")
    return cfg_r, cfg_t, params, pt, batch_r, batch_t


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = b.detach().to(torch.float32).numpy()
    return np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)


def test_loss_and_gradient_match_reference(reference):
    _, cfg_t, _, pt, _, batch_t = _setup()
    l_r, g_r = reference["grad"]
    leaves = [x.clone().requires_grad_(True) for x in TD.tree_leaves(pt)]
    pt = TD.tree_map(lambda _: None, pt)
    for path, leaf in zip(TD._paths(pt), leaves):
        TD._set(pt, path, leaf)
    l_t = TM.loss_fn(pt, batch_t, cfg_t, device="cpu")
    g_t = torch.autograd.grad(l_t, leaves)
    assert float(l_t.detach()) == pytest.approx(float(l_r), rel=LOSS_RTOL)
    for a, b in zip(jax.tree.leaves(g_r), g_t):
        assert a.shape == tuple(b.shape)
        assert _rel(a, b) <= LEAF_REL


def test_masked_labels_weigh_nothing():
    _, cfg_t, _, pt, _, batch_t = _setup()
    lab = batch_t["labels"].clone()
    lab[:, 10:] = -1
    full = TM.loss_fn(pt, {"tokens": batch_t["tokens"][:, :10],
                           "labels": batch_t["labels"][:, :10]}, cfg_t,
                      device="cpu")
    masked = TM.loss_fn(pt, {"tokens": batch_t["tokens"], "labels": lab},
                        cfg_t, device="cpu")
    assert float(masked) == pytest.approx(float(full), rel=1e-6)


STEP_KW = dict(theta_d=0.3, theta_u=0.4, local_lr=1e-2)


def _reference_two_steps(ef):
    """The reference's two train steps (mesh None, backend "jnp") from the
    shared state and batch: (state, [loss])."""
    cfg_r, _, params, _, batch_r, _ = _setup()
    dr = RD.DistConfig(backend="jnp", use_error_feedback=ef, **STEP_KW)
    sr = RD.init_state(params, dr, mesh=None)
    step_r = jax.jit(RD.make_train_step(cfg_r, dr, mesh=None))
    losses = []
    for _ in range(2):
        sr, mr = step_r(sr, batch_r)
        losses.append(float(mr["loss"]))
    return sr, losses


def _reference_loss_and_grad():
    cfg_r, _, params, _, batch_r, _ = _setup()
    return jax.jit(jax.value_and_grad(RM.loss_fn), static_argnums=2)(
        params, batch_r, cfg_r)


@pytest.fixture(scope="module")
def reference():
    """The reference's loss and gradient and its two train steps, plain
    and with EF, computed once for the module, each compile on a thread of
    its own: {"grad": (loss, grads), False: ..., True: (state, losses)}."""
    _setup()
    jobs = {"grad": _reference_loss_and_grad,
            False: lambda: _reference_two_steps(False),
            True: lambda: _reference_two_steps(True)}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futures = {k: ex.submit(fn) for k, fn in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


@functools.lru_cache(maxsize=None)
def _port_two_steps(ef):
    """The port's two train steps from the same state and batch: (state,
    [loss])."""
    _, cfg_t, _, pt, _, batch_t = _setup()
    dt = TD.DistConfig(use_error_feedback=ef, **STEP_KW)
    st = TD.init_state(pt, dt)
    step_t = TD.make_train_step(cfg_t, dt, device="cpu")
    losses = []
    for _ in range(2):
        st, mt = step_t(st, batch_t)
        losses.append(float(mt["loss"]))
    return st, losses


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
def test_two_train_steps_match_reference(reference, ef):
    sr, losses_r = reference[ef]
    st, losses_t = _port_two_steps(ef)
    for lr_, lt in zip(losses_r, losses_t):
        assert lt == pytest.approx(lr_, rel=LOSS_RTOL)
    assert int(st.step) == int(sr.step) == 2
    trees = [("params", sr.params, st.params),
             ("prev", sr.prev_params, st.prev_params)]
    for name, a_tree, b_tree in trees:
        for a, b in zip(jax.tree.leaves(a_tree), TD.tree_leaves(b_tree)):
            assert a.shape == tuple(b.shape), name
            assert _rel(a, b) <= LEAF_REL, name
    if ef:
        for a, b in zip(jax.tree.leaves(sr.ef), TD.tree_leaves(st.ef)):
            a = np.asarray(a)
            # kept by one framework, dropped by the other
            assert not ((a == 0) != (b.numpy() == 0)).any()
            if np.abs(a).max() > 0:
                assert _rel(a, b) <= EF_REL


def test_state_from_reference_carries_every_leaf(reference):
    sr, _ = reference[True]
    st = TD.state_from_reference(jax.tree.map(np.asarray, sr), device="cpu")
    assert int(st.step) == 2 and st.step.dtype == torch.int32
    assert float(st.theta_d) == pytest.approx(0.3)
    for a_tree, b_tree in ((sr.params, st.params), (sr.ef, st.ef),
                           (sr.prev_params, st.prev_params)):
        for a, b in zip(jax.tree.leaves(a_tree), TD.tree_leaves(b_tree)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_ratio_zero_is_plain_sgd():
    """θ_u = 0, θ_d = 0 from a fresh stale model ⇒ the round is plain local
    SGD (the lossless ratio is exact through every kernel twin)."""
    _, cfg_t, _, pt, _, batch_t = _setup(tau=1)
    dt = TD.DistConfig(theta_d=0.0, theta_u=0.0, local_lr=1e-2)
    s2, _ = TD.make_train_step(cfg_t, dt, device="cpu")(
        TD.init_state(pt, dt), batch_t)
    leaves = [x.clone().requires_grad_(True) for x in TD.tree_leaves(pt)]
    tree = TD.tree_map(lambda _: None, pt)
    for path, leaf in zip(TD._paths(pt), leaves):
        TD._set(tree, path, leaf)
    g = torch.autograd.grad(TM.loss_fn(tree, batch_t, cfg_t, device="cpu"),
                            leaves)
    for a, p, gg in zip(TD.tree_leaves(s2.params), TD.tree_leaves(pt), g):
        # p − (p − w) equals w = p − lr·g to within an ulp of p
        np.testing.assert_allclose(a.numpy(), (p - 1e-2 * gg).numpy(),
                                   rtol=1e-6, atol=1e-7)
    for a, p in zip(TD.tree_leaves(s2.prev_params), TD.tree_leaves(pt)):
        assert a.shape == (1,) + tuple(p.shape)


def test_error_feedback_accumulates_the_dropped_mass():
    _, cfg_t, _, pt, _, batch_t = _setup(tau=1)
    dt = TD.DistConfig(theta_u=0.9, use_error_feedback=True)
    s2, _ = TD.make_train_step(cfg_t, dt, device="cpu")(
        TD.init_state(pt, dt), batch_t)
    ef = sum(float(e.abs().sum()) for e in TD.tree_leaves(s2.ef))
    assert ef > 0
    # upload + residual reconstruct the residual-corrected delta exactly
    rng = np.random.default_rng(0)
    d = {"w": torch.from_numpy(rng.normal(size=(64, 33)).astype(np.float32))}
    e = {"w": torch.from_numpy(rng.normal(size=(64, 33)).astype(np.float32)
                               * 0.1)}
    wire, new_ef = TD.tree_upload_compress(d, e, torch.tensor(0.7))
    assert torch.equal(wire["w"] + new_ef["w"], d["w"] + e["w"])
    assert int((wire["w"] == 0).sum()) > 0.6 * d["w"].numel()


def test_upload_compress_wire_dtype_residual_matches_reference():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (512,)) * 0.3)
    wire_r, ef_r = RD.tree_upload_compress(
        {"w": jnp.asarray(x)}, {"w": jnp.zeros(512)}, jnp.float32(0.0),
        "jnp", wire_dtype=jnp.bfloat16)
    wire, ef = TD.tree_upload_compress(
        {"w": torch.from_numpy(x.copy())}, {"w": torch.zeros(512)},
        torch.tensor(0.0), wire_dtype=torch.bfloat16)
    assert wire["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wire["w"].to(torch.float32).numpy(),
        np.asarray(wire_r["w"].astype(jnp.float32)))
    np.testing.assert_array_equal(ef["w"].numpy(), np.asarray(ef_r["w"]))
    np.testing.assert_allclose((wire["w"].to(torch.float32)
                                + ef["w"]).numpy(), x, rtol=0, atol=1e-6)
    assert float(ef["w"].abs().sum()) > 0      # bf16 rounding captured


def test_compressed_collective_feeds_the_wire_cast_into_ef():
    _, cfg_t, _, pt, _, batch_t = _setup(tau=1)
    dt = TD.DistConfig(theta_d=0.0, theta_u=0.0, local_lr=1e-2,
                       use_error_feedback=True, compressed_collective=True)
    s2, _ = TD.make_train_step(cfg_t, dt, device="cpu")(
        TD.init_state(pt, dt), batch_t)
    assert sum(float(e.abs().sum()) for e in TD.tree_leaves(s2.ef)) > 0


def test_prev_int8_round_trip_matches_reference():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (256,)) * 2.0)
    q_r = RD.quantize_tree({"w": jnp.asarray(x)})
    q_t = TD.quantize_tree({"w": torch.from_numpy(x)})
    np.testing.assert_array_equal(q_t["w"]["q"].numpy(),
                                  np.asarray(q_r["w"]["q"]))
    assert float(q_t["w"]["s"]) == float(q_r["w"]["s"])
    back = TD.dequantize_tree(q_t, {"w": torch.from_numpy(x)})["w"]
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(RD.dequantize_tree(
            q_r, {"w": jnp.asarray(x)})["w"]))
    scale = float(np.abs(x).max()) / 127
    assert float((back - torch.from_numpy(x)).abs().max()) <= \
        scale * 0.51 + 1e-6


def test_prev_int8_state_trains():
    _, cfg_t, _, pt, _, batch_t = _setup(tau=2)
    dt = TD.DistConfig(theta_d=0.4, theta_u=0.4, local_lr=3e-2,
                       prev_int8=True)
    state = TD.init_state(pt, dt)
    leaf = state.prev_params["lm_head"]
    assert leaf["q"].dtype == torch.int8 and leaf["q"].shape[0] == 1
    step = TD.make_train_step(cfg_t, dt, device="cpu")
    losses = []
    for _ in range(4):
        state, m = step(state, batch_t)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_loss_decreases_over_rounds():
    _, cfg_t, _, pt, _, batch_t = _setup(tau=4)
    dt = TD.DistConfig(theta_d=0.2, theta_u=0.3, local_lr=5e-2)
    state = TD.init_state(pt, dt)
    step = TD.make_train_step(cfg_t, dt, device="cpu")
    losses = []
    for _ in range(6):
        state, m = step(state, batch_t)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_bf16_step_is_finite():
    _, cfg_t, _, pt, _, batch_t = _setup(tau=1, dtype="bfloat16")
    assert pt["lm_head"].dtype == torch.bfloat16
    dt = TD.DistConfig(theta_d=0.3, theta_u=0.35, use_error_feedback=True)
    step = TD.make_train_step(cfg_t, dt, device="cpu")
    state = TD.init_state(pt, dt)
    for _ in range(2):
        state, m = step(state, batch_t)
        assert np.isfinite(float(m["loss"]))
    for tree in (state.params, state.prev_params, state.ef):
        for x in TD.tree_leaves(tree):
            assert x.dtype == torch.bfloat16
            assert bool(torch.isfinite(x).all())


def test_mesh_and_default_device_rules():
    """A mesh must be a `Mesh`; serving and prefill under the (1, 1) local
    mesh equal their meshless results (tests/test_torch_serve_mesh.py
    holds larger meshes to the reference); "cuda" without a card raises."""
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import specs as SP
    _, cfg_t, _, pt, _, batch_t = _setup()
    with pytest.raises(TypeError, match="Mesh"):
        TD.make_train_step(cfg_t, TD.DistConfig(), mesh=object(),
                           device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        TD.make_serve_step(cfg_t, mesh=object(), device="cpu")
    mesh = MESH.make_local_mesh("cpu")
    assert torch.equal(TD.make_prefill(cfg_t, mesh, "cpu")(pt, batch_t),
                       TD.make_prefill(cfg_t, None, "cpu")(pt, batch_t))
    tok, zero = batch_t["tokens"][:, :1], torch.zeros(4, dtype=torch.int32)
    want, cache = TD.make_serve_step(cfg_t, None, "cpu")(
        pt, TM.init_cache(cfg_t, 4, 8, device="cpu"), tok, zero)
    got, sharded = TD.make_serve_step(cfg_t, mesh, "cpu")(
        pt, SP.shard_cache(TM.init_cache(cfg_t, 4, 8, device="cpu"), cfg_t,
                           mesh, 4, 8), tok, zero)
    assert torch.equal(got, want)
    for a, b in zip(TD.tree_leaves(cache),
                    TD.tree_leaves(SP.gather_cache(sharded, mesh))):
        assert torch.equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TD.make_train_step(cfg_t, TD.DistConfig())


def _pods(n_pods=4):
    _, _, _, pt, _, _ = _setup()
    st = TD.init_state(pt, TD.DistConfig(use_error_feedback=True))
    scale = (1 + torch.arange(n_pods, dtype=torch.float32))
    st.prev_params = TD.tree_map(
        lambda a: a.expand((n_pods,) + tuple(a.shape[1:]))
        * scale.reshape((n_pods,) + (1,) * (a.dim() - 1)), st.prev_params)
    st.ef = TD.tree_map(lambda a: a.expand((n_pods,) + tuple(a.shape[1:]))
                        .clone(), st.ef)
    return st


def test_shrink_drops_lost_pod():
    st = _pods(4)
    st2 = elastic.shrink_state(st, lost_pods=[1])
    lead = TD.tree_leaves(st2.prev_params)[0]
    assert lead.shape[0] == 3
    assert torch.equal(lead[1], TD.tree_leaves(st.prev_params)[0][2])
    with pytest.raises(ValueError):
        elastic.shrink_state(_pods(2), lost_pods=[0, 1])


def test_grow_adds_fresh_cohorts_from_global():
    st = _pods(2)
    st2 = elastic.grow_state(st, n_new=2)
    prev = TD.tree_leaves(st2.prev_params)[0]
    assert prev.shape[0] == 4
    assert torch.equal(prev[3], TD.tree_leaves(st.params)[0])
    ef = TD.tree_leaves(st2.ef)[0]
    assert float(ef[2:].abs().max()) == 0.0
    st3 = elastic.grow_state(elastic.shrink_state(_pods(3), [0]), 1)
    assert TD.tree_leaves(st3.prev_params)[0].shape[0] == 3


def test_serve_and_prefill_steps_run_the_dense_model():
    _, cfg_t, _, pt, _, batch_t = _setup()
    logits = TD.make_prefill(cfg_t, device="cpu")(pt, batch_t)
    assert logits.shape == (4, cfg_t.vocab)
    cache = TM.init_cache(cfg_t, 4, 8, device="cpu")
    out, _ = TD.make_serve_step(cfg_t, device="cpu")(
        pt, cache, batch_t["tokens"][:, :1],
        torch.zeros(4, dtype=torch.int32))
    assert out.shape == (4, cfg_t.vocab) and bool(torch.isfinite(out).all())


def test_launcher_smoke_resumes_where_it_stopped(tmp_path):
    """`python -m repro_torch.launch.train --smoke --device cpu`: a run cut
    at step 2 and restarted from its checkpoint ends where a straight run
    ends (the token stream is advanced past the steps taken)."""
    from repro_torch.launch import train
    base = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--error-feedback", "--ckpt-every", "2"]
    quiet = (lambda s: None)
    straight = train.run(train.parser().parse_args(base + ["--steps", "4"]),
                         log=quiet)
    ck = ["--ckpt-dir", str(tmp_path)]
    train.run(train.parser().parse_args(base + ck + ["--steps", "2"]),
              log=quiet)
    resumed = train.run(train.parser().parse_args(base + ck + ["--steps",
                                                               "4"]),
                        log=quiet)
    assert resumed["start"] == 2
    assert resumed["losses"] == straight["losses"][2:]
    for a, b in zip(TD.tree_leaves(resumed["state"].params),
                    TD.tree_leaves(straight["state"].params)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="256"):
        train.run(train.parser().parse_args(base + ["--production-mesh"]),
                  log=quiet)
