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
# the other families' residuals after two steps (see
# test_two_train_steps_of_every_family_match_reference)
FLIP_EDGE = 0.99
FLIP_MAX = 4
MOVED_MAX = 1


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


def test_loss_and_gradient_match_reference():
    cfg_r, cfg_t, params, pt, batch_r, batch_t = _setup()
    l_r, g_r = jax.jit(jax.value_and_grad(RM.loss_fn), static_argnums=2)(
        params, batch_r, cfg_r)
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


@functools.lru_cache(maxsize=None)
def _two_steps(ef):
    """Two train steps of each package from the same state and batch:
    (reference state, port state, [(reference loss, port loss)])."""
    cfg_r, cfg_t, params, pt, batch_r, batch_t = _setup()
    kw = dict(theta_d=0.3, theta_u=0.4, local_lr=1e-2,
              use_error_feedback=ef)
    dr = RD.DistConfig(backend="jnp", **kw)
    dt = TD.DistConfig(**kw)
    sr = RD.init_state(params, dr, mesh=None)
    st = TD.init_state(pt, dt)
    step_r = jax.jit(RD.make_train_step(cfg_r, dr, mesh=None))
    step_t = TD.make_train_step(cfg_t, dt, device="cpu")
    losses = []
    for _ in range(2):
        sr, mr = step_r(sr, batch_r)
        st, mt = step_t(st, batch_t)
        losses.append((float(mr["loss"]), float(mt["loss"])))
    return sr, st, losses


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
def test_two_train_steps_match_reference(ef):
    sr, st, losses = _two_steps(ef)
    for lr_, lt in losses:
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


def test_state_from_reference_carries_every_leaf():
    sr, _, _ = _two_steps(True)
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
    from repro_torch.launch import mesh as MESH
    _, cfg_t, _, _, _, _ = _setup()
    with pytest.raises(TypeError, match="Mesh"):
        TD.make_train_step(cfg_t, TD.DistConfig(), mesh=object(),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="13c"):
        TD.make_serve_step(cfg_t, mesh=MESH.make_local_mesh("cpu"),
                           device="cpu")
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


FAMILIES = [a for a in RC.ARCH_IDS if RC.get(a).family != "dense"]


@functools.lru_cache(maxsize=None)
def _family(arch, dtype="float32"):
    """(reference cfg, port cfg, reference params, port params, numpy
    batch) of an arch's smoke config, τ 1."""
    cfg_r = dataclasses.replace(RC.get(arch).smoke(), dtype=dtype)
    cfg_t = dataclasses.replace(TC.get(arch).smoke(), dtype=dtype)
    params = RM.init_params(jax.random.PRNGKey(0), cfg_r)
    pt = TM.from_reference(jax.tree.map(np.asarray, params), cfg_t,
                           device="cpu")
    from repro.launch.train import make_batch as r_batch
    seq = 16 + cfg_r.n_patches
    batch = {k: np.asarray(v) for k, v in r_batch(
        np.random.default_rng(5), cfg_r, 4, seq).items()}
    return cfg_r, cfg_t, params, pt, batch


def _steps(arch, ef):
    """Two train steps of each package on an arch's smoke config."""
    cfg_r, cfg_t, params, pt, batch = _family(arch)
    kw = dict(theta_d=0.3, theta_u=0.4, local_lr=1e-2,
              use_error_feedback=ef)
    dr = RD.DistConfig(backend="jnp", **kw)
    dt = TD.DistConfig(**kw)
    sr = RD.init_state(params, dr, mesh=None)
    st = TD.init_state(pt, dt)
    step_r = jax.jit(RD.make_train_step(cfg_r, dr, mesh=None))
    step_t = TD.make_train_step(cfg_t, dt, device="cpu")
    batch_r = {k: jnp.asarray(v) for k, v in batch.items()}
    batch_t = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    losses = []
    for _ in range(2):
        sr, mr = step_r(sr, batch_r)
        st, mt = step_t(st, batch_t)
        losses.append((float(mr["loss"]), float(mt["loss"])))
    return sr, st, losses


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_two_train_steps_of_every_family_match_reference(arch, ef):
    """The dense test's bounds on every other family's smoke config (the
    encoder's unread token embedding keeps its value: a zero gradient, as
    jax.grad gives). Over these leaves a residual element may be kept by
    one framework and dropped by the other, of two kinds only: at the
    upload threshold (|value| ≥ 0.99 of the leaf's largest residual: F4's
    bin-edge flip) or a delta of at most two ulps of its weight against an
    exact zero (one rounding of the local step). At most 4 such flips in
    all (measured 1–2 per arch); the residual is compared outside them,
    per expert for the routed experts' leaves. One expert's residual may
    differ beyond the bound: a token whose step-2 assignment moved on a
    near-tie of its router probabilities (the router sees weights that
    already differ by ~1e-7 after step 1). Measured: DeepSeek-V3, layer 2,
    expert 6 of w_up at 2.6e-2, every other slice ≤ 3e-4."""
    sr, st, losses = _steps(arch, ef)
    for lr_, lt in losses:
        assert lt == pytest.approx(lr_, rel=LOSS_RTOL)
    trees = [("params", sr.params, st.params),
             ("prev", sr.prev_params, st.prev_params)]
    if ef:
        trees.append(("ef", sr.ef, st.ef))
    flips, moved = 0, []
    for name, a_tree, b_tree in trees:
        ref_leaves = jax.tree.leaves(a_tree)
        assert len(ref_leaves) == len(TD.tree_leaves(b_tree)), name
        for q, a, b in zip(TD._leaf_paths(b_tree), ref_leaves,
                           TD.tree_leaves(b_tree)):
            a = np.asarray(a)
            assert a.shape == tuple(b.shape) and str(a.dtype) == str(
                b.dtype).split(".")[-1], (name, q)
            if name != "ef":
                assert _rel(a, b) <= LEAF_REL, (name, q, _rel(a, b))
                continue
            b = b.numpy()
            flip = (a == 0) != (b == 0)
            flips += int(flip.sum())
            if flip.any():
                v = np.abs(np.where(a != 0, a, b)[flip])
                w = np.abs(TD._get(st.prev_params, q).numpy())[flip]
                edge = v >= FLIP_EDGE * max(np.abs(a).max(), np.abs(b).max())
                ulp = v <= 2 * np.spacing(w.astype(np.float32))
                assert (edge | ulp).all(), (q, v, w)
            a, b = np.where(flip, 0, a), np.where(flip, 0, b)
            # routed experts: one slice per expert [1, L, E, ...]
            expert = q[0] == "moe_layers" and q[-2] == "ffn" and \
                q[-1] != "router"
            for sl in (np.ndindex(a.shape[1:3]) if expert else [()]):
                aa, bb = a[(0,) + sl] if sl else a, b[(0,) + sl] if sl else b
                if np.linalg.norm(aa - bb) > EF_REL * np.linalg.norm(aa):
                    moved.append((q, sl))
    assert flips <= FLIP_MAX
    assert len(moved) <= MOVED_MAX, moved
    if arch == "llama4_scout_17b_a16e":
        assert st.params["dense_layers"] is None
        assert st.prev_params["dense_layers"] is None


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "llama4_scout_17b_a16e"])
def test_bf16_state_round_trips_reference_and_checkpoint(arch, tmp_path):
    """A bf16 smoke TrainState (Llama-4-Scout's None dense stack, its f32
    router; Zamba2's f32 a_log and dt_bias) through state_from_reference
    and a CheckpointManager save/restore, leaf for leaf in its own dtype;
    then a step runs from the restored state."""
    from repro.checkpoint.manager import CheckpointManager as RCkpt
    from repro_torch.checkpoint.manager import CheckpointManager
    cfg_r, cfg_t, params, _, batch = _family(arch, "bfloat16")
    dr = RD.DistConfig(backend="jnp", use_error_feedback=True)
    sr = jax.tree.map(np.asarray, RD.init_state(params, dr, mesh=None))
    st = TD.state_from_reference(sr, device="cpu")
    f32 = set()
    for tree_r, tree_t in ((sr.params, st.params), (sr.ef, st.ef),
                           (sr.prev_params, st.prev_params)):
        for q, a, b in zip(TD._leaf_paths(tree_t), jax.tree.leaves(tree_r),
                           TD.tree_leaves(tree_t)):
            assert str(a.dtype) == str(b.dtype).split(".")[-1], q
            np.testing.assert_array_equal(
                b.view(torch.int16).numpy() if b.dtype == torch.bfloat16
                else b.numpy(), a.view(np.int16) if a.dtype.name ==
                "bfloat16" else a)
            if b.dtype == torch.float32:
                f32.add(q[-1])
    assert f32 == ({"router"} if arch.startswith("llama4")
                   else {"a_log", "dt_bias"})
    mgr = CheckpointManager(tmp_path / "port")
    mgr.save(st, 3)
    like = TD.init_state(TM.init_params(cfg_t, torch.Generator()
                                        .manual_seed(1), device="cpu"),
                         TD.DistConfig(use_error_feedback=True))
    back, step = mgr.restore_latest(like)
    assert step == 3
    for a, b in zip(TD.tree_leaves(st.params) + TD.tree_leaves(st.ef),
                    TD.tree_leaves(back.params) + TD.tree_leaves(back.ef)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if arch.startswith("llama4"):
        assert back.params["dense_layers"] is None
    # the reference's checkpoint of the same numpy state restores here too
    RCkpt(tmp_path / "ref").save(jax.tree.map(
        lambda a: a.astype(np.float32) if a.dtype.name == "bfloat16" else a,
        sr), 1)
    got, _ = CheckpointManager(tmp_path / "ref").restore_latest(like)
    for a, b in zip(TD.tree_leaves(st.params), TD.tree_leaves(got.params)):
        assert torch.equal(a, b)
    step_fn = TD.make_train_step(cfg_t, TD.DistConfig(
        use_error_feedback=True), device="cpu")
    s2, m = step_fn(back, {k: torch.from_numpy(v.copy())
                           for k, v in batch.items()})
    assert np.isfinite(float(m["loss"]))
    for x in TD.tree_leaves(s2.params):
        assert bool(torch.isfinite(x).all())


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_and_prefill_steps_run_every_family(arch):
    """The steps are the model's prefill and decode_step (held to the
    reference's in tests/test_torch_families.py), bit for bit; the encoder
    has no decode."""
    _, cfg_t, _, pt, batch = _family(arch)
    bt = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    got = TD.make_prefill(cfg_t, device="cpu")(pt, bt)
    assert torch.equal(got, TM.prefill(pt, bt, cfg_t, device="cpu"))
    assert got.shape == (4, cfg_t.vocab) and bool(torch.isfinite(got).all())
    serve = TD.make_serve_step(cfg_t, device="cpu")
    if not cfg_t.supports_decode:
        with pytest.raises(ValueError, match="decode"):
            TM.init_cache(cfg_t, 4, 8, device="cpu")
        return
    tok = torch.from_numpy(batch["tokens"][:, :1].copy())
    zero = torch.zeros(4, dtype=torch.int32)
    out, _ = serve(pt, TM.init_cache(cfg_t, 4, 8, device="cpu"), tok, zero)
    want, _ = TM.decode_step(pt, TM.init_cache(cfg_t, 4, 8, device="cpu"),
                             {"tokens": tok}, zero, cfg_t, device="cpu")
    assert torch.equal(out, want) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("arch", ["hubert_xlarge", "internvl2_2b",
                                  "qwen1p5_4b"])
def test_make_batch_draws_like_the_reference(arch):
    """frames / patches / tokens from the same numpy stream, in the same
    order (so a resumed run's stream skips the same draws)."""
    from repro.launch.train import make_batch as r_batch
    from repro_torch.launch.train import make_batch as t_batch
    cfg = TC.get(arch).smoke()
    rng_r, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(2):
        want = r_batch(rng_r, RC.get(arch).smoke(), 2, 24)
        got = t_batch(rng_t, cfg, 2, 24, "cpu")
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if cfg.frontend == "vision":
        assert tuple(got["tokens"].shape) == (2, 24 - cfg.n_patches)


def test_launcher_trains_the_families_from_the_command_line():
    """`--arch` takes every family: two steps of each non-dense smoke
    config through the launcher, finite losses."""
    from repro_torch.launch import train
    for arch in ("deepseek-v3-671b", "hubert-xlarge", "internvl2-2b"):
        res = train.run(train.parser().parse_args(
            ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
             "--batch", "2", "--seq", "24", "--error-feedback"]),
            log=lambda s: None)
        assert len(res["losses"]) == 2
        assert all(np.isfinite(x) for x in res["losses"])


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
