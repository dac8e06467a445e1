"""Track B on the port for every family other than dense — MoE (DeepSeek-V3
with MLA, Llama-4-Scout), Mamba2, the Zamba2 hybrid, the HuBERT encoder
and InternVL2 — against the reference at each arch's smoke config (f32,
τ 1), the reference's weights carried across: two train steps of
`fl.distributed.make_train_step` against the reference's (mesh None,
backend "jnp"), plain and with error feedback; a bf16 state through
`state_from_reference` and the checkpoint; the serve and prefill steps;
the launcher's batches and `--arch`. Split from
tests/test_torch_distributed.py (the dense model), whose tolerances these
tests keep: loss rtol 2e-6, params and stale models relative L2 1e-5 per
leaf, residuals 5e-4 outside the flips that
`test_two_train_steps_of_every_family_match_reference` describes.

The reference's steps of every (arch, EF) case are computed once for the
module, each compile on a thread of its own (`reference_steps`); the
port's run in the test.
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
from repro_torch.models import model as TM  # noqa: E402

LOSS_RTOL = 2e-6
LEAF_REL = 1e-5
EF_REL = 5e-4
# the residuals after two steps (see
# test_two_train_steps_of_every_family_match_reference)
FLIP_EDGE = 0.99
FLIP_MAX = 4
MOVED_MAX = 1
REFERENCE_THREADS = 4


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


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = b.detach().to(torch.float32).numpy()
    return np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)


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


STEP_KW = dict(theta_d=0.3, theta_u=0.4, local_lr=1e-2)


def _reference_steps(arch, ef):
    """The reference's two train steps on an arch's smoke config: (state,
    [loss])."""
    cfg_r, _, params, _, batch = _family(arch)
    dr = RD.DistConfig(backend="jnp", use_error_feedback=ef, **STEP_KW)
    sr = RD.init_state(params, dr, mesh=None)
    step_r = jax.jit(RD.make_train_step(cfg_r, dr, mesh=None))
    batch_r = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(2):
        sr, mr = step_r(sr, batch_r)
        losses.append(float(mr["loss"]))
    return sr, losses


@pytest.fixture(scope="module")
def reference_steps():
    """{(arch, ef): the reference's two steps} of every case, computed once
    for the module: the archs' initial params, then every case's compile
    and steps, each on a thread of its own."""
    cases = [(a, ef) for a in FAMILIES for ef in (False, True)]
    with concurrent.futures.ThreadPoolExecutor(REFERENCE_THREADS) as ex:
        list(ex.map(_family, FAMILIES))
        return dict(zip(cases, ex.map(lambda c: _reference_steps(*c),
                                      cases)))


def _port_steps(arch, ef):
    """The port's two train steps on an arch's smoke config: (state,
    [loss])."""
    _, cfg_t, _, pt, batch = _family(arch)
    dt = TD.DistConfig(use_error_feedback=ef, **STEP_KW)
    st = TD.init_state(pt, dt)
    step_t = TD.make_train_step(cfg_t, dt, device="cpu")
    batch_t = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    losses = []
    for _ in range(2):
        st, mt = step_t(st, batch_t)
        losses.append(float(mt["loss"]))
    return st, losses


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_two_train_steps_of_every_family_match_reference(reference_steps,
                                                         arch, ef):
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
    sr, losses_r = reference_steps[(arch, ef)]
    st, losses_t = _port_steps(arch, ef)
    for lr_, lt in zip(losses_r, losses_t):
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
