"""repro_torch's LM families other than dense — MoE (DeepSeek-V3 with MLA,
Llama-4-Scout with GQA and an empty dense stack), Mamba2, the Zamba2
hybrid, the HuBERT encoder (audio frontend) and InternVL2 (vision
frontend) — against the reference's, whole model at each arch's smoke
config on the CPU, with the reference's own initial weights carried over
by ``from_reference``; and every arch's ``init_abstract`` at full size.

Tolerances, all f32, the dense ones (tests/test_torch_lm.py,
tests/test_torch_distributed.py) wherever they hold:
* logits of ``forward``, ``prefill`` and every ``decode_step``: atol 1e-4
  (the two frameworks' matmuls and reductions sum in other orders);
* caches after 16 decode steps: atol 1e-5 (K/V, MLA latents, conv
  states). The SSM state is a running sum of B·x·dt outer products over
  16 steps with entries up to ~30, so its atol is 1e-5 relative to its
  max |value| (measured ≤ 2e-6 relative);
* loss rtol 2e-6 and every gradient leaf within relative L2 1e-5, but
  Llama-4-Scout's router: with top-1 routing the normalized weight is
  p/p ≡ 1, its true gradient is 0 and both frameworks' values are
  rounding residue, held to |g| ≤ 1e-7 instead;
* greedy tokens of the serve loop: exact.
MoE routing: the port takes the top k with a stable sort as
``jax.lax.top_k`` does; router logits may differ by an ulp between the
frameworks, so `_route_swaps` counts the rows whose ids differ and the
test allows none unless the k-th and (k+1)-th probabilities lie within
rtol 1e-5 (no such row at these inputs).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as R_CFG  # noqa: E402
import repro_torch.configs as T_CFG  # noqa: E402
from repro.models import model as R_M  # noqa: E402
from repro.models import moe as R_MOE  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.fl import distributed as TD  # noqa: E402
from repro_torch.models import model as T_M  # noqa: E402
from repro_torch.models import moe as T_MOE  # noqa: E402

LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5
LOSS_RTOL = 2e-6
LEAF_REL = 1e-5
TIE_RTOL = 1e-5
FAMILIES = [a for a in R_CFG.ARCH_IDS if R_CFG.get(a).family != "dense"]
DECODERS = [a for a in FAMILIES if R_CFG.get(a).supports_decode]
B, S = 2, 16


def _rng(seed):
    return np.random.default_rng(np.random.SeedSequence(seed,
                                                        spawn_key=(99,)))


def make_batch(cfg, seed=1, b=B, s=S) -> dict:
    """numpy batch of the arch's inputs (frames / patches + text)."""
    rng = _rng(seed)
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal(
                    (b, s, cfg.frontend_dim)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    st = s - cfg.n_patches if cfg.frontend == "vision" else s
    toks = rng.integers(0, cfg.vocab, (b, st)).astype(np.int32)
    out = {"tokens": toks, "labels": toks}
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


class Model:
    """One arch at its smoke config, with the reference's jitted entry
    points (shared by the tests of this module)."""

    def __init__(self, arch):
        self.arch = arch
        self.rcfg = R_CFG.get(arch).smoke()
        self.tcfg = T_CFG.get(arch).smoke()
        self.rp = jax.jit(R_M.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), self.rcfg)
        self.tp = T_M.from_reference(jax.tree.map(np.asarray, self.rp),
                                     self.tcfg, device="cpu")
        self.batch = make_batch(self.rcfg)
        cfg = self.rcfg
        # one compile for the logits, the loss and its gradient
        self.logits_loss_grad = jax.jit(jax.value_and_grad(
            lambda p, b: (R_M.loss_fn(p, b, cfg), R_M.forward(p, b, cfg)),
            has_aux=True))
        self.decode = jax.jit(lambda p, c, t, n: R_M.decode_step(
            p, c, {"tokens": t}, n, cfg))


_MODELS: dict = {}


def _model(arch) -> Model:
    if arch not in _MODELS:
        _MODELS[arch] = Model(arch)
    return _MODELS[arch]


@pytest.fixture(scope="module", params=FAMILIES)
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module", params=DECODERS)
def decoder(request):
    return _model(request.param)


def _reference(m: Model):
    """(loss, gradient tree, logits) of the reference on the model's
    batch, computed once."""
    if not hasattr(m, "_ref"):
        (loss, logits), grads = m.logits_loss_grad(m.rp, _j(m.batch))
        m._ref = (loss, grads, logits)
    return m._ref


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = b.detach().to(torch.float32).numpy()
    return np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)


# --- parameters --------------------------------------------------------------

def _shapes(tree, torch_tree=False):
    if torch_tree:
        return TD.tree_map(lambda t: (tuple(t.shape),
                                      str(t.dtype).split(".")[-1]), tree)
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), tree)


@pytest.mark.parametrize("arch", R_CFG.ARCH_IDS)
def test_init_abstract_matches_reference_at_full_size(arch):
    """Shapes and dtypes of every leaf (None subtrees included) at the
    published size: the f32 router, ``a_log`` and ``dt_bias`` of a bf16
    model stay f32."""
    want = _shapes(R_M.init_abstract(R_CFG.get(arch)))
    got = T_M.init_abstract(T_CFG.get(arch))
    assert all(t.device.type == "meta" for t in TD.tree_leaves(got))
    assert _shapes(got, torch_tree=True) == want


def test_init_params_distributions_and_from_reference(model):
    cfg = model.tcfg
    p = T_M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(p, True) == _shapes(model.rp)
    assert _shapes(model.tp, True) == _shapes(model.rp)
    for a, b in zip(jax.tree.leaves(model.rp), TD.tree_leaves(model.tp)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jax.tree.leaves(model.rp), TD.tree_leaves(p)):
        a = np.asarray(a)
        if a.size >= 4096:                  # same distribution, own draws
            assert abs(float(b.std()) - a.std()) <= 0.1 * a.std() + 1e-3
            assert abs(float(b.mean())) <= 0.1 * a.std() + 1e-3
        elif a.std() == 0:                  # ones and zeros
            np.testing.assert_array_equal(b.numpy(), a)
    bad = jax.tree.map(np.asarray, model.rp)
    bad.pop("final_norm")
    with pytest.raises(ValueError, match="final_norm"):
        T_M.from_reference(bad, cfg, device="cpu")


def test_empty_stack_is_none_like_the_reference():
    cfg = T_CFG.get("llama4_scout_17b_a16e").smoke()
    p = T_M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert "dense_layers" in p and p["dense_layers"] is None
    c = T_M.init_cache(cfg, 2, 4, device="cpu")
    rc = R_M.init_cache(R_CFG.get("llama4_scout_17b_a16e").smoke(), 2, 4)
    assert tuple(c["dense_layers"]["k"].shape) == rc["dense_layers"]["k"].shape
    assert c["dense_layers"]["k"].shape[0] == 0


# --- the model ---------------------------------------------------------------

def test_forward_and_prefill_match_reference(model):
    want = np.asarray(_reference(model)[2])
    got = T_M.forward(model.tp, _t(model.batch), model.tcfg, device="cpu")
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL)
    np.testing.assert_allclose(
        T_M.prefill(model.tp, _t(model.batch), model.tcfg,
                    device="cpu").numpy(), want[:, -1], atol=LOGIT_ATOL)


def test_loss_and_every_gradient_leaf_match_reference(model):
    l_r, g_r, _ = _reference(model)
    paths = TD._leaf_paths(model.tp)
    leaves = [TD._get(model.tp, q).clone().requires_grad_(True)
              for q in paths]
    tree = TD._skeleton(model.tp)
    for q, leaf in zip(paths, leaves):
        TD._set(tree, q, leaf)
    l_t = T_M.loss_fn(tree, _t(model.batch), model.tcfg, device="cpu")
    g_t = torch.autograd.grad(l_t, leaves, allow_unused=True)
    assert float(l_t.detach()) == pytest.approx(float(l_r), rel=LOSS_RTOL)
    g_r = jax.tree.leaves(g_r)
    assert len(g_r) == len(g_t)
    for q, a, b in zip(paths, g_r, g_t):
        a = np.asarray(a)
        if b is None:                       # a leaf the loss never reads
            assert not a.any(), q
            continue
        assert a.shape == tuple(b.shape), q
        if np.abs(a).max() == 0:
            assert not b.any(), q
        elif q[-1] == "router" and model.tcfg.moe_top_k == 1:
            # top-1: the normalized weight is p/p ≡ 1, so the router's true
            # gradient is 0 and both values are rounding residue (measured
            # ≤ 2e-9 against ~1e-3 for the weights)
            assert max(np.abs(a).max(), float(b.abs().max())) <= 1e-7, q
        else:
            assert _rel(a, b) <= LEAF_REL, (q, _rel(a, b))


def test_loss_slices_the_frontends_like_the_reference(model):
    """The VLM's loss reads only the text positions; the encoder's labels
    are per frame (no shift)."""
    cfg = model.tcfg
    base = float(T_M.loss_fn(model.tp, _t(model.batch), cfg, device="cpu"))
    lab = model.batch["labels"].copy()
    if cfg.family == "encoder":             # frame 0 is a target
        lab[:, 0] = (lab[:, 0] + 1) % cfg.vocab
    else:                                   # the first text token is not
        lab[:, 0] = -1
    got = float(T_M.loss_fn(model.tp, _t({**model.batch, "labels": lab}),
                            cfg, device="cpu"))
    if cfg.family == "encoder":
        assert got != base
    else:
        assert got == pytest.approx(base, rel=1e-6)


def _route_swaps(x2d_np, router_np, k):
    """Rows whose top-k ids differ between the frameworks, and whether each
    lies on a near-tie of the k-th and (k+1)-th probabilities."""
    ids_r, _ = R_MOE.route(jnp.asarray(x2d_np), jnp.asarray(router_np), k)
    ids_t, _ = T_MOE.route(torch.from_numpy(x2d_np.copy()),
                           torch.from_numpy(router_np.copy()), k)
    rows = np.nonzero((np.asarray(ids_r) != ids_t.numpy()).any(1))[0]
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x2d_np) @ router_np, -1))
    srt = -np.sort(-probs, axis=1)
    return [(int(r), abs(srt[r, k - 1] - srt[r, k]) <= TIE_RTOL * srt[r, k])
            for r in rows]


def test_decode_steps_and_caches_match_reference(decoder):
    """16 teacher-forced steps: logits at every step, every cache at the
    end; and the port's decode agrees with its own forward on each row's
    positions before the forward's first capacity drop (a causal position
    sees only earlier ones; 2 decode tokens never overflow a capacity of
    8)."""
    m = decoder
    rcfg, tcfg = m.rcfg, m.tcfg
    toks = m.batch["tokens"]               # the VLM decodes text only
    s = toks.shape[1]
    rc = R_M.init_cache(rcfg, B, s)
    tc = T_M.init_cache(tcfg, B, s, device="cpu")
    fwd_batch = {"tokens": torch.from_numpy(toks)}
    if tcfg.frontend == "vision":            # text-only forward: no patches
        fwd_batch["patches"] = torch.zeros((B, 0, tcfg.frontend_dim))
    T_MOE.record_routes = []
    try:
        fwd = T_M.forward(m.tp, fwd_batch, tcfg, device="cpu").numpy()
        drops = [d for _, d in T_MOE.record_routes]
        T_MOE.record_routes = []
        rl = jnp.zeros(B, jnp.int32)
        tl = torch.zeros(B, dtype=torch.int32)
        K.reset_launch_counts()
        for i in range(s):
            a, rc = m.decode(m.rp, rc, jnp.asarray(toks[:, i:i + 1]), rl)
            b, tc = T_M.decode_step(m.tp, tc, {"tokens": torch.from_numpy(
                toks[:, i:i + 1])}, tl, tcfg, device="cpu")
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       atol=LOGIT_ATOL, err_msg=f"step {i}")
            rl, tl = rl + 1, tl + 1
        dec_drops = [d for _, d in T_MOE.record_routes]
    finally:
        T_MOE.record_routes = None
    assert not any(bool(d.any()) for d in dec_drops)
    clean = np.full(B, s)
    for d in drops:
        d = d.numpy().reshape(B, s)
        for r in range(B):
            hit = np.nonzero(d[r])[0]
            if len(hit):
                clean[r] = min(clean[r], hit[0])
    paths = TD._leaf_paths(tc)
    assert len(paths) == len(jax.tree.leaves(rc))
    for q, want in zip(paths, jax.tree.leaves(rc)):
        got = TD._get(tc, q)
        assert tuple(got.shape) == want.shape, q
        want = np.asarray(want)
        atol = CACHE_ATOL * (max(1.0, float(np.abs(want).max()))
                             if q[0] == "ssm" else 1.0)
        np.testing.assert_allclose(got.numpy(), want, atol=atol,
                                   err_msg=str(q))
    assert K.launch_counts()["decode_attention"] == 0    # CPU: the twin
    assert clean.sum() > 0
    # decode vs the port's own forward, before each row's first drop
    tc = T_M.init_cache(tcfg, B, s, device="cpu")
    tl = torch.zeros(B, dtype=torch.int32)
    for i in range(s):
        b, tc = T_M.decode_step(m.tp, tc, {"tokens": torch.from_numpy(
            toks[:, i:i + 1])}, tl, tcfg, device="cpu")
        tl = tl + 1
        rows = clean > i
        np.testing.assert_allclose(b.numpy()[rows], fwd[rows, i],
                                   atol=LOGIT_ATOL,
                                   err_msg=f"decode vs forward, step {i}")


def test_greedy_serve_loop_matches_reference(decoder):
    m = decoder
    toks = m.batch["tokens"]
    p, new = min(6, toks.shape[1]), 5
    prompt = toks[:, :p]
    rc = R_M.init_cache(m.rcfg, B, p + new)
    length = jnp.zeros(B, jnp.int32)
    tok, want = jnp.asarray(prompt[:, :1]), []
    for i in range(p + new - 1):
        logits, rc = m.decode(m.rp, rc, tok, length)
        length = length + 1
        if i + 1 < p:
            tok = jnp.asarray(prompt[:, i + 1:i + 2])
        else:
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            want.append(np.asarray(tok))
    got = T_M.generate(m.tp, m.tcfg, torch.from_numpy(prompt), new,
                       device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, 1))


@pytest.mark.parametrize("arch", [a for a in FAMILIES
                                  if R_CFG.get(a).family == "moe"])
def test_routing_of_the_model_has_no_unstated_swaps(arch):
    """The first MoE layer's router on the embeddings of the model's batch:
    ids equal the reference's but on stated near-ties."""
    m = _model(arch)
    router = np.asarray(m.rp["moe_layers"]["ffn"]["router"][0])
    x = np.asarray(m.rp["embed"])[m.batch["tokens"].reshape(-1)]
    swaps = _route_swaps(x.astype(np.float32), router, m.rcfg.moe_top_k)
    assert all(tie for _, tie in swaps), swaps


def test_encoder_has_no_decode_and_is_bidirectional():
    """The encoder raises on the decode entry points as the reference does;
    its attention is not causal: moving a late frame changes the first
    frame's logits (mirror of tests/test_models.py's check)."""
    cfg = T_CFG.get("hubert_xlarge").smoke()
    p = T_M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    one = torch.zeros(1, 1, dtype=torch.int32)
    for fn in (lambda: T_M.init_cache(cfg, 1, 4, device="cpu"),
               lambda: T_M.decode_step(p, {}, {"tokens": one}, one[0], cfg,
                                       device="cpu"),
               lambda: T_M.generate(p, cfg, torch.zeros(1, 2,
                                                        dtype=torch.int32),
                                    2, device="cpu")):
        with pytest.raises(ValueError, match="does not support decode"):
            fn()
    b = _t(make_batch(cfg, b=1, s=16))
    l1 = T_M.forward(p, b, cfg, device="cpu")
    frames2 = b["frames"].clone()
    frames2[:, -1] += 10.0
    l2 = T_M.forward(p, {**b, "frames": frames2}, cfg, device="cpu")
    assert float((l1[:, 0] - l2[:, 0]).abs().max()) > 1e-6
    # a causal decoder's first logits do not move
    dcfg = T_CFG.get("mamba2_780m").smoke()
    dp = T_M.init_params(dcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    t1 = torch.from_numpy(make_batch(dcfg)["tokens"])
    t2 = t1.clone()
    t2[:, -1] = (t2[:, -1] + 1) % dcfg.vocab
    a = T_M.forward(dp, {"tokens": t1}, dcfg, device="cpu")
    c = T_M.forward(dp, {"tokens": t2}, dcfg, device="cpu")
    assert torch.equal(a[:, :-1], c[:, :-1])


def test_bf16_models_keep_their_f32_leaves():
    for arch in ("llama4_scout_17b_a16e", "zamba2_1p2b"):
        cfg = dataclasses.replace(T_CFG.get(arch).smoke(), dtype="bfloat16")
        p = T_M.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
        f32 = {q[-1] for q in TD._leaf_paths(p)
               if TD._get(p, q).dtype == torch.float32}
        assert f32 == ({"router"} if cfg.family == "moe"
                       else {"a_log", "dt_bias"})
        b = _t(make_batch(cfg))
        out = T_M.forward(p, b, cfg, device="cpu")
        assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
