"""repro_torch's MoE (models/moe.py) and MLA (models/mla.py) units against
the reference's, on the same numpy inputs, on the CPU.

Tolerances (f32):
* routing weights and ids: ids exact unless the k-th and (k+1)-th
  probabilities lie within rtol 1e-5 (a near-tie that an ulp of the
  router logits can flip; none at these seeds), weights atol 1e-6;
* ``routed_experts_local`` (with and without capacity drops), ``moe_ffn``
  and ``aux_load_loss``: atol 1e-5 (magnitudes ~1; the batched matmuls sum
  in other orders);
* gradients through dispatch and combine: relative L2 1e-5, the dense
  Track-B bound;
* MLA: train and decode against the reference's atol 1e-5; absorbed decode
  against the materialized train path atol 1e-4 (the reference's own
  bound in tests/test_models.py).
The hypothesis properties mirror tests/test_moe_properties.py on the
port, derandomized so every run draws the same examples.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import hypothesis.strategies as st  # noqa: E402
from hypothesis import given, settings  # noqa: E402

import repro.configs as R_CFG  # noqa: E402
import repro_torch.configs as T_CFG  # noqa: E402
from repro.models import mla as R_MLA  # noqa: E402
from repro.models import moe as R_MOE  # noqa: E402
from repro_torch.models import layers as T_L  # noqa: E402
from repro_torch.models import mla as T_MLA  # noqa: E402
from repro_torch.models import moe as T_MOE  # noqa: E402

ATOL = 1e-5
TIE_RTOL = 1e-5
GRAD_REL = 1e-5
PROPS = settings(deadline=None, max_examples=20, derandomize=True)


def _rng(seed):
    return np.random.default_rng(np.random.SeedSequence(seed,
                                                        spawn_key=(101,)))


def _experts(rng, e, d, f, scale=0.3):
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in ((e, d, f), (e, d, f), (e, f, d))]


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


# --- routing -----------------------------------------------------------------

@pytest.mark.parametrize("t,e,k", [(32, 8, 2), (64, 16, 1), (40, 256, 8),
                                   (17, 4, 3)])
def test_route_matches_reference(t, e, k):
    rng = _rng(t + e + k)
    x = rng.standard_normal((t, 24)).astype(np.float32)
    router = (rng.standard_normal((24, e)) * 0.3).astype(np.float32)
    ids_r, w_r = R_MOE.route(*_j(x, router), k)
    ids_t, w_t = T_MOE.route(*_t(x, router), k)
    assert ids_t.dtype == torch.int32 and w_t.dtype == torch.float32
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ router, -1))
    srt = -np.sort(-probs, axis=1)
    gap = np.abs(srt[:, k - 1] - srt[:, min(k, e - 1)])
    near = gap <= TIE_RTOL * srt[:, k - 1]
    differ = (np.asarray(ids_r) != ids_t.numpy()).any(1)
    assert not (differ & ~near).any(), np.nonzero(differ)[0]
    np.testing.assert_allclose(w_t.numpy()[~differ], np.asarray(w_r)[~differ],
                               atol=1e-6)
    np.testing.assert_allclose(
        float(T_MOE.aux_load_loss(*_t(x, router), k)),
        float(R_MOE.aux_load_loss(*_j(x, router), k)), atol=ATOL)


def test_exact_ties_go_to_the_lower_expert_like_lax_top_k():
    x = np.zeros((3, 4), np.float32)           # every prob 1/E: all tied
    router = np.ones((4, 6), np.float32)
    ids_r, _ = R_MOE.route(*_j(x, router), 3)
    ids_t, _ = T_MOE.route(*_t(x, router), 3)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_r))
    np.testing.assert_array_equal(ids_t.numpy(), [[0, 1, 2]] * 3)


@pytest.mark.parametrize("n,k,e,cf", [(4, 8, 256, 1.25), (192, 8, 256, 1.25),
                                      (192, 1, 16, 1.25), (1024, 1, 16, 1.25),
                                      (32, 2, 8, 1.25), (1, 1, 16, 1.0)])
def test_capacity_matches_reference(n, k, e, cf):
    assert T_MOE._capacity(n, k, e, cf) == R_MOE._capacity(n, k, e, cf)


# --- dispatch and combine ----------------------------------------------------

@pytest.mark.parametrize("cap", [1024, 6, 3], ids=["ample", "drops", "tight"])
@pytest.mark.parametrize("e_start,e_loc", [(0, 8), (3, 2)])
def test_routed_experts_local_matches_reference(cap, e_start, e_loc):
    rng = _rng(cap + e_start)
    t, d, f, e, k = 24, 16, 12, 8, 2
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = rng.standard_normal((d, e)).astype(np.float32)
    ids, wts = R_MOE.route(*_j(x, router), k)
    ws = _experts(rng, e_loc, d, f)
    want = R_MOE.routed_experts_local(jnp.asarray(x), ids, wts, *_j(*ws),
                                      e_start, e, cap)
    drops = []
    got = T_MOE.routed_experts_local(
        *_t(x, np.asarray(ids), np.asarray(wts), *ws), e_start, e, cap,
        drops)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the drop mask: tokens with an in-slice assignment ranked past cap
    ids_np = np.asarray(ids)
    want_drop = np.zeros(t, bool)
    for ex in range(e_start, e_start + e_loc):
        hits = [i // k for i in range(t * k) if ids_np.reshape(-1)[i] == ex]
        for tok in hits[cap:]:
            want_drop[tok] = True
    np.testing.assert_array_equal(drops[0].numpy(), want_drop)
    assert want_drop.any() == (cap < 1024)


def test_gradients_through_dispatch_and_combine_match_reference():
    rng = _rng(7)
    t, d, f, e, k = 20, 16, 8, 4, 2
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = rng.standard_normal((d, e)).astype(np.float32)
    ws = _experts(rng, e, d, f)
    cap = 8                                   # some drops

    def ref(x, router, wg, wu, wd):
        ids, wts = R_MOE.route(x, router, k)
        return jnp.sum(R_MOE.routed_experts_local(x, ids, wts, wg, wu, wd,
                                                  0, e, cap) ** 2)
    g_r = jax.jit(jax.grad(ref, argnums=(0, 1, 2, 3, 4)))(*_j(x, router,
                                                             *ws))
    args = [a.requires_grad_(True) for a in _t(x, router, *ws)]
    ids, wts = T_MOE.route(args[0], args[1], k)
    y = T_MOE.routed_experts_local(args[0], ids, wts, *args[2:], 0, e, cap)
    g_t = torch.autograd.grad(torch.sum(y ** 2), args)
    for a, b in zip(g_r, g_t):
        a = np.asarray(a)
        assert np.linalg.norm(b.numpy() - a) <= GRAD_REL * np.linalg.norm(a)


def test_combine_and_dispatch_fold_in_ascending_slot_order():
    """Each token's terms are added one by one from 0 in ascending slot
    order (the order of XLA's CPU scatter-add), forward and backward: the
    port's result equals that sequential fold bit for bit."""
    rng = _rng(8)
    t, d, f, e, k = 12, 8, 8, 4, 3
    x = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    x.requires_grad_(True)
    ws = [w.requires_grad_(True) for w in _t(*_experts(rng, e, d, f))]
    ids = torch.from_numpy(np.stack([rng.permutation(e)[:k]
                                     for _ in range(t)]).astype(np.int32))
    wts = torch.from_numpy(rng.uniform(0.1, 1, (t, k)).astype(np.float32))
    cap = 16
    y = T_MOE.routed_experts_local(x, ids, wts, *ws, 0, e, cap)
    gy = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    gx = torch.autograd.grad(y, x, gy)[0]
    with torch.no_grad():
        outs = [torch.nn.functional.silu(x @ ws[0][i]) * (x @ ws[1][i])
                @ ws[2][i] for i in range(e)]
    want = torch.zeros_like(y)
    for tok in range(t):
        for ex in sorted(ids[tok].tolist()):   # ascending slot = expert id
            j = ids[tok].tolist().index(ex)
            want[tok] = want[tok] + outs[ex][tok] * wts[tok, j]
    assert torch.equal(y.detach(), want)
    # backward of the dispatch: per token, ascending slot order from 0
    xe = x.detach().clone().requires_grad_(True)
    parts = []
    for ex in range(e):
        parts.append(torch.autograd.grad(
            (torch.nn.functional.silu(xe @ ws[0][ex]) * (xe @ ws[1][ex])
             @ ws[2][ex] * (wts * (ids == ex)).sum(1, keepdim=True)
             * gy).sum(), xe, retain_graph=True)[0])
    fold = torch.zeros_like(gx)
    for tok in range(t):
        for ex in sorted(ids[tok].tolist()):
            fold[tok] = fold[tok] + parts[ex][tok]
    np.testing.assert_allclose(gx.numpy(), fold.numpy(), atol=1e-6)


def test_moe_ffn_matches_reference_and_refuses_a_mesh():
    rcfg = R_CFG.get("deepseek_v3_671b").smoke()
    tcfg = T_CFG.get("deepseek_v3_671b").smoke()
    rng = _rng(9)
    d, e, f = rcfg.d_model, rcfg.n_experts, rcfg.d_ff_expert
    p = dict(zip(("w_gate", "w_up", "w_down"), _experts(rng, e, d, f, 0.1)))
    p["router"] = (rng.standard_normal((d, e)) * 0.1).astype(np.float32)
    x = rng.standard_normal((2, 16, d)).astype(np.float32)
    want = R_MOE.moe_ffn(jnp.asarray(x), {k: jnp.asarray(v)
                                          for k, v in p.items()}, rcfg)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = T_MOE.moe_ffn(torch.from_numpy(x), tp, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the sharded branch is held to the reference in test_torch_pod_mesh.py
    with pytest.raises(TypeError, match="Mesh"):
        T_MOE.moe_ffn(torch.from_numpy(x), tp, tcfg, mesh=object())


# --- the four properties of tests/test_moe_properties.py ---------------------

@PROPS
@given(t=st.integers(4, 64), e=st.sampled_from([4, 8]),
       k=st.integers(1, 3), seed=st.integers(0, 50))
def test_property_routing_weights_normalized_and_ids_valid(t, e, k, seed):
    k = min(k, e)
    rng = _rng(seed)
    x = torch.from_numpy(rng.standard_normal((t, 16)).astype(np.float32))
    router = torch.from_numpy(rng.standard_normal((16, e)).astype(np.float32))
    ids, wts = T_MOE.route(x, router, k)
    assert int(ids.min()) >= 0 and int(ids.max()) < e
    np.testing.assert_allclose(wts.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert bool((wts >= 0).all())


@PROPS
@given(t=st.integers(4, 48), seed=st.integers(0, 30))
def test_property_dispatch_no_token_double_count(t, seed):
    d, e, k, cap = 8, 4, 2, 1024                 # ample: no drops
    rng = _rng(seed)
    x = torch.ones((t, d))
    ids = torch.from_numpy(rng.integers(0, e, (t, k)).astype(np.int32))
    wts = torch.full((t, k), 0.5)
    wg, wu, wd = _t(*_experts(rng, e, d, d))
    y = T_MOE.routed_experts_local(x, ids, wts, wg, wu, wd, 0, e, cap)
    ref = torch.zeros((t, d))
    for ti in range(t):
        for j in range(k):
            eid = int(ids[ti, j])
            h = torch.nn.functional.silu(x[ti] @ wg[eid]) * (x[ti] @ wu[eid])
            ref[ti] += 0.5 * (h @ wd[eid])
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=2e-4, atol=2e-5)


@PROPS
@given(seed=st.integers(0, 30))
def test_property_capacity_drops_monotone(seed):
    t, d, e, k = 32, 8, 4, 2
    x = torch.from_numpy(_rng(seed).standard_normal((t, d)).astype(np.float32))
    ids = torch.zeros((t, k), dtype=torch.int32)   # all to expert 0
    wts = torch.full((t, k), 0.5)
    w = torch.full((e, d, d), 0.1)
    served = []
    for cap in (4, 16, 64):
        y = T_MOE.routed_experts_local(x, ids, wts, w, w, w, 0, e, cap)
        served.append(int(((y != 0).sum(1) > 0).sum()))
    assert served[0] <= served[1] <= served[2] == t


@PROPS
@given(e_start=st.integers(0, 3))
def test_property_expert_slices_sum_to_whole(e_start):
    t, d, e, k, cap = 24, 8, 4, 2, 1024
    rng = _rng(7)
    x = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    router = torch.from_numpy(rng.standard_normal((d, e)).astype(np.float32))
    ids, wts = T_MOE.route(x, router, k)
    wg, wu, wd = _t(*_experts(rng, e, d, d, 0.2))
    full = T_MOE.routed_experts_local(x, ids, wts, wg, wu, wd, 0, e, cap)
    parts = sum(T_MOE.routed_experts_local(
        x, ids, wts, wg[s:s + 1], wu[s:s + 1], wd[s:s + 1], s, e, cap)
        for s in range(e))
    np.testing.assert_allclose(parts.numpy(), full.numpy(), rtol=2e-4,
                               atol=2e-5)
    lone = T_MOE.routed_experts_local(x, ids, wts, wg[e_start:e_start + 1],
                                      wu[e_start:e_start + 1],
                                      wd[e_start:e_start + 1], e_start, e, cap)
    assert bool(((lone != 0).any(1) == (ids == e_start).any(1)).all())


# --- MLA ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla():
    rcfg = R_CFG.get("deepseek_v3_671b").smoke()
    tcfg = T_CFG.get("deepseek_v3_671b").smoke()
    rp = R_MLA.init_mla_params(jax.random.PRNGKey(0), rcfg, jnp.float32)
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in rp.items()}
    x = (_rng(10).standard_normal((2, 8, rcfg.d_model)) * 0.5
         ).astype(np.float32)
    return rcfg, tcfg, rp, tp, x


def _mla_rope(cfg, positions):
    return T_L.rope_freqs(cfg.qk_rope_dim, cfg.rope_theta, positions)


def test_mla_params_layout_matches_reference(mla):
    rcfg, tcfg, rp, _, _ = mla
    make = T_L.ParamMaker(torch.Generator().manual_seed(0), "cpu")
    tp = T_MLA.init_mla_params(make, tcfg, torch.float32)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in rp.items()}
    assert abs(float(tp["w_uk"].std()) - tcfg.kv_lora_rank ** -0.5) < 0.02


def test_mla_train_and_decode_match_reference(mla):
    rcfg, tcfg, rp, tp, x = mla
    b, s = x.shape[:2]
    want, rcache = R_MLA.mla_attention_train(jnp.asarray(x), rp, rcfg,
                                             jnp.arange(s))
    got, tcache = T_MLA.mla_attention_train(
        torch.from_numpy(x), tp, tcfg, _mla_rope(tcfg, torch.arange(s)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for k in ("c", "k_rope"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(rcache[k]),
                                   atol=ATOL)
    rc = R_MLA.init_mla_cache(b, 12, rcfg, jnp.float32)
    tc = T_MLA.init_mla_cache(b, 12, tcfg, torch.float32, "cpu")
    rl = jnp.array([0, 3], jnp.int32)
    tl = torch.tensor([0, 3], dtype=torch.int32)
    step = jax.jit(lambda x, p, c, n: R_MLA.mla_attention_decode(
        x, p, rcfg, c, n))
    for i in range(s):
        a, rc = step(jnp.asarray(x[:, i:i + 1]), rp, rc, rl)
        o, tc = T_MLA.mla_attention_decode(
            torch.from_numpy(x[:, i:i + 1]), tp, tcfg, tc, tl,
            _mla_rope(tcfg, tl[:, None]))
        np.testing.assert_allclose(o.numpy(), np.asarray(a), atol=ATOL)
        rl, tl = rl + 1, tl + 1
    for k in ("c", "k_rope"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(rc[k]),
                                   atol=ATOL)


def test_mla_decode_matches_train(mla):
    """Absorbed decode == materialized train attention (the same math;
    mirror of tests/test_models.py's check)."""
    _, tcfg, _, tp, x = mla
    x = torch.from_numpy(x[:1])
    s = x.shape[1]
    out_train, _ = T_MLA.mla_attention_train(
        x, tp, tcfg, _mla_rope(tcfg, torch.arange(s)))
    cache = T_MLA.init_mla_cache(1, 16, tcfg, torch.float32, "cpu")
    length = torch.zeros(1, dtype=torch.int32)
    outs = []
    for i in range(s):
        o, cache = T_MLA.mla_attention_decode(
            x[:, i:i + 1], tp, tcfg, cache, length,
            _mla_rope(tcfg, length[:, None]))
        outs.append(o[:, 0])
        length = length + 1
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               out_train.numpy(), rtol=1e-4, atol=1e-4)


def test_mla_place_at_writes_in_place_like_the_one_hot_blend():
    rng = _rng(11)
    cache = rng.standard_normal((3, 7, 5)).astype(np.float32)
    new = rng.standard_normal((3, 1, 5)).astype(np.float32)
    length = np.array([0, 6, 3], np.int32)
    want = np.asarray(R_MLA._place_at(*_j(cache, new, length)))
    t = torch.from_numpy(cache.copy())
    out = T_L.place_at(t, torch.from_numpy(new), torch.from_numpy(length))
    assert out.data_ptr() == t.data_ptr()
    np.testing.assert_array_equal(t.numpy(), want)


def test_llama4_smoke_moe_layer_has_shared_expert_and_no_dense_stack():
    cfg = dataclasses.replace(T_CFG.get("llama4_scout_17b_a16e").smoke())
    make = T_L.ParamMaker(None, torch.device("meta"))
    p = T_MOE.init_moe_params(make, cfg, torch.bfloat16,
                              lambda mk, f: {"w_gate": mk.dense(
                                  cfg.d_model, f, torch.bfloat16)})
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].dtype == torch.bfloat16
    assert tuple(p["shared"]["w_gate"].shape) == (cfg.d_model,
                                                  cfg.d_ff_expert)
