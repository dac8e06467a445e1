"""repro_torch's dense LM (models/{config,layers,model}.py and configs/)
against the reference's, at smoke size on the CPU, with the reference's
own initial weights carried over by ``from_reference``.

Models: the smoke variants of qwen1p5_4b (QKV bias) and phi4_mini_3p8b
(2 layers, d_model 128, 4 heads over 2 kv heads: G = 2), in f32.

Tolerances, all f32:
* logits of ``forward``, ``prefill`` and every ``decode_step``: atol 1e-4
  (magnitudes up to ~4). The two frameworks' matmuls and reductions sum in
  other orders and XLA's rsqrt/exp/sin/cos differ by an ulp; measured
  ≤ 5e-6. A layout or masking error gives O(1) differences.
* KV caches after 16 decode steps: atol 1e-5 (RoPE'd projections, ≤ 3e-6
  measured).
* layers: atol 1e-5 for norms, RoPE, SwiGLU and chunked attention.
* greedy tokens of the serve loop: exact (the logits agree to 5e-6 and no
  two top logits of these inputs lie that close).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as R_CFG  # noqa: E402
import repro_torch.configs as T_CFG  # noqa: E402
from repro.models import layers as R_L  # noqa: E402
from repro.models import model as R_M  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.models import layers as T_L  # noqa: E402
from repro_torch.models import model as T_M  # noqa: E402

LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5
LAYER_ATOL = 1e-5
ARCHS = ["qwen1p5_4b", "phi4_mini_3p8b"]
B, S = 2, 16


def _rng(seed):
    return np.random.default_rng(np.random.SeedSequence(seed,
                                                        spawn_key=(97,)))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    rcfg = R_CFG.get(request.param).smoke()
    tcfg = T_CFG.get(request.param).smoke()
    rp = R_M.init_params(jax.random.PRNGKey(0), rcfg)
    tp = T_M.from_reference(jax.tree.map(np.asarray, rp), tcfg, device="cpu")
    tokens = _rng(1).integers(0, rcfg.vocab, (B, S)).astype(np.int32)
    return rcfg, rp, tcfg, tp, tokens


# --- configs -----------------------------------------------------------------

@pytest.mark.parametrize("arch", R_CFG.ARCH_IDS)
def test_configs_equal_reference_field_by_field(arch):
    a, b = R_CFG.get(arch), T_CFG.get(arch)
    assert dataclasses.asdict(b) == dataclasses.asdict(a)
    assert dataclasses.asdict(b.smoke()) == dataclasses.asdict(a.smoke())
    for prop in ("head_dim", "supports_decode", "d_inner", "ssm_heads",
                 "is_attention_free", "supports_long_context"):
        assert getattr(b, prop) == getattr(a, prop), prop


def test_config_ids_and_aliases_resolve_the_same():
    assert T_CFG.ARCH_IDS == R_CFG.ARCH_IDS
    assert T_CFG.ALIASES == R_CFG.ALIASES
    for alias, arch in T_CFG.ALIASES.items():
        assert T_CFG.get(alias) is T_CFG.get(arch)


# --- layers ------------------------------------------------------------------

def test_norm_rope_swiglu_match_reference():
    rng = _rng(2)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        T_L.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(R_L.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=LAYER_ATOL)
    for pos in (np.arange(5), np.array([[3], [9]]) + np.zeros((2, 5), int)):
        pos = pos.astype(np.int32)
        rc, rs = R_L.rope_freqs(16, 10000.0, jnp.asarray(pos))
        tc, ts = T_L.rope_freqs(16, 10000.0, torch.from_numpy(pos))
        np.testing.assert_allclose(tc.numpy(), np.asarray(rc),
                                   atol=LAYER_ATOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(rs),
                                   atol=LAYER_ATOL)
        np.testing.assert_allclose(
            T_L.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
            np.asarray(R_L.apply_rope(jnp.asarray(x), rc, rs)),
            atol=LAYER_ATOL)
    w = [rng.standard_normal(s).astype(np.float32) * 0.2
         for s in ((16, 24), (16, 24), (24, 16))]
    np.testing.assert_allclose(
        T_L.swiglu(torch.from_numpy(x), *map(torch.from_numpy, w)).numpy(),
        np.asarray(R_L.swiglu(jnp.asarray(x), *map(jnp.asarray, w))),
        atol=LAYER_ATOL)


@pytest.mark.parametrize("causal,q_off,blocks", [
    (True, 0, (4, 8)), (False, 0, (8, 4)), (True, 8, (16, 16))])
def test_chunked_attention_matches_reference(causal, q_off, blocks):
    rng = _rng(3)
    q = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 24 if q_off else 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    kw = dict(causal=causal, q_block=blocks[0], kv_block=blocks[1],
              q_offset=q_off)
    got = T_L.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = R_L.flash_attention_jnp(*map(jnp.asarray, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_ATOL)


def test_init_distributions_and_layout():
    cfg = T_CFG.get("qwen1p5_4b").smoke()
    p = T_M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = jax.tree.map(np.asarray,
                       R_M.init_params(jax.random.PRNGKey(0),
                                       R_CFG.get("qwen1p5_4b").smoke()))
    shapes = jax.tree.map(lambda a: a.shape, ref)
    got = jax.tree.map(lambda t: tuple(t.shape), p)
    assert got == shapes
    wq = p["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.01
    assert abs(float(p["embed"].std()) - 0.02) < 0.002
    assert float(p["layers"]["attn"]["bq"].abs().sum()) == 0.0
    assert torch.equal(p["final_norm"], torch.ones(cfg.d_model))


# --- the model ---------------------------------------------------------------

def test_forward_and_prefill_match_reference(model):
    rcfg, rp, tcfg, tp, tokens = model
    want = np.asarray(R_M.forward(rp, {"tokens": jnp.asarray(tokens)}, rcfg))
    batch = {"tokens": torch.from_numpy(tokens)}
    got = T_M.forward(tp, batch, tcfg, device="cpu").numpy()
    assert got.shape == (B, S, tcfg.vocab)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)
    np.testing.assert_allclose(
        T_M.prefill(tp, batch, tcfg, device="cpu").numpy(),
        np.asarray(R_M.prefill(rp, {"tokens": jnp.asarray(tokens)}, rcfg)),
        atol=LOGIT_ATOL)


def test_decode_steps_and_caches_match_reference(model):
    """16 teacher-forced steps: logits at every step, caches at the end;
    and decode agrees with the port's own forward at every position."""
    rcfg, rp, tcfg, tp, tokens = model
    rc = R_M.init_cache(rcfg, B, S)
    tc = T_M.init_cache(tcfg, B, S, device="cpu")
    step = jax.jit(lambda p, c, t, n: R_M.decode_step(p, c, {"tokens": t},
                                                      n, rcfg))
    fwd = T_M.forward(tp, {"tokens": torch.from_numpy(tokens)}, tcfg,
                      device="cpu").numpy()
    rl = jnp.zeros(B, jnp.int32)
    tl = torch.zeros(B, dtype=torch.int32)
    K.reset_launch_counts()
    for i in range(S):
        a, rc = step(rp, rc, jnp.asarray(tokens[:, i:i + 1]), rl)
        b, tc = T_M.decode_step(tp, tc, {"tokens": torch.from_numpy(
            tokens[:, i:i + 1])}, tl, tcfg, device="cpu")
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   atol=LOGIT_ATOL, err_msg=f"step {i}")
        np.testing.assert_allclose(b.numpy(), fwd[:, i], atol=LOGIT_ATOL,
                                   err_msg=f"decode vs forward, step {i}")
        rl, tl = rl + 1, tl + 1
    for name in ("k", "v"):
        assert tuple(tc["layers"][name].shape) == \
            rc["layers"][name].shape
        np.testing.assert_allclose(tc["layers"][name].numpy(),
                                   np.asarray(rc["layers"][name]),
                                   atol=CACHE_ATOL)
    assert K.launch_counts()["decode_attention"] == 0    # CPU: the twin


def test_greedy_serve_loop_matches_reference(model):
    """The serve example's loop (prompt token by token, then argmax)."""
    rcfg, rp, tcfg, tp, tokens = model
    prompt, new = tokens[:, :6], 5
    rc = R_M.init_cache(rcfg, B, 6 + new)
    step = jax.jit(lambda p, c, t, n: R_M.decode_step(p, c, {"tokens": t},
                                                      n, rcfg))
    length = jnp.zeros(B, jnp.int32)
    tok, want = jnp.asarray(prompt[:, :1]), []
    for i in range(6 + new - 1):
        logits, rc = step(rp, rc, tok, length)
        length = length + 1
        if i + 1 < 6:
            tok = jnp.asarray(prompt[:, i + 1:i + 2])
        else:
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            want.append(np.asarray(tok))
    got = T_M.generate(tp, tcfg, torch.from_numpy(prompt), new, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, 1))


def test_place_at_4d_writes_in_place_like_the_one_hot_blend():
    rng = _rng(4)
    cache = rng.standard_normal((3, 7, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
    length = np.array([0, 6, 3], np.int32)
    want = np.asarray(R_M._place_at_4d(*map(jnp.asarray, (cache, new,
                                                          length))))
    t = torch.from_numpy(cache.copy())
    out = T_L.place_at(t, torch.from_numpy(new), torch.from_numpy(length))
    assert out.data_ptr() == t.data_ptr()
    np.testing.assert_array_equal(t.numpy(), want)


def test_entry_points_default_to_cuda_and_never_fall_back(model):
    _, rp, tcfg, tp, tokens = model
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-fallback rule is "
                    "checked where there is none")
    cache = T_M.init_cache(tcfg, B, S, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        T_M.decode_step(tp, cache, {"tokens": torch.from_numpy(
            tokens[:, :1])}, torch.zeros(B, dtype=torch.int32), tcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        T_M.init_cache(tcfg, B, S)
    with pytest.raises(RuntimeError, match="cuda"):
        T_M.init_params(tcfg, torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        T_M.generate(tp, tcfg, torch.from_numpy(tokens), 2)
    with pytest.raises(RuntimeError, match="cuda"):
        T_M.from_reference(jax.tree.map(np.asarray, rp), tcfg)


def test_tensors_on_another_device_are_refused(model):
    _, _, tcfg, tp, tokens = model
    cache = T_M.init_cache(tcfg, B, S, device="cpu")
    with pytest.raises(ValueError, match="meta"):
        T_M.decode_step(tp, cache, {"tokens": torch.zeros(
            B, 1, dtype=torch.int32, device="meta")},
            torch.zeros(B, dtype=torch.int32), tcfg, device="cpu")


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_decode_goes_through_the_kernel_and_matches_cpu(cuda, model):
    _, _, tcfg, tp, tokens = model
    gp = jax.tree.map(lambda t: t.to(cuda), tp)
    prompt = torch.from_numpy(tokens[:, :6])
    K.reset_launch_counts()
    got = T_M.generate(gp, tcfg, prompt.to(cuda), 5)
    assert K.launch_counts()["decode_attention"] == tcfg.n_layers * 10
    want = T_M.generate(tp, tcfg, prompt, 5, device="cpu")
    assert torch.equal(got.cpu(), want)


def test_serve_example_runs_on_cpu_and_refuses_a_missing_card():
    import os
    import subprocess
    import sys
    from pathlib import Path
    ex = Path(__file__).resolve().parents[1] / "examples" / \
        "serve_decode_torch.py"
    r = subprocess.run([sys.executable, str(ex), "--smoke", "--device", "cpu",
                        "--new-tokens", "4"], capture_output=True, text=True,
                       timeout=300, env=dict(os.environ))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "generated 4 tokens/seq × 4 seqs" in r.stdout
    assert "on cpu" in r.stdout and "finite: True" in r.stdout
    if torch.cuda.is_available():
        return
    r = subprocess.run([sys.executable, str(ex), "--smoke"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "cuda" in r.stderr
