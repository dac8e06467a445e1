"""The LM zoo's dense family, counterpart of ``repro.models.model`` without
a mesh (``mesh=None`` only).

Public API (functions of a params dict, as the reference's pytree):
    init_params(cfg, generator, device)          -> params
    from_reference(params_numpy_pytree, cfg, device) -> params (a copy)
    init_cache(cfg, batch, seq, device)          -> cache
    forward(params, batch, cfg, device)          -> logits [B, S, V]
    loss_fn(params, batch, cfg, device)          -> mean next-token CE
    prefill(params, batch, cfg, device)          -> last-position logits
    decode_step(params, cache, batch, length, cfg, device) -> (logits, cache)
    generate(params, cfg, prompt, new_tokens, device)      -> new tokens

Parameters keep the reference's layout: layers stacked along a leading
``[L]`` axis, weights ``[d_in, d_out]``. The layer scan is a Python loop
over that axis. Decode attention goes through the CUDA kernel's wrapper
(`decode_attention`, the name this module looks up at call time); the
Pallas kernel's own docstring calls it "the inference-path counterpart with
identical math" of the reference's ``decode_attention_jnp``.

Every entry point runs on ``device="cuda"`` unless the caller passes
``device="cpu"``, and raises when there is no card; tensors on another
device than the one named are refused. Families other than ``dense`` raise
``NotImplementedError`` naming their ROADMAP item.

Training: `loss_fn` is the reference's next-token cross entropy; its
gradients come from ``torch.autograd`` through `forward` (the train-path
`layers.flash_attention` is plain torch, as in the reference, and
differentiable). Track-B's cohort round (`repro_torch.fl.distributed`)
trains through it.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels.flash_attention import decode_attention
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_NOT_PORTED = {
    "moe": "MoE",
    "ssm": "Mamba2",
    "hybrid": "hybrid (Mamba2 + shared attention)",
    "encoder": "encoder-only",
    "vlm": "VLM (vision frontend)",
}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {_NOT_PORTED[cfg.family]} family is not ported "
            "yet (ROADMAP queue 1, item 14: Track B)")
    if cfg.family != "dense" or cfg.use_mla or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: only the dense family without MLA or a frontend is "
            "ported (ROADMAP queue 1, item 14: Track B)")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; "cuda" without a card raises (the port
    never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _on(t: torch.Tensor, dev: torch.device, what: str) -> None:
    if t.device.type != dev.type:
        raise ValueError(f"{what} is on {t.device}, not on {dev}")


# ===========================================================================
# Parameters
# ===========================================================================

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Random parameters in the reference's distributions (N(0, 1/d_in)
    weights, N(0, 0.02²) embedding, unit norms, zero QKV biases), drawn
    from ``generator``, which must live on ``device``."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    n, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(device=dev)

    def dense(d_in, d_out, layers=None):
        return L.dense_init(generator, d_in, d_out, dt, layers=layers, **kw)

    attn = {"wq": dense(d, h * dh, n), "wk": dense(d, hkv * dh, n),
            "wv": dense(d, hkv * dh, n), "wo": dense(h * dh, d, n)}
    if cfg.qkv_bias:
        attn["bq"] = torch.zeros((n, h * dh), dtype=dt, **kw)
        attn["bk"] = torch.zeros((n, hkv * dh), dtype=dt, **kw)
        attn["bv"] = torch.zeros((n, hkv * dh), dtype=dt, **kw)
    return {
        "embed": L.embed_init(generator, cfg.vocab, d, dt, **kw),
        "final_norm": torch.ones(d, dtype=dt, **kw),
        "lm_head": dense(d, cfg.vocab),
        "layers": {
            "ln1": torch.ones((n, d), dtype=dt, **kw),
            "ln2": torch.ones((n, d), dtype=dt, **kw),
            "attn": attn,
            "ffn": {"w_gate": dense(d, f, n), "w_up": dense(d, f, n),
                    "w_down": dense(f, d, n)},
        },
    }


def _to_tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":                # ml_dtypes, no torch twin
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(dev)


def from_reference(params, cfg: ModelConfig, device="cuda") -> Params:
    """The reference's ``init_params`` pytree (numpy or jax arrays, stacked
    ``[L, ...]`` layers) as the port's parameters: the same nested dict,
    copied leaf by leaf in the same dtype."""
    _check_family(cfg)
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _to_tensor(x, dev)

    out = conv(params)
    want = {"embed", "final_norm", "lm_head", "layers"}
    if set(out) != want:
        raise ValueError(f"expected a dense params pytree with keys {want}, "
                         f"got {sorted(out)}")
    return out


def _unstack(stacked: dict, n: int) -> list:
    """The stacked ``[L, ...]`` layer params as L per-layer dicts of views,
    split with one ``unbind`` per leaf: its backward writes each stacked
    gradient once, where indexing layer by layer (``v[i]``) gives every
    layer's backward a zero-filled full-stack gradient to add up (L² work
    over the stack in training)."""
    parts = {k: (_unstack(v, n) if isinstance(v, dict)
                 else torch.unbind(v, 0)) for k, v in stacked.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


# ===========================================================================
# Forward
# ===========================================================================

def _place_at_4d(cache: torch.Tensor, new: torch.Tensor,
                 length: torch.Tensor) -> torch.Tensor:
    """Write new [B,1,H,D] at position length[b] of cache [B,S,H,D].

    Updates ``cache`` IN PLACE (an indexed write) and returns it. For finite
    inputs this gives the values of the reference's one-hot blend
    ``cache·(1−oh) + oh·new``, which builds a new cache instead."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, length.long()] = new[:, 0].to(cache.dtype)
    return cache


def _gqa_attention(x, p, cfg, rope, cache=None, length=None):
    """Standard GQA attention. rope: (cos, sin) of the positions, from
    `_rope`; cache: dict(k, v) [B,S,Hkv,Dh] or None."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.matmul(x, p["wq"])
    kk = torch.matmul(x, p["wk"])
    vv = torch.matmul(x, p["wv"])
    if cfg.qkv_bias and "bq" in p:
        q, kk, vv = q + p["bq"], kk + p["bk"], vv + p["bv"]
    q = q.reshape(b, s, h, dh)
    kk = kk.reshape(b, s, hkv, dh)
    vv = vv.reshape(b, s, hkv, dh)
    cos, sin = rope
    q = L.apply_rope(q, cos, sin)
    kk = L.apply_rope(kk, cos, sin)

    if cache is None:
        y = L.flash_attention(q, kk, vv, causal=cfg.causal)
        new_cache = {"k": kk, "v": vv}
    else:
        ck = _place_at_4d(cache["k"], kk, length)
        cv = _place_at_4d(cache["v"], vv, length)
        y = decode_attention(q[:, 0].contiguous(), ck, cv,
                             (length + 1).to(torch.int32))[:, None]
        new_cache = {"k": ck, "v": cv}
    y = y.reshape(b, s, h * dh)
    return torch.matmul(y, p["wo"]), new_cache


def _attn_ffn_layer(x, lp, cfg, rope, cache=None, length=None):
    h = x
    xa = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    ao, new_cache = _gqa_attention(xa, lp["attn"], cfg, rope, cache, length)
    h = h + ao
    xf = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
    fp = lp["ffn"]
    return h + L.swiglu(xf, fp["w_gate"], fp["w_up"], fp["w_down"]), new_cache


def _rope(cfg, positions):
    """(cos, sin) of ``positions``: the reference recomputes them in every
    layer's attention; they are the same for every layer, so the port
    computes them once per call (same values, 39 fewer small launches per
    layer stack)."""
    return L.rope_freqs(cfg.head_dim, cfg.rope_theta, positions)


def _scan_layers(x, stacked, cfg, positions, caches=None, length=None):
    """The layer stack in order (the reference's ``lax.scan``). ``caches``:
    {"k", "v"} with a leading L axis, written in place."""
    n = stacked["ln1"].shape[0]
    rope = _rope(cfg, positions)
    for i, lp in enumerate(_unstack(stacked, n)):
        cache = (None if caches is None else
                 {"k": caches["k"][i], "v": caches["v"][i]})
        x, _ = _attn_ffn_layer(x, lp, cfg, rope, cache, length)
    return x, caches


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` for ``tokens``. ``F.embedding``, not ``table[tokens]``:
    the same values, but its backward on the card sums repeated tokens in a
    fixed order, where an indexed read's backward accumulates with atomics
    in no fixed order (same-input training steps must repeat bit for
    bit)."""
    return torch.nn.functional.embedding(tokens.long(), table)


def forward(params, batch, cfg: ModelConfig, device="cuda") -> torch.Tensor:
    """Logits [B, S, V] of the full causal forward; batch {"tokens": [B,S]}."""
    _check_family(cfg)
    dev = resolve_device(device)
    tokens = batch["tokens"]
    _on(tokens, dev, "tokens")
    _on(params["embed"], dev, "params")
    x = embed_lookup(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=dev)
    x, _ = _scan_layers(x, params["layers"], cfg, positions)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return torch.matmul(x, params["lm_head"])


def loss_fn(params, batch, cfg: ModelConfig, device="cuda") -> torch.Tensor:
    """Mean next-token cross entropy over the positions with ``labels >= 0``
    (batch {"tokens", "labels": [B, S]}), as the reference's ``loss_fn``:
    logits and labels shift by one, the row max is taken with its gradient
    stopped, the shift stays in the model dtype, ``exp``/``log`` run in f32
    and the label logit is read in f32. The label logit is a gather (the
    reference contracts a one-hot, which only a sharded vocabulary needs;
    the values and the gradient are the same); masked labels are clamped
    to 0 for the gather and weigh 0."""
    logits = forward(params, batch, cfg, device)
    labels = batch["labels"].to(torch.int64)
    logits = logits[:, :-1, :]              # next-token shift (dense AR)
    labels = labels[:, 1:]
    m = torch.amax(logits.detach(), dim=-1, keepdim=True)
    shifted = logits - m                                       # model dtype
    sumexp = torch.sum(torch.exp(shifted.to(torch.float32)), dim=-1)
    lse = torch.log(sumexp) + m[..., 0].to(torch.float32)
    lab_logit = torch.gather(logits, -1, labels.clamp(min=0)[..., None]
                             )[..., 0].to(torch.float32)
    ll = lab_logit - lse
    mask = (labels >= 0).to(torch.float32)
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def prefill(params, batch, cfg: ModelConfig, device="cuda") -> torch.Tensor:
    """Forward over a full prompt; returns last-position logits [B, V]
    (the cache is rebuilt decode-side, as in the reference)."""
    return forward(params, batch, cfg, device)[:, -1]


# ===========================================================================
# Serving: cache + decode
# ===========================================================================

def init_cache(cfg: ModelConfig, batch: int, seq: int, device="cuda"):
    """{"layers": {"k", "v": [L, B, S, Hkv, Dh]}} zeros in the model dtype."""
    _check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return {"layers": {"k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
                       "v": torch.zeros(shape, dtype=_dtype(cfg),
                                        device=dev)}}


def decode_step(params, cache, batch, length, cfg: ModelConfig,
                device="cuda"):
    """One token for every sequence. batch {"tokens": [B,1]}; length [B]
    int32, the number of tokens already in the cache. Writes the new K/V at
    position length[b] in place and returns (logits [B, V], cache)."""
    _check_family(cfg)
    dev = resolve_device(device)
    tokens = batch["tokens"]
    for t, what in ((tokens, "tokens"), (length, "length"),
                    (params["embed"], "params"),
                    (cache["layers"]["k"], "cache")):
        _on(t, dev, what)
    x = embed_lookup(params["embed"], tokens)
    positions = length[:, None]
    x, nc = _scan_layers(x, params["layers"], cfg, positions,
                         caches=cache["layers"], length=length)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.matmul(x, params["lm_head"])
    return logits[:, 0], {"layers": nc}


def generate(params, cfg: ModelConfig, prompt: torch.Tensor,
             new_tokens: int, device="cuda") -> torch.Tensor:
    """Greedy decoding as ``examples/serve_decode.py`` runs it: the prompt
    [B, P] goes token by token through `decode_step`, then the argmax token
    is fed back; P + new_tokens − 1 steps. Returns the new tokens
    [B, new_tokens] (int32). The loop never waits on the card."""
    dev = resolve_device(device)
    _on(prompt, dev, "prompt")
    b, p = prompt.shape
    if p < 1 or new_tokens < 1:
        raise ValueError("need a prompt token and at least one new token")
    cache = init_cache(cfg, b, p + new_tokens, device=dev)
    length = torch.zeros(b, dtype=torch.int32, device=dev)
    tok = prompt[:, :1]
    out = []
    for i in range(p + new_tokens - 1):
        logits, cache = decode_step(params, cache, {"tokens": tok}, length,
                                    cfg, device=dev)
        length = length + 1
        if i + 1 < p:
            tok = prompt[:, i + 1:i + 2]
        else:
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            out.append(tok)
    return torch.cat(out, dim=1)
