"""Multi-head Latent Attention (DeepSeek-V3 style), the port of
``repro.models.mla``.

Training/prefill materializes per-head K/V from the compressed latent and
runs the chunked `layers.flash_attention`; decode uses the *absorbed* form:
scores and values are computed directly in the (kv_lora + rope) latent
space, so the KV cache stores only ``kv_lora_rank + qk_rope_dim`` values
per token. Both are plain torch, as the reference computes them in plain
jnp (no Pallas kernel covers MLA there).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import merge_partials
from repro_torch.models import layers as L


def init_mla_params(make: L.ParamMaker, cfg, dtype) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    qn, qr, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    return {
        "w_dq": make.dense(d, cfg.q_lora_rank, dtype),
        "q_norm": make.ones((cfg.q_lora_rank,), dtype),
        "w_uq": make.dense(cfg.q_lora_rank, h * (qn + qr), dtype),
        "w_dkv": make.dense(d, r + qr, dtype),
        "kv_norm": make.ones((r,), dtype),
        # stored per head for the absorbed decode: [kv_lora, H, qn/vh],
        # drawn as the reference's [kv_lora, H·qn] (std kv_lora^-1/2)
        "w_uk": make.normal((r, h, qn), r ** -0.5, dtype),
        "w_uv": make.normal((r, h, vh), r ** -0.5, dtype),
        "w_o": make.dense(h * vh, d, dtype),
    }


def _project_q(x, p, cfg):
    b, s, _ = x.shape
    h, qn, qr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    ql = L.rms_norm(torch.matmul(x, p["w_dq"]), p["q_norm"], cfg.norm_eps)
    q = torch.matmul(ql, p["w_uq"]).reshape(b, s, h, qn + qr)
    return q[..., :qn], q[..., qn:]                      # nope, rope parts


def _project_latent(x, p, cfg):
    ckr = torch.matmul(x, p["w_dkv"])
    c = L.rms_norm(ckr[..., :cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = ckr[..., cfg.kv_lora_rank:]                 # [B,S,qr] shared head
    return c, k_rope


def mla_attention_train(x, p, cfg, rope):
    """Materialized path for train/prefill; rope: (cos, sin) of the
    positions at ``qk_rope_dim``. Returns ([B,S,d], cache)."""
    b, s, _ = x.shape
    h, qn, qr, vh = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _project_q(x, p, cfg)
    c, k_rope = _project_latent(x, p, cfg)

    cos, sin = rope
    q_rope = L.apply_rope(q_rope, cos, sin)
    k_rope = L.apply_rope(k_rope[:, :, None, :], cos, sin)  # [B,S,1,qr]

    k_nope = torch.einsum("bsr,rhn->bshn", c, p["w_uk"])
    v = torch.einsum("bsr,rhv->bshv", c, p["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    kr = k_rope.expand(b, s, h, qr)
    kk = torch.cat([k_nope, kr], dim=-1)

    y = L.flash_attention(q, kk, v, causal=cfg.causal)
    out = torch.matmul(y.reshape(b, s, h * vh), p["w_o"])
    return out, {"c": c, "k_rope": k_rope[:, :, 0, :]}


def mla_attention_decode(x, p, cfg, cache, length, rope, mesh=None,
                         seq_axes=()):
    """Absorbed decode: x [B,1,d]; cache c [B,S,kv_lora], k_rope [B,S,qr],
    written in place at position length[b]; rope: (cos, sin) of
    ``length[:, None]`` at ``qk_rope_dim``.

    Under ``mesh`` with live ``seq_axes``, the cache is this rank's
    segment of positions (its index over those axes × S_loc onwards): the
    new latent goes in only where position length[b] falls inside it, the
    softmax runs over the segment's valid positions (log-sum-exp −inf and
    output 0 where it holds none), and the segments' latent outputs are
    merged in rank order (`merge_partials`)."""
    b = x.shape[0]
    qn, qr = cfg.qk_nope_dim, cfg.qk_rope_dim
    scale = (qn + qr) ** -0.5
    s_loc = cache["c"].shape[1]
    off = mesh.index_over(seq_axes) * s_loc if seq_axes else None

    q_nope, q_rope = _project_q(x, p, cfg)                 # [B,1,H,*]
    c_new, kr_new = _project_latent(x, p, cfg)             # [B,1,*]
    cos, sin = rope
    q_rope = L.apply_rope(q_rope, cos, sin)
    kr_new = L.apply_rope(kr_new[:, :, None, :], cos, sin)[:, :, 0, :]

    cache_c = L.place_at(cache["c"], c_new, length, off)
    cache_kr = L.place_at(cache["k_rope"], kr_new, length, off)

    # absorb W_uk into q: q_lat [B,H,kv_lora]
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], p["w_uk"])
    cf = cache_c.to(torch.float32)
    s_lat = torch.einsum("bhr,bsr->bhs", q_lat.to(torch.float32), cf)
    s_rope = torch.einsum("bhr,bsr->bhs", q_rope[:, 0].to(torch.float32),
                          cache_kr.to(torch.float32))
    logits = (s_lat + s_rope) * scale
    pos = (off or 0) + torch.arange(s_loc, device=x.device)
    mask = pos[None, None, :] <= length[:, None, None]
    if seq_axes:
        logits = torch.where(mask, logits, float("-inf"))
        lse = torch.logsumexp(logits, dim=-1)              # [B,H]
        pr = torch.where(mask, torch.exp(logits - lse[..., None]), 0.0)
        o_lat = merge_partials(
            mesh.all_gather_axis(torch.einsum("bhs,bsr->bhr", pr, cf)[None],
                                 seq_axes, 0),
            mesh.all_gather_axis(lse[None], seq_axes, 0))
    else:
        pr = torch.softmax(torch.where(mask, logits, L.NEG_INF), dim=-1)
        o_lat = torch.einsum("bhs,bsr->bhr", pr, cf)
    y = torch.einsum("bhr,rhv->bhv", o_lat.to(x.dtype), p["w_uv"])
    out = torch.matmul(y.reshape(b, -1), p["w_o"])[:, None, :]
    return out, {"c": cache_c, "k_rope": cache_kr}


def init_mla_cache(batch: int, seq: int, cfg, dtype, device,
                   layers: int | None = None) -> dict:
    lead = () if layers is None else (layers,)
    return {"c": torch.zeros(lead + (batch, seq, cfg.kv_lora_rank),
                             dtype=dtype, device=device),
            "k_rope": torch.zeros(lead + (batch, seq, cfg.qk_rope_dim),
                                  dtype=dtype, device=device)}
