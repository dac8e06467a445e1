"""Multi-head Latent Attention (DeepSeek-V3 style), the port of
``repro.models.mla``.

Training/prefill materializes per-head K/V from the compressed latent and
runs the chunked `layers.flash_attention`; decode uses the *absorbed* form:
scores and values are computed directly in the (kv_lora + rope) latent
space, so the KV cache stores only ``kv_lora_rank + qk_rope_dim`` values
per token. Both are plain torch, as the reference computes them in plain
jnp (no Pallas kernel covers MLA there).

Under a mesh whose "model" axis splits ``w_uq`` (its output dim) and
``w_uk``/``w_uv`` (their heads), both paths run on the rank's heads: q
from ``ql`` and the rank's columns of ``w_uq``, k_nope and v from the
shared latent and the rank's heads of ``w_uk``/``w_uv`` (``ql``, the
latent and k_rope enter through `copy_to_model`, each rank using its
part), and the heads' outputs are gathered over "model" in rank order
before the replicated ``w_o``. Where the heads do not divide "model" but
``w_uq``'s columns do, q is gathered as an activation and every rank
attends over every head. The cache (latents, not split over "model") is
read whole by every rank.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import merge_partials
from repro_torch.launch import sharding as SH
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


def _heads_split(p, cfg) -> bool:
    """Whether ``p`` holds the rank's heads of ``w_uk``/``w_uv`` (and so
    of ``w_uq``): the heads divide "model"."""
    return p["w_uk"].shape[1] < cfg.n_heads


def _project_q(x, p, cfg, mesh=None):
    """(q_nope, q_rope) [B, S, H', qn], [B, S, H', qr] of the heads the
    layer computes: all H, or the rank's where `_heads_split`. A block of
    ``w_uq``'s columns that is not whole heads is gathered over "model"
    as an activation."""
    b, s, _ = x.shape
    h, qn, qr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    ql = L.rms_norm(torch.matmul(x, p["w_dq"]), p["q_norm"], cfg.norm_eps)
    if p["w_uq"].shape[-1] < h * (qn + qr):
        q = torch.matmul(SH.copy_to_model(ql, mesh), p["w_uq"])
        if not _heads_split(p, cfg):
            q = SH.gather_from_model(q, mesh)
    else:
        q = torch.matmul(ql, p["w_uq"])
    q = q.reshape(b, s, -1, qn + qr)
    return q[..., :qn], q[..., qn:]                      # nope, rope parts


def _out(y, p, cfg, mesh):
    """[.., H'·vh] of the heads' outputs through the replicated ``w_o``:
    the rank's heads gathered over "model" in rank order first (every rank
    then uses the whole the same way, so the gather's backward keeps the
    rank's slice)."""
    if _heads_split(p, cfg):
        y = SH.gather_from_model(y, mesh)
    return torch.matmul(y, p["w_o"])


def _project_latent(x, p, cfg):
    ckr = torch.matmul(x, p["w_dkv"])
    c = L.rms_norm(ckr[..., :cfg.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = ckr[..., cfg.kv_lora_rank:]                 # [B,S,qr] shared head
    return c, k_rope


def mla_attention_train(x, p, cfg, rope, mesh=None):
    """Materialized path for train/prefill; rope: (cos, sin) of the
    positions at ``qk_rope_dim``. Returns ([B,S,d], cache). Under a mesh
    that splits the heads, on the rank's heads (module docstring)."""
    b, s, _ = x.shape
    qr = cfg.qk_rope_dim
    q_nope, q_rope = _project_q(x, p, cfg, mesh)
    c, k_rope = _project_latent(x, p, cfg)
    cu, kru = c, k_rope
    if _heads_split(p, cfg):
        cu, kru = SH.copy_to_model(c, mesh), SH.copy_to_model(k_rope, mesh)

    cos, sin = rope
    q_rope = L.apply_rope(q_rope, cos, sin)
    kru = L.apply_rope(kru[:, :, None, :], cos, sin)      # [B,S,1,qr]

    k_nope = torch.einsum("bsr,rhn->bshn", cu, p["w_uk"])
    v = torch.einsum("bsr,rhv->bshv", cu, p["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    kr = kru.expand(b, s, q.shape[2], qr)
    kk = torch.cat([k_nope, kr], dim=-1)

    y = L.flash_attention(q, kk, v, causal=cfg.causal)
    out = _out(y.reshape(b, s, -1), p, cfg, mesh)
    return out, {"c": c, "k_rope": kru[:, :, 0, :]}


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
    merged in rank order (`merge_partials`). Where the mesh splits the
    heads over "model", the scores, the softmax, the merge and the value
    product run on the rank's heads (module docstring)."""
    b = x.shape[0]
    qn, qr = cfg.qk_nope_dim, cfg.qk_rope_dim
    scale = (qn + qr) ** -0.5
    s_loc = cache["c"].shape[1]
    off = mesh.index_over(seq_axes) * s_loc if seq_axes else None

    q_nope, q_rope = _project_q(x, p, cfg, mesh)           # [B,1,H',*]
    c_new, kr_new = _project_latent(x, p, cfg)             # [B,1,*]
    cos, sin = rope
    q_rope = L.apply_rope(q_rope, cos, sin)
    kr_new = L.apply_rope(kr_new[:, :, None, :], cos, sin)[:, :, 0, :]

    cache_c = L.place_at(cache["c"], c_new, length, off)
    cache_kr = L.place_at(cache["k_rope"], kr_new, length, off)

    # absorb W_uk into q: q_lat [B,H',kv_lora]
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
        lse = torch.logsumexp(logits, dim=-1)              # [B,H']
        pr = torch.where(mask, torch.exp(logits - lse[..., None]), 0.0)
        o_lat = merge_partials(
            mesh.all_gather_axis(torch.einsum("bhs,bsr->bhr", pr, cf)[None],
                                 seq_axes, 0),
            mesh.all_gather_axis(lse[None], seq_axes, 0))
    else:
        pr = torch.softmax(torch.where(mask, logits, L.NEG_INF), dim=-1)
        o_lat = torch.einsum("bhs,bsr->bhr", pr, cf)
    y = torch.einsum("bhr,rhv->bhv", o_lat.to(x.dtype), p["w_uv"])
    out = _out(y.reshape(b, -1), p, cfg, mesh)[:, None, :]
    return out, {"c": cache_c, "k_rope": cache_kr}


def init_mla_cache(batch: int, seq: int, cfg, dtype, device,
                   layers: int | None = None) -> dict:
    lead = () if layers is None else (layers,)
    return {"c": torch.zeros(lead + (batch, seq, cfg.kv_lora_rank),
                             dtype=dtype, device=device),
            "k_rope": torch.zeros(lead + (batch, seq, cfg.qk_rope_dim),
                                  dtype=dtype, device=device)}
