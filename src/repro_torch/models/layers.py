"""Shared NN primitives of the LM zoo, op for op as ``repro.models.layers``:
init helpers, RMSNorm, RoPE, SwiGLU, and attention.

Weights keep the reference's ``[d_in, d_out]`` layout (``x @ W``), so a
reference pytree carries over as a copy. Every f32 upcast and cast back to
the working dtype sits where the reference puts it.

Training/prefill attention (`flash_attention`) is the reference's chunked
online-softmax jnp function written in plain torch: it is not a Pallas
kernel there either. `decode_attention_plain` is the reference's jnp decode
path; the model decodes through the CUDA kernel's wrapper
(``repro_torch.kernels.flash_attention.decode_attention``) instead.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               *, layers: int | None = None, device=None) -> torch.Tensor:
    """N(0, 1/d_in) weights ``[d_in, d_out]`` (``[layers, d_in, d_out]``
    for a stacked layer axis), drawn in f32 and cast to ``dtype``."""
    shape = (d_in, d_out) if layers is None else (layers, d_in, d_out)
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * d_in ** -0.5).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype,
               *, device=None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=generator, device=device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    return torch.matmul(F.silu(g) * u, w_down)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, positions: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [..., S] → (cos, sin) each [..., S, dim//2] in f32."""
    dev = positions.device
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=dev) / dim
    # theta is filled on the device: a host scalar copied there would make
    # the host wait for the stream on every call
    base = torch.full((), theta, dtype=torch.float32, device=dev)
    inv = 1.0 / torch.pow(base, exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [S, D//2] or [B, S, D//2]."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked (flash-style) attention — train/prefill path
# ---------------------------------------------------------------------------

def _pick_block(s: int, pref: int) -> int:
    b = min(pref, s)
    while s % b:
        b //= 2
    return max(b, 1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_block: int = 512,
                    kv_block: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """q: [B,Sq,H,D]; k/v: [B,Sk,Hkv,D] (GQA folded by repeat).

    The reference's ``flash_attention_jnp``: q blocks in an outer loop, kv
    blocks in an inner online-softmax loop, f32 inside, output in q's
    dtype. ``q_offset``: absolute position of q[0]."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    if hkv != h:
        rep = h // hkv
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    qb = _pick_block(sq, q_block)
    kb = _pick_block(sk, kv_block)
    nq, nk = sq // qb, sk // kb
    scale = d ** -0.5
    dev = q.device

    qr = q.reshape(b, nq, qb, h, d).permute(1, 0, 3, 2, 4)    # [nq,B,H,qb,D]
    kr = k.reshape(b, nk, kb, h, d).permute(1, 0, 3, 2, 4)    # [nk,B,H,kb,D]
    vr = v.reshape(b, nk, kb, h, dv).permute(1, 0, 3, 2, 4)
    ys = []
    for qi in range(nq):
        qf = qr[qi].to(torch.float32) * scale
        m = torch.full((b, h, qb), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, qb), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, qb, dv), dtype=torch.float32, device=dev)
        for ki in range(nk):
            s = torch.einsum("bhqd,bhkd->bhqk", qf,
                             kr[ki].to(torch.float32))
            if causal:
                qpos = q_offset + qi * qb + torch.arange(qb, device=dev)
                kpos = ki * kb + torch.arange(kb, device=dev)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + torch.sum(p, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vr[ki].to(torch.float32))
            m = m_new
        y = acc / torch.clamp(l, min=1e-30)[..., None]
        ys.append(y.to(q.dtype))
    out = torch.stack(ys)                                     # [nq,B,H,qb,Dv]
    return out.permute(1, 0, 3, 2, 4).reshape(b, sq, h, dv)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           length: torch.Tensor) -> torch.Tensor:
    """Single-token decode: q [B,H,D], cache k/v [B,S,Hkv,D], length [B].

    The reference's ``decode_attention_jnp``, op for op; query head h reads
    kv head h // (H/Hkv)."""
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, hkv, g, d).to(torch.float32)
    logits = torch.einsum("bhgd,bshd->bhgs", qg,
                          k.to(torch.float32)) / (d ** 0.5)
    pos = torch.arange(s, device=q.device)[None, None, None, :]
    logits = torch.where(pos < length[:, None, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.to(torch.float32))
    return out.reshape(b, h, d).to(q.dtype)
