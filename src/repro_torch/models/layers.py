"""Shared NN primitives of the LM zoo, op for op as ``repro.models.layers``:
init helpers, RMSNorm (plain and gated), RoPE, SwiGLU, and attention; and
the tensor-parallel pieces the layers share under a mesh: the gated norm
of a row split over "model" and the row-parallel product.

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

from repro_torch.launch import sharding as SH

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

# at most this many elements are drawn in f32 at once: a larger leaf (the
# expert stacks: DeepSeek-V3's MoE layer holds 3.8e9) is drawn slice by
# slice along its leading axes, so the f32 temporary stays small
_DRAW_ELEMS = 1 << 27


class ParamMaker:
    """Makes the parameter leaves of the zoo's init functions, in the
    reference's distributions: ``dense`` N(0, 1/d_in) ``[d_in, d_out]``,
    ``normal`` N(0, std²), ``ones`` and ``zeros``, each drawn in f32 and cast
    to its dtype. ``layers`` prepends a stacked ``[L]`` axis to every leaf.
    With ``generator=None`` the leaves are uninitialised tensors (on the
    ``meta`` device: shapes and dtypes only, the reference's
    ``init_abstract``)."""

    def __init__(self, generator: torch.Generator | None, device,
                 layers: int | None = None):
        self.generator, self.device, self.layers = generator, device, layers

    def stacked(self, n: int) -> "ParamMaker":
        return ParamMaker(self.generator, self.device, n)

    def _shape(self, shape) -> tuple:
        shape = tuple(shape)
        return shape if self.layers is None else (self.layers,) + shape

    def normal(self, shape, std: float, dtype) -> torch.Tensor:
        out = torch.empty(self._shape(shape), dtype=dtype, device=self.device)
        if self.generator is None:
            return out
        flat = out.view(-1, *out.shape[1:]) if out.dim() else out.view(1)
        while flat.dim() > 1 and flat[0].numel() > _DRAW_ELEMS:
            flat = flat.view(-1, *flat.shape[2:])
        step = max(1, _DRAW_ELEMS // max(flat[0].numel(), 1))
        for i in range(0, flat.shape[0], step):
            part = flat[i:i + step]
            w = torch.randn(part.shape, generator=self.generator,
                            device=self.device, dtype=torch.float32)
            part.copy_(w * std)
        return out

    def dense(self, d_in: int, d_out: int, dtype) -> torch.Tensor:
        return self.normal((d_in, d_out), d_in ** -0.5, dtype)

    def ones(self, shape, dtype) -> torch.Tensor:
        out = torch.empty(self._shape(shape), dtype=dtype, device=self.device)
        return out if self.generator is None else out.fill_(1)

    def zeros(self, shape, dtype) -> torch.Tensor:
        out = torch.empty(self._shape(shape), dtype=dtype, device=self.device)
        return out if self.generator is None else out.zero_()


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return out.to(x.dtype)


def gated_rms_norm(x: torch.Tensor, gate: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Mamba2-style: norm(x * silu(gate)), the gate's silu in f32."""
    return rms_norm(x * F.silu(gate.to(torch.float32)).to(x.dtype), scale,
                    eps)


def gated_rms_norm_split(x: torch.Tensor, gate: torch.Tensor,
                         scale: torch.Tensor, eps: float, mesh,
                         width: int) -> torch.Tensor:
    """`gated_rms_norm` of a row of ``width`` split over "model": ``x``,
    ``gate`` and ``scale`` are the rank's block of it. The rank's f32 sum
    of squares is summed over "model" in rank order; the sum enters
    through `copy_to_model` too, since each rank's outputs use it with
    other elements (its gradient is the sum of the ranks')."""
    g = (x * F.silu(gate.to(torch.float32)).to(x.dtype)).to(torch.float32)
    ss = SH.copy_to_model(SH.reduce_from_model(
        torch.sum(g * g, dim=-1, keepdim=True), mesh), mesh)
    out = g * torch.rsqrt(ss / width + eps) * scale.to(torch.float32)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    return torch.matmul(F.silu(g) * u, w_down)


# ---------------------------------------------------------------------------
# Row-parallel products (tensor parallelism over "model")
# ---------------------------------------------------------------------------

class WideMatmul(torch.autograd.Function):
    """``y @ w`` ([.., k] × [k, n]) whose output is its accumulator at
    twice the inputs' precision, not rounded to their dtype: f32 for bf16
    operands (cuBLAS's ``out_dtype`` on the card and on ``meta``, the f32
    product of the casts on the CPU: exact products), f64 for f32 ones
    (the f64 product of the casts: exact products). The backward is
    ``y @ w``'s in the inputs' dtype, the gradient cast to it."""

    @staticmethod
    def forward(ctx, y, w):
        ctx.save_for_backward(y, w)
        y2 = y.reshape(-1, y.shape[-1])
        if y.dtype == torch.float32:
            out = torch.matmul(y2.to(torch.float64), w.to(torch.float64))
        elif y.device.type == "cpu":
            out = torch.matmul(y2.to(torch.float32), w.to(torch.float32))
        else:
            out = torch.mm(y2, w, out_dtype=torch.float32)
        return out.reshape(y.shape[:-1] + (w.shape[-1],))

    @staticmethod
    def backward(ctx, g):
        y, w = ctx.saved_tensors
        g = g.to(y.dtype)
        gw = torch.matmul(y.reshape(-1, y.shape[-1]).t(),
                          g.reshape(-1, g.shape[-1]))
        return torch.matmul(g, w.t()), gw


def row_parallel(y, w, mesh):
    """Σ over "model" of ``y @ w`` on each rank's rows of ``w`` (its block
    of the contraction), in rank order (`sharding.reduce_from_model`). Each
    rank's partial product stays at twice the activation precision (f32
    for a bf16 model, f64 for an f32 one: `WideMatmul`) and the ranks'
    are summed there, then rounded once to the activation dtype, as one
    matmul over every row rounds once: partial products rounded to the
    activation dtype and summed there move bf16 greedy tokens on the card
    and f32 gradients past the pod mesh's gates, at twice the bytes over
    "model"."""
    return SH.reduce_from_model(WideMatmul.apply(y, w), mesh).to(y.dtype)


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


def place_at(cache: torch.Tensor, new: torch.Tensor, length: torch.Tensor,
             offset: int | None = None) -> torch.Tensor:
    """Write new [B, 1, ...] at position length[b] of ``cache`` [B, S, ...],
    IN PLACE, and return ``cache``.

    With ``offset`` None this is one indexed write (for finite inputs the
    values of the reference's one-hot blend ``cache·(1−oh) + oh·new``, which
    builds a new cache instead). With an ``offset``, ``cache`` is a rank's
    segment of positions [offset, offset + S) and the row goes in at
    length[b] − offset only where that falls inside it; the other rows keep
    their bits (their row is read and written back)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    if offset is None:
        cache[rows, length.long()] = new[:, 0].to(cache.dtype)
        return cache
    s_loc = cache.shape[1]
    pos = length.long() - offset
    own = (pos >= 0) & (pos < s_loc)
    idx = pos.clamp(0, s_loc - 1)
    old = cache[rows, idx]
    own = own.reshape((-1,) + (1,) * (old.dim() - 1))
    cache[rows, idx] = torch.where(own, new[:, 0].to(cache.dtype), old)
    return cache


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
