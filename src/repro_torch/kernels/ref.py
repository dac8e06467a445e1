"""Plain PyTorch versions of the port's CUDA kernels.

Each compression function computes exactly what its kernel computes, on
the same ``[rows, n]`` batch with one scalar per row; `decode_attention`
takes the decode kernel's ``[B, H, D]`` query and ``[B, S, Hkv, D]`` cache.
They are the CPU path (the wrappers in this package call them for CPU
tensors) and the kernels' first oracle (``chip_smoke.py`` compares each
kernel with its twin on the card). They mirror ``repro.kernels.ref`` op
for op.

Divisions are written tensor / tensor: ``python_scalar / tensor`` is
``reciprocal() * scalar`` in PyTorch, which rounds differently from the
reference's true division.
"""
from __future__ import annotations

import torch

N_BINS = 256


def _recip_scale(max_abs: torch.Tensor) -> torch.Tensor:
    """f32 ``N_BINS / max(max_abs, 1e-30)`` with true division."""
    m = torch.clamp(max_abs, min=1e-30)
    return torch.full_like(m, float(N_BINS)) / m


def magnitude_histogram(x: torch.Tensor, max_abs: torch.Tensor
                        ) -> torch.Tensor:
    """[rows, 256] int32 histogram of |x| over [0, max_abs] per row.

    Bin = clip(int32(|x| · f32(256 / max(max_abs, 1e-30))), 0, 255).
    x [rows, n] f32; max_abs [rows] f32."""
    rows = x.shape[0]
    scale = _recip_scale(max_abs)
    idx = (x.abs() * scale[:, None]).to(torch.int32).clamp_(0, N_BINS - 1)
    flat = idx.to(torch.int64) + torch.arange(
        rows, device=x.device, dtype=torch.int64)[:, None] * N_BINS
    # integer index_add_, not bincount: bincount reads its input's maximum
    # back to the host, which stalls the host on every call on the card
    hist = torch.zeros(rows * N_BINS, dtype=torch.int32, device=x.device)
    hist.index_add_(0, flat.reshape(-1),
                    torch.ones(flat.numel(), dtype=torch.int32,
                               device=x.device))
    return hist.view(rows, N_BINS)


def threshold_from_cdf(cdf: torch.Tensor, max_abs: torch.Tensor,
                       ratio: torch.Tensor) -> torch.Tensor:
    """[len(ratio)] lower bin edges whose cdf first reaches ratio·n.

    ``cdf`` [rows, N_BINS] f32 with ``max_abs`` [rows], where rows is 1 (one
    tensor, many ratios) or len(ratio). The lower edge keeps ratio=0
    exactly lossless (thr=0 ⇒ nothing compressed under ``|x| < thr``)."""
    k = ratio.shape[0]
    cdf = cdf.expand(k, cdf.shape[-1]).contiguous()
    target = torch.clamp(ratio, 0.0, 1.0) * cdf[:, -1]
    bin_idx = torch.searchsorted(cdf, target[:, None].contiguous(),
                                 right=False)[:, 0]
    width = torch.clamp(max_abs.expand(k), min=1e-30) / N_BINS
    return bin_idx.to(torch.float32) * width


def threshold_from_histogram(hist: torch.Tensor, max_abs: torch.Tensor,
                             ratio: torch.Tensor) -> torch.Tensor:
    """[rows] lower edge of the first bin whose cdf reaches ratio·n."""
    cdf = torch.cumsum(hist, dim=-1).to(torch.float32)
    return threshold_from_cdf(cdf, max_abs, ratio)


def hybrid_compress(x: torch.Tensor, thr: torch.Tensor):
    """Fig.-3 sender for every row: (kept [rows, n] f32, sign [rows, n] int8,
    count [rows] int32, sum_abs [rows] f32, max_abs [rows] f32) over the
    compressed set ``|x| < thr``. ``x`` is [rows, n], or one [n] vector
    shared by every row."""
    rows = thr.shape[0]
    xr = x.expand(rows, x.shape[-1]) if x.dim() == 1 else x
    absx = xr.abs()
    mask = absx < thr[:, None]
    kept = torch.where(mask, 0.0, xr)
    sign = torch.where(mask, torch.sign(xr), 0.0).to(torch.int8)
    count = mask.sum(dim=-1, dtype=torch.int32)
    comp = torch.where(mask, absx, 0.0)
    return kept, sign, count, comp.sum(dim=-1), comp.amax(dim=-1)


def recover(kept: torch.Tensor, sign: torch.Tensor, local: torch.Tensor,
            mean_abs: torch.Tensor, max_abs: torch.Tensor) -> torch.Tensor:
    """Fig.-3 receiver per row (sign == 0 marks full-precision slots)."""
    sgn = sign.to(local.dtype)
    sign_bad = torch.sign(local) * sgn < 0
    mag_bad = local.abs() > max_abs[:, None]
    approx = torch.where(sign_bad | mag_bad, sgn * mean_abs[:, None], local)
    return torch.where(sign != 0, approx, kept)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor | None = None,
                     lse: torch.Tensor | None = None,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Single-token decode attention, as ``repro.kernels.ref.decode_attention``.

    q [B, H, D]; k/v [B, S, Hkv, D]; length [B] valid cache length (0..S;
    a row of length 0 comes out as zeros). Query head h reads kv head
    h // (H/Hkv). f32 softmax, output in q's dtype; positions ≥ length are
    masked with -inf. Given ``lse`` (f32 [B, H]), each row's log-sum-exp
    of its scaled logits is written there (-inf for length 0), as the
    kernel writes it; ``out_dtype`` (f32 on bf16 inputs) keeps the output
    in that dtype instead."""
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    qg = q.reshape(b, hkv, group, d).to(torch.float32)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    # made on the device: a host scalar copied there would wait for the
    # stream (a pageable copy), and ``/ python_float`` may multiply by the
    # reciprocal instead of dividing
    sqrt_d = torch.sqrt(torch.full((), float(d), dtype=torch.float32,
                                   device=q.device))
    logits = torch.einsum("bhgd,bshd->bhgs", qg, kf) / sqrt_d
    if length is not None:
        pos = torch.arange(s, device=q.device)[None, None, None, :]
        logits = torch.where(pos < length[:, None, None, None], logits,
                             float("-inf"))
    p = torch.softmax(logits, dim=-1)
    if length is not None:      # an empty row's softmax is NaN: weigh it 0
        p = torch.where(length[:, None, None, None] > 0, p, 0.0)
    if lse is not None:
        lse.copy_(torch.logsumexp(logits, dim=-1).reshape(b, h))
    out = torch.einsum("bhgs,bshd->bhgd", p, vf)
    return out.reshape(b, h, d).to(out_dtype or q.dtype)
