"""Mamba2 / SSD (state-space duality) blocks, the port of
``repro.models.mamba2``: the chunked matmul-form scan for train/prefill
and the one-token recurrence for decode, in plain torch as the reference
computes them in plain jnp.

SSD (Dao & Gu, arXiv:2405.21060): the sequence is split into chunks;
intra-chunk interactions are a masked attention-like matmul, inter-chunk
interactions carry a recurrent state [H, P, N] through a loop over chunks.
One B/C group (n_groups = 1) is shared across heads.

Under a mesh whose "model" axis splits ``w_zx`` (output dim), ``w_out``
(input dim) and the gated norm's scale, the block is tensor-parallel over
"model" (`mamba_block`): on the rank's SSM heads where they divide it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch import sharding as SH
from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k], -inf
    above the diagonal (selected with `torch.where`, so ``exp`` gives 0 and
    the backward sees no inf − inf)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -torch.inf)


def ssd_chunked(x, dt, a, b, c, chunk: int):
    """x [B,L,H,P]; dt [B,L,H] (>0); a [H] (<0); b,c [B,L,N].
    Returns y [B,L,H,P] in x's dtype."""
    bb, l, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, l)
    while l % q:
        q //= 2
    nc = l // q

    xd = (x * dt[..., None]).to(torch.float32)             # fold dt into x
    da = (dt * a[None, None, :]).to(torch.float32)         # [B,L,H]

    xc = xd.reshape(bb, nc, q, h, p)
    dac = da.reshape(bb, nc, q, h).permute(0, 1, 3, 2)     # [B,C,H,Q]
    bc = b.reshape(bb, nc, q, n).to(torch.float32)
    cc = c.reshape(bb, nc, q, n).to(torch.float32)

    da_cum = torch.cumsum(dac, dim=-1)                     # [B,C,H,Q]
    # 1) intra-chunk (diagonal blocks)
    lmat = torch.exp(_segsum(dac))                         # [B,C,H,Q,Q]
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)       # [B,C,Q,Q]
    att = scores[:, :, None] * lmat                        # [B,C,H,Q,Q]
    y_diag = torch.einsum("bchij,bcjhp->bcihp", att, xc)

    # 2) chunk final states
    decay_to_end = torch.exp(da_cum[..., -1:] - da_cum)    # [B,C,H,Q]
    states = torch.einsum("bcjn,bchj,bcjhp->bchpn", bc, decay_to_end, xc)

    # 3) inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(da_cum[..., -1])               # [B,C,H]
    h_prev = torch.zeros((bb, h, p, n), dtype=torch.float32, device=x.device)
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(h_prev)
        h_prev = h_prev * chunk_decay[:, ci, :, None, None] + states[:, ci]
    h_prevs = torch.stack(h_prevs, dim=1)                  # [B,C,H,P,N]

    # 4) inter-chunk contribution
    in_decay = torch.exp(da_cum)                           # from chunk start
    y_off = torch.einsum("bcin,bchpn,bchi->bcihp", cc, h_prevs, in_decay)

    y = (y_diag + y_off).reshape(bb, l, h, p)
    return y.to(x.dtype)


def ssd_decode(xt, dt, a, b, c, state):
    """One-token recurrence. xt [B,H,P]; dt [B,H]; b,c [B,N];
    state [B,H,P,N] f32. Returns (y [B,H,P], new state)."""
    da = torch.exp((dt * a[None, :]).to(torch.float32))    # [B,H]
    upd = torch.einsum("bn,bhp->bhpn", b.to(torch.float32),
                       (xt * dt[..., None]).to(torch.float32))
    new_state = state * da[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, c.to(torch.float32))
    return y.to(xt.dtype), new_state


# ---------------------------------------------------------------------------
# Causal depthwise conv (width W) as shift-adds
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor,
                prev: torch.Tensor | None = None):
    """x [B,L,Ch]; w [W,Ch]. prev: [B,W-1,Ch] carried state (decode) or
    None. Returns (silu(conv) [B,L,Ch], new carried state)."""
    width = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], width - 1, x.shape[-1]))
    xp = torch.cat([prev, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(width))
    new_prev = xp[:, -(width - 1):, :]
    return F.silu(y.to(torch.float32)).to(x.dtype), new_prev


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------

def init_mamba_params(make: L.ParamMaker, cfg, dtype) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.ssm_conv_width
    return {
        "w_zx": make.dense(d, 2 * di, dtype),
        "w_bcdt": make.dense(d, 2 * n + h, dtype),
        "conv_w": make.normal((w, di + 2 * n), 0.2, dtype),
        "a_log": make.zeros((h,), torch.float32),          # A = -exp(0) = -1
        "dt_bias": make.zeros((h,), torch.float32),
        "d_skip": make.ones((h,), dtype),
        "norm": make.ones((di,), dtype),
        "w_out": make.dense(di, d, dtype),
    }


def _projections(x, p, cfg):
    di, n = cfg.d_inner, cfg.ssm_state
    zx = torch.matmul(x, p["w_zx"])
    z, xin = zx[..., :di], zx[..., di:]
    b, c, dt = _bcdt(torch.matmul(x, p["w_bcdt"]), p["dt_bias"], cfg)
    return z, xin, b, c, dt


def _bcdt(bcdt, dt_bias, cfg):
    """(b, c, dt) of ``x @ w_bcdt`` with ``dt_bias`` added to the dt
    columns it holds (all heads, or a rank's: ``dt_bias`` is cut to the
    same heads)."""
    n = cfg.ssm_state
    b, c, dt_raw = bcdt[..., :n], bcdt[..., n:2 * n], bcdt[..., 2 * n:]
    # jax.nn.softplus is logaddexp(x, 0); F.softplus switches to x above 20
    dt = torch.logaddexp(dt_raw.to(torch.float32) + dt_bias,
                         torch.zeros((), device=bcdt.device))
    return b, c, dt


def _block(t: torch.Tensor, dim: int, j: int, n: int) -> torch.Tensor:
    """Block j of n equal blocks of t along dim."""
    return t.narrow(dim, j * n, n)


def _conv(xbc, conv_w, conv_state, mesh, chan_axes):
    """`causal_conv` of the whole [x | b | c] channels; in decode with live
    ``chan_axes`` the conv state is this rank's block of the channels, the
    conv runs on those and its output is gathered over the axes in rank
    order."""
    if not chan_axes:
        return causal_conv(xbc, conv_w, conv_state)
    j, c_loc = mesh.index_over(chan_axes), conv_state.shape[-1]
    out, new_conv = causal_conv(_block(xbc, -1, j, c_loc),
                                _block(conv_w, -1, j, c_loc), conv_state)
    return mesh.all_gather_axis(out, chan_axes, -1), new_conv


def mamba_block(x, p, cfg, state=None, conv_state=None, mesh=None,
                head_axes=(), chan_axes=()):
    """x [B,L,d] → (y [B,L,d], (ssm_state, conv_state)); a given state means
    decode (L = 1).

    Where ``p`` holds "model" blocks (``w_zx``'s columns split over
    "model"), the block is tensor-parallel: on the rank's SSM heads where
    they divide "model" (`_mamba_heads`), else on every head from z and x
    gathered over "model" as activations, with the rank's rows of the
    gated norm's scale and of ``w_out``. Either way ``w_out`` closes a
    row-parallel sum (`layers.row_parallel`).

    Decode under ``mesh`` with whole projections (no tensor parallelism:
    the dp_only policy): with live ``chan_axes`` the conv state holds
    this rank's block of the conv channels (`_conv`); with live
    ``head_axes`` the SSM state holds this rank's block of heads, and the
    one-token recurrence runs on those heads, y gathered in rank order
    before the skip and the gated norm."""
    bb, l, _ = x.shape
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    ph = cfg.ssm_head_dim
    split = p["w_zx"].shape[-1] < 2 * di
    if split and h % mesh.axis_size("model") == 0:
        return _mamba_heads(x, p, cfg, state, conv_state, mesh, chan_axes)
    if split:
        # every rank's block of x @ w_zx gathered into the whole
        zx = SH.gather_from_model(torch.matmul(
            SH.copy_to_model(x, mesh), p["w_zx"]), mesh)
        z, xin = zx[..., :di], zx[..., di:]
        b, c, dt = _bcdt(torch.matmul(x, p["w_bcdt"]), p["dt_bias"], cfg)
    else:
        z, xin, b, c, dt = _projections(x, p, cfg)
    a = -torch.exp(p["a_log"])

    xbc, new_conv = _conv(torch.cat([xin, b, c], dim=-1), p["conv_w"],
                          conv_state, mesh, chan_axes)
    xin, b, c = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]

    xh = xin.reshape(bb, l, h, ph)
    if state is None:
        y = ssd_chunked(xh, dt, a, b, c, cfg.ssm_chunk)
        new_state = None   # the train path does not expose the state
    elif head_axes:
        j, h_loc = mesh.index_over(head_axes), state.shape[1]
        y1, new_state = ssd_decode(_block(xh[:, 0], 1, j, h_loc),
                                   _block(dt[:, 0], 1, j, h_loc),
                                   _block(a, 0, j, h_loc), b[:, 0], c[:, 0],
                                   state)
        y = mesh.all_gather_axis(y1, head_axes, 1)[:, None]
    else:
        y1, new_state = ssd_decode(xh[:, 0], dt[:, 0], a, b[:, 0], c[:, 0],
                                   state)
        y = y1[:, None]
    y = y + xh * p["d_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(bb, l, di)
    if p["norm"].shape[0] < di:
        # the rank's rows of the norm's scale and of w_out: every rank
        # normalizes the whole y the same way, and its gradient (each
        # rank's from its rows) is summed at the cut
        r, w = mesh.axis_index("model"), p["norm"].shape[0]
        g = (y * F.silu(z.to(torch.float32)).to(y.dtype)).to(torch.float32)
        g = g * torch.rsqrt(torch.mean(g * g, dim=-1, keepdim=True)
                            + cfg.norm_eps)
        g = SH.copy_to_model(g, mesh).narrow(-1, r * w, w)
        y = (g * p["norm"].to(torch.float32)).to(y.dtype)
        return L.row_parallel(y, p["w_out"], mesh), (new_state, new_conv)
    y = L.gated_rms_norm(y, z, p["norm"], cfg.norm_eps)
    return torch.matmul(y, p["w_out"]), (new_state, new_conv)


def _zx_mine(x, w, mesh):
    """[z_r | x_r], this rank's block of z and of x, from its block ``w``
    of ``w_zx``'s columns ([z | x] split contiguously over "model": on two
    ranks rank 0 holds all of z). The pieces are moved between the ranks
    (`sharding.regroup_model`) as weight columns [d, d_inner / n] or as
    the product's columns [T, d_inner / n], whichever is smaller: the
    weight where the tokens T outnumber d (training, prefill), the
    product in decode. ``x`` enters through `copy_to_model`."""
    xc = SH.copy_to_model(x, mesh)
    if x.numel() // x.shape[-1] < w.shape[0]:
        return SH.regroup_model(torch.matmul(xc, w), 2, mesh)
    return torch.matmul(xc, SH.regroup_model(w, 2, mesh))


def _mamba_heads(x, p, cfg, state, conv_state, mesh, chan_axes):
    """`mamba_block` on the rank's SSM heads: ``p`` holds the rank's
    block of ``w_zx``'s columns (`_zx_mine` makes it the rank's z and x),
    its blocks of ``norm`` and of ``w_out``'s rows. The replicated leaves
    the rank uses in part (the output of ``w_bcdt``: dt cut to the rank's
    heads, b and c feeding only them; ``conv_w``: the rank's x channels
    and the b, c channels; ``a_log``, ``dt_bias``, ``d_skip`` cut to its
    heads) enter through `copy_to_model`, so their gradients are summed
    over "model". The SSD scan and the
    one-token recurrence run on the rank's heads (the decode cache's SSM
    heads over "model" are the same blocks). Train: the conv runs on the
    rank's x channels and every b, c channel. Decode: the rank's x is
    gathered over "model" into the whole conv input, the conv runs as
    `_conv` runs it on the cache's channels, and the rank's heads are
    kept. The gated norm sums its squares over "model"
    (`layers.gated_rms_norm_split`), and ``w_out`` closes a row-parallel
    sum."""
    bb, l, _ = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    m, r = mesh.axis_size("model"), mesh.axis_index("model")
    h_l, w = cfg.ssm_heads // m, di // m

    def mine(t):            # a replicated per-head leaf, the rank's heads
        return _block(SH.copy_to_model(t, mesh), 0, r, h_l)

    zx = _zx_mine(x, p["w_zx"], mesh)
    z, xin = zx[..., :w], zx[..., w:]
    bcdt = SH.copy_to_model(torch.matmul(x, p["w_bcdt"]), mesh)
    b, c, dt = _bcdt(torch.cat([bcdt[..., :2 * n], _block(
        bcdt[..., 2 * n:], -1, r, h_l)], dim=-1), mine(p["dt_bias"]), cfg)
    a = -torch.exp(mine(p["a_log"]))
    conv_w = SH.copy_to_model(p["conv_w"], mesh)
    if conv_state is None:
        xbc, new_conv = causal_conv(
            torch.cat([xin, b, c], dim=-1),
            torch.cat([_block(conv_w, -1, r, w), conv_w[:, di:]], dim=-1))
        xin, b, c = xbc[..., :w], xbc[..., w:w + n], xbc[..., w + n:]
    else:
        xbc, new_conv = _conv(torch.cat([
            mesh.all_gather_axis(xin, "model", -1), b, c], dim=-1), conv_w,
            conv_state, mesh, chan_axes)
        xin = _block(xbc, -1, r, w)
        b, c = xbc[..., di:di + n], xbc[..., di + n:]

    xh = xin.reshape(bb, l, h_l, cfg.ssm_head_dim)
    if state is None:
        y = ssd_chunked(xh, dt, a, b, c, cfg.ssm_chunk)
        new_state = None
    else:
        if state.shape[1] != h_l:
            raise ValueError(f"the SSM state holds {state.shape[1]} heads, "
                             f"not the rank's {h_l}")
        y1, new_state = ssd_decode(xh[:, 0], dt[:, 0], a, b[:, 0], c[:, 0],
                                   state)
        y = y1[:, None]
    y = y + xh * mine(p["d_skip"]).to(y.dtype)[None, None, :, None]
    y = L.gated_rms_norm_split(y.reshape(bb, l, w), z, p["norm"],
                               cfg.norm_eps, mesh, di)
    return L.row_parallel(y, p["w_out"], mesh), (new_state, new_conv)


def init_mamba_cache(batch: int, cfg, dtype, device,
                     layers: int | None = None):
    """(ssm state [B,H,P,N] f32, conv state [B,W-1,d_inner+2N]) zeros, with
    a leading [layers] axis when given: real tensors, which decode writes
    in place (the reference broadcasts one zero state)."""
    h, ph, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    lead = () if layers is None else (layers,)
    ssm = torch.zeros(lead + (batch, h, ph, n), dtype=torch.float32,
                      device=device)
    conv = torch.zeros(lead + (batch, cfg.ssm_conv_width - 1,
                               cfg.d_inner + 2 * n), dtype=dtype,
                       device=device)
    return ssm, conv
