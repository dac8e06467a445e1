"""The LM zoo, counterpart of ``repro.models.model``: dense / MoE (with
GQA or MLA) / SSM (Mamba2) / hybrid (Zamba2) / encoder (audio frontend) /
VLM (vision frontend).

Public API (functions of a params dict, as the reference's pytree):
    init_params(cfg, generator, device)          -> params
    init_abstract(cfg)                           -> params on ``meta``
    from_reference(params_numpy_pytree, cfg, device) -> params (a copy)
    init_cache(cfg, batch, seq, device)          -> cache
    param_specs(cfg, mesh), dp_axes, batch_spec  -> partition specs
    forward(params, batch, cfg, device, mesh)    -> logits [B, S, V]
    loss_fn(params, batch, cfg, device, mesh)    -> mean next-token CE
    prefill(params, batch, cfg, device, mesh)    -> last-position logits
    decode_step(params, cache, batch, length, cfg, device, mesh)
                                                 -> (logits, cache)
    generate(params, cfg, prompt, new_tokens, device)      -> new tokens

Parameters keep the reference's layout: layers stacked along a leading
``[L]`` axis, weights ``[d_in, d_out]``, an empty stack (Llama-4-Scout's
``dense_layers``) as ``None``. The layer scans are Python loops over that
axis; heterogeneous stacks (DeepSeek's dense prefix, Zamba2's shared
attention every ``attn_every`` Mamba2 layers) are segmented as in the
reference. GQA decode attention goes through the CUDA kernel's wrapper
(`decode_attention`, the name this module looks up at call time); the
Pallas kernel's own docstring calls it "the inference-path counterpart with
identical math" of the reference's ``decode_attention_jnp``. MLA's absorbed
decode, the MoE dispatch and the SSD scan are plain torch, as the
reference computes them in plain jnp. Decode writes every cache (K/V,
MLA latents, SSM and conv states) in place.

Every entry point runs on ``device="cuda"`` unless the caller passes
``device="cpu"``, and raises when there is no card; tensors on another
device than the one named are refused. The encoder family has no decode:
`init_cache` and `decode_step` raise ``ValueError`` as the reference does.

Training: `loss_fn` is the reference's cross entropy (next-token for the
decoders, per-frame for the encoder, text positions only for the VLM); its
gradients come from ``torch.autograd`` through `forward` (the train-path
`layers.flash_attention` is plain torch, as in the reference, and
differentiable). Track-B's cohort round (`repro_torch.fl.distributed`)
trains through it.

Under a pod mesh (a `launch.mesh.Mesh`, one rank per position) `forward`
and `loss_fn` take this rank's shards (`param_specs`, the reference's
rules) and its rows of the batch. The layers are tensor-parallel over
"model" wherever the specs split a leaf there, as GSPMD runs the
reference: GQA attention on the rank's columns of ``wq``/``wk``/``wv``
and rows of ``wo``, the dense SwiGLU on its columns of ``w_gate``/
``w_up`` and rows of ``w_down``, each region entered through
`launch.sharding.copy_to_model` and closed by one sum over "model" of
partial products kept at twice the activation precision
(`_gqa_attention_tp`, `_swiglu`, `layers.row_parallel`); MLA on the rank's
heads of ``w_uq``/``w_uk``/``w_uv``, their outputs gathered before the
replicated ``w_o`` (`mla`); Mamba2 on the rank's SSM heads, its block of
z and x from ``w_zx``, a gated norm summed over "model" and the rank's
rows of ``w_out`` (`mamba2.mamba_block`); the LM head on the rank's
vocabulary block, whose cross entropy never gathers the logits
(`loss_fn`). Every other leaf is replicated over "model" and gathered on
use over the batch axes (`launch.sharding.use_param`, its gradient summed
over the pod's batch axes); the routed experts stay split over "model"
(`moe.moe_ffn`) and the token embedding is vocab-parallel where "model"
divides the vocabulary. No leaf is gathered whole over "model".
Over a one-rank "model" axis nothing is split and the code is the
meshless code. `prefill` and `decode_step` take the same per-rank
contract, the decode cache as a `ShardedCache` of this rank's shards
(``launch.specs.cache_specs``): kv heads and SSM heads over "model" are
the rank's own heads of the tensor-parallel layers, conv channels split
over "model" run on the rank's block and are gathered in rank order
(with whole projections, under the dp_only policy, the SSM heads too);
a sequence split over ranks runs the decode kernel on the rank's
segment with its log-sum-exp, and the segments' partials are merged in
rank order (``kernels.flash_attention.merge_partials``; MLA's latents
too).
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.kernels.flash_attention import decode_attention, merge_partials
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import Mesh, axis_tuple
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.config import ModelConfig

Params = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; "cuda" without a card raises (the port
    never falls back to the CPU). ``meta`` runs the card's path on shapes
    only (``launch.dryrun``'s census)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _on(t: torch.Tensor, dev: torch.device, what: str) -> None:
    if t.device.type != dev.type:
        raise ValueError(f"{what} is on {t.device}, not on {dev}")


def _no_decode(cfg: ModelConfig) -> None:
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.family} does not support decode")


# ===========================================================================
# Parameters
# ===========================================================================

def _init_gqa(make: L.ParamMaker, cfg, dtype, d_attn=None) -> dict:
    d = d_attn or cfg.d_model
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": make.dense(d, h * dh, dtype),
         "wk": make.dense(d, hkv * dh, dtype),
         "wv": make.dense(d, hkv * dh, dtype),
         "wo": make.dense(h * dh, cfg.d_model, dtype)}
    if cfg.qkv_bias:
        p["bq"] = make.zeros((h * dh,), dtype)
        p["bk"] = make.zeros((hkv * dh,), dtype)
        p["bv"] = make.zeros((hkv * dh,), dtype)
    return p


def _init_ffn(make: L.ParamMaker, cfg, dtype, d_ff=None, d_in=None) -> dict:
    f, d = d_ff or cfg.d_ff, d_in or cfg.d_model
    return {"w_gate": make.dense(d, f, dtype), "w_up": make.dense(d, f, dtype),
            "w_down": make.dense(f, cfg.d_model, dtype)}


def _init_attn_layer(make: L.ParamMaker, cfg, dtype, moe: bool) -> dict:
    d = cfg.d_model
    p = {"ln1": make.ones((d,), dtype), "ln2": make.ones((d,), dtype),
         "attn": (MLA.init_mla_params(make, cfg, dtype) if cfg.use_mla
                  else _init_gqa(make, cfg, dtype))}
    p["ffn"] = (MOE.init_moe_params(
        make, cfg, dtype, lambda mk, f: _init_ffn(mk, cfg, dtype, d_ff=f))
        if moe else _init_ffn(make, cfg, dtype))
    return p


def _stack_init(make: L.ParamMaker, n: int, fn):
    """``fn`` of a maker that stacks n layers; None for an empty stack."""
    return fn(make.stacked(n)) if n > 0 else None


def _param_tree(cfg: ModelConfig, make: L.ParamMaker) -> Params:
    dt = _dtype(cfg)
    d = cfg.d_model
    p: dict = {"embed": make.normal((cfg.vocab, d), 0.02, dt),
               "final_norm": make.ones((d,), dt),
               "lm_head": make.dense(d, cfg.vocab, dt)}
    if cfg.frontend is not None:
        p["frontend_proj"] = make.dense(cfg.frontend_dim, d, dt)

    def mamba_layer(mk):
        return {"ln1": mk.ones((d,), dt),
                "mamba": M2.init_mamba_params(mk, cfg, dt)}

    fam = cfg.family
    if fam in ("dense", "encoder", "vlm"):
        p["layers"] = _stack_init(
            make, cfg.n_layers,
            lambda mk: _init_attn_layer(mk, cfg, dt, moe=False))
    elif fam == "moe":
        nd = cfg.n_dense_layers
        p["dense_layers"] = _stack_init(
            make, nd, lambda mk: _init_attn_layer(mk, cfg, dt, moe=False))
        p["moe_layers"] = _stack_init(
            make, cfg.n_layers - nd,
            lambda mk: _init_attn_layer(mk, cfg, dt, moe=True))
    elif fam == "ssm":
        p["layers"] = _stack_init(make, cfg.n_layers, mamba_layer)
    elif fam == "hybrid":
        p["layers"] = _stack_init(make, cfg.n_layers, mamba_layer)
        # Zamba2's shared attention block on concat([h, x_emb]) (width 2d)
        d2 = 2 * d
        p["shared_attn"] = {
            "ln": make.ones((d2,), dt),
            "attn": _init_gqa(make, cfg, dt, d_attn=d2),
            "ln2": make.ones((d2,), dt),
            "ffn": _init_ffn(make, cfg, dt, d_in=d2)}
    else:
        raise ValueError(fam)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Random parameters in the reference's distributions (N(0, 1/d_in)
    weights, N(0, 0.02²) embedding, N(0, 1/d) f32 router, N(0, 0.2²) conv
    taps, unit norms and skips, zero QKV biases, ``a_log`` and ``dt_bias``),
    drawn from ``generator``, which must live on ``device``."""
    dev = resolve_device(device)
    return _param_tree(cfg, L.ParamMaker(generator, dev))


def init_abstract(cfg: ModelConfig) -> Params:
    """The parameters' shapes and dtypes as tensors on the ``meta`` device
    (no memory), the reference's ``init_abstract``."""
    return _param_tree(cfg, L.ParamMaker(None, torch.device("meta")))


# ===========================================================================
# Partition specs (DESIGN.md §5), the reference's rules: fsdp = "data",
# tp = "model"; an axis is dropped where the dim does not divide. A spec is
# a tuple with one entry per dim: None, an axis name or a tuple of names.
# ===========================================================================

def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts; None subtrees stay None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    return fn(path, tree)


def param_specs(cfg: ModelConfig, mesh) -> Params:
    """The spec of every leaf of ``init_abstract(cfg)`` on ``mesh`` (any
    object with ``axis_names`` and ``shape``); all-replicated ``()`` specs
    without a mesh."""
    if mesh is None:
        return _map_with_path(lambda _p, _l: (), init_abstract(cfg))
    axes = tuple(mesh.axis_names)
    fsdp = tuple(a for a in axes if a != "model" and a != "pod")
    fsdp = fsdp[0] if len(fsdp) == 1 else fsdp
    tp = "model"
    sizes = dict(mesh.shape)
    fsdp_size = sizes.get("data", 1)
    tp_size = 1 if cfg.dp_only else sizes.get("model", 1)

    def div(dim, axis, size):
        return axis if (axis is not None and dim % size == 0
                        and size > 1) else None

    def spec_for(names, leaf):
        shape = tuple(leaf.shape)
        stacked = bool(names) and names[0] in ("layers", "dense_layers",
                                               "moe_layers")
        core = shape[1:] if stacked else shape
        nm = names[-1]
        parent = names[-2] if len(names) > 1 else ""

        def out(*core_spec):
            core_spec = list(core_spec) + [None] * (len(core)
                                                    - len(core_spec))
            return tuple(([None] if stacked else []) + core_spec)

        if len(core) == 0:
            return ()
        if nm == "embed":
            return out(div(core[0], tp, tp_size), None)
        if nm == "lm_head":
            return out(div(core[0], fsdp, fsdp_size),
                       div(core[1], tp, tp_size))
        if nm == "router":
            return out(None, None)
        if parent != "shared" and nm in ("w_gate", "w_up") and len(core) == 3:
            # routed experts [E, d, f]: EP over tp, FSDP over d
            return out(div(core[0], tp, tp_size),
                       div(core[1], fsdp, fsdp_size), None)
        if nm == "w_down" and len(core) == 3:
            return out(div(core[0], tp, tp_size), None,
                       div(core[2], fsdp, fsdp_size))
        if parent == "shared" and nm in ("w_gate", "w_up"):
            return out(None, div(core[1], tp, tp_size))
        if parent == "shared" and nm == "w_down":
            return out(div(core[0], tp, tp_size), None)
        if nm in ("wq", "wk", "wv", "w_gate", "w_up", "w_uq", "w_zx"):
            return out(div(core[0], fsdp, fsdp_size),
                       div(core[1], tp, tp_size))
        if nm in ("wo", "w_down", "w_out"):
            return out(div(core[0], tp, tp_size),
                       div(core[1], fsdp, fsdp_size))
        if nm in ("w_uk", "w_uv"):   # [kv_lora, H, hd]: TP over heads
            return out(None, div(core[1], tp, tp_size), None)
        if nm in ("w_dq", "w_dkv", "w_bcdt", "frontend_proj"):
            return out(div(core[0], fsdp, fsdp_size), None)
        if nm in ("bq", "bk", "bv"):
            return out(div(core[0], tp, tp_size))
        if nm == "norm":             # mamba gated-norm scale [d_inner]
            return out(div(core[0], tp, tp_size))
        return out(*([None] * len(core)))

    return _map_with_path(spec_for, init_abstract(cfg))


@functools.lru_cache(maxsize=32)
def _cached_specs(cfg: ModelConfig, mesh) -> Params:
    """`param_specs` of a (config, mesh) pair, built once (read only)."""
    return param_specs(cfg, mesh)


def dp_axes(cfg: ModelConfig, mesh, manual_axes=()) -> tuple:
    """Axes carrying the batch: the non-model axes (+ "model" under
    ``dp_only``), without ``manual_axes``."""
    axes = tuple(a for a in mesh.axis_names if a not in manual_axes)
    if cfg.dp_only:
        return axes
    return tuple(a for a in axes if a != "model")


def spec_entry(axes):
    """One spec entry of a tuple of axis names, as PartitionSpec keeps it:
    None for none, the name for one, the tuple for more."""
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def batch_spec(cfg: ModelConfig, mesh) -> tuple:
    if mesh is None:
        return ()
    return (spec_entry(dp_axes(cfg, mesh)),)


def _to_tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":                # ml_dtypes, no torch twin
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(dev)


def _structure(tree, prefix=""):
    """{path: (shape, dtype)} of a tree's leaves; None subtrees as None."""
    if tree is None:
        return {prefix: None}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_structure(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), tree.dtype)}


def from_reference(params, cfg: ModelConfig, device="cuda") -> Params:
    """The reference's ``init_params`` pytree (numpy or jax arrays, stacked
    ``[L, ...]`` layers, None for an empty stack) as the port's parameters:
    the same nested dict, copied leaf by leaf in the same dtype. Raises
    ``ValueError`` when its leaves are not those of ``cfg``."""
    dev = resolve_device(device)

    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _to_tensor(x, dev)

    out = conv(params)
    got, want = _structure(out), _structure(init_abstract(cfg))
    if got != want:
        diff = sorted(k for k in set(got) | set(want)
                      if got.get(k, "-") != want.get(k, "-"))
        raise ValueError(f"params do not match {cfg.name}'s: {diff[:6]}")
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


def _n_stacked(stacked: dict) -> int:
    v = next(iter(stacked.values()))
    return _n_stacked(v) if isinstance(v, dict) else v.shape[0]


# ===========================================================================
# Forward
# ===========================================================================

class _Split(NamedTuple):
    """The live mesh axes that split one layer's cache: its positions
    (``seq``) and its heads (``heads``: kv heads, SSM heads or conv
    channels)."""
    seq: tuple = ()
    heads: tuple = ()


def _gqa_decode(q, kk, vv, cache, length, mesh=None,
                split: _Split = _Split()):
    """Decode attention over the cache (written in place at length[b]),
    [B, H, Dh]. Under a mesh, on this rank's shards of it: ``q``, ``kk``
    and ``vv`` hold the heads of the cache's block (its kv heads and
    their query heads where ``split.heads`` splits them), and its segment
    of positions where ``split.seq`` does. The new K/V row goes only into
    the segment that holds position length[b]; kernel 4 runs on the local
    heads and positions at local length clamp(length + 1 − offset, 0,
    S_loc), with its f32 output and lse, and the segments' partials are
    merged in rank order (`merge_partials`). Every collective runs on
    every rank."""
    ck, cv = cache["k"], cache["v"]
    s_loc = ck.shape[1]
    q1 = q[:, 0].contiguous()
    off = mesh.index_over(split.seq) * s_loc if split.seq else None
    L.place_at(ck, kk, length, off)
    L.place_at(cv, vv, length, off)
    if split.seq:
        local = torch.clamp(length + 1 - off, 0, s_loc).to(torch.int32)
        lse = torch.empty(q1.shape[:2], dtype=torch.float32,
                          device=q1.device)
        # the partials stay f32 until the merge rounds once, as the
        # kernel's own merge of splits does
        y = decode_attention(q1, ck, cv, local, lse, torch.float32)
        return merge_partials(mesh.all_gather_axis(y[None], split.seq, 0),
                              mesh.all_gather_axis(lse[None], split.seq, 0)
                              ).to(q1.dtype)
    return decode_attention(q1, ck, cv, (length + 1).to(torch.int32))


def _attend(q, kk, vv, cfg, cache, length, mesh, split):
    """[B, S, H_q·Dh] of attention over the given heads: the train-path
    flash attention, or `_gqa_decode` into ``cache``."""
    b, s = q.shape[:2]
    if cache is None:
        y = L.flash_attention(q, kk, vv, causal=cfg.causal)
    else:
        y = _gqa_decode(q, kk, vv, cache, length, mesh, split)[:, None]
    return y.reshape(b, s, -1)


def _gqa_attention(x, p, cfg, rope, cache=None, length=None, mesh=None,
                   split: _Split | None = None):
    """Standard GQA attention. rope: (cos, sin) of the positions, from
    `_rope`; cache: dict(k, v) [B,S,Hkv,Dh] or None. Under ``mesh`` the
    decode runs on this rank's shards of the cache, split as ``split``
    says (`_gqa_decode`), and where ``p`` holds "model" blocks of the
    projections the layer is tensor-parallel (`_gqa_attention_tp`)."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    split = split or _Split()
    if p["wq"].shape[-1] < h * dh:
        return _gqa_attention_tp(x, p, cfg, rope, cache, length, mesh, split)
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
    if cache is not None and split.heads:
        # whole projections beside a cache whose kv heads are split (no
        # tensor parallelism: the dp_only policy): the rank's heads, and
        # every rank's outputs gathered back in rank order
        j, hkv_l = mesh.index_over(split.heads), cache["k"].shape[2]
        h_l = hkv_l * (h // hkv)
        y = _attend(q[:, :, j * h_l:(j + 1) * h_l],
                    kk[:, :, j * hkv_l:(j + 1) * hkv_l],
                    vv[:, :, j * hkv_l:(j + 1) * hkv_l], cfg, cache, length,
                    mesh, split)
        y = mesh.all_gather_axis(y, split.heads, -1)
    else:
        y = _attend(q, kk, vv, cfg, cache, length, mesh, split)
    return torch.matmul(y, p["wo"]), (cache if cache is not None else
                                      {"k": kk, "v": vv})


def _gqa_attention_tp(x, p, cfg, rope, cache, length, mesh, split):
    """`_gqa_attention` with ``p`` holding this rank's "model" blocks:
    the columns of ``wq`` (and ``bq``), of ``wk``/``wv`` where their width
    divides over "model" (else the whole leaves), and the rows of ``wo``.

    ``x`` enters through `copy_to_model`. Where the rank's columns of q
    are whole heads (and, in decode, the cache splits the kv heads), the
    attention runs on the rank's query heads, each reading kv head
    ``h // G``: the rank's own k/v columns where they are whole heads,
    else the whole k/v cut to the heads it needs. Otherwise q, k and v
    are whole on every rank and every rank attends over every head (in
    decode: over its segment of a cache split by positions, the partials
    merged in rank order), then keeps its rows of the output. A whole
    projection from split columns is gathered over "model" in rank order
    as an activation, never as its weight. The rank's rows of the output
    meet its rows of ``wo``, and `layers.row_parallel` sums the ranks'
    products."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n, r = mesh.axis_size("model"), mesh.axis_index("model")
    cos, sin = rope
    xc = SH.copy_to_model(x, mesh)
    bias = cfg.qkv_bias and "bq" in p

    def proj(w, bn, src):
        out = torch.matmul(src, p[w])
        return out + p[bn] if bias else out

    def whole(w, bn, heads):
        """Every column of x @ w (+ b), as [B, S, heads, Dh]: the rank's
        block gathered over "model" in rank order, or the whole leaf on
        the (replicated) input."""
        if p[w].shape[-1] < heads * dh:
            out = SH.gather_from_model(proj(w, bn, xc), mesh)
        else:
            out = proj(w, bn, x)
        return out.reshape(b, s, heads, dh)

    def rope(t):
        return L.apply_rope(t, cos, sin)

    if h % n == 0 and (cache is None or split.heads):
        h_l = h // n
        q = rope(proj("wq", "bq", xc).reshape(b, s, h_l, dh))
        if hkv % n == 0:
            kk = rope(proj("wk", "bk", xc).reshape(b, s, hkv // n, dh))
            vv = proj("wv", "bv", xc).reshape(b, s, hkv // n, dh)
        else:
            # the kv head of each of the rank's query heads, from the
            # whole k/v (each rank uses other heads of it: copy_to_model)
            g = h // hkv
            lo, hi = (r * h_l) // g, ((r + 1) * h_l - 1) // g + 1
            off = r * h_l - lo * g

            def mine(t):
                t = SH.copy_to_model(t, mesh).narrow(2, lo, hi - lo)
                return t.repeat_interleave(g, dim=2).narrow(2, off, h_l)
            kk = mine(rope(whole("wk", "bk", hkv)))
            vv = mine(whole("wv", "bv", hkv))
        y = _attend(q, kk, vv, cfg, cache, length, mesh, split)
    else:
        y = _attend(rope(whole("wq", "bq", h)), rope(whole("wk", "bk", hkv)),
                    whole("wv", "bv", hkv), cfg, cache, length, mesh, split)
        w = p["wo"].shape[0]
        y = SH.copy_to_model(y, mesh).narrow(-1, r * w, w)
    return L.row_parallel(y, p["wo"], mesh), cache


def _swiglu(x, fp, cfg, mesh=None):
    """The dense SwiGLU; where ``fp`` holds this rank's "model" blocks
    (columns of ``w_gate``/``w_up``, rows of ``w_down``) its hidden width
    is split: `copy_to_model` in, `layers.row_parallel` out."""
    if fp["w_gate"].shape[-1] < cfg.d_ff:
        xc = SH.copy_to_model(x, mesh)
        h = torch.nn.functional.silu(torch.matmul(xc, fp["w_gate"])) * \
            torch.matmul(xc, fp["w_up"])
        return L.row_parallel(h, fp["w_down"], mesh)
    return L.swiglu(x, fp["w_gate"], fp["w_up"], fp["w_down"])


def _attn_ffn_layer(x, lp, cfg, rope, cache=None, length=None, moe=False,
                    mesh=None, split: _Split | None = None):
    h = x
    xa = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        if cache is None:
            ao, new_cache = MLA.mla_attention_train(xa, lp["attn"], cfg, rope,
                                                    mesh)
        else:
            ao, new_cache = MLA.mla_attention_decode(
                xa, lp["attn"], cfg, cache, length, rope, mesh,
                () if split is None else split.seq)
    else:
        ao, new_cache = _gqa_attention(xa, lp["attn"], cfg, rope, cache,
                                       length, mesh, split)
    h = h + ao
    xf = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
    fp = lp["ffn"]
    if moe:
        # under a mesh moe_ffn takes the rank's shards and runs the shared
        # expert itself, in its model-parallel region
        fo = MOE.moe_ffn(xf, fp, cfg, mesh)
        if cfg.n_shared_experts and mesh is None:
            sp = fp["shared"]
            fo = fo + L.swiglu(xf, sp["w_gate"], sp["w_up"], sp["w_down"])
    else:
        fo = _swiglu(xf, fp, cfg, mesh)
    return h + fo, new_cache


def _rope(cfg, positions):
    """(cos, sin) of ``positions`` (at ``qk_rope_dim`` under MLA): the
    reference recomputes them in every layer's attention; they are the same
    for every layer, so the port computes them once per call (same values,
    fewer small launches per layer stack)."""
    dim = cfg.qk_rope_dim if cfg.use_mla else cfg.head_dim
    return L.rope_freqs(dim, cfg.rope_theta, positions)


def _scan_layers(x, stacked, cfg, positions, caches=None, length=None,
                 moe=False, use=None, stack=None, split=None):
    """The attention layer stack in order (the reference's ``lax.scan``);
    an empty stack (None) passes x through. ``caches``: a dict of [L, ...]
    tensors ({"k", "v"}, or MLA's {"c", "k_rope"}), written in place
    (under a mesh this rank's shards, split as ``split`` says).
    ``use`` (a `_Use`, under a mesh) gathers each layer's shards of the
    stack named ``stack`` as the layer runs; a MoE layer's FFN stays with
    `moe.moe_ffn`."""
    if stacked is None:
        return x, caches
    rope = _rope(cfg, positions)
    for i, lp in enumerate(_unstack(stacked, _n_stacked(stacked))):
        cache = (None if caches is None else
                 {k: v[i] for k, v in caches.items()})
        if use is not None:
            lp = use.layer(lp, stack, keep=("ffn",) if moe else ())
        x, _ = _attn_ffn_layer(x, lp, cfg, rope, cache, length, moe,
                               None if use is None else use.mesh, split)
    return x, caches


# --- SSM / hybrid stacks ----------------------------------------------------

def _scan_mamba(x, layers: list, cfg, states=None, convs=None, mesh=None,
                splits=None):
    """Mamba2 layers (per-layer dicts) in order, each ``h + block(norm(h))``.
    Decode (``states`` [L, B, H, P, N], ``convs`` [L, B, W-1, C]) writes
    each layer's new states in place; under ``mesh`` they are this rank's
    shards, their heads and channels split as ``splits`` (the (ssm, conv)
    `_Split`s) says."""
    heads, chans = ((), ()) if splits is None else (s.heads for s in splits)
    for i, lp in enumerate(layers):
        xa = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        mo, (ns, nc) = M2.mamba_block(
            xa, lp["mamba"], cfg,
            state=None if states is None else states[i],
            conv_state=None if convs is None else convs[i], mesh=mesh,
            head_axes=heads, chan_axes=chans)
        x = x + mo
        if states is not None:
            states[i].copy_(ns)
            convs[i].copy_(nc)
    return x


def _shared_attn_block(h, x0, sp, cfg, rope, cache=None, length=None,
                       mesh=None, split=None):
    """Zamba2 shared block: attention+MLP on concat([h, x0]) → residual to
    h."""
    z = torch.cat([h, x0], dim=-1)
    za = L.rms_norm(z, sp["ln"], cfg.norm_eps)
    ao, new_cache = _gqa_attention(za, sp["attn"], cfg, rope, cache, length,
                                   mesh, split)
    z2 = L.rms_norm(z + torch.cat([ao, torch.zeros_like(ao)], dim=-1),
                    sp["ln2"], cfg.norm_eps)
    return h + ao + _swiglu(z2, sp["ffn"], cfg, mesh), new_cache


def _hybrid_segments(cfg) -> list:
    """Segment the mamba stack at shared-attention application points."""
    period = cfg.attn_every
    segs, done = [], 0
    while done < cfg.n_layers:
        seg = min(period, cfg.n_layers - done)
        segs.append(seg)
        done += seg
    return segs


def _hybrid(x, params, cfg, positions, cache=None, length=None, use=None,
            splits=None):
    """Zamba2's stack: before each segment of ``attn_every`` Mamba2 layers,
    the shared block on concat([h, embedding]) (cache["shared"] slice si
    for application si in decode; ``splits`` the cache's `_Split`s under a
    mesh)."""
    mesh = None if use is None else use.mesh
    splits = splits or {}
    x0 = x
    rope = _rope(cfg, positions)
    layers = _unstack(params["layers"], cfg.n_layers)
    shared = params["shared_attn"]
    if use is not None:
        layers = [use.layer(lp, "layers") for lp in layers]
        shared = use.top("shared_attn")
    off = 0
    for si, seg in enumerate(_hybrid_segments(cfg)):
        sc = (None if cache is None else
              {k: v[si] for k, v in cache["shared"].items()})
        x, _ = _shared_attn_block(x, x0, shared, cfg, rope, sc, length,
                                  mesh, splits.get("shared"))
        x = _scan_mamba(
            x, layers[off:off + seg], cfg,
            None if cache is None else cache["ssm"][off:off + seg],
            None if cache is None else cache["conv"][off:off + seg], mesh,
            None if "ssm" not in splits else (splits["ssm"],
                                              splits["conv"]))
        off += seg
    return x


# ===========================================================================
# Embedding / frontend
# ===========================================================================

def _vocab_parallel(cfg: ModelConfig, mesh) -> bool:
    n_model = mesh.shape.get("model", 1)
    return (not cfg.dp_only) and cfg.vocab % n_model == 0 and n_model > 1


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, cfg=None,
                 mesh=None) -> torch.Tensor:
    """Rows of ``table`` for ``tokens``. ``F.embedding``, not ``table[tokens]``:
    the same values, but its backward on the card sums repeated tokens in a
    fixed order, where an indexed read's backward accumulates with atomics
    in no fixed order (same-input training steps must repeat bit for
    bit).

    Under a mesh whose "model" axis divides the vocabulary, ``table`` is
    this rank's vocabulary block (the reference's vocab-parallel branch): a
    masked local lookup, then `sharding.reduce_from_model`. Exactly one
    rank's term is non-zero, so the sum is exact."""
    if mesh is None or not _vocab_parallel(cfg, mesh):
        return torch.nn.functional.embedding(tokens.long(), table)
    vloc = cfg.vocab // mesh.shape["model"]
    local = tokens.long() - mesh.axis_index("model") * vloc
    ok = (local >= 0) & (local < vloc)
    emb = torch.nn.functional.embedding(local.clamp(0, vloc - 1), table)
    emb = torch.where(ok[..., None], emb, torch.zeros_like(emb))
    return SH.reduce_from_model(emb, mesh)


def embed_inputs(params, batch, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """batch: {"tokens": [B,S]}, or {"frames": [B,S,F]} for the audio
    frontend, or {"tokens", "patches": [B,P,F]} for the vision frontend
    (patches first)."""
    if cfg.frontend == "audio":
        return torch.matmul(batch["frames"].to(_dtype(cfg)),
                            params["frontend_proj"])
    tok = embed_lookup(params["embed"], batch["tokens"], cfg, mesh)
    if cfg.frontend == "vision":
        patch = torch.matmul(batch["patches"].to(_dtype(cfg)),
                             params["frontend_proj"])
        return torch.cat([patch, tok], dim=1)
    return tok


def _check_batch(params, batch, dev) -> None:
    for k, v in batch.items():
        _on(v, dev, k)
    _on(params["embed"], dev, "params")


# ===========================================================================
# Train forward / loss
# ===========================================================================

def check_mesh(mesh, dev: torch.device | None = None) -> Mesh:
    """``mesh`` if it is a `launch.mesh.Mesh` (on ``dev``'s device type),
    else TypeError (ValueError for another device)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh or "
                        f"None, got {type(mesh).__name__}")
    if dev is not None and mesh.device.type != dev.type:
        raise ValueError(f"the mesh's rank device is {mesh.device}, not "
                         f"{dev}")
    return mesh


# the leaves a layer uses as its "model" block where their spec splits them
# there (tensor parallelism), by the name of the dict that holds them: GQA's
# projections and MLA's up-projections, the dense SwiGLU, Mamba2's in- and
# out-projections and gated-norm scale; the LM head at the top
_TP_LEAVES = {"attn": ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_uq",
                       "w_uk", "w_uv"),
              "ffn": ("w_gate", "w_up", "w_down"),
              "mamba": ("w_zx", "w_out", "norm")}


class _Use:
    """The leaves of a rank's shards as the forward uses them under
    ``mesh``: gathered on use over their spec's axes (FSDP), their
    gradients summed over the pod's batch axes (`sharding.use_param`).
    A leaf whose spec splits it over "model" and that a tensor-parallel
    layer computes with (`_TP_LEAVES`: GQA's, MLA's, the dense SwiGLU's
    and Mamba2's; the LM head) keeps its "model" block (`sharding.
    use_block`), so no leaf is gathered whole over "model". The token
    embedding keeps its block (vocab-parallel lookup) and a MoE layer's
    FFN its shards (`moe.moe_ffn`)."""

    def __init__(self, cfg: ModelConfig, mesh: Mesh, params):
        self.mesh, self.params, self.cfg = mesh, params, cfg
        self.specs = _cached_specs(cfg, mesh)
        self.dp = dp_axes(cfg, mesh, ("pod",))
        self._layer_specs = {}

    def _tensor_parallel(self, path, spec) -> bool:
        if "model" not in SH.spec_axes(spec):
            return False
        if path == ("lm_head",):
            return True
        return len(path) > 1 and path[-1] in _TP_LEAVES.get(path[-2], ())

    def _tree(self, tree, specs, keep=(), path=()):
        if isinstance(tree, dict):
            return {k: (tree[k] if k in keep else self._tree(
                tree[k], specs[k], path=path + (k,))) for k in sorted(tree)}
        use = (SH.use_block if self._tensor_parallel(path, specs)
               else SH.use_param)
        return use(tree, specs, self.mesh, self.dp)

    def top(self, name):
        if name == "embed":          # the block as stored: see embed_lookup
            return SH.use_param(self.params[name], (), self.mesh, self.dp)
        return self._tree(self.params[name], self.specs[name], path=(name,))

    def layer(self, lp, stack: str, keep=()):
        """One layer's dict of views of the stack ``stack`` (its specs
        without the stack's leading None)."""
        if stack not in self._layer_specs:
            self._layer_specs[stack] = _map_with_path(
                lambda _p, sp: sp[1:], self.specs[stack])
        return self._tree(lp, self._layer_specs[stack], keep)


def _lm_head(x, w, cfg: ModelConfig, mesh=None):
    """(logits, split): ``x`` through the LM head ``w``; where ``w`` is
    this rank's vocabulary block (a tensor-parallel head) the logits are
    that block, from `copy_to_model` of ``x``, and ``split`` is True."""
    if w.shape[-1] < cfg.vocab:
        return torch.matmul(SH.copy_to_model(x, mesh), w), True
    return torch.matmul(x, w), False


def _hidden(params, batch, cfg: ModelConfig, device, mesh):
    """(final hidden states [B, S, d], the top leaves as used)."""
    dev = resolve_device(device)
    _check_batch(params, batch, dev)
    use = None if mesh is None else _Use(cfg, check_mesh(mesh, dev), params)
    top = params if use is None else {
        k: use.top(k) for k in ("embed", "frontend_proj", "final_norm",
                                "lm_head") if k in params}
    x = embed_inputs(top, batch, cfg, mesh)
    positions = torch.arange(x.shape[1], device=dev)
    fam = cfg.family
    if fam in ("dense", "encoder", "vlm"):
        x, _ = _scan_layers(x, params["layers"], cfg, positions, use=use,
                            stack="layers")
    elif fam == "moe":
        x, _ = _scan_layers(x, params["dense_layers"], cfg, positions,
                            use=use, stack="dense_layers")
        x, _ = _scan_layers(x, params["moe_layers"], cfg, positions,
                            moe=True, use=use, stack="moe_layers")
    elif fam == "ssm":
        layers = _unstack(params["layers"], cfg.n_layers)
        if use is not None:
            layers = [use.layer(lp, "layers") for lp in layers]
        x = _scan_mamba(x, layers, cfg, mesh=mesh)
    elif fam == "hybrid":
        x = _hybrid(x, params, cfg, positions, use=use)
    else:
        raise ValueError(fam)
    return L.rms_norm(x, top["final_norm"], cfg.norm_eps), top


def forward(params, batch, cfg: ModelConfig, device="cuda",
            mesh=None) -> torch.Tensor:
    """Logits [B, S, V] of the full forward (causal but for the encoder).

    Under ``mesh`` (a `launch.mesh.Mesh`), ``params`` are this rank's
    shards (`param_specs`) and ``batch`` its rows: the leaves are gathered
    on use but where a layer is tensor-parallel over "model" (`_Use`),
    the routed experts stay over "model" (`moe.moe_ffn`) and the token
    embedding is vocab-parallel where "model" divides the vocabulary. A
    vocab-parallel LM head's blocks are gathered over "model" in rank
    order: every rank returns the whole logits of its rows."""
    x, top = _hidden(params, batch, cfg, device, mesh)
    logits, split = _lm_head(x, top["lm_head"], cfg, mesh)
    return SH.gather_from_model(logits, mesh) if split else logits


def loss_fn(params, batch, cfg: ModelConfig, device="cuda",
            mesh=None) -> torch.Tensor:
    """Mean cross entropy over the positions with ``labels >= 0``, as the
    reference's ``loss_fn``: the VLM's logits keep only the text positions,
    the decoders' logits and labels shift by one (the encoder's do not),
    the row max is taken with its gradient stopped, the shift stays in the
    model dtype, ``exp``/``log`` run in f32 and the label logit is read in
    f32. The label logit is a gather (the reference contracts a one-hot,
    which only a sharded vocabulary needs; the values and the gradient are
    the same); masked labels are clamped to 0 for the gather and weigh 0.

    Under ``mesh`` the pod's loss: the sum of the per-position losses and
    the count of positions are summed over the pod's batch axes (in a
    fixed order) before the division, as the reference's global mean
    over the pod's rows; the gradient is this rank's rows' part of it,
    which `sharding.use_param` sums over those axes. Where the LM head is
    vocab-parallel the cross entropy is the reference's partitionable one
    on the rank's vocabulary block, never gathered: the row max is the MAX
    over "model" of the blocks' maxima, the f32 sums of exps and the label
    logit (read on the rank that owns the label, 0 elsewhere) are summed
    over "model" (`sharding.reduce_from_model`)."""
    x, top = _hidden(params, batch, cfg, device, mesh)
    logits, split = _lm_head(x, top["lm_head"], cfg, mesh)
    labels = batch["labels"].to(torch.int64)
    if cfg.frontend == "vision":            # loss only on text positions
        logits = logits[:, cfg.n_patches:, :]
    if cfg.family != "encoder":             # next-token shift for decoders
        logits = logits[:, :-1, :]
        labels = labels[:, 1:]
    m = torch.amax(logits.detach(), dim=-1, keepdim=True)
    if split:
        m = mesh.max_axis(m, "model")
    shifted = logits - m                                       # model dtype
    sumexp = torch.sum(torch.exp(shifted.to(torch.float32)), dim=-1)
    if split:
        sumexp = SH.reduce_from_model(sumexp, mesh)
    lse = torch.log(sumexp) + m[..., 0].to(torch.float32)
    if split:
        v_l = logits.shape[-1]
        local = labels - mesh.axis_index("model") * v_l
        own = (local >= 0) & (local < v_l)
        lab_logit = torch.gather(logits, -1, local.clamp(0, v_l - 1)[
            ..., None])[..., 0].to(torch.float32)
        lab_logit = SH.reduce_from_model(
            torch.where(own, lab_logit, torch.zeros_like(lab_logit)), mesh)
    else:
        lab_logit = torch.gather(logits, -1, labels.clamp(min=0)[..., None]
                                 )[..., 0].to(torch.float32)
    ll = lab_logit - lse
    mask = (labels >= 0).to(torch.float32)
    total, count = -torch.sum(ll * mask), torch.sum(mask)
    if mesh is not None:
        dp = dp_axes(cfg, mesh, ("pod",))
        total = SH.reduce_from(total, mesh, dp)
        count = mesh.sum_axis(count, dp)
    return total / torch.clamp(count, min=1.0)


def prefill(params, batch, cfg: ModelConfig, device="cuda",
            mesh=None) -> torch.Tensor:
    """Forward over a full prompt; returns last-position logits [B, V]
    (the cache is rebuilt decode-side, as in the reference). Under
    ``mesh``, `forward`'s per-rank contract: ``params`` this rank's
    shards, ``batch`` its rows (its block over the data axes when they
    divide B, else every row); the logits of those rows, the same on every
    "model" rank (a vocab-parallel head computes and gathers the last
    position's only)."""
    x, top = _hidden(params, batch, cfg, device, mesh)
    if top["lm_head"].shape[-1] < cfg.vocab:
        logits, _ = _lm_head(x[:, -1:], top["lm_head"], cfg, mesh)
        return SH.gather_from_model(logits, mesh)[:, 0]
    return torch.matmul(x, top["lm_head"])[:, -1]


# ===========================================================================
# Serving: cache + decode
# ===========================================================================

def init_cache(cfg: ModelConfig, batch: int, seq: int, device="cuda"):
    """Zeros in the model dtype (SSM states in f32), the reference's
    layout: {"layers": {"k", "v": [L, B, S, Hkv, Dh]}} (dense, VLM);
    {"dense_layers", "moe_layers"} of K/V or, under MLA, of latents
    {"c": [L, B, S, kv_lora], "k_rope": [L, B, S, qk_rope]} (an empty
    stack has L = 0); {"ssm": [L, B, H, P, N], "conv": [L, B, W-1, C]}
    (SSM), plus {"shared": {"k", "v": [n_shared, B, S, Hkv, Dh]}} for the
    hybrid. The encoder raises ``ValueError``."""
    _no_decode(cfg)
    return _init_cache(cfg, batch, seq, resolve_device(device))


def _init_cache(cfg: ModelConfig, batch: int, seq: int,
                dev: torch.device):
    """`init_cache` on ``dev`` (also ``meta``, for the cache's shapes)."""
    dt = _dtype(cfg)

    def kv(n):
        shape = (n, batch, seq, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}

    fam = cfg.family
    if fam in ("dense", "vlm"):
        return {"layers": kv(cfg.n_layers)}
    if fam == "moe":
        nd, nm = cfg.n_dense_layers, cfg.n_layers - cfg.n_dense_layers
        if cfg.use_mla:
            return {"dense_layers": MLA.init_mla_cache(batch, seq, cfg, dt,
                                                       dev, layers=nd),
                    "moe_layers": MLA.init_mla_cache(batch, seq, cfg, dt,
                                                     dev, layers=nm)}
        return {"dense_layers": kv(nd), "moe_layers": kv(nm)}
    ssm, conv = M2.init_mamba_cache(batch, cfg, dt, dev, layers=cfg.n_layers)
    if fam == "ssm":
        return {"ssm": ssm, "conv": conv}
    if fam == "hybrid":
        return {"ssm": ssm, "conv": conv,
                "shared": kv(len(_hybrid_segments(cfg)))}
    raise ValueError(fam)


class ShardedCache(dict):
    """A rank's shards of a decode cache under a mesh: the tree of
    `init_cache`, each leaf this rank's block as ``specs`` (the tree of
    ``launch.specs.cache_specs(cfg, mesh, B, S)``) lays it out. Made by
    ``launch.specs.shard_cache`` (from a whole cache) or
    ``launch.specs.init_sharded_cache`` (zeros); `decode_step` reads the
    layout from ``specs``."""

    def __init__(self, tree: dict, specs: dict):
        super().__init__(tree)
        self.specs = specs


def _cache_splits(cache: ShardedCache, mesh: Mesh) -> dict:
    """{group: `_Split`} of each group of a sharded cache ("layers",
    "dense_layers", "moe_layers", "shared": K/V or MLA latents; "ssm":
    heads; "conv": channels), from the specs of its [L, ...] leaves."""
    def live(entry):
        return mesh.live_axes(axis_tuple(entry))

    out = {}
    for name, sp in cache.specs.items():
        if name == "ssm":                   # [L, B, H, P, N]
            out[name] = _Split(heads=live(sp[2]))
        elif name == "conv":                # [L, B, W-1, C]
            out[name] = _Split(heads=live(sp[3]))
        elif "k" in sp:                     # [L, B, S, Hkv, Dh]
            out[name] = _Split(seq=live(sp["k"][2]), heads=live(sp["k"][3]))
        else:                               # MLA [L, B, S, r]
            out[name] = _Split(seq=live(sp["c"][2]))
    return out


def decode_step(params, cache, batch, length, cfg: ModelConfig,
                device="cuda", mesh=None):
    """One token for every sequence. batch {"tokens": [B,1]}; length [B]
    int32, the number of tokens already in the cache. Writes the new
    position (K/V or latents at length[b], SSM and conv states) in place
    and returns (logits [B, V], cache).

    Under ``mesh`` (a `launch.mesh.Mesh`) the per-rank contract:
    ``params`` are this rank's shards (`param_specs`), used as `forward`
    uses them (tensor-parallel over "model" where the specs split a leaf
    there, else gathered on use);
    ``cache`` a `ShardedCache` of its shards as ``launch.specs.
    cache_specs(cfg, mesh, B, S)`` lays them out (the batch over the data
    axes where they divide B, else the sequence; kv heads, SSM heads and
    conv channels over "model" where it divides them, else, for K/V, the
    sequence); ``tokens`` and ``length`` its rows (its block over the data
    axes when they divide B, else every row). Returns the logits of its
    rows [B_loc, V], the same on every "model" rank. On the (1, 1) local
    mesh the step is bit-identical to ``mesh=None``."""
    _no_decode(cfg)
    dev = resolve_device(device)
    tokens = batch["tokens"]
    for t, what in ((tokens, "tokens"), (length, "length"),
                    (params["embed"], "params"),
                    (next(_cache_leaves(cache)), "cache")):
        _on(t, dev, what)
    use = splits = None
    top = params
    if mesh is not None:
        use = _Use(cfg, check_mesh(mesh, dev), params)
        if not isinstance(cache, ShardedCache):
            raise TypeError("under a mesh the cache must be a ShardedCache "
                            "(launch.specs.shard_cache or "
                            "init_sharded_cache)")
        splits = _cache_splits(cache, mesh)
        top = {k: use.top(k) for k in ("embed", "final_norm", "lm_head")}
    x = embed_lookup(top["embed"], tokens, cfg, mesh)
    positions = length[:, None]
    fam = cfg.family

    def stack(x, name, moe=False):
        return _scan_layers(x, params[name], cfg, positions,
                            caches=cache[name], length=length, moe=moe,
                            use=use, stack=name,
                            split=None if splits is None else splits[name])[0]

    if fam in ("dense", "vlm"):
        x = stack(x, "layers")
    elif fam == "moe":
        x = stack(x, "dense_layers")
        x = stack(x, "moe_layers", moe=True)
    elif fam == "ssm":
        layers = _unstack(params["layers"], cfg.n_layers)
        if use is not None:
            layers = [use.layer(lp, "layers") for lp in layers]
        x = _scan_mamba(x, layers, cfg, states=cache["ssm"],
                        convs=cache["conv"], mesh=mesh,
                        splits=None if splits is None else (splits["ssm"],
                                                            splits["conv"]))
    else:                                   # hybrid
        x = _hybrid(x, params, cfg, positions, cache, length, use, splits)
    x = L.rms_norm(x, top["final_norm"], cfg.norm_eps)
    logits, split = _lm_head(x, top["lm_head"], cfg, mesh)
    if split:
        logits = SH.gather_from_model(logits, mesh)
    return logits[:, 0], cache


def _cache_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _cache_leaves(tree[k])
    else:
        yield tree


def generate(params, cfg: ModelConfig, prompt: torch.Tensor,
             new_tokens: int, device="cuda") -> torch.Tensor:
    """Greedy decoding as ``examples/serve_decode.py`` runs it: the prompt
    [B, P] goes token by token through `decode_step`, then the argmax token
    is fed back; P + new_tokens − 1 steps. Returns the new tokens
    [B, new_tokens] (int32). The loop never waits on the card."""
    _no_decode(cfg)
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
