"""Token-choice top-k MoE, the port of ``repro.models.moe`` without a mesh.

Dispatch is capacity-bounded and sort-based (static shapes): assignments
are sorted by expert id (stable), ranked within their expert, and written
into an [E, C] slot buffer of token ids; compute is two batched matmuls.
An assignment past its expert's capacity C is dropped.

Both data movements that sum are folded in a fixed order, so a step
repeats bit for bit on the card (where ``index_add_`` and the backward of
an indexed read accumulate with atomics in no fixed order):

* the combine adds each token's weighted expert outputs in ascending slot
  order, starting from 0 (the order of XLA's CPU scatter-add in the
  reference's ``y.at[buf_tok].add``), through the inverse map
  token × k → slot: one gather, then a sum over k in order;
* the dispatch ``x[buf_tok]`` has a backward (`_Dispatch`) that folds each
  token's slot gradients the same way.

Routing takes the top k of the router's softmax with a stable descending
sort, so exact ties go to the lower expert id as in ``jax.lax.top_k``.

Under a `launch.mesh.Mesh` (the reference's ``shard_map`` branch) the
experts are split over "model" and their weights FSDP-sharded over
"data": each rank gathers its ``E / n_model`` experts over "data", routes
its own tokens with the capacity of its token count, runs the shared
expert on its slice of the hidden width, and one `sharding.
reduce_from_model` sums the model ranks' parts; the input enters through
`sharding.copy_to_model`. The router is replicated but each model rank
computes other terms from it, so its gradient is summed over "model" too.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as L

# when a list, `moe_ffn` appends one (ids [T, K], dropped [T]) per call:
# each token's experts and whether it lost an assignment to capacity (read
# by checks that compare two paths through the experts: a decode step and
# a forward have other token counts, so other capacities, and an ulp can
# move a token on a near-tie of its router probabilities)
record_routes: list | None = None


def _capacity(n_tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    return max(8, int(math.ceil(n_tokens * top_k / n_experts * cf)))


def _router_probs(x2d, router):
    logits = torch.matmul(x2d.to(torch.float32), router.to(torch.float32))
    return torch.softmax(logits, dim=-1)


def _top_k(probs, k: int):
    """(values, ids) of the k largest per row; ties to the lower index."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def route(x2d: torch.Tensor, router: torch.Tensor, top_k: int):
    """Softmax-normalized top-k routing. x2d [T, d]; router [d, E].
    Returns (ids [T, K] int32, weights [T, K] f32 summing to 1)."""
    wts, ids = _top_k(_router_probs(x2d, router), top_k)
    wts = wts / torch.clamp(torch.sum(wts, -1, keepdim=True), min=1e-9)
    return ids.to(torch.int32), wts


def aux_load_loss(x2d: torch.Tensor, router: torch.Tensor,
                  top_k: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (beyond-paper extra)."""
    probs = _router_probs(x2d, router)
    e = probs.shape[-1]
    _, ids = _top_k(probs, top_k)
    frac = torch.mean(F.one_hot(ids, e).to(torch.float32), dim=(0, 1))
    return e * torch.sum(frac * torch.mean(probs, dim=0))


def _fold_slots(terms: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Σ_k terms[:, k] over valid[:, k], added left to right from 0.

    terms [T, K, d]; valid [T, K]."""
    y = torch.zeros_like(terms[:, 0])
    for j in range(terms.shape[1]):
        y = torch.where(valid[:, j, None], y + terms[:, j], y)
    return y


class _Dispatch(torch.autograd.Function):
    """``x_pad[buf_tok]`` (x_pad = x with a zero row appended) whose
    backward sums each token's slot gradients in ascending slot order
    (``slots`` [T, K] ascending per row, ``valid`` marking kept ones)."""

    @staticmethod
    def forward(ctx, x, buf_tok, slots, valid):
        ctx.save_for_backward(slots, valid)
        x_pad = torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)
        return x_pad[buf_tok]

    @staticmethod
    def backward(ctx, g):
        slots, valid = ctx.saved_tensors
        g_pad = torch.cat([g, g.new_zeros((1, g.shape[1]))], dim=0)
        terms = g_pad[slots.reshape(-1)].reshape(slots.shape + g.shape[1:])
        return _fold_slots(terms, valid), None, None, None


def routed_experts_local(x2d, ids, wts, w_gate, w_up, w_down, e_start: int,
                         n_experts_total: int, capacity: int,
                         drops: list | None = None) -> torch.Tensor:
    """The routed-expert output for the expert slice [e_start, e_start +
    E_loc). x2d [T, d]; ids/wts [T, K]; w_* [E_loc, d, f] / [E_loc, f, d].
    With ``drops`` a list, appends the [T] bool mask of tokens that lost an
    assignment to capacity."""
    t, d = x2d.shape
    k = ids.shape[1]
    e_loc = w_gate.shape[0]
    c = capacity
    dev = x2d.device

    local = ids.to(torch.int64) - e_start                  # [T, K]
    valid = (local >= 0) & (local < e_loc)
    lid = torch.where(valid, local, e_loc).reshape(-1)     # sentinel group
    order = torch.argsort(lid, stable=True)                # [T*K]
    sorted_ids = lid[order]
    group_start = torch.searchsorted(
        sorted_ids, torch.arange(e_loc + 1, device=dev))
    pos = torch.arange(t * k, device=dev) - group_start[sorted_ids]
    ok = (pos < c) & (sorted_ids < e_loc)
    slot = torch.where(ok, sorted_ids * c + pos, e_loc * c)  # overflow slot

    tok_of_assign = (torch.arange(t * k, device=dev) // k)[order]
    buf_tok = torch.full((e_loc * c + 1,), t, dtype=torch.int64, device=dev)
    buf_tok[slot] = tok_of_assign          # the overflow slot is cut below
    buf_tok = buf_tok[:-1]
    # inverse map: the slot of each (token, k), then ascending per token
    slot_tk = torch.empty_like(slot).scatter_(0, order, slot).reshape(t, k)
    if drops is not None:
        drops.append((valid & (slot_tk == e_loc * c)).any(dim=1))
    slot_tk, perm = torch.sort(slot_tk, dim=1, stable=True)
    kept = slot_tk < e_loc * c

    xe = _Dispatch.apply(x2d, buf_tok, slot_tk, kept).reshape(e_loc, c, d)
    g = torch.bmm(xe, w_gate)
    u = torch.bmm(xe, w_up)
    ye = torch.bmm(F.silu(g) * u, w_down).reshape(e_loc * c, d)

    ye_pad = torch.cat([ye, ye.new_zeros((1, d))], dim=0).to(torch.float32)
    terms = ye_pad[slot_tk.reshape(-1)].reshape(t, k, d)
    terms = terms * torch.gather(wts, 1, perm)[..., None]
    return _fold_slots(terms, kept).to(x2d.dtype)


def moe_ffn(x: torch.Tensor, p: dict, cfg, mesh=None) -> torch.Tensor:
    """x [B, S, d] → routed-experts output. Without a mesh, on one device
    (shared experts handled by the caller); under ``mesh``, ``x`` is this
    rank's tokens, ``p`` its shards, and the output includes the shared
    experts (`_moe_ffn_mesh`)."""
    if mesh is not None:
        return _moe_ffn_mesh(x, p, cfg, mesh)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    x2d = x.reshape(b * s, d)
    ids, wts = route(x2d, p["router"], k)
    cap = _capacity(b * s, k, e, cfg.capacity_factor)
    drops = [] if record_routes is not None else None
    y = routed_experts_local(x2d, ids, wts, p["w_gate"], p["w_up"],
                             p["w_down"], 0, e, cap, drops)
    if drops is not None:
        record_routes.append((ids, drops[0]))
    return y.reshape(b, s, d)


def _moe_ffn_mesh(x, p, cfg, mesh) -> torch.Tensor:
    """The expert-parallel branch: ``p`` holds this rank's routed experts
    [E/n_model, d(/n_data), f] / [E/n_model, f, d(/n_data)], the router and
    the shared experts' f-slices ([d, f/n_model] / [f/n_model, d])."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh or "
                        f"None, got {type(mesh).__name__}")
    if "model" not in mesh.axis_names:
        raise ValueError(f"MoE under a mesh needs a 'model' axis, got "
                         f"{mesh.axis_names}")
    if cfg.dp_only:
        raise ValueError("the dp_only policy is for TP-free (non-MoE) archs")
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    n_model = mesh.axis_size("model")
    e_m = e // n_model
    if e_m * n_model != e:
        raise ValueError(f"{e} experts do not divide over model={n_model}")
    dp = tuple(a for a in mesh.axis_names if a not in ("pod", "model"))
    # the reference's t_loc = (B // n_dp)·s: x holds this rank's rows
    cap = _capacity(b * s, k, e, cfg.capacity_factor)
    n_data = mesh.shape.get("data", 1)
    d_shard = "data" if "data" in mesh.axis_names and d % n_data == 0 \
        else None
    wg = SH.use_param(p["w_gate"], (None, d_shard, None), mesh, dp)
    wu = SH.use_param(p["w_up"], (None, d_shard, None), mesh, dp)
    wd = SH.use_param(p["w_down"], (None, None, d_shard), mesh, dp)
    router = SH.use_param(p["router"], (), mesh, dp + ("model",))
    xl = SH.copy_to_model(x, mesh)
    x2d = xl.reshape(b * s, d)
    ids, wts = route(x2d, router, k)
    drops = [] if record_routes is not None else None
    y = routed_experts_local(x2d, ids, wts, wg, wu, wd,
                             mesh.axis_index("model") * e_m, e, cap, drops)
    if drops is not None:
        record_routes.append((ids, drops[0]))
    y = y.reshape(b, s, d)
    if "shared" in p:
        # the shared experts on this rank's slice of their hidden width,
        # folded into the same sum over "model" as the routed output
        sh = p["shared"]
        f_all = cfg.d_ff_expert * cfg.n_shared_experts
        if sh["w_gate"].shape[1] * n_model != f_all:
            raise ValueError(f"the shared experts' width {f_all} does not "
                             f"divide over model={n_model}")
        sg, su, sd = (SH.use_param(sh[n], (), mesh, dp)
                      for n in ("w_gate", "w_up", "w_down"))
        y = y + L.swiglu(xl, sg, su, sd)
    return SH.reduce_from_model(y, mesh)


def init_moe_params(make: L.ParamMaker, cfg, dtype, ffn_init) -> dict:
    """The routed experts ([E, d, f] / [E, f, d]), the f32 router [d, E]
    and, with shared experts, their SwiGLU (``ffn_init(make, d_ff)``)."""
    e, f, d = cfg.n_experts, cfg.d_ff_expert, cfg.d_model
    p = {
        "router": make.normal((d, e), d ** -0.5, torch.float32),
        "w_gate": make.normal((e, d, f), d ** -0.5, dtype),
        "w_up": make.normal((e, d, f), d ** -0.5, dtype),
        "w_down": make.normal((e, f, d), f ** -0.5, dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = ffn_init(make, cfg.d_ff_expert * cfg.n_shared_experts)
    return p
