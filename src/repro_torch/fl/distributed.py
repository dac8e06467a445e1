"""Track B: datacenter cohort-mode Caesar — the port of
``repro.fl.distributed``.

Pods are clients: each runs τ local SGD steps from a *recovered* initial
model (the staleness-aware download deviation), derives its local delta,
sparsifies it (top-k upload with optional error feedback), and the server
applies the mean of the pods' compressed deltas. Without a mesh the cohort
is one pod on one device and the compression deviation is still applied,
so convergence semantics match Track A.

Under a ("pod",) "data", "model" `launch.mesh.Mesh` (the reference's
``shard_map`` over "pod", GSPMD within a pod) every rank holds its shards
of each leaf as `models.model.param_specs` says, and its own pod's stale
model and residual. A rank trains on the rows ``[pod block][micro
i][data block]`` of the global batch (`models.model.loss_fn` gathers each
leaf on use over its spec's axes but "model" where the layer is
tensor-parallel there, and sums the gradient over the pod's data ranks);
each leaf's
compression stays whole-leaf (``group=`` of the compression operators:
thresholds from histograms summed over the leaf's shards, the kernels on
each shard); the pods' wire-format deltas are summed over "pod" in a fixed
order and divided by the pod count, and the server step runs on each
shard. On the (1, 1) local mesh the step is bit-identical to
``mesh=None``. `shard_state` / `gather_state` move a whole state in and
out; `make_pods_step` composes the same step pod by pod on one device.

Every parameter leaf goes through the Track-A compression operators
(`repro_torch.core.compression.fused_hybrid_roundtrip` and `fused_topk`)
as one row [1, numel]: per leaf and step, two magnitude histograms
(download threshold, upload top-k), one hybrid compress and one recover —
the hand-written CUDA kernels on the card, their plain twins on the CPU.

State is a `TrainState` of nested dicts of tensors; per-pod buffers
(``prev_params``, ``ef``) carry a leading ``[1]`` pod axis. The reference's
order of casts is kept: f32 into the kernels, the recovered download cast
to the stale model's dtype, the delta in the model dtype, the server step
in f32 and cast back. Work goes leaf by leaf and frees each leaf's
temporaries before the next, so a 4B-parameter bf16 model's step holds a
few whole-model trees at a time, not the reference's whole-tree
intermediates.

Serving (`make_serve_step`, `make_prefill`) runs without a mesh or under
one: each rank then holds its parameter shards, its shards of the cache as
``launch.specs.cache_specs`` lays them out (`launch.specs.shard_cache`) and
its rows (`models.model.decode_step`'s per-rank contract).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import compression as C
from repro_torch.launch import sharding as SH
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DistConfig:
    theta_d: float = 0.3          # this round's download ratio (from plan)
    theta_u: float = 0.35         # this round's upload ratio (from plan)
    server_lr: float = 1.0
    local_lr: float = 1e-2
    use_error_feedback: bool = False
    simulate_download: bool = True   # keep prev-params buffer + recovery path
    compressed_collective: bool = False  # bf16 wire format of the delta
    prev_int8: bool = False          # int8 stale-model buffer (absmax-scaled;
                                     # recovery reference only)


@dataclasses.dataclass
class TrainState:
    params: Any                   # global model {name: tensor}
    prev_params: Optional[Any]    # [n_pods, ...] cohort-local stale models
    ef: Optional[Any]             # [n_pods, ...] error-feedback buffers
    step: torch.Tensor            # 0-d int32
    theta_d: torch.Tensor         # 0-d f32, this round's ratios
    theta_u: torch.Tensor


# ---------------------------------------------------------------------------
# Trees: nested dicts of tensors (an int8 leaf is a {"q", "s"} dict). A
# None is an empty subtree, as in the reference's pytrees (Llama-4-Scout's
# ``dense_layers``): it holds no leaf and every map keeps it as None.
# ---------------------------------------------------------------------------

def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def tree_map(fn: Callable, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of nested dicts (sorted keys, as the
    reference's pytrees), with matching ``rest`` trees; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in sorted(tree)}
    return fn(tree, *rest)


def _paths(tree, prefix=()) -> list:
    """Key paths of the leaves of nested dicts, in sorted-key order (a None
    value, such as a `_skeleton`'s leaf, counts as a leaf here)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        prefix + (k,))]
    return [prefix]


def _leaf_paths(tree) -> list:
    """`_paths` of the tensor leaves: without the empty (None) subtrees."""
    return [p for p in _paths(tree) if _get(tree, p) is not None]


def _skeleton(tree):
    """``tree``'s dicts with None at every leaf (and at its None
    subtrees), for `_set` to fill in."""
    return tree_map(lambda _: None, tree)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_leaves(tree) -> list:
    return [_get(tree, p) for p in _leaf_paths(tree)]


def _set(tree: dict, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _pop(tree: dict, path):
    """Remove and return a leaf (so its memory can go as soon as the caller
    drops it)."""
    for k in path[:-1]:
        tree = tree[k]
    return tree.pop(path[-1])


def _quantize_leaf(a: torch.Tensor, group=None) -> dict:
    """Absmax int8 of a leaf; with ``group``, of this rank's shard against
    the whole leaf's absmax."""
    af = a.to(torch.float32)
    amax = torch.amax(torch.abs(af))
    if group is not None:
        amax = group.max(amax)
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(af / scale), -127, 127)
    return {"q": q.to(torch.int8), "s": scale.to(torch.float32)}


def _dequantize_leaf(d: dict, dtype) -> torch.Tensor:
    return (d["q"].to(torch.float32) * d["s"]).to(dtype)


def quantize_tree(tree, groups=None):
    return tree_map(_quantize_leaf, tree,
                    _skeleton(tree) if groups is None else groups)


def dequantize_tree(qtree, like):
    return tree_map(lambda d, lk: _dequantize_leaf(d, lk.dtype), qtree,
                    like, is_leaf=_is_qleaf)


def _scalar(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype).to(device)


def _n_pods(mesh) -> int:
    return mesh.shape["pod"] if (mesh is not None
                                 and "pod" in mesh.axis_names) else 1


def state_specs(cfg: ModelConfig, dcfg: DistConfig, mesh) -> TrainState:
    """The spec of every leaf of a `TrainState` on ``mesh`` (the
    reference's): the params' `param_specs`, the per-pod buffers with a
    leading "pod" entry (the int8 stale model's scale is ``("pod",)``)."""
    pspecs = M.param_specs(cfg, mesh)
    pod = "pod" if (mesh is not None and "pod" in mesh.axis_names) else None

    def podded(sp):
        return (pod,) + tuple(sp)

    if dcfg.simulate_download:
        if dcfg.prev_int8:
            prev_specs = tree_map(lambda sp: {"q": podded(sp), "s": (pod,)},
                                  pspecs)
        else:
            prev_specs = tree_map(podded, pspecs)
    else:
        prev_specs = None
    return TrainState(
        params=pspecs, prev_params=prev_specs,
        ef=tree_map(podded, pspecs) if dcfg.use_error_feedback else None,
        step=(), theta_d=(), theta_u=())


def _leaf_groups(cfg: ModelConfig, mesh):
    """Per leaf, the `launch.mesh.AxisGroup` of the axes that shard it."""
    return tree_map(lambda sp: mesh.group(SH.spec_axes(sp)),
                    M.param_specs(cfg, mesh))


def _fields(state: TrainState):
    return [(f.name, getattr(state, f.name))
            for f in dataclasses.fields(state)]


def shard_state(state: TrainState, cfg: ModelConfig, dcfg: DistConfig,
                mesh) -> TrainState:
    """This rank's part of a whole ``TrainState`` (every pod's buffers,
    e.g. restored from a checkpoint): its shards, and its pod's buffers
    with the leading axis of 1."""
    specs = state_specs(cfg, dcfg, M.check_mesh(mesh))
    return TrainState(**{k: (None if v is None else SH.shard_tree(
        v, getattr(specs, k), mesh)) for k, v in _fields(state)})


def gather_state(state: TrainState, cfg: ModelConfig, dcfg: DistConfig,
                 mesh) -> TrainState:
    """The whole ``TrainState`` from every rank's part (a collective: every
    rank calls it and every rank gets the whole tree)."""
    specs = state_specs(cfg, dcfg, M.check_mesh(mesh))
    return TrainState(**{k: (None if v is None else SH.gather_tree(
        v, getattr(specs, k), mesh)) for k, v in _fields(state)})


def init_state(params, dcfg: DistConfig, mesh=None, cfg=None) -> TrainState:
    """The cohort state: stale model = the params (or their int8 form),
    residuals zero, each with a leading pod axis — [1] (one pod, or under
    ``mesh`` this rank's own pod). Under ``mesh`` (``cfg`` names the
    specs) ``params`` is the whole tree and the rank keeps its shards."""
    groups = None
    if mesh is not None:
        M.check_mesh(mesh)
        if cfg is None:
            raise ValueError("init_state under a mesh needs the model "
                             "config for the partition specs")
        params = SH.shard_tree(params, M.param_specs(cfg, mesh), mesh)
        groups = _leaf_groups(cfg, mesh)
    dev = tree_leaves(params)[0].device
    if dcfg.simulate_download:
        prev = quantize_tree(params, groups) if dcfg.prev_int8 else params
        prev = tree_map(lambda a: a[None].clone(), prev)
    else:
        prev = None
    return TrainState(
        params=params,
        prev_params=prev,
        ef=(tree_map(lambda a: torch.zeros((1,) + tuple(a.shape),
                                           dtype=a.dtype, device=a.device),
                     params) if dcfg.use_error_feedback else None),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        theta_d=_scalar(dcfg.theta_d, torch.float32, dev),
        theta_u=_scalar(dcfg.theta_u, torch.float32, dev),
    )


def _to_tensor_tree(tree, dev):
    if tree is None:
        return None
    return tree_map(lambda a: M._to_tensor(a, dev), tree)


def state_from_reference(state, device="cuda") -> TrainState:
    """A reference ``TrainState`` (numpy or jax leaves, e.g. restored from
    its checkpoint) as the port's, leaf for leaf in the same dtypes."""
    dev = M.resolve_device(device)
    return TrainState(
        params=_to_tensor_tree(state.params, dev),
        prev_params=_to_tensor_tree(state.prev_params, dev),
        ef=_to_tensor_tree(state.ef, dev),
        step=M._to_tensor(np.asarray(state.step, np.int32), dev),
        theta_d=M._to_tensor(np.asarray(state.theta_d, np.float32), dev),
        theta_u=M._to_tensor(np.asarray(state.theta_u, np.float32), dev))


# ---------------------------------------------------------------------------
# Per-leaf compression through the Track-A fused operators
# ---------------------------------------------------------------------------

def _leaf_hybrid_roundtrip(x, local, ratio, group=None):
    rec, _ = C.fused_hybrid_roundtrip(x, local, ratio, group)
    return rec.to(local.dtype)


def _leaf_upload(d, e, ratio, wire_dtype=None, group=None):
    """(wire-format sparse delta, new residual or None) of one leaf. With a
    residual, EF sees exactly what the wire carries: the top-k loss AND the
    wire cast's rounding."""
    corrected = d if e is None else d + e.to(d.dtype)
    sparse, _ = C.fused_topk(corrected, ratio, group)
    wire = sparse.to(wire_dtype) if wire_dtype is not None else sparse
    if e is None:
        return wire, None
    return wire, (corrected - wire.to(corrected.dtype)).to(corrected.dtype)


def tree_download_recover(params, prev, ratio, groups=None):
    return tree_map(
        lambda g, lk, gr: _leaf_hybrid_roundtrip(g, lk, ratio, gr), params,
        prev, _skeleton(params) if groups is None else groups)


def tree_upload_compress(delta, ef, ratio, wire_dtype=None):
    """Returns (sparse_delta_in_wire_format, new_ef). ``wire_dtype`` (bf16
    for ``compressed_collective``) is applied BEFORE the error-feedback
    residual is computed, so EF corrects the wire cast's rounding too."""
    if ef is None:
        ef = tree_map(lambda _: None, delta)
    out = tree_map(lambda d, e: _leaf_upload(d, e, ratio, wire_dtype),
                   delta, ef)
    wire = tree_map(lambda o: o[0], out)
    new_ef = tree_map(lambda o: o[1], out)
    return wire, (None if tree_leaves(new_ef)[0] is None else new_ef)


# ---------------------------------------------------------------------------
# One cohort round and the train step
# ---------------------------------------------------------------------------

def _data_rows(mb: dict, cfg: ModelConfig, mesh) -> dict:
    """This rank's block of a micro-batch's rows over the pod's batch
    axes (row-major over them)."""
    dp = M.dp_axes(cfg, mesh, ("pod",))
    n = mesh.size_over(dp)
    rows = next(iter(mb.values())).shape[0]
    if rows % n:
        raise ValueError(f"a micro-batch of {rows} rows does not divide "
                         f"over the pod's {n} batch ranks {dp}")
    j, r = mesh.index_over(dp), rows // n
    return {k: v[j * r:(j + 1) * r] for k, v in mb.items()}


def _sgd_steps(w_init, batch, cfg: ModelConfig, dcfg: DistConfig, device,
               mesh=None):
    """τ local SGD steps over microbatch slices of ``batch`` (the pod's
    rows; under ``mesh`` each micro-batch's block of this rank); each
    update ``(p − lr·g)`` is cast to the param dtype. Returns (w_fin, [τ]
    losses)."""
    tau = max(cfg.local_iters, 1)
    paths = _leaf_paths(w_init)
    p = w_init
    losses = []
    for i in range(tau):
        mb = {k: v[i * (v.shape[0] // tau):(i + 1) * (v.shape[0] // tau)]
              for k, v in batch.items()}
        if mesh is not None:
            mb = _data_rows(mb, cfg, mesh)
        leaves = [_get(p, q).detach().requires_grad_(True) for q in paths]
        tree = _skeleton(w_init)
        for q, leaf in zip(paths, leaves):
            _set(tree, q, leaf)
        with torch.enable_grad():
            loss = M.loss_fn(tree, mb, cfg, device, mesh)
            # a leaf the loss does not read (the encoder's token
            # embedding) has a zero gradient, as jax.grad gives
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        del tree
        newp = _skeleton(w_init)
        grads = list(grads)
        for j, (q, a) in enumerate(zip(paths, leaves)):
            g, grads[j] = grads[j], None     # each gradient goes once used
            if g is None:
                g = torch.zeros_like(a)
            _set(newp, q, (a.detach() - dcfg.local_lr * g).to(a.dtype))
            del g
        del leaves, grads
        p = newp
        losses.append(loss.detach())
    return p, torch.stack(losses)


def _cohort_round(params, prev, ef, batch, theta_d, theta_u,
                  cfg: ModelConfig, dcfg: DistConfig, device, mesh=None,
                  groups=None):
    """(sparse upload, new stale model, new residual, mean loss) of one
    pod, leaves without the pod axis. Under ``mesh`` the leaves are this
    rank's shards and ``groups`` (`_leaf_groups`) their shard groups."""
    # (1) download: recover a precise initial model from the stale copy
    if dcfg.simulate_download and prev is not None:
        local_ref = (dequantize_tree(prev, params) if dcfg.prev_int8
                     else prev)
        w_init = tree_download_recover(params, local_ref, theta_d, groups)
        del local_ref
    else:
        w_init = params
    # (2) τ local SGD steps
    w_fin, losses = _sgd_steps(w_init, batch, cfg, dcfg, device, mesh)
    # (3) local delta in the model dtype, (4) top-k upload (+EF), leaf by
    # leaf so the recovered download and each delta go as soon as used
    wire_dtype = torch.bfloat16 if dcfg.compressed_collective else None
    own = w_init is not params
    sparse = _skeleton(w_fin)
    new_ef = _skeleton(w_fin) if ef is not None else None
    for q in _leaf_paths(w_fin):
        a = _pop(w_init, q) if own else _get(w_init, q)
        b = _get(w_fin, q)
        d = (a - b).to(a.dtype)
        wire, e = _leaf_upload(d, None if ef is None else _get(ef, q),
                               theta_u, wire_dtype,
                               None if groups is None else _get(groups, q))
        del a, d
        _set(sparse, q, wire)
        if new_ef is not None:
            _set(new_ef, q, e)
    new_prev = quantize_tree(w_fin, groups) if dcfg.prev_int8 else w_fin
    return sparse, new_prev, new_ef, torch.mean(losses)


def _pod_mean(x, n_pods: int, fold) -> torch.Tensor:
    """``fold(x)`` (the pods' Σ) / n_pods in its dtype, the reference's
    ``pmean``: a true division by a tensor on its device."""
    s = fold(x)
    return s / torch.full((), n_pods, dtype=s.dtype, device=s.device)


def _server_step(params, agg, server_lr: float, combine=None):
    """(p − server_lr·agg) in f32, cast back, leaf by leaf (``agg`` is
    emptied as it goes; ``combine`` maps each of its leaves first)."""
    new_params = _skeleton(params)
    for q in _leaf_paths(params):
        p = _get(params, q)
        d = _pop(agg, q)
        if combine is not None:
            d = combine(d)
        _set(new_params, q, (p.to(torch.float32) - server_lr
                             * d.to(torch.float32)).to(p.dtype))
        del d
    return new_params


def _pod_rows(batch: dict, n_pods: int, pod: int) -> dict:
    rows = next(iter(batch.values())).shape[0]
    if rows % n_pods:
        raise ValueError(f"a batch of {rows} rows does not divide over "
                         f"{n_pods} pods")
    r = rows // n_pods
    return {k: v[pod * r:(pod + 1) * r] for k, v in batch.items()}


def _sq(t):
    return None if t is None else tree_map(lambda a: a[0], t)


def _ex(t):
    return None if t is None else tree_map(lambda a: a[None], t)


def make_train_step(cfg: ModelConfig, dcfg: DistConfig, mesh=None,
                    device="cuda"):
    """Builds ``train_step(state, batch) -> (new_state, {"loss"})``: one
    Caesar round on ``device`` (default the card; it raises without one).
    Without a mesh, of the single pod; under ``mesh`` (a
    `launch.mesh.Mesh` on ``device``'s type), of this rank's part of the
    pod mesh: ``state`` is its part (`init_state` / `shard_state`) and
    ``batch`` the global batch, the same on every rank."""
    dev = M.resolve_device(device)
    groups, n_pods, pod = None, 1, 0
    if mesh is not None:
        M.check_mesh(mesh, dev)
        dev = mesh.device
        groups = _leaf_groups(cfg, mesh)
        n_pods = _n_pods(mesh)
        pod = mesh.axis_index("pod") if "pod" in mesh.axis_names else 0

    def pods(x):
        return mesh.sum_axis(x, "pod")

    def train_step(state: TrainState, batch):
        if mesh is not None:
            batch = _pod_rows(batch, n_pods, pod)
        sparse, w_fin, new_ef, loss = _cohort_round(
            state.params, _sq(state.prev_params), _sq(state.ef), batch,
            state.theta_d, state.theta_u, cfg, dcfg, dev, mesh, groups)
        combine = None
        if mesh is not None and "pod" in mesh.axis_names:
            # (5) the pods' compressed deltas cross the "pod" axis
            def combine(d):
                return _pod_mean(d, n_pods, pods)
            loss = _pod_mean(loss, n_pods, pods)
        # (6) server update in f32, cast back to the param dtype
        new_params = _server_step(state.params, sparse, dcfg.server_lr,
                                  combine)
        new_state = TrainState(
            params=new_params,
            prev_params=_ex(w_fin) if dcfg.simulate_download else None,
            ef=_ex(new_ef),
            step=state.step + 1,
            theta_d=state.theta_d, theta_u=state.theta_u)
        return new_state, {"loss": loss}

    return train_step


def make_pods_step(cfg: ModelConfig, dcfg: DistConfig, n_pods: int,
                   device="cuda"):
    """The pod mesh's step composed without a mesh, pod after pod on one
    device: what the reference's ``shard_map`` over "pod" computes by
    construction. ``state`` is a whole state with [n_pods] buffers; pod p
    runs `_cohort_round` on its block of the batch's rows, the pods'
    wire-format deltas are summed in pod order and divided by n_pods, and
    the server step follows. Within a pod nothing is sharded, so a MoE
    layer's capacity is that of the pod's micro-batch (a mesh's is that of
    each data rank's rows)."""
    dev = M.resolve_device(device)

    def pick(t, p):
        return None if t is None else tree_map(lambda a: a[p], t)

    def train_step(state: TrainState, batch):
        outs = []
        for p in range(n_pods):
            outs.append(_cohort_round(
                state.params, pick(state.prev_params, p),
                pick(state.ef, p), _pod_rows(batch, n_pods, p),
                state.theta_d, state.theta_u, cfg, dcfg, dev))

        def fold(parts):
            acc = parts[0]
            for x in parts[1:]:
                acc = acc + x
            return acc

        sparse = tree_map(lambda *ds: _pod_mean(ds, n_pods, fold),
                          *(o[0] for o in outs))
        stack = (lambda *xs: torch.stack(xs))
        new_state = TrainState(
            params=_server_step(state.params, sparse, dcfg.server_lr),
            prev_params=(tree_map(stack, *(o[1] for o in outs))
                         if dcfg.simulate_download else None),
            ef=(None if outs[0][2] is None
                else tree_map(stack, *(o[2] for o in outs))),
            step=state.step + 1,
            theta_d=state.theta_d, theta_u=state.theta_u)
        loss = _pod_mean([o[3] for o in outs], n_pods, fold)
        return new_state, {"loss": loss}

    return train_step


# ---------------------------------------------------------------------------
# Serving steps (no Caesar on the serving path)
# ---------------------------------------------------------------------------

def make_serve_step(cfg: ModelConfig, mesh=None, device="cuda"):
    """``serve_step(params, cache, tokens, length) -> (logits, cache)``:
    `models.model.decode_step` under ``mesh`` (its per-rank contract: this
    rank's parameter shards, its `ShardedCache`, its rows)."""
    if mesh is not None:
        M.check_mesh(mesh)

    def serve_step(params, cache, tokens, length):
        return M.decode_step(params, cache, {"tokens": tokens}, length, cfg,
                             device, mesh)
    return serve_step


def make_prefill(cfg: ModelConfig, mesh=None, device="cuda"):
    """``prefill_step(params, batch) -> last-position logits``:
    `models.model.prefill` under ``mesh`` (this rank's shards and rows)."""
    if mesh is not None:
        M.check_mesh(mesh)

    def prefill_step(params, batch):
        return M.prefill(params, batch, cfg, device, mesh)
    return prefill_step
