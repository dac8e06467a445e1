"""Per-rank census of every (arch × shape × mesh) cell — the port's
counterpart of ``repro.launch.dryrun``.

The reference lowers and compiles each cell and reads XLA's
``memory_analysis``, ``cost_analysis`` and the collectives of the
optimized HLO. Eager PyTorch has no compiler output to read, so the port
runs one rank's real step (`fl.distributed.make_train_step`,
`make_prefill`, `make_serve_step`) on ``meta`` tensors under a
`launch.mesh.census_mesh`: the card's path with the data left out. The
collectives are recorded instead of run, each kernel wrapper takes its
``meta`` branch (`kernels.meta`), and a dispatch mode watches every op:

* **memory** — ``argument_size_in_bytes`` (the rank's state or params,
  cache and batch), ``output_size_in_bytes``, ``alias_size_in_bytes``
  (outputs that share an argument's storage), ``temp_size_in_bytes``
  (peak live bytes less arguments and outputs) and ``peak_bytes``, the
  largest live total as ``torch.cuda.max_memory_allocated`` counts it on
  the card: each new storage once, rounded up to the caching allocator's
  `ALLOC_ROUND`, dropped when the storage dies, over the arguments and
  the `RESIDENT` allocations meta cannot see;
* **flops** — the formulas of ``torch.utils.flop_counter`` (the ones
  ``FlopCounterMode`` applies: matmuls, convolutions, attention; no
  elementwise ops, which XLA's count has);
* **bytes_accessed** — the input plus output bytes of every dispatched op
  that is not a view or an allocation, with each kernel launch counted
  once at its own bytes;
* **collectives** — the reference's ``{op: {count, result_bytes,
  ops[≤200]}}`` from the mesh's `CollectiveCensus`, with the bytes a rank
  sends and receives;
* **kernels** — launches and bytes per kernel.

`rank_bytes` is the spec arithmetic alone (no step): a rank's bytes of
parameters, train state and decode cache, leaf by leaf, from
`models.model.param_specs`, `fl.distributed.state_specs` and
`launch.specs.cache_specs`.

Stand-ins, where the card's step would depend on data:

* the decode kernel's bytes count every row at the cache's full length
  (its lengths are data; the launch plan, and so the allocations, are
  not);
* nothing else: the step functions read no value on the host (their loss
  is a tensor; ``launch.train``'s per-step print is the launcher's), MoE
  capacities and every shape follow from the config and the cell.

Usage (CPU only; no card is needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1p5_4b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \
      --multi-pod

Writes one JSON per cell to ``experiments/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

import repro_torch.configs as configs
from repro_torch.fl import distributed as D
from repro_torch.kernels import meta as KMETA
from repro_torch.launch import mesh as MESH
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as S
from repro_torch.models import model as M

SHAPES = S.SHAPES
cell_supported = S.cell_supported

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
PRODUCTION = {False: ("pod16x16", (16, 16), ("data", "model")),
              True: ("pod2x16x16", (2, 16, 16), ("pod", "data", "model"))}
# the CUDA caching allocator hands out blocks in multiples of 512 bytes
ALLOC_ROUND = 512
# what the card holds that meta cannot see: one cuBLAS workspace per
# handle (PyTorch's default CUBLAS_WORKSPACE_CONFIG on sm_90, :4096:8, is
# 32 MiB, allocated through the caching allocator); a train step has two
# handles, the caller's thread's and autograd's device thread's
CUBLAS_WORKSPACE_BYTES = 32 * 2 ** 20
RESIDENT = {"train": {"cublas_workspaces": 2 * CUBLAS_WORKSPACE_BYTES},
            "prefill": {"cublas_workspaces": CUBLAS_WORKSPACE_BYTES},
            "decode": {"cublas_workspaces": CUBLAS_WORKSPACE_BYTES}}
_META = torch.device("meta")
_ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty",
           "new_empty_strided", "_unsafe_view", "detach", "alias",
           "lift_fresh"}


def _round(nbytes: int) -> int:
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND if nbytes else 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None) -> list:
    """The tensors of an op's arguments or results (lists, tuples and
    dicts of them), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    return out


def _leaves(tree) -> list:
    """Tensor leaves of nested dicts, TrainStates and tuples."""
    if isinstance(tree, D.TrainState):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _sig(x):
    """A hashable key of an op argument's metadata (shape, strides and
    dtype for a tensor: all a meta op's outputs can depend on)."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in sorted(x.items()))
    return x


class _Tally(TorchDispatchMode):
    """Every op of the step: its flops (``torch.utils.flop_counter``'s
    formulas, the ones ``FlopCounterMode`` applies), its bytes accessed
    and the live bytes, from its outputs' storages: a storage not seen
    before (nor an argument's) adds its rounded bytes once and drops them
    when it dies.

    A meta op still costs its shape function (0.1–0.2 ms for many, which
    PyTorch writes in Python), and a long prefill runs ~10^6 of them, so
    with ``memo`` the outputs of a functional op are made anew from the
    shapes, strides and dtypes it gave for the same argument metadata
    before: fresh storages, as the op's own. An op whose schema or first
    run shows an output aliasing an input always runs."""

    def __init__(self, arguments: list, memo: bool = True):
        super().__init__()
        self.known = {_key(t) for t in arguments}
        self.sizes: dict = {}
        self.memo = {} if memo else None
        self.pure: dict = {}
        self.live = self.peak = self.bytes_accessed = self.ops = 0
        self.flops = 0

    def _free(self, key) -> None:
        self.live -= self.sizes.pop(key, 0)

    def _pure(self, func) -> bool:
        pure = self.pure.get(func)
        if pure is None:
            sch = func._schema
            pure = self.pure[func] = not (
                func.is_view or sch.is_mutable
                or func.overloadpacket.__name__ in _ALLOCS
                or any(r.alias_info is not None for r in sch.returns))
        return pure

    def _run(self, func, args, kwargs):
        """(the op's result, its tensors)."""
        if self.memo is None or not self._pure(func):
            out = func(*args, **kwargs)
            return out, _tensors(out)
        try:
            key = (func, _sig(args), _sig(kwargs))
            hit = self.memo.get(key)
        except TypeError:               # an unhashable argument
            out = func(*args, **kwargs)
            return out, _tensors(out)
        if hit is not None:
            leaves, spec = hit
            leaves = [torch.empty_strided(x[0], x[1], dtype=x[2],
                                          device=_META)
                      if isinstance(x, tuple) else x for x in leaves]
            return (pytree.tree_unflatten(leaves, spec),
                    [t for t in leaves if isinstance(t, torch.Tensor)])
        out = func(*args, **kwargs)
        outs = _tensors(out)
        ins = {_key(t) for t in _tensors((args, kwargs))}
        if any(_key(t) in ins for t in outs):
            self.pure[func] = False
            return out, outs
        leaves, spec = pytree.tree_flatten(out)
        self.memo[key] = ([(t.shape, t.stride(), t.dtype)
                           if isinstance(t, torch.Tensor) else t
                           for t in leaves], spec)
        return out, outs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out, outs = self._run(func, args, kwargs)
        self.ops += 1
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not (func.is_view or packet.__name__ in _ALLOCS):
            self.bytes_accessed += sum(_nbytes(t) for t in
                                       _tensors((args, kwargs)) + outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.known or key in self.sizes:
                continue
            self.sizes[key] = nb = _round(st.nbytes())
            self.live += nb
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)
        return out


# ---------------------------------------------------------------------------
# Per-rank bytes from the specs
# ---------------------------------------------------------------------------

def _shard_bytes(whole, specs, mesh) -> dict:
    """{path: bytes of this rank's block} of a tree of meta leaves."""
    out = {}

    def visit(t, sp, path):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                visit(t[k], sp[k], path + (k,))
            return
        out["/".join(path)] = _nbytes(SH.shard_leaf(t, sp, mesh))

    visit(whole, specs, ())
    return out


def _meta_like(tree, lead=()):
    return D.tree_map(lambda a: torch.empty(tuple(lead) + tuple(a.shape),
                                            dtype=a.dtype, device=_META),
                      tree)


def state_struct(cfg, dcfg, mesh) -> D.TrainState:
    """The whole `TrainState` of ``init_state`` as meta leaves, every pod's
    buffers stacked as the specs lay them out."""
    params = M.init_abstract(cfg)
    n_pods = D._n_pods(mesh)
    prev = None
    if dcfg.simulate_download:
        prev = (D.tree_map(lambda a: {
            "q": torch.empty((n_pods,) + tuple(a.shape), dtype=torch.int8,
                             device=_META),
            "s": torch.empty((n_pods,), dtype=torch.float32, device=_META)},
            params) if dcfg.prev_int8 else _meta_like(params, (n_pods,)))
    scalar = (lambda dt: torch.empty((), dtype=dt, device=_META))
    return D.TrainState(
        params=params, prev_params=prev,
        ef=_meta_like(params, (n_pods,)) if dcfg.use_error_feedback
        else None,
        step=scalar(torch.int32), theta_d=scalar(torch.float32),
        theta_u=scalar(torch.float32))


def _cell(shape) -> dict:
    return dict(SHAPES[shape]) if isinstance(shape, str) else dict(shape)


def rank_bytes(cfg, dcfg, mesh, shape) -> dict:
    """This rank's bytes of the parameters, the train state (``dcfg``;
    train cells) and the decode cache (decode cells), leaf by leaf
    (``{path: bytes}``, ``/``-joined key paths; the state's under its
    field names) with their totals. ``shape`` is a `SHAPES` name or a
    dict with ``kind``, ``seq`` and ``batch``; ``mesh`` any mesh with
    coordinates (`launch.mesh.abstract_mesh`, `census_mesh`)."""
    cell = _cell(shape)
    out = {"params": _shard_bytes(M.init_abstract(cfg),
                                  M.param_specs(cfg, mesh), mesh),
           "state": None, "cache": None}
    if cell["kind"] == "train":
        whole, specs = state_struct(cfg, dcfg, mesh), D.state_specs(
            cfg, dcfg, mesh)
        out["state"] = {}
        for f in dataclasses.fields(whole):
            t = getattr(whole, f.name)
            if t is None:
                continue
            if isinstance(t, torch.Tensor):
                out["state"][f.name] = _nbytes(SH.shard_leaf(
                    t, getattr(specs, f.name), mesh))
                continue
            for p, b in _shard_bytes(t, getattr(specs, f.name),
                                     mesh).items():
                out["state"][f"{f.name}/{p}"] = b
    elif cell["kind"] == "decode":
        out["cache"] = _shard_bytes(
            S.cache_struct(cfg, cell["batch"], cell["seq"]),
            S.cache_specs(cfg, mesh, cell["batch"], cell["seq"]), mesh)
    out["totals"] = {k: (None if v is None else sum(v.values()))
                     for k, v in out.items()}
    return out


# ---------------------------------------------------------------------------
# One rank's step on meta
# ---------------------------------------------------------------------------

def _rows(tree: dict, axes, mesh) -> dict:
    """This rank's block of rows over ``axes`` when they divide the batch,
    else every row (the serving steps' per-rank contract)."""
    b = next(iter(tree.values())).shape[0]
    n = mesh.size_over(axes)
    if b % n:
        return tree
    r, i = b // n, mesh.index_over(axes)
    return {k: v[i * r:(i + 1) * r].contiguous() for k, v in tree.items()}


def _local_params(cfg, mesh):
    return SH.shard_tree(M.init_abstract(cfg), M.param_specs(cfg, mesh),
                         mesh)


def _step_inputs(cfg, dcfg, mesh, cell):
    """(step function, its arguments) of one rank, on meta. The step's
    partition specs are built here, before it runs: `models.model`
    builds them once per mesh from ``init_abstract``'s meta tensors of
    the whole model, which hold no memory on the card but would count as
    the step's allocations here."""
    kind, seq, batch = cell["kind"], cell["seq"], cell["batch"]
    M._cached_specs(cfg, mesh)
    if kind == "train":
        state = D.shard_state(state_struct(cfg, dcfg, mesh), cfg, dcfg,
                              mesh)
        return (D.make_train_step(cfg, dcfg, mesh, _META),
                (state, S.batch_struct(cfg, batch, seq)))
    params = _local_params(cfg, mesh)
    if kind == "prefill":
        rows = S.batch_struct(cfg, batch, seq)
        rows.pop("labels")
        return (D.make_prefill(cfg, mesh, _META),
                (params, _rows(rows, S._axes(mesh, cfg), mesh)))
    whole, _, tok, _, length, _ = S.decode_inputs(cfg, mesh, batch, seq)
    cache = S.shard_cache(whole, cfg, mesh, batch, seq)
    rows = _rows({"tokens": tok, "length": length}, S._axes(mesh), mesh)
    return (D.make_serve_step(cfg, mesh, _META),
            (params, cache, rows["tokens"], rows["length"]))


def census(cfg, shape, mesh, dcfg=None, memo: bool = True) -> dict:
    """Run one step of rank ``mesh.rank`` on meta under ``mesh`` (a
    `launch.mesh.census_mesh`) and count it: memory, flops, bytes
    accessed, collectives and kernel launches (the module docstring says
    what each is). ``shape`` is a `SHAPES` name or a dict with ``kind``,
    ``seq`` and ``batch``; ``dcfg`` the train step's `DistConfig`;
    ``memo=False`` runs every op's shape function (`_Tally`)."""
    cell = _cell(shape)
    dcfg = dcfg or D.DistConfig()
    fn, args = _step_inputs(cfg, dcfg, mesh, cell)
    arguments = _leaves(args)
    mesh.census.calls.clear()
    kernels: dict = {}

    def launch(name, read, written):
        k = kernels.setdefault(name, {"launches": 0, "read": 0,
                                      "written": 0})
        k["launches"] += 1
        k["read"] += read
        k["written"] += written

    t0 = time.perf_counter()
    with KMETA.recording(launch), _Tally(arguments, memo) as tally:
        out = fn(*args)
        outputs = _leaves(out)
    trace_s = time.perf_counter() - t0
    arg_keys = {_key(t) for t in arguments}
    out_bytes = sum(_nbytes(t) for t in outputs)
    alias = sum(_nbytes(t) for t in outputs if _key(t) in arg_keys)
    new_out = sum(_round(b) for b in {
        _key(t): t.untyped_storage().nbytes() for t in outputs
        if _key(t) not in arg_keys}.values())
    arg_alloc = sum(_round(b) for b in {
        _key(t): t.untyped_storage().nbytes() for t in arguments}.values())
    resident = RESIDENT[cell["kind"]]
    kernel_bytes = sum(k["read"] + k["written"] for k in kernels.values())
    return {
        "cell": cell, "mesh_shape": dict(mesh.shape), "rank": mesh.rank,
        "coords": list(mesh.coords), "trace_s": trace_s, "ops": tally.ops,
        "memory": {
            "argument_size_in_bytes": sum(_nbytes(t) for t in arguments),
            "output_size_in_bytes": out_bytes,
            "alias_size_in_bytes": alias,
            "temp_size_in_bytes": max(tally.peak - new_out, 0),
            "peak_bytes": sum(resident.values()) + arg_alloc + tally.peak,
            "resident": resident},
        "flops": float(tally.flops),
        "bytes_accessed": float(tally.bytes_accessed + kernel_bytes),
        "collectives": mesh.census.summary(),
        "kernels": kernels,
        "rank_bytes": rank_bytes(cfg, dcfg, mesh, cell)["totals"],
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, tag: str = "",
             rank: int = 0, **variant) -> dict:
    """The census of one production cell (the reference's ``run_cell``):
    a record with ``status`` ok, skipped (with the reference's ``why``)
    or error (with the exception and its trace)."""
    cfg = configs.get(arch)
    ok, why = S.cell_supported(cfg, shape_name)
    mesh_name, shape, names = PRODUCTION[multi_pod]
    rec = {"arch": cfg.name, "shape": shape_name, "mesh": mesh_name,
           "rank": rank, "tag": tag, "variant": variant,
           "status": "skipped", "why": why}
    if not ok:
        return rec
    try:
        cfg = dataclasses.replace(
            cfg, local_iters=variant.get("local_iters", 1),
            dp_only=variant.get("dp_only", False))
        dcfg = D.DistConfig(
            simulate_download=variant.get("simulate_download", True),
            use_error_feedback=variant.get("error_feedback", False),
            compressed_collective=variant.get("compressed_collective",
                                              False),
            prev_int8=variant.get("prev_int8", False))
        mesh = MESH.census_mesh(shape, names, rank)
        rec.update(status="ok", **census(cfg, shape_name, mesh, dcfg))
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-4000:]})
    return rec


def collective_census(mesh) -> dict:
    """The recorded collectives of a `census_mesh` (the reference's
    ``collective_census`` reads them from the HLO)."""
    return mesh.census.summary()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all", choices=["all"] + list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rank", type=int, default=0,
                    help="the mesh position counted (row-major)")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--no-download-sim", action="store_true")
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--compressed-collective", action="store_true")
    ap.add_argument("--local-iters", type=int, default=1)
    ap.add_argument("--dp-only", action="store_true")
    ap.add_argument("--prev-int8", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = configs.ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    variant = dict(simulate_download=not args.no_download_sim,
                   error_feedback=args.error_feedback,
                   compressed_collective=args.compressed_collective,
                   local_iters=args.local_iters, dp_only=args.dp_only,
                   prev_int8=args.prev_int8)
    mesh_name = PRODUCTION[args.multi_pod][0]
    for arch in archs:
        cfg_name = configs.get(arch).name
        for shape_name in shapes:
            rank = "" if args.rank == 0 else f"__r{args.rank}"
            fname = OUT_DIR / (f"{cfg_name}__{shape_name}__{mesh_name}__"
                               f"{args.tag}{rank}.json")
            if fname.exists() and not args.force:
                print(f"[skip-cached] {fname.name}")
                continue
            print(f"[dryrun] {cfg_name} × {shape_name} × {mesh_name} ...",
                  flush=True)
            rec = run_cell(arch, shape_name, args.multi_pod, args.tag,
                           args.rank, **variant)
            fname.write_text(json.dumps(rec, indent=1))
            if rec["status"] == "ok":
                m = rec["memory"]
                extra = (f"trace={rec['trace_s']:.1f}s "
                         f"peak={m['peak_bytes'] / 1e9:.2f}GB "
                         f"args={m['argument_size_in_bytes'] / 1e9:.2f}GB "
                         f"flops={rec['flops']:.3e} coll_recv="
                         f"{rec['collectives']['total']['received'] / 1e9:.2f}"
                         "GB")
            else:
                extra = rec.get("why") or rec.get("error", "")
            print(f"  -> {rec['status']}: {extra}", flush=True)


if __name__ == "__main__":
    main()
