"""What GSPMD does for the reference inside a pod, made explicit for the
ranks of a `launch.mesh.Mesh`.

A leaf's spec (`models.model.param_specs`) is a tuple with one entry per
dim: None, an axis name or a tuple of names. A rank holds the block of
every leaf that its coordinates on those axes select (row-major over a
tuple's names), stored at rest.

* `shard_leaf` / `gather_leaf` (and `shard_tree` / `gather_tree`) move a
  whole leaf in and out of that layout; the gather is an all-gather over
  the spec's axes, concatenated in rank order.
* `GatherParam` (through `use_param`) is FSDP's gather on use: forward the
  all-gather over the axes asked for; backward the fixed-order sum of the
  gradient over the ranks that computed different terms from the leaf (the
  batch axes of the pod, and "model" for a leaf the model ranks use
  differently), then this rank's block. `use_block` is the same for a
  tensor-parallel leaf: gathered over its spec's axes but "model", so the
  rank keeps its "model" block (columns of ``wq``, rows of ``wo``, …).
* `regroup_model` turns a rank's contiguous "model" block of a leaf made
  of segments end to end (Mamba2's ``w_zx``, [z | x]) into its block of
  every segment, moving the pieces between ranks in one all-to-all.
* `copy_to` / `reduce_from` are Megatron's two operators for a region whose
  ranks each compute a part: forward identity / backward sum, and forward
  sum / backward identity (`copy_to_model`, `reduce_from_model` over
  "model"); `gather_from_model` is its third, the ranks' blocks of an
  activation concatenated along the last dim, backward the rank's slice.

Every sum is `Mesh.sum_axis`'s left fold in ascending rank order (at
all-reduce cost), so the bits do not depend on the backend.
"""
from __future__ import annotations

import itertools

import torch

from repro_torch.launch.mesh import Mesh, axis_tuple


def spec_axes(spec) -> tuple:
    """Every axis name of a spec, in dim order."""
    return tuple(a for e in (spec or ()) for a in axis_tuple(e))


def _check(mesh) -> Mesh:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"want a repro_torch.launch.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    return mesh


def shard_leaf(full: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a view where no dim is
    split; split dims must divide)."""
    out = full
    for dim, entry in enumerate(spec or ()):
        axes = axis_tuple(entry)
        n = mesh.size_over(axes)
        if n == 1:
            continue
        size = out.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"divide over {axes} ({n} ranks)")
        blk = size // n
        out = out.narrow(dim, mesh.index_over(axes) * blk, blk)
    return out


def gather_leaf(local: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from every rank's block: an all-gather over each
    split dim's axes, in rank order."""
    out = local
    for dim, entry in enumerate(spec or ()):
        out = mesh.all_gather_axis(out, axis_tuple(entry), dim)
    return out


def _map2(fn, tree, specs):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map2(fn, tree[k], specs[k]) for k in sorted(tree)}
    return fn(tree, specs)


def _own_block(full: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """`shard_leaf` as a tensor of its own: a block cut from ``full`` is
    copied even where the view is contiguous already (a block along the
    first dim is), so it holds no storage of the whole leaf."""
    out = shard_leaf(full, spec, mesh)
    return out.contiguous() if out is full else out.clone(
        memory_format=torch.contiguous_format)


def shard_tree(tree, specs, mesh: Mesh):
    """`shard_leaf` of every leaf (copies, so the whole tree can go)."""
    return _map2(lambda a, s: _own_block(a, s, mesh), tree, specs)


def gather_tree(tree, specs, mesh: Mesh):
    return _map2(lambda a, s: gather_leaf(a, s, mesh), tree, specs)


class GatherParam(torch.autograd.Function):
    """Forward: the leaf gathered over ``spec``'s axes. Backward: the
    gradient summed over ``sum_axes`` in a fixed order, then this rank's
    block under ``spec``."""

    @staticmethod
    def forward(ctx, local, spec, mesh, sum_axes):
        ctx.spec, ctx.mesh, ctx.sum_axes = spec, mesh, sum_axes
        out = gather_leaf(local, spec, mesh)
        return out.view_as(out) if out is local else out

    @staticmethod
    def backward(ctx, g):
        return _sum_to_block(g, ctx.spec, ctx.mesh, ctx.sum_axes), None, \
            None, None


def _sum_to_block(g: torch.Tensor, spec, mesh: Mesh, sum_axes
                  ) -> torch.Tensor:
    """This rank's block under ``spec`` of Σ over ``sum_axes`` of ``g``:
    the block of the dims whose axes are not summed first (it is the same
    for every rank summed with), then one fixed-order sum per block of the
    summed dims, each kept by the ranks that own it — a reduce-scatter
    made of sums, which holds one block at a time instead of the whole
    tensor. The bits are those of
    ``shard_leaf(mesh.sum_axis(g, sum_axes), spec, mesh)``."""
    summed = set(mesh.live_axes(sum_axes))
    spec = tuple(spec or ())
    split = [bool(set(axis_tuple(e)) & summed) for e in spec]
    g = shard_leaf(g, tuple(None if s else e for e, s in zip(spec, split)),
                   mesh)
    dims = [d for d, s in enumerate(split)
            if s and mesh.size_over(axis_tuple(spec[d])) > 1]
    if not dims:
        out = mesh.sum_axis(g, sum_axes)
        return out if out is g else out.contiguous()
    sizes = [mesh.size_over(axis_tuple(spec[d])) for d in dims]
    mine = tuple(mesh.index_over(axis_tuple(spec[d])) for d in dims)
    out = None
    for blk in itertools.product(*(range(n) for n in sizes)):
        part = g
        for d, n, i in zip(dims, sizes, blk):
            w = part.shape[d] // n
            part = part.narrow(d, i * w, w)
        total = mesh.sum_axis(part.contiguous(), sum_axes)
        if blk == mine:
            out = total
    return out


def use_param(local: torch.Tensor, spec, mesh: Mesh, sum_axes=()
              ) -> torch.Tensor:
    """A leaf as the computation uses it: gathered over ``spec``'s axes
    (``()`` keeps the block), its gradient summed over ``sum_axes``."""
    return GatherParam.apply(local, tuple(spec or ()), _check(mesh),
                             axis_tuple(sum_axes))


def without_model(spec) -> tuple:
    """``spec`` with "model" taken out of every entry (the dims a rank's
    "model" block keeps whole)."""
    def drop(entry):
        axes = tuple(a for a in axis_tuple(entry) if a != "model")
        return None if not axes else axes[0] if len(axes) == 1 else axes
    return tuple(drop(e) for e in (spec or ()))


def use_block(local: torch.Tensor, spec, mesh: Mesh, sum_axes=()
              ) -> torch.Tensor:
    """A tensor-parallel leaf as the computation uses it: its "model"
    block, gathered over ``spec``'s other axes; its gradient, which the
    rank computes for that block alone, summed over ``sum_axes`` (the
    pod's batch axes) and cut to the stored block."""
    return use_param(local, without_model(spec), mesh, sum_axes)


def _move_pieces(t: torch.Tensor, have: list, want: list, mesh: Mesh
                 ) -> torch.Tensor:
    """``t`` [P, m]: this rank's pieces. ``have[j]`` / ``want[j]`` list
    the ids of the pieces "model" rank j holds / wants, in order; each id
    is held by one rank and wanted by one. One all-to-all over "model"
    (`Mesh.exchange_axis`) sends every piece to the rank that wants it;
    returns [len(want[me]), m] in that order."""
    me, m = mesh.axis_index("model"), t.shape[1]
    out_ids = [[k for k in w if k in have[me]] for w in want]
    in_ids = [[k for k in want[me] if k in h] for h in have]
    send = _rows(t, [have[me].index(k) for ids in out_ids for k in ids])
    got = mesh.exchange_axis(send.reshape(-1), "model",
                             [len(i) * m for i in out_ids],
                             [len(i) * m for i in in_ids]).view(-1, m)
    arrived = [k for ids in in_ids for k in ids]
    return _rows(got, [arrived.index(k) for k in want[me]])


def _rows(t: torch.Tensor, order: list) -> torch.Tensor:
    """Rows ``order`` of ``t`` (slices: no index tensor to copy to the
    device)."""
    return torch.cat([t[i:i + 1] for i in order])


def _regroup(x: torch.Tensor, groups: int, have: list, want: list,
             mesh: Mesh) -> torch.Tensor:
    """`_move_pieces` of the ``groups`` equal pieces of ``x``'s last dim."""
    lead, w = x.shape[:-1], x.shape[-1] // groups
    pieces = x.reshape(*lead, groups, w).movedim(-2, 0).reshape(groups, -1)
    out = _move_pieces(pieces, have, want, mesh)
    return out.reshape(groups, *lead, w).movedim(0, -2).reshape(x.shape)


class _Regroup(torch.autograd.Function):
    """Forward: the rank's stored block, pieces r·G … r·G + G − 1 of the
    n·G pieces of the whole last dim, becomes its piece of every segment
    (ids g·n + r). Backward: each piece's gradient goes back to the rank
    that stores it."""

    @staticmethod
    def forward(ctx, local, groups, mesh):
        n = mesh.axis_size("model")
        ctx.groups, ctx.mesh = groups, mesh
        ctx.stored = [list(range(j * groups, (j + 1) * groups))
                      for j in range(n)]
        ctx.used = [list(range(j, n * groups, n)) for j in range(n)]
        return _regroup(local, groups, ctx.stored, ctx.used, mesh)

    @staticmethod
    def backward(ctx, g):
        return _regroup(g, ctx.groups, ctx.used, ctx.stored,
                        ctx.mesh), None, None


def regroup_model(local: torch.Tensor, groups: int, mesh: Mesh
                  ) -> torch.Tensor:
    """A leaf whose last dim is ``groups`` equal segments laid end to end
    (Mamba2's ``w_zx``: [z | x]) and whose spec splits that dim over
    "model" in contiguous blocks, as the rank's block of every segment,
    concatenated ([z_r | x_r], where on two ranks rank 0 stores all of z
    and rank 1 all of x). Each segment must divide over "model". The
    pieces move in one all-to-all over "model"; a rank receives at most
    its own block's size. The gradient goes back to the stored layout the
    same way (exact: nothing is summed). Over one rank the block itself."""
    if mesh.axis_size("model") == 1:
        return local
    return _Regroup.apply(local, groups, _check(mesh))


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.sum_axis(g, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        out = mesh.sum_axis(x, axes)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes, ctx.width = mesh, axes, x.shape[-1]
        out = mesh.all_gather_axis(x, axes, -1)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index_over(ctx.mesh.live_axes(ctx.axes))
        return g.narrow(-1, i * ctx.width, ctx.width), None, None


def copy_to(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """Identity forward; backward sums the gradient over ``axes`` (the
    input of a region whose ranks each compute a part from it)."""
    return _CopyTo.apply(x, _check(mesh), axis_tuple(axes))


def reduce_from(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """Forward sums ``x`` over ``axes``; backward passes the gradient
    (the output of such a region)."""
    return _ReduceFrom.apply(x, _check(mesh), axis_tuple(axes))


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return copy_to(x, mesh, "model")


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return reduce_from(x, mesh, "model")


def gather_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The "model" ranks' blocks of ``x`` concatenated along its last dim
    in rank order (every rank holds the whole); backward keeps the rank's
    slice of the gradient, which is right where every rank's use of the
    whole is the same (put `copy_to_model` after it where it is not)."""
    return _GatherLast.apply(x, _check(mesh), ("model",))
