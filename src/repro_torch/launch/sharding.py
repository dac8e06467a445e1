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
  differently), then this rank's block.
* `copy_to` / `reduce_from` are Megatron's two operators for a region whose
  ranks each compute a part: forward identity / backward sum, and forward
  sum / backward identity (`copy_to_model`, `reduce_from_model` over
  "model").

Every sum is `Mesh.sum_axis`'s all-gather and left fold in ascending rank
order, so the bits do not depend on the backend.
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
    made of all-gathers, which holds one block of every rank at a time
    instead of every rank's whole tensor. The bits are those of
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
