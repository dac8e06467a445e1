"""The sharded Track-A engine's process layout over ``torch.distributed`` —
the port of ``repro.launch.mesh``'s "data" axis (DESIGN.md §7, "Shard
layout" and "Multi-host mesh").

The reference runs one process over a D-device ``("data",)`` mesh and
``shard_map``s the round step over it. The port runs **one rank per
shard**: a world of D ranks is the D-device "data" mesh. Every rank runs
the same-seed host loop (draws, planning, batch gathers, accounting), holds
only its own segment of the client-state pool on its own device, runs its
own shard's rows of every chunk, and the ranks meet in two collectives per
round: the upload sum (`fixed_order_sum`) and the per-participant outputs
(`fetch_global`).

* `init_distributed` brings up the process group, from explicit arguments
  or the torchrun environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
  ``WORLD_SIZE``); idempotent. Explicit arguments that fail raise; with
  nothing to detect it returns ``False`` (single process).
* `make_data_group` is the shard layout: rank, world size, this rank's
  device and the group — a world of 1 when no process group is up.
* `fetch_global` all-gathers one tensor per rank into a list in rank order.
* `fixed_order_sum` adds the ranks' partial sums left to right in ascending
  rank order on every rank, so the bits do not depend on the backend's
  reduce tree.
* `spawn` starts a local world: one fresh process per rank running
  ``fn(rank, *args)``, joined within a time limit (each rank brings up its
  own group with `init_distributed`); ``torchrun`` does the same for a
  script.

Track B's pod meshes are `Mesh`: named axes (("pod",) "data", "model"),
one rank per mesh position in row-major rank order (the device order of
``jax.make_mesh``), and one process group per set of axes a collective
runs over. `make_mesh` builds one over the current world,
`make_local_mesh` the (1, 1) mesh of a world of 1 and
`make_production_mesh` the (16, 16) or (2, 16, 16) mesh of 256 or 512
ranks; `abstract_mesh` has the shape only (for the partition specs), and
`census_mesh` is one rank's abstract mesh whose collectives are recorded
in a `CollectiveCensus` instead of run (``launch.dryrun``'s census on
``meta`` tensors).
Every collective of a `Mesh` is an all-gather (`Mesh.all_gather_axis`),
a sum folded left in ascending rank order at all-reduce cost (an
all-to-all, each rank's fold of its block, an all-gather:
`Mesh.sum_axis`), an all-to-all of uneven blocks (`Mesh.exchange_axis`,
which moves pieces of a weight between ranks) or an all-reduce MAX
(`Mesh.max_axis`), so its bits do not depend on the backend's reduce
tree.

Nothing touches ``torch.distributed`` on import. ``shard_map_compat`` and
``host_local_array`` have no counterpart here (SPMD ranks take their
place).
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import time

import torch
import torch.distributed as dist

# a collective that waits longer than this raises instead of hanging: the
# ranks of one round step wait on each other only for the length of a
# round, so a rank that never arrives has fallen out of step
DEFAULT_TIMEOUT_S = 300.0
_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """One rank's view of the 1-D "data" layout: its ``rank`` in a world of
    ``world`` ranks (one shard each), its ``device``, and the process group
    (``None`` for a world of 1 without one)."""
    rank: int
    world: int
    device: torch.device
    group: object = None


def _default_backend(device=None) -> str:
    """NCCL for a rank on a card, gloo for one on the CPU; with no device
    named, NCCL when the process sees a card."""
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _init_method(address: str) -> str:
    """``tcp://host:port`` / ``file://path`` as given; a bare ``host:port``
    is TCP."""
    return address if "://" in address else f"tcp://{address}"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     device=None) -> bool:
    """Bring up ``torch.distributed`` for a multi-process "data" layout,
    idempotently. Returns True when the world has more than one rank.

    With explicit arguments (all three; ``coordinator_address`` is an
    init URL such as ``tcp://localhost:29500`` or ``file:///tmp/pg``, or a
    bare ``host:port``) a failure propagates: it is a misconfiguration.
    With none, the torchrun environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``) is used when it is complete; otherwise, or if
    that fails, the process stays single. ``backend`` defaults to the
    rank's ``device``: NCCL for ``cuda``, gloo for ``cpu`` (with no device
    named, NCCL when the process sees a card)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    timeout = datetime.timedelta(seconds=timeout_s)
    backend = backend or _default_backend(device)
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("init_distributed needs coordinator_address, "
                             "num_processes and process_id together")
        dist.init_process_group(backend, init_method=_init_method(
            coordinator_address), world_size=int(num_processes),
            rank=int(process_id), timeout=timeout)
        return dist.get_world_size() > 1
    if not dist.is_available() or any(k not in os.environ for k in _ENV):
        return False
    try:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    except (RuntimeError, ValueError):
        return False
    return dist.get_world_size() > 1


def rank_device(device, local_rank: int) -> torch.device:
    """A rank's device: ``cuda:{local_rank % cards}`` for ``"cuda"`` (so
    several ranks may share one card), the device as given otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device`` without making the host wait for the
    card: a blocking copy from pageable memory synchronizes the stream
    first, so onto a card the copy is staged in page-locked memory and
    enqueued behind the work already queued. Anything else is ``x.to``."""
    device = torch.device(device)
    if device.type != "cuda" or x.device.type != "cpu":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


def make_data_group(device="cuda") -> DataGroup:
    """The shard layout of this process: the process group's rank and world
    size when one is up, else a world of 1; the device from
    `rank_device` with ``LOCAL_RANK`` (default: the rank)."""
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        group = dist.group.WORLD
    else:
        rank, world, group = 0, 1, None
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(device, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return DataGroup(rank=rank, world=world, device=dev, group=group)


def fetch_global(x: torch.Tensor, layout: DataGroup | None) -> list:
    """Every rank's ``x`` (same shape and dtype on every rank), in rank
    order: an all-gather into a list. A world of 1 returns ``[x]``."""
    if layout is None or layout.world == 1:
        return [x]
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(layout.world)]
    dist.all_gather(out, x, group=layout.group)
    return out


def fixed_order_sum(partial: torch.Tensor,
                    layout: DataGroup | None) -> torch.Tensor:
    """Σ over ranks of ``partial``, folded left in ascending rank order
    (``((p0 + p1) + p2) + …``) on every rank, so every rank holds the same
    bits whatever tree the backend would reduce in. A world of 1 returns
    ``partial`` itself."""
    parts = fetch_global(partial, layout)
    if len(parts) == 1:
        return partial
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def spawn(fn, world: int, args: tuple = (), timeout_s: float = 600.0
          ) -> None:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes (start method
    ``spawn``, so each rank starts clean: no inherited CUDA context) and
    wait for all of them at most ``timeout_s`` seconds. A rank that raises
    or dies makes the others stop and raises here; past the time limit
    every rank is killed and TimeoutError is raised, so a rank that fell
    out of step fails the caller instead of hanging it."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish within "
                                   f"{timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


# ---------------------------------------------------------------------------
# Track B's pod meshes
# ---------------------------------------------------------------------------

def _fold(parts: list) -> torch.Tensor:
    """``((p0 + p1) + p2) + …``: the parts added left to right."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def axis_tuple(axes) -> tuple:
    """An axis name, a tuple of names or None (a spec entry, say) as a
    tuple of names."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a named mesh: the axis names and sizes, this
    rank's coordinate on each axis, its device and its global rank, and
    the process groups of `make_mesh` (keyed by the frozenset of the axes
    a group spans; a set whose ranks are the whole world uses the world's
    group, and a set of size 1 has none). ``abstract`` meshes have the
    shape only: their collectives raise, unless a ``census`` records
    them (`census_mesh`)."""
    axis_names: tuple
    sizes: tuple
    coords: tuple
    device: torch.device
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict)
    abstract: bool = False
    census: "CollectiveCensus | None" = None

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def axis_index(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)]

    def axis_size(self, name: str) -> int:
        return self.sizes[self.axis_names.index(name)]

    def live_axes(self, axes) -> tuple:
        """The axes of ``axes`` with more than one rank, in mesh order."""
        axes = axis_tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"no axis {a!r} in mesh {self.axis_names}")
        return tuple(a for a in self.axis_names
                     if a in axes and self.axis_size(a) > 1)

    def index_over(self, axes) -> int:
        """This rank's row-major index over ``axes`` (in the order given)."""
        idx = 0
        for a in axis_tuple(axes):
            idx = idx * self.axis_size(a) + self.axis_index(a)
        return idx

    def size_over(self, axes) -> int:
        return math.prod(self.axis_size(a) for a in axis_tuple(axes))

    def _gather(self, x: torch.Tensor, live: tuple) -> list:
        """Every rank's ``x`` over the live axes ``live`` (mesh order), in
        group rank order: one all-gather."""
        if self.abstract:
            # the card's allocations, no data: every part is a stand-in
            self._census().record("all-gather", live, self.size_over(live),
                                  x)
            return [torch.empty_like(x) for _ in range(self.size_over(live))]
        parts = [torch.empty_like(x) for _ in range(self.size_over(live))]
        dist.all_gather(parts, x, group=self.groups[frozenset(live)])
        return parts

    def _exchange(self, x: torch.Tensor, live: tuple) -> torch.Tensor:
        """One all-to-all over ``live``: ``x`` (1-D, a multiple of the
        group size n long) is cut into n blocks, block j goes to group
        rank j, and block j of the result came from group rank j."""
        if self.abstract:
            self._census().record("all-to-all", live, self.size_over(live),
                                  x)
            return torch.empty_like(x)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.groups[frozenset(live)])
        return out

    def _exchange_v(self, x: torch.Tensor, live: tuple, send: tuple,
                    recv: tuple) -> torch.Tensor:
        """One all-to-all over ``live`` with blocks of any length: ``x``
        (1-D, ``sum(send)`` long) is cut into blocks of ``send[j]``
        elements, block j going to group rank j; the result holds the
        ``recv[j]`` elements from group rank j, in group rank order."""
        out = x.new_empty(sum(recv))
        if self.abstract:
            me = self.index_over(live)
            self._census().record("all-to-all-v", live, len(send), x,
                                  moved=(sum(send) - send[me],
                                         sum(recv) - recv[me]),
                                  result=out)
            return out
        dist.all_to_all_single(out, x, list(recv), list(send),
                               group=self.groups[frozenset(live)])
        return out

    def _in_order(self, parts: list, axes, live: tuple) -> list:
        """``parts`` in group rank order (ascending in mesh order)
        reordered row-major over ``axes`` in the order given."""
        order = tuple(a for a in axis_tuple(axes) if a in live)
        if order == live:
            return parts
        ranked = list(itertools.product(*(range(self.axis_size(a))
                                          for a in live)))
        pos = {a: i for i, a in enumerate(live)}
        out = [None] * len(parts)
        for part, c in zip(parts, ranked):
            j = 0
            for a in order:
                j = j * self.axis_size(a) + c[pos[a]]
            out[j] = part
        return out

    def _parts(self, x: torch.Tensor, axes) -> list:
        """Every rank's ``x`` over ``axes``, ordered row-major over the
        axes in the order given (one part when they span one rank)."""
        live = self.live_axes(axes)
        if not live:
            return [x]
        return self._in_order(self._gather(x.contiguous(), live), axes, live)

    def all_gather_axis(self, x: torch.Tensor, axes, dim: int = 0
                        ) -> torch.Tensor:
        """The ranks' blocks of ``x`` over ``axes`` concatenated along
        ``dim`` (row-major over the axes in the order given)."""
        parts = self._parts(x, axes)
        return x if len(parts) == 1 else torch.cat(parts, dim=dim)

    def sum_axis(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Σ of ``x`` over the ranks of ``axes``, folded left in ascending
        rank order (row-major over the axes in the order given) on every
        rank, with every element's bits the same on every rank (``x``
        itself over one rank).

        At all-reduce cost: the flat ``x``, zero-padded to a multiple of
        the group size n, goes through one all-to-all (group rank j gets
        block j of every rank's), each rank folds its block's n parts in
        that order, and one all-gather brings the folded blocks back —
        2(n − 1)/n of ``x``'s bytes received, where gathering every rank's
        whole ``x`` receives (n − 1)·b. Each element is the same fold of
        the same parts as that gather's. A tensor of fewer than n
        elements takes the gather."""
        live = self.live_axes(axes)
        if not live:
            return x
        n = self.size_over(live)
        if x.numel() < n:
            return _fold(self._parts(x, axes))
        flat = x.contiguous().reshape(-1)
        blk = -(-flat.numel() // n)
        if blk * n != flat.numel():
            flat = torch.cat([flat, flat.new_zeros(blk * n - flat.numel())])
        mine = _fold(self._in_order(list(self._exchange(flat, live).split(
            blk)), axes, live))
        out = torch.cat(self._gather(mine.contiguous(), live))
        return out[:x.numel()].reshape(x.shape)

    def exchange_axis(self, x: torch.Tensor, axes, send, recv
                      ) -> torch.Tensor:
        """An all-to-all over ``axes`` with uneven blocks (`_exchange_v`):
        ``send[j]`` elements of the 1-D ``x`` to group rank j and
        ``recv[j]`` from it, the group ranks row-major over the live axes
        in mesh order. Over one rank ``x`` itself."""
        live = self.live_axes(axes)
        if not live:
            return x
        return self._exchange_v(x.contiguous(), live, tuple(send),
                                tuple(recv))

    def max_axis(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The elementwise max of ``x`` over the ranks of ``axes`` (an
        all-reduce MAX, exact in any order; ``x`` itself over one rank)."""
        live = self.live_axes(axes)
        if not live:
            return x
        out = x.detach().clone()
        if self.abstract:
            self._census().record("all-reduce", live, self.size_over(live),
                                  x)
            return out
        dist.all_reduce(out, op=dist.ReduceOp.MAX,
                        group=self.groups[frozenset(live)])
        return out

    def barrier(self) -> None:
        """Wait for every rank of the mesh (nothing over one rank)."""
        if self.size > 1:
            if self.abstract:
                self._census()          # a recorded census moves no data
                return
            dist.barrier()

    def _census(self) -> "CollectiveCensus":
        if self.census is None:
            raise RuntimeError("an abstract mesh has no process groups")
        return self.census

    def group(self, axes) -> "AxisGroup":
        return AxisGroup(self, axis_tuple(axes))


@dataclasses.dataclass(frozen=True, eq=False)
class AxisGroup:
    """The ranks of ``mesh`` that differ only along ``axes``: the shards of
    one leaf, for the compression operators' ``group=``."""
    mesh: Mesh
    axes: tuple

    @property
    def size(self) -> int:
        return self.mesh.size_over(self.axes)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.sum_axis(x, self.axes)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.max_axis(x, self.axes)


def _check_shape(shape, names) -> tuple:
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} do not "
                         "match")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} has an empty axis")
    return shape, names


def _coords(rank: int, shape: tuple) -> tuple:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


class CollectiveCensus:
    """The collectives one rank of a `census_mesh` would run, in order:
    per call its op (``all-gather`` for `Mesh._gather`, under every
    gather and the second phase of a sum; ``all-to-all`` for
    `Mesh._exchange`, a sum's first phase; ``all-to-all-v`` for
    `Mesh._exchange_v`, blocks of any length; ``all-reduce`` for
    `Mesh.max_axis`), the live axes, the group size n, and the bytes of
    the rank's own operand b. ``result_bytes`` is the op's result (n·b
    for a gather, b otherwise), as the reference's HLO census counts it.
    ``sent`` and ``received`` are what an exchange of the operands moves:
    b out and the other ranks' (n − 1)·b in for a gather and the MAX;
    (n − 1)/n·b each way for an all-to-all, whose own block stays (gloo's
    own algorithms move other amounts on the wire); the blocks to and
    from the other ranks for an all-to-all-v."""

    MAX_OPS = 200                     # ops listed per kind, as the reference
    OPS = ("all-gather", "all-to-all", "all-to-all-v", "all-reduce")

    def __init__(self):
        self.calls = []

    def record(self, op: str, axes: tuple, group: int, x: torch.Tensor,
               moved: tuple | None = None,
               result: torch.Tensor | None = None) -> None:
        """One call on operand ``x``; ``moved`` (elements sent, received)
        and ``result`` for an all-to-all-v, whose blocks are uneven."""
        b = x.numel() * x.element_size()
        if moved is not None:
            sent, received = (m * x.element_size() for m in moved)
            out = result.numel() * result.element_size()
        else:
            received = (b * (group - 1) // group if op == "all-to-all"
                        else b * (group - 1))
            sent = received if op == "all-to-all" else b
            out = b * group if op == "all-gather" else b
        self.calls.append({"op": op, "axes": list(axes), "group": group,
                           "bytes": b, "result_bytes": out, "sent": sent,
                           "received": received})

    def summary(self) -> dict:
        """{op: {count, result_bytes, sent, received, ops[≤200]}}, the
        rank's totals, and ``received_by_axes``: the bytes received over
        each set of live axes ("data", "model", "data+model", …)."""
        out = {op: {"count": 0, "result_bytes": 0, "sent": 0,
                    "received": 0, "ops": []} for op in self.OPS}
        by_axes: dict = {}
        for c in self.calls:
            rec = out[c["op"]]
            rec["count"] += 1
            rec["result_bytes"] += c["result_bytes"]
            rec["sent"] += c["sent"]
            rec["received"] += c["received"]
            key = "+".join(c["axes"])
            by_axes[key] = by_axes.get(key, 0) + c["received"]
            if len(rec["ops"]) < self.MAX_OPS:
                rec["ops"].append({"bytes": c["result_bytes"],
                                   "group": c["group"],
                                   "axes": c["axes"]})
        out["total"] = {k: sum(out[op][k] for op in self.OPS)
                        for k in ("count", "sent", "received")}
        out["received_by_axes"] = by_axes
        return out


def abstract_mesh(shape, names) -> Mesh:
    """A mesh of ``shape`` with no world behind it (coordinates 0, the
    ``meta`` device): for the partition specs, as
    ``jax.sharding.AbstractMesh``."""
    shape, names = _check_shape(shape, names)
    return Mesh(axis_names=names, sizes=shape, coords=(0,) * len(shape),
                device=torch.device("meta"), abstract=True)


def census_mesh(shape, names, rank: int = 0) -> Mesh:
    """Rank ``rank``'s view of the mesh ``shape`` with no world behind it,
    on the ``meta`` device, whose collectives are recorded in its
    ``census`` (a `CollectiveCensus`) instead of run: `Mesh._parts`
    returns ``empty_like`` stand-ins of every rank's part (the
    allocations the card's gather makes), `Mesh.max_axis` a clone, and
    `Mesh.barrier` does nothing."""
    shape, names = _check_shape(shape, names)
    if not 0 <= rank < math.prod(shape):
        raise ValueError(f"rank {rank} is not in a {shape} mesh")
    return Mesh(axis_names=names, sizes=shape, coords=_coords(rank, shape),
                device=torch.device("meta"), rank=rank, abstract=True,
                census=CollectiveCensus())


def make_mesh(shape, names, device="cuda") -> Mesh:
    """The mesh ``shape`` over the current world (a world of 1 when no
    process group is up), one rank per position in row-major rank order,
    with a process group for every set of axes spanning more than one
    rank (every rank creates every group, in one order). Raises
    ``ValueError`` when the world size is not ``prod(shape)``."""
    shape, names = _check_shape(shape, names)
    up = dist.is_available() and dist.is_initialized()
    rank, world = (dist.get_rank(), dist.get_world_size()) if up else (0, 1)
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh over {names} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    groups = {}
    live = [i for i, s in enumerate(shape) if s > 1]
    for r in range(1, len(live) + 1):
        for sub in itertools.combinations(live, r):
            key = frozenset(names[i] for i in sub)
            if math.prod(shape[i] for i in sub) == world:
                groups[key] = dist.group.WORLD
                continue
            rest = [i for i in range(len(shape)) if i not in sub]
            mine = None
            for fixed in itertools.product(*(range(shape[i]) for i in rest)):
                members = [g for g in range(world)
                           if all(_coords(g, shape)[i] == c
                                  for i, c in zip(rest, fixed))]
                pg = dist.new_group(members)
                if rank in members:
                    mine = pg
            groups[key] = mine
    return Mesh(axis_names=names, sizes=shape, coords=_coords(rank, shape),
                device=dev, rank=rank, groups=groups)


def make_local_mesh(device="cuda") -> Mesh:
    """The (1, 1) ("data", "model") mesh of a world of 1."""
    return make_mesh((1, 1), ("data", "model"), device)


def make_production_mesh(multi_pod: bool = False, device="cuda") -> Mesh:
    """16 × 16 = 256 ranks per pod; ``multi_pod`` adds a "pod" axis of 2
    (512 ranks). Raises ``ValueError`` naming the rank count in a world of
    any other size: it never shrinks to fit."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, names, device)
