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

Nothing touches ``torch.distributed`` on import. ``shard_map_compat`` and
``host_local_array`` have no counterpart here (SPMD ranks take their
place); the pod meshes of Track B (``make_production_mesh``,
``make_local_mesh``) are not ported yet (ROADMAP queue 1 item 13).
"""
from __future__ import annotations

import dataclasses
import datetime
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
