"""Track A: the faithful multi-client FL simulator (paper Algorithm 1) on
PyTorch — the public surface of the port's layered round engine, a facade
over its sibling modules:

* `repro_torch.fl.state` — `ClientStateStore`, the participation-keyed
  client row pool (grow-on-demand, dense, or capped with eviction and
  host/memmap offload) on the simulator's device;
* `repro_torch.fl.planner` — `RoundPlanner`, participant-scoped Eq. 8–9 /
  §4.1 Caesar planning, or a baseline policy's, on the CPU;
* `repro_torch.fl.baselines` — the baseline policies (`POLICIES`: fedavg,
  fic, cac, flexcom, prowd, pyramidfl) and their `Plan`;
* `repro_torch.fl.executor` — `RoundExecutor`, the plan-shaped (ragged)
  or uniform-cap (masked) round step batched over chunks, through the CUDA
  kernels on the card, with error feedback and a bf16 pool;
* `repro_torch.fl.wire`, `faults`, `robust`, `availability` — the wire
  boundary: serialized uploads, fault injection, robust aggregation and
  diurnal availability;
* `repro_torch.fl.driver` — `SimConfig`, `History`, `RoundPkg`,
  `Simulator`: the pipelined round loop and Eq.-7 accounting, unsharded
  or sharded (``SimConfig.sharded``: one rank of a torch.distributed world
  per shard of the pool, `repro_torch.launch.mesh`).

Import from HERE (``from repro_torch.fl.simulation import Simulator,
SimConfig``).
"""
from __future__ import annotations

from repro_torch.fl.availability import AvailabilityConfig  # noqa: F401
from repro_torch.fl.baselines import POLICIES, Plan  # noqa: F401
from repro_torch.fl.driver import (History, RoundPkg, SimConfig,  # noqa: F401
                                   Simulator)
from repro_torch.fl.executor import (BUFFER_DTYPES, EF_EXTRA_ARRAYS,  # noqa: F401
                                     RoundExecutor, TierGroup)
from repro_torch.fl.faults import FaultConfig, FaultPlan  # noqa: F401
from repro_torch.fl.planner import RoundPlanner  # noqa: F401
from repro_torch.fl.robust import AGGREGATIONS, make_aggregator  # noqa: F401
from repro_torch.fl.state import ClientStateStore  # noqa: F401
from repro_torch.fl.wire import (WireUpload, decode_upload,  # noqa: F401
                                 encode_upload)

__all__ = [
    "AGGREGATIONS",
    "AvailabilityConfig",
    "BUFFER_DTYPES",
    "ClientStateStore",
    "EF_EXTRA_ARRAYS",
    "FaultConfig",
    "FaultPlan",
    "History",
    "POLICIES",
    "Plan",
    "RoundExecutor",
    "RoundPkg",
    "RoundPlanner",
    "SimConfig",
    "Simulator",
    "TierGroup",
    "WireUpload",
    "decode_upload",
    "encode_upload",
    "make_aggregator",
]
