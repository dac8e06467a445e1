"""Track A: the faithful multi-client FL simulator (paper Algorithm 1) on
PyTorch — the public surface of the port's layered round engine, a facade
over its sibling modules:

* `repro_torch.fl.state` — `ClientStateStore`, the participation-keyed
  client row pool (grow-on-demand or dense) on the simulator's device;
* `repro_torch.fl.planner` — `RoundPlanner`, participant-scoped Eq. 8–9 /
  §4.1 Caesar planning, or a baseline policy's, on the CPU;
* `repro_torch.fl.baselines` — the baseline policies (`POLICIES`: fedavg,
  fic, cac, flexcom, prowd, pyramidfl) and their `Plan`;
* `repro_torch.fl.executor` — `RoundExecutor`, the plan-shaped round step
  batched over tier chunks, through the CUDA kernels on the card;
* `repro_torch.fl.driver` — `SimConfig`, `History`, `RoundPkg`,
  `Simulator`: the pipelined round loop and Eq.-7 accounting.

Import from HERE (``from repro_torch.fl.simulation import Simulator,
SimConfig``).
"""
from __future__ import annotations

from repro_torch.fl.baselines import POLICIES, Plan  # noqa: F401
from repro_torch.fl.driver import (History, RoundPkg, SimConfig,  # noqa: F401
                                   Simulator)
from repro_torch.fl.executor import RoundExecutor, TierGroup  # noqa: F401
from repro_torch.fl.planner import RoundPlanner  # noqa: F401
from repro_torch.fl.state import ClientStateStore  # noqa: F401

__all__ = [
    "ClientStateStore",
    "History",
    "POLICIES",
    "Plan",
    "RoundExecutor",
    "RoundPkg",
    "RoundPlanner",
    "SimConfig",
    "Simulator",
    "TierGroup",
]
