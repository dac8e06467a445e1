"""Pipeline ownership audit — the dynamic twin of REP003/REP008, the port's
counterpart of ``repro.analysis.ownership``.

The pipelined driver is race-free by *discipline*, not by locks
(fl/driver.py module docstring): the worker thread owns host sampling for
round t+1 (and, under ragged, caesar planning — plan and advance depend
only on participant sets); the main thread owns the state store (prepare →
step, which writes the pool in place), the executor, and masked planning.
Nothing enforces that at runtime — a change that moves one call to the
wrong side would corrupt state only occasionally and only under load.

`OwnershipAudit` instruments one real Simulator — wrappers set on its own
instances only, recording ``(object, method, thread, round)`` — runs it,
and `check` tests the documented contract, then takes the wrappers off:

* ClientStateStore methods (prepare/state_dict/load_state_dict; the port
  has no ``adopt``: the step writes the pool in place) — main thread only;
* RoundExecutor step entry points — main thread only;
* pipelined: every ``_prefetch_pkg`` body on ONE non-main worker thread,
  never re-entered concurrently;
* planner ``plan``/``advance`` — on the worker thread iff (pipelined and
  ragged caesar), else on main; ``advance`` rounds strictly increasing
  (participation records replay in order).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from repro_torch.analysis.contracts import InstancePatches

# the reference's, less its "adopt": the port's step writes the pool in place
_STORE_METHODS = ("prepare", "state_dict", "load_state_dict")
_PLANNER_METHODS = ("plan", "advance", "observe")
_EXECUTOR_METHODS = ("step", "step_ragged", "step_ragged_deferred")


@dataclasses.dataclass(frozen=True)
class Touch:
    obj: str            # "store" | "planner" | "executor" | "prefetch"
    method: str
    thread: str
    is_main: bool
    t: Optional[int]    # round index when extractable
    seq: int


class OwnershipAudit:
    """Recorder + checker. ``instrument(sim)`` must run before
    ``sim.run()``; ``check(sim.cfg)`` afterwards returns violations and
    restores the instances' own methods (`restore` does only that)."""

    def __init__(self):
        self.touches: list[Touch] = []
        self._lock = threading.Lock()
        self._prefetch_depth = 0
        self._overlap = False
        self._patches = InstancePatches()
        self.last_store = None

    # -- recording ----------------------------------------------------------

    def record(self, obj: str, method: str, t: Optional[int] = None):
        th = threading.current_thread()
        with self._lock:
            self.touches.append(Touch(
                obj, method, th.name, th is threading.main_thread(), t,
                len(self.touches)))

    def _wrap(self, holder, name: str, obj: str, t_pos: Optional[int]):
        def make(orig):
            def wrapped(*args, **kwargs):
                t = None
                if t_pos is not None and len(args) > t_pos:
                    try:
                        t = int(args[t_pos])
                    except (TypeError, ValueError):
                        t = None
                if obj == "prefetch":
                    with self._lock:
                        self._prefetch_depth += 1
                        if self._prefetch_depth > 1:
                            self._overlap = True
                self.record(obj, name, t)
                try:
                    return orig(*args, **kwargs)
                finally:
                    if obj == "prefetch":
                        with self._lock:
                            self._prefetch_depth -= 1
            return wrapped
        self._patches.wrap(holder, name, make)

    def instrument(self, sim):
        """Wrap the shared-object surface of one Simulator instance."""
        for m in _PLANNER_METHODS:
            self._wrap(sim.planner, m, "planner", t_pos=0)
        for m in _EXECUTOR_METHODS:
            self._wrap(sim.executor, m, "executor", t_pos=None)
        self._wrap(sim, "_prefetch_pkg", "prefetch", t_pos=0)

        # the store is built inside run(); hook its factory
        def make_store(orig):
            def make_and_wrap():
                store = orig()
                self.last_store = store
                for m in _STORE_METHODS:
                    self._wrap(store, m, "store", t_pos=None)
                return store
            return make_and_wrap
        self._patches.wrap(sim, "_make_store", make_store)
        return self

    def restore(self):
        """Give the instrumented instances their own methods back."""
        self._patches.restore()

    # -- checking -----------------------------------------------------------

    def check(self, cfg, is_caesar: bool = True) -> list[str]:
        self.restore()
        violations = []
        by = lambda o: [t for t in self.touches if t.obj == o]  # noqa: E731

        for t in by("store"):
            if not t.is_main:
                violations.append(
                    f"store.{t.method} on thread '{t.thread}' — the "
                    "in-flight step writes the pool; store calls belong "
                    "on the main thread")
        for t in by("executor"):
            if not t.is_main:
                violations.append(
                    f"executor.{t.method} on thread '{t.thread}' — step "
                    "dispatch is main-thread state")

        prefetch = by("prefetch")
        if getattr(cfg, "pipelined", False):
            workers = {t.thread for t in prefetch if not t.is_main}
            on_main = [t for t in prefetch if t.is_main]
            if on_main:
                violations.append(
                    f"{len(on_main)} prefetch bodies ran on the main "
                    "thread under pipelined=True — the producer left its "
                    "lane")
            if len(workers) > 1:
                violations.append(
                    f"prefetch bodies spread over {sorted(workers)} — "
                    "the SeedSequence handoff assumes one producer")
            if self._overlap:
                violations.append(
                    "prefetch bodies overlapped in time — re-entrant "
                    "producer would race the persistent sample buffers")

        plan_touches = [t for t in by("planner")
                        if t.method in ("plan", "advance")]
        # worker-side planning only exists on the caesar ragged pipelined
        # path (driver._prefetch_pkg) — every other combination plans on
        # the main thread with pkg.plan is None
        worker_owns = (getattr(cfg, "pipelined", False)
                       and getattr(cfg, "ragged", False) and is_caesar)
        for t in plan_touches:
            if worker_owns and t.is_main:
                violations.append(
                    f"planner.{t.method}(t={t.t}) on the main thread "
                    "under pipelined ragged — caesar_state is "
                    "worker-owned there")
            if not worker_owns and not t.is_main:
                violations.append(
                    f"planner.{t.method}(t={t.t}) on thread "
                    f"'{t.thread}' — masked/sync planning is main-"
                    "thread-owned")

        advances = [t.t for t in by("planner") if t.method == "advance"
                    and t.t is not None]
        if advances != sorted(advances) or len(set(advances)) != \
                len(advances):
            violations.append(
                f"planner.advance rounds out of order: {advances} — "
                "participation records must replay in round order")
        return violations


def audit_run(device: str = "cuda", **overrides) -> tuple:
    """Instrumented tiny pipelined run on ``device``. Returns (violations,
    audit); the simulator's instances have their own methods back."""
    from repro_torch.analysis.contracts import _tiny_cfg
    from repro_torch.fl.simulation import Simulator
    overrides.setdefault("pipelined", True)
    sim = Simulator(_tiny_cfg(device, **overrides))
    audit = OwnershipAudit().instrument(sim)
    try:
        sim.run()
    finally:
        audit.restore()
    return audit.check(sim.cfg, is_caesar=sim.planner.is_caesar), audit


def run_ownership(device: str = "cuda") -> list:
    """Audit both engine modes plus the wire-boundary round; returns
    contract-style reports."""
    from repro_torch.analysis.contracts import ContractReport
    from repro_torch.fl import faults as F
    out = []
    cases = [("ragged", dict(ragged=True)),
             ("masked", dict(ragged=False)),
             # wire round: transport drains + deferred step + robust fold
             # are all main-thread work; the worker still owns planning
             # AND the fault draw (pure numpy — REP003)
             ("wire", dict(ragged=True, wire="loopback",
                           faults=F.FaultConfig(dropout_rate=0.2,
                                                byzantine_frac=0.2)))]
    for label, overrides in cases:
        violations, audit = audit_run(device, **overrides)
        n = len(audit.touches)
        out.append(ContractReport(
            f"ownership[pipelined/{label}]", not violations,
            "; ".join(violations) if violations else
            f"{n} shared-object touches, all on documented owners"))
    return out
