"""Runtime contracts over the REAL round steps — the port's counterpart of
``repro.analysis.contracts``.

The reference asserts what XLA compiled (jaxpr avals, HLO aliasing, host
callback primitives). Eager PyTorch compiles nothing, so each contract is
observed while a tiny `Simulator` (the reference's ``_tiny_cfg``) runs its
rounds, through wrappers set on the run's own instances and removed after
it, whatever the run did:

* **no-f64** — no float64/complex128 tensor is produced in a round step:
  the output dtypes of every op, recorded under a ``TorchDispatchMode``
  entered and left around each step call (`DtypeRecorder`). Host numpy in
  f64 (the Eq.-7 accounting) is not a tensor and not in scope.
* **in-place** — the twin of donation. The pool and the EF pool keep their
  storage (``data_ptr``) across every chunk step (``_tier_chunk_defer``
  writes them with ``index_copy_``); growth reallocates by design at
  ``prepare``, so the check is per chunk step, not across rounds. Buffers
  the reference donates that the port allocates anew every round are
  named in the report: the global vector out of ``_finalize`` and the
  fold's carry, each [n_params] — O(n_params), not O(capacity).
* **shape-lattice** — the tier-chunk shapes run stay within
  ``shape_lattice_bound()`` and each is a lattice point (the reference's
  ``check_tier_shapes`` / ``check_tier_lattice_membership`` on the port
  executor's telemetry).
* **no-stray-sync** — the counterpart of the reference's no-callbacks
  contract: the rounds run under ``torch.cuda.set_sync_debug_mode``, set
  in ``try/finally``, and every synchronizing CUDA call is recorded with
  its Python stack (`SyncRecorder`). Exactly the `SANCTIONED_SYNCS` pass:
  the end-of-round readback, the wire's per-chunk copy and the eval
  boundary; any other sync fails the contract and the report names its
  place. The mode is "warn", not "error": an error would abort the round
  at the first sync, the sanctioned readback included, while the warning
  lets the contract pass exactly the sanctioned ones and name every other.
  It needs the card: on the CPU the report says so and counts as neither
  a pass nor a failure.

``verify_track_b()`` runs one Track-B step of the Qwen1.5-4B smoke config
for no-f64 and in-place (the step is functional: it leaves its input
state as it was and allocates the new one).

Entry points run on the card unless the caller passes ``device="cpu"``;
``"cuda"`` without a card raises, as the simulator does.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import traceback
import warnings
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

_BAD_DTYPES = (torch.float64, torch.complex128)
_SYNC_MSG = "called a synchronizing CUDA operation"

# (module path suffix, function, text on its frame's line or None, what):
# a sync is sanctioned when a frame of its stack matches one of these
SANCTIONED_SYNCS = (
    ("repro_torch/fl/executor.py", "_readback", None,
     "end-of-round readback"),
    ("repro_torch/fl/driver.py", "_wire_round", "ups.cpu()",
     "wire per-chunk copy"),
    ("repro_torch/fl/driver.py", "run", "self._eval(", "eval boundary"),
)


@dataclasses.dataclass(frozen=True)
class ContractReport:
    name: str
    ok: bool
    detail: str = ""
    # the contract cannot run here (the sync check without a card): the
    # report is neither a pass nor a failure
    skipped: bool = False
    # the compression-kernel launches the checked run implies, per kernel
    # (the executor's ``kernel_launches()``; the Track-B step's per leaf)
    launches: Optional[dict] = dataclasses.field(default=None,
                                                 compare=False)

    @property
    def failed(self) -> bool:
        return not self.ok and not self.skipped

    def __str__(self) -> str:
        mark = "SKIP" if self.skipped else "PASS" if self.ok else "FAIL"
        return f"[{mark}] {self.name}" + (f": {self.detail}"
                                          if self.detail else "")


# --- instance wrappers ------------------------------------------------------

class InstancePatches:
    """Wrappers set as attributes of single instances, undone in reverse
    order by `restore`. Never on a class: a class-level wrapper would
    outlive the check and reach every other instance in the process."""

    def __init__(self):
        self._undo: list = []

    def wrap(self, obj, name: str, make: Callable):
        """``obj.name = make(obj.name)`` on the instance."""
        if isinstance(obj, type):
            raise TypeError(f"wrap instances, not the class {obj.__name__}")
        own = vars(obj)
        self._undo.append((obj, name, name in own, own.get(name)))
        setattr(obj, name, make(getattr(obj, name)))

    def restore(self):
        while self._undo:
            obj, name, had, old = self._undo.pop()
            if had:
                setattr(obj, name, old)
            else:
                delattr(obj, name)


# --- recorders --------------------------------------------------------------

class DtypeRecorder(TorchDispatchMode):
    """Counts every op dispatched while entered and records those whose
    outputs hold a float64/complex128 tensor (op name → dtypes)."""

    def __init__(self):
        super().__init__()
        self.n_ops = 0
        self.wide: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.n_ops += 1
        for t in _pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.dtype in _BAD_DTYPES:
                self.wide.setdefault(str(func), set()).add(str(t.dtype))
        return out

    def around(self, fn: Callable) -> Callable:
        """``fn`` with every call run under this recorder."""
        def wrapped(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return wrapped


class InPlaceProbe:
    """``data_ptr`` of the store's pool and EF pool before and after every
    chunk step, and whether ``_finalize`` returned a new global vector."""

    def __init__(self):
        self.chunk_steps = 0
        self.moved: collections.Counter = collections.Counter()
        self.finalize_calls = 0
        self.finalize_new = 0

    def instrument(self, patches: InstancePatches, executor):
        def chunk(orig):
            def wrapped(store, *args, **kwargs):
                before = (store.pool.data_ptr(), store.ef_pool.data_ptr())
                out = orig(store, *args, **kwargs)
                after = (store.pool.data_ptr(), store.ef_pool.data_ptr())
                self.chunk_steps += 1
                for name, b, a in zip(("pool", "ef_pool"), before, after):
                    if a != b:
                        self.moved[name] += 1
                return out
            return wrapped

        def finalize(orig):
            def wrapped(global_f, *args, **kwargs):
                out = orig(global_f, *args, **kwargs)
                self.finalize_calls += 1
                self.finalize_new += out.data_ptr() != global_f.data_ptr()
                return out
            return wrapped

        patches.wrap(executor, "_tier_chunk_defer", chunk)
        patches.wrap(executor, "_finalize", finalize)


class SyncRecorder:
    """Every synchronizing CUDA call made while entered and armed, with its
    Python stack. Entering sets ``torch.cuda.set_sync_debug_mode("warn")``
    and routes that warning here (never to the user); leaving restores the
    mode and the warning machinery, also when the run raised. `arm_on_call`
    wraps the round's first call, so set-up copies before it do not count."""

    def __init__(self):
        self.armed = False
        self.stacks: list = []

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if _SYNC_MSG in str(message):
            if self.armed:
                self.stacks.append(traceback.extract_stack()[:-1])
            return
        self._shown(message, category, filename, lineno, file, line)

    def __enter__(self):
        self._mode = torch.cuda.get_sync_debug_mode()
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.filterwarnings("always", message=_SYNC_MSG)
        self._shown = warnings.showwarning
        warnings.showwarning = self._show
        try:
            torch.cuda.set_sync_debug_mode("warn")
        except BaseException:
            self._catch.__exit__(None, None, None)
            raise
        return self

    def __exit__(self, *exc):
        try:
            torch.cuda.set_sync_debug_mode(self._mode)
        finally:
            self._catch.__exit__(*exc)
        return False

    def arm_on_call(self, fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            self.armed = True
            return fn(*args, **kwargs)
        return wrapped


def _sanctioned(stack) -> Optional[str]:
    for fr in stack:
        path = fr.filename.replace("\\", "/")
        for suffix, func, text, what in SANCTIONED_SYNCS:
            if path.endswith(suffix) and fr.name == func and \
                    (text is None or text in (fr.line or "")):
                return what
    return None


def _place(stack) -> str:
    """The innermost frame outside torch, the warnings machinery and this
    package: where the sync was asked for."""
    for fr in reversed(stack):
        path = fr.filename.replace("\\", "/")
        if "/torch/" in path or path.endswith("/warnings.py") or \
                "repro_torch/analysis/" in path:
            continue
        tail = "/".join(path.split("/")[-3:])
        return f"{tail}:{fr.lineno} in {fr.name}: {(fr.line or '').strip()}"
    return "<no Python frame outside torch>"


# --- individual contracts ---------------------------------------------------

def check_no_f64(rec: DtypeRecorder, label: str) -> ContractReport:
    name = f"no-f64[{label}]"
    if rec.n_ops == 0:
        return ContractReport(name, False, "no op ran under the recorder "
                              "(the step was never called)")
    bad = sorted(f"{op} -> {'/'.join(sorted(d))}"
                 for op, d in rec.wide.items())
    return ContractReport(
        name, not bad,
        f"wide dtypes produced in the step: {bad}" if bad else
        f"{rec.n_ops} ops, none producing float64/complex128")


def check_in_place(probe: InPlaceProbe, label: str,
                   launches: Optional[dict] = None) -> ContractReport:
    name = f"in-place[{label}]"
    if probe.chunk_steps == 0:
        return ContractReport(name, False, "no chunk step ran",
                              launches=launches)
    anew = ("allocated anew every round (O(n_params), not O(capacity)): "
            "the fold's carry, and the global vector "
            f"({probe.finalize_new} of {probe.finalize_calls} "
            "_finalize calls returned a new tensor)"
            if probe.finalize_calls else
            "allocated anew every round (O(n_params) each, not "
            "O(capacity)): the server aggregator's carry and the global "
            "vector")
    if probe.moved:
        moved = ", ".join(f"{k} in {n} of {probe.chunk_steps}"
                          for k, n in sorted(probe.moved.items()))
        return ContractReport(
            name, False, f"chunk steps reallocated a pool they should "
            f"write in place: {moved}", launches=launches)
    return ContractReport(
        name, True, f"pool and EF pool kept their storage across "
        f"{probe.chunk_steps} chunk steps; {anew}", launches=launches)


def check_tier_shapes(telemetry: dict,
                      label: str = "ragged") -> ContractReport:
    """Count bound from executor telemetry."""
    seen = telemetry["compiled_tier_shapes"]
    bound = telemetry["shape_lattice_bound"]
    ok = seen <= bound
    return ContractReport(
        f"shape-lattice-count[{label}]", ok,
        f"{seen} tier-chunk shapes vs lattice bound {bound}"
        + ("" if ok else " — the shapes run are NOT bounded by the tier "
           "lattice"))


def check_tier_lattice_membership(executor,
                                  label: str = "ragged") -> ContractReport:
    from repro_torch.core import batchsize as BS
    chunk_rungs = set(executor.chunk_rungs())
    b_rungs = set(np.asarray(
        BS.tier_rungs(executor.b_min, executor.b_cap)).tolist())
    t_rungs = set(np.asarray(
        BS.tier_rungs(1, executor.tau_cap)).tolist())
    off = sorted(s for s in executor._shapes_seen
                 if s[0] not in chunk_rungs or s[1] not in t_rungs
                 or s[2] not in b_rungs)
    return ContractReport(
        f"shape-lattice-member[{label}]", not off,
        f"off-lattice tier-chunk shapes (chunk, tau, b): {off}" if off else
        f"{len(executor._shapes_seen)} shapes all on the lattice")


def check_no_stray_sync(rec: Optional[SyncRecorder],
                        label: str) -> ContractReport:
    name = f"no-stray-sync[{label}]"
    if rec is None:
        return ContractReport(name, False, "needs a card (CUDA sync debug "
                              "mode); not run on the CPU", skipped=True)
    if not rec.armed:
        return ContractReport(name, False, "no round ran under the check")
    stray: collections.Counter = collections.Counter()
    passed: collections.Counter = collections.Counter()
    for stack in rec.stacks:
        what = _sanctioned(stack)
        if what is None:
            stray[_place(stack)] += 1
        else:
            passed[what] += 1
    if stray:
        return ContractReport(name, False, "host syncs outside the "
                              "sanctioned points: " + "; ".join(
                                  f"{p} (x{n})"
                                  for p, n in sorted(stray.items())))
    if not passed:
        return ContractReport(name, False, "no sync recorded at all, not "
                              "even the end-of-round readback: the "
                              "recorder saw nothing")
    return ContractReport(name, True, f"{sum(passed.values())} syncs, all "
                          "sanctioned: " + ", ".join(
                              f"{w} x{n}" for w, n in sorted(passed.items())))


# --- end-to-end verification ------------------------------------------------

def _tiny_cfg(device: str = "cuda", **overrides):
    """The reference's ``_tiny_cfg`` (oppo_ts at 64 features, 12 clients,
    EF on, 3 rounds, not pipelined) on ``device``."""
    from repro_torch.core.caesar import CaesarConfig
    from repro_torch.fl.simulation import SimConfig
    base = dict(dataset="oppo_ts", rounds=3, n_clients=12, data_scale=0.01,
                eval_every=3, participation=0.5, seed=0,
                dataset_kwargs={"n_features": 64},
                # EF on so the EF pool is a real buffer of every chunk step
                caesar=CaesarConfig(tau=2, b_max=8, use_error_feedback=True),
                pipelined=False, device=device)
    base.update(overrides)
    return SimConfig(**base)


def _run_checked(sim, label: str, step_holder, step_name: str,
                 patch: Optional[Callable]) -> list:
    """Run ``sim`` with the recorders on its own instances; the step entry
    ``step_holder.step_name`` runs under the dtype recorder. ``patch(sim,
    patches)`` may seed a violation through the same undo list."""
    patches = InstancePatches()
    dtypes, probe = DtypeRecorder(), InPlaceProbe()
    syncs = SyncRecorder() if sim.device.type == "cuda" else None
    try:
        if patch is not None:
            patch(sim, patches)
        probe.instrument(patches, sim.executor)
        patches.wrap(step_holder, step_name, dtypes.around)
        if syncs is not None:
            patches.wrap(sim, "_prefetch_pkg", syncs.arm_on_call)
        with syncs if syncs is not None else contextlib.nullcontext():
            sim.run()
    finally:
        patches.restore()
    return [check_no_f64(dtypes, label),
            check_in_place(probe, label, sim.executor.kernel_launches()),
            check_no_stray_sync(syncs, label)]


def verify_round_engine(ragged: bool, device: str = "cuda",
                        patch: Optional[Callable] = None,
                        **overrides) -> list:
    """Build the tiny sim on ``device``, run the (masked|ragged) engine's
    rounds under the recorders and check every contract."""
    from repro_torch.fl.simulation import Simulator
    label = "ragged" if ragged else "masked"
    sim = Simulator(_tiny_cfg(device, ragged=ragged, **overrides))
    ex = sim.executor
    reports = _run_checked(sim, label, ex,
                           "step_ragged" if ragged else "step", patch)
    if ragged:
        reports.append(check_tier_shapes(ex.telemetry(), label))
        reports.append(check_tier_lattice_membership(ex, label))
    return reports


def verify_wire_engine(device: str = "cuda", patch: Optional[Callable] = None,
                       **overrides) -> list:
    """The wire-boundary round (a tiny loopback run with faults and
    trimmed-mean aggregation): its deferred chunk steps and the server's
    fold run under the dtype recorder, the pools under the in-place probe
    and the whole round under the sync check."""
    from repro_torch.fl import faults as F
    from repro_torch.fl.simulation import Simulator
    sim = Simulator(_tiny_cfg(
        device, ragged=True, wire="loopback",
        faults=F.FaultConfig(dropout_rate=0.2, byzantine_frac=0.2),
        aggregation="trimmed_mean", **overrides))
    return _run_checked(sim, "wire", sim, "_wire_round", patch)


def _tensors(state) -> list:
    from repro_torch.fl import distributed as D
    out = []
    for f in ("params", "prev_params", "ef"):
        tree = getattr(state, f)
        if tree is not None:
            out.extend(D.tree_leaves(tree))
    return out


def verify_track_b(device: str = "cuda",
                   patch: Optional[Callable] = None) -> list:
    """One Track-B step of the Qwen1.5-4B smoke config (τ = 2, EF on,
    meshless) under the dtype recorder; in-place: the step must leave its
    input state as it was, since it allocates the new one (the reference
    donates the state to its compiled step). ``patch(step)`` returns the
    step to run (a seeded violation)."""
    import repro_torch.configs as configs
    from repro_torch.fl import distributed as D
    from repro_torch.models import model as M

    dev = M.resolve_device(device)
    cfg = dataclasses.replace(configs.get("qwen1p5_4b").smoke(),
                              local_iters=2)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, gen, dev)
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=gen, device=dev)
    batch = {"tokens": toks, "labels": toks}
    dcfg = D.DistConfig(theta_d=0.3, theta_u=0.4, local_lr=1e-2,
                        use_error_feedback=True)
    state = D.init_state(params, dcfg, mesh=None)
    step = D.make_train_step(cfg, dcfg, mesh=None, device=dev)
    if patch is not None:
        step = patch(step)
    before = [t.clone() for t in _tensors(state)]
    dtypes = DtypeRecorder()
    with dtypes:
        new_state, _ = step(state, batch)
    written = sum(not torch.equal(a, b)
                  for a, b in zip(before, _tensors(state)))
    fresh = _tensors(new_state)
    n_leaves = len(D.tree_leaves(params))
    launches = {"magnitude_histogram": 2 * n_leaves,
                "hybrid_compress": n_leaves, "recover": n_leaves}
    mb = sum(t.numel() * t.element_size() for t in fresh) / 2**20
    in_place = ContractReport(
        "in-place[track_b]", written == 0,
        f"the step wrote {written} of {len(before)} tensors of its input "
        "state in place" if written else
        f"input state untouched; the new state is allocated anew each step "
        f"({len(fresh)} tensors, {mb:.2f} MiB: params, prev_params, ef — "
        "O(model), every element of which the step rewrites)",
        launches=launches)
    return [check_no_f64(dtypes, "track_b"), in_place]


def run_contracts(track_b: bool = True, device: str = "cuda") -> list:
    reports = verify_round_engine(ragged=False, device=device)
    reports += verify_round_engine(ragged=True, device=device)
    reports += verify_wire_engine(device=device)
    if track_b:
        reports += verify_track_b(device=device)
    return reports
