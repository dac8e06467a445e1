"""repro_torch.analysis — the port's invariant checker — against the
reference's (repro.analysis) on the CPU.

* Lint: the port's rules give the reference's (code, line) diagnostics on
  every fixture of tests/fixtures/analysis/ (EXACT), flag the torch
  fixtures of tests/fixtures/analysis_torch/, and the port's tree lints
  clean.
* Contracts: the port executor's tier shapes and lattice bound equal the
  reference executor's on the same ``_tiny_cfg`` (EXACT) and both tier
  checks agree with the reference's on the same telemetry; no-f64 and
  in-place pass on the ragged, masked and wire engines and the Track-B
  step, and each flags a violation seeded into a run. The sync contract
  needs a card and reports so here.
* Ownership: the audit is clean on the three pipelined cases and sees the
  reference audit's (object, method, round, is_main) touches, without the
  reference store's ``adopt`` (the port's step writes the pool in place);
  a rogue-thread ``store.prepare`` is flagged.
* No global state outlives a check, also one that raised.
"""
import collections
import functools
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import (  # noqa: E402
    _get_current_dispatch_mode_stack)

from repro.analysis import contracts as RC  # noqa: E402
from repro.analysis.lint import SourceFile as RSource  # noqa: E402
from repro.analysis.lint import lint_source as r_lint  # noqa: E402
from repro.analysis.ownership import OwnershipAudit as RAudit  # noqa: E402
from repro.analysis.rules import ALL_RULES as R_RULES  # noqa: E402
from repro.fl import faults as RF  # noqa: E402
from repro.fl.simulation import Simulator as RSim  # noqa: E402
from repro_torch.analysis import contracts as TC  # noqa: E402
from repro_torch.analysis import ownership as TO  # noqa: E402
from repro_torch.analysis.__main__ import default_paths, main  # noqa: E402
from repro_torch.analysis.lint import SourceFile, lint_source, run_lint  # noqa: E402
from repro_torch.analysis.rules import ALL_RULES  # noqa: E402
from repro_torch.fl import distributed as D  # noqa: E402
from repro_torch.fl import faults as TF  # noqa: E402
from repro_torch.fl.executor import RoundExecutor  # noqa: E402
from repro_torch.fl.simulation import Simulator  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "analysis"
TORCH_FIXTURES = REPO / "tests" / "fixtures" / "analysis_torch"
CODES = [r.code for r in R_RULES]

# the reference test's synthetic in-scope paths (test_analysis.py)
_LINT_PATH = {"REP005": "src/repro/core/{name}",
              "REP009": "src/repro/fl/faults.py",
              "REP010": "src/repro/fl/availability.py"}
# where the torch fixtures are linted: REP005's port scope
_TORCH_PATH = {"REP005": "src/repro_torch/fl/executor.py"}


def _keys(diags):
    return sorted((d.rule, d.line) for d in diags)


# --- (a) lint parity on the reference's fixtures -----------------------------

@pytest.mark.parametrize("which", ["fail", "pass"])
@pytest.mark.parametrize("code", CODES)
def test_lint_parity_with_reference(code, which):
    name = f"{code.lower()}_{which}.py"
    path = _LINT_PATH.get(code, "{name}").format(name=name)
    text = (FIXTURES / name).read_text()
    ref, _ = r_lint(RSource(path, text), R_RULES)
    port, _ = lint_source(SourceFile(path, text), ALL_RULES)
    assert _keys(port) == _keys(ref)
    if which == "fail":
        assert any(d.rule == code for d in port)
    else:
        assert port == []


def test_one_noqa_comment_satisfies_both_linters():
    text = (FIXTURES / "rep006_fail.py").read_text().replace(
        "losses.append(float(bits))",
        "losses.append(float(bits))  # repro: noqa=REP006")
    assert text != (FIXTURES / "rep006_fail.py").read_text()
    ref, r_sup = r_lint(RSource("x.py", text), R_RULES)
    port, t_sup = lint_source(SourceFile("x.py", text), ALL_RULES)
    assert ref == port == [] and r_sup == t_sup == 1


# --- (b) torch fixtures ----------------------------------------------------------

_TORCH_FAIL_LINES = {"REP003": [10], "REP005": [8, 13],
                     "REP006": [11, 12, 13, 14]}


@pytest.mark.parametrize("which", ["fail", "pass"])
@pytest.mark.parametrize("code", sorted(_TORCH_FAIL_LINES))
def test_torch_fixture(code, which):
    name = f"{code.lower()}_{which}.py"
    path = _TORCH_PATH.get(code, "{name}").format(name=name)
    src = SourceFile(path, (TORCH_FIXTURES / name).read_text())
    diags, _ = lint_source(src, ALL_RULES)
    if which == "fail":
        assert {d.rule for d in diags} == {code}
        assert sorted(d.line for d in diags) == _TORCH_FAIL_LINES[code]
    else:
        assert diags == []


# --- (c) the port's tree -----------------------------------------------------

def test_port_tree_lints_clean():
    paths = default_paths(REPO)
    assert REPO / "src" / "repro_torch" in paths
    diags, _ = run_lint(paths, root=REPO)
    assert diags == [], "\n".join(str(d) for d in diags)


def test_analysis_imports_neither_jax_nor_the_reference():
    import ast
    for f in sorted((REPO / "src" / "repro_torch" / "analysis").rglob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (f, n)


def test_cli_lint_only_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "from repro_torch.analysis.__main__ import main; "
            "sys.exit(main(['--skip', 'contracts', '--skip', 'ownership', "
            "'--strict']))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[lint] 0 diagnostics" in out.stderr


def test_cli_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--skip", "lint", "--skip", "ownership"])


# --- reference and port runs, each once per module --------------------------

_OWN_CASES = {
    "ragged": dict(ragged=True),
    "masked": dict(ragged=False),
    "wire": dict(ragged=True, wire="loopback"),
}


def _faults(F, label):
    return (dict(faults=F.FaultConfig(dropout_rate=0.2, byzantine_frac=0.2))
            if label == "wire" else {})


@functools.lru_cache(maxsize=None)
def _reference_audit(label):
    """The reference's ``audit_run`` on one case, keeping its simulator."""
    sim = RSim(RC._tiny_cfg(pipelined=True, **_OWN_CASES[label],
                            **_faults(RF, label)))
    audit = RAudit().instrument(sim)
    sim.run()
    return sim, audit, audit.check(sim.cfg, is_caesar=sim.planner.is_caesar)


@functools.lru_cache(maxsize=None)
def _port_audit(label):
    sim = Simulator(TC._tiny_cfg("cpu", pipelined=True, **_OWN_CASES[label],
                                 **_faults(TF, label)))
    audit = TO.OwnershipAudit().instrument(sim)
    try:
        sim.run()
    finally:
        audit.restore()
    return sim, audit, audit.check(sim.cfg, is_caesar=sim.planner.is_caesar)


def _touches(audit, drop=()):
    return sorted(collections.Counter(
        (t.obj, t.method, -1 if t.t is None else t.t, t.is_main)
        for t in audit.touches
        if (t.obj, t.method) not in drop).items())


# --- (d) tier shapes against the reference -----------------------------------

def test_tier_shapes_equal_reference():
    rsim, _, _ = _reference_audit("ragged")
    tsim, _, _ = _port_audit("ragged")
    rex, tex = rsim.executor, tsim.executor
    assert tex._shapes_seen == rex._shapes_seen
    assert tex.shape_lattice_bound() == rex.shape_lattice_bound()
    assert tex.chunk_rungs() == list(rex.chunk_rungs())
    # the unpipelined run of the same config draws the same tiers
    sync = Simulator(TC._tiny_cfg("cpu", ragged=True))
    sync.run()
    assert sync.executor._shapes_seen == rex._shapes_seen


def test_tier_checks_agree_with_reference():
    rsim, _, _ = _reference_audit("ragged")
    tsim, _, _ = _port_audit("ragged")
    rtel, ttel = rsim.executor.telemetry(), tsim.executor.telemetry()
    for tel in (rtel, ttel, {"compiled_tier_shapes": 33,
                             "shape_lattice_bound": 32}):
        a, b = RC.check_tier_shapes(tel), TC.check_tier_shapes(tel)
        assert (a.ok, a.name) == (b.ok, b.name)
    assert TC.check_tier_shapes(ttel).ok
    assert not TC.check_tier_shapes({"compiled_tier_shapes": 33,
                                     "shape_lattice_bound": 32}).ok
    for ex in (rsim.executor, tsim.executor):
        a = RC.check_tier_lattice_membership(ex)
        b = TC.check_tier_lattice_membership(ex)
        assert a.ok and b.ok and a.detail == b.detail
    # an off-lattice shape (chunk 3 is no rung) fails both
    tex = tsim.executor
    seen = set(tex._shapes_seen)
    try:
        tex._shapes_seen.add((3, 2, 8))
        a = RC.check_tier_lattice_membership(tex)
        b = TC.check_tier_lattice_membership(tex)
        assert not a.ok and not b.ok and "(3, 2, 8)" in b.detail
    finally:
        tex._shapes_seen = seen


# --- (e) contracts -------------------------------------------------------

_ENGINES = ("ragged", "masked", "wire", "track_b")


def _verify(engine, patch=None):
    if engine == "track_b":
        return TC.verify_track_b("cpu", patch=patch)
    if engine == "wire":
        return TC.verify_wire_engine("cpu", patch=patch)
    return TC.verify_round_engine(engine == "ragged", "cpu", patch=patch)


@functools.lru_cache(maxsize=None)
def _clean(engine):
    return {r.name.split("[")[0]: r for r in _verify(engine)}


def _assert_no_global_state():
    assert _get_current_dispatch_mode_stack() == []
    assert torch.get_default_dtype() == torch.float32
    for name in ("step", "step_ragged", "step_ragged_deferred",
                 "_tier_chunk_defer", "_finalize"):
        assert name in vars(RoundExecutor)
    for name in ("run", "_prefetch_pkg", "_wire_round", "_make_store"):
        assert name in vars(Simulator)


_WRAPPED = {"sim": ("_prefetch_pkg", "_wire_round", "_make_store"),
            "executor": ("step", "step_ragged", "step_ragged_deferred",
                         "_tier_chunk_defer", "_finalize"),
            "planner": ("plan", "advance", "observe"),
            "store": ("prepare", "state_dict", "load_state_dict")}


def _assert_own_methods(sim):
    """No wrapper a check set is left on the simulator's instances."""
    objs = {"sim": sim, "executor": sim.executor, "planner": sim.planner,
            "store": getattr(sim, "store", None)}
    for key, obj in objs.items():
        if obj is not None:
            left = [m for m in _WRAPPED[key] if m in vars(obj)]
            assert left == [], (key, left)


@pytest.mark.parametrize("engine", _ENGINES)
def test_contracts_pass(engine):
    reps = _clean(engine)
    assert reps["no-f64"].ok, reps["no-f64"]
    assert reps["in-place"].ok, reps["in-place"]
    assert reps["in-place"].launches["hybrid_compress"] > 0
    if engine != "track_b":
        sync = reps["no-stray-sync"]
        assert sync.skipped and not sync.ok and not sync.failed
        assert "needs a card" in sync.detail
    if engine == "ragged":
        assert reps["shape-lattice-count"].ok
        assert reps["shape-lattice-member"].ok
    _assert_no_global_state()


def _seed_track_a(seen):
    """Seeds both violations into the real chunk step: an f64 op, and the
    pool reallocated in place of being written in place."""
    def patch(sim, patches):
        seen.append(sim)

        def make(orig):
            def bad_chunk(store, *args, **kwargs):
                out = orig(store, *args, **kwargs)
                store.pool.to(torch.float64)
                store.pool = store.pool.clone()
                return out
            return bad_chunk
        patches.wrap(sim.executor, "_tier_chunk_defer", make)
    return patch


def _seed_track_b(step):
    def bad_step(state, batch):
        out = step(state, batch)
        leaf = D.tree_leaves(state.ef)[0]
        leaf.add_(1.0)
        leaf.to(torch.complex128)
        return out
    return bad_step


@pytest.mark.parametrize("engine", _ENGINES)
def test_contracts_flag_seeded_violations(engine):
    seen = []
    patch = _seed_track_b if engine == "track_b" else _seed_track_a(seen)
    reps = {r.name.split("[")[0]: r for r in _verify(engine, patch)}
    assert reps["no-f64"].failed
    want = "complex128" if engine == "track_b" else "float64"
    assert want in reps["no-f64"].detail
    assert reps["in-place"].failed
    assert ("input state" if engine == "track_b" else
            "reallocated") in reps["in-place"].detail
    _assert_no_global_state()
    for sim in seen:
        _assert_own_methods(sim)


@pytest.mark.parametrize("engine", ["ragged", "wire", "track_b"])
def test_no_global_state_survives_a_check_that_raised(engine):
    seen = []

    def boom(*args, **kwargs):
        raise RuntimeError("seeded failure")

    if engine == "track_b":
        def patch(step):
            return boom
    else:
        def patch(sim, patches):
            seen.append(sim)
            patches.wrap(sim.executor, "_tier_chunk_defer", lambda f: boom)
    with pytest.raises(RuntimeError, match="seeded failure"):
        _verify(engine, patch)
    _assert_no_global_state()
    for sim in seen:
        _assert_own_methods(sim)


# --- (f) ownership -----------------------------------------------------------

@pytest.mark.parametrize("label", sorted(_OWN_CASES))
def test_ownership_clean_and_equal_to_reference(label):
    sim, audit, violations = _port_audit(label)
    assert violations == [], violations
    objs = {t.obj for t in audit.touches}
    assert {"store", "executor", "planner", "prefetch"} <= objs
    assert all(not t.is_main for t in audit.touches if t.obj == "prefetch")
    _, raudit, rviol = _reference_audit(label)
    assert rviol == []
    # the reference store's adopt takes the donated pools back; the port's
    # step writes its pool in place and has no adopt
    assert _touches(audit) == _touches(raudit, drop={("store", "adopt")})
    _assert_own_methods(sim)
    _assert_no_global_state()


def test_ownership_flags_rogue_store_touch():
    sim = Simulator(TC._tiny_cfg("cpu", pipelined=True, ragged=True))
    audit = TO.OwnershipAudit().instrument(sim)
    try:
        sim.run()
        rogue = threading.Thread(
            target=lambda: audit.last_store.prepare(
                np.array([0], np.int64), 99),
            name="rogue")
        rogue.start()
        rogue.join()
    finally:
        flagged = audit.check(sim.cfg)
    assert any("rogue" in v and "store.prepare" in v for v in flagged), \
        flagged
    _assert_own_methods(sim)
    assert "prepare" not in vars(audit.last_store)


def test_ownership_restores_after_a_run_that_raised():
    # a pool capacity below the cohort raises inside run(), after the
    # audit has wrapped the simulator
    with pytest.raises((RuntimeError, ValueError)):
        TO.audit_run("cpu", ragged=True, state_capacity=1)
    _assert_no_global_state()
