"""The sharded Track-A round engine of repro_torch against the reference's,
on the CPU: a world of 4 gloo ranks (tests/torch_sharded_ranks.py) against
the reference's 4-device "data" mesh (a subprocess with
``--xla_force_host_platform_device_count=4``, ``multi_host=True`` as in
tests/test_round_engine.py's sharded subprocess, backend "jnp"), both from
the reference's initial vector.

Config: tests/test_round_engine.py's sharded one (har, 24 clients, 8
participants = 2 per shard, data_scale 0.25, τ 3, b_max 8, chunk 2, seed
3, 4 rounds), ragged, masked, and ragged with error feedback. Clients 17
and 21 of this population tie in importance to within the two frameworks'
f32 exp/log ulps (ROADMAP fault F3) and swap upload ratios, so the port's
planner starts from the reference's importance and upload ratios, as
tests/test_torch_planning.py's ``share`` cases do.
* exact: participants (the stratified draw), plans, sim_time and waiting,
  every round;
* traffic: exact outside the selection flips, counted from each
  participant's payload bits (a flip is an element on its threshold's bin
  edge to within the two frameworks' f32 rounding; tests/
  test_torch_schemes.py); the global vector within relative L2 1e-5
  outside as many elements as flipped (f32 rounding of two frameworks over
  4 rounds, including the shards' summation order); accuracy within 5e-3
  (the reference's ragged-vs-masked tolerance on this config);
* every rank's History and round_log identical, and its pool a segment of
  exactly ``cap_per_shard`` rows (and its residual segment with EF);
  the gathered state_dict pool is every segment in rank order;
* the bf16 pool runs sharded (finite, identical on every rank); a pool
  capped at 8 rows with host offload (every round evicts across ranks)
  equals the uncapped run bit for bit, and resumes from a state_dict
  after round 2 bit for bit;
* the refusals: the reference's exception types and messages (multi_host
  without sharded, the wire engine and diurnal availability with sharded,
  n_clients not dividing over the shards) and its cohort warning.
The reference's subprocess and the port's ranks are computed once for the
module, the ranks while the reference runs (`world`). A world of 1 and
the two-shard store are tests/test_torch_sharded_layouts.py's.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")


import torch_sharded_ranks as RK  # noqa: E402
from repro_torch.core.caesar import CaesarConfig as TCaesar  # noqa: E402
from repro_torch.fl import simulation as TSIM  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.models.paper_models import from_reference  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
WORLD = 4
CFG = dict(dataset="har", rounds=4, n_clients=24, data_scale=0.25,
           eval_every=2, participation=1 / 3, seed=3,
           dataset_kwargs={"sep": 1.8, "noise": 2.0}, chunk_size=2)
CAESAR = dict(tau=3, b_max=8)
MODES = {"ragged": dict(ragged=True), "masked": dict(ragged=False),
         "ef": dict(ragged=True, use_error_feedback=True)}
GLOBAL_REL_L2 = 1e-5
ACC_TOL = 5e-3               # tests/test_round_engine.py's sharded gate
TOPK_ELEMENT_BITS = 64       # index + f32 value of a top-k upload element
HYBRID_ELEMENT_BITS = 31     # f32 value less its 1-bit sign
SPAWN_TIMEOUT_S = 180.0
REFERENCE_TIMEOUT_S = 600.0
RESUME = ("capped", 2)       # the capped run, cut after round 2

@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """This module's torch work is small ops beside the other test
    workers' JAX and torch threads: with one intra-op thread they do not
    wait on a pool the other workers' threads crowd out (under six xdist
    workers a step that takes 0.9 s alone took 44 s with eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import dataclasses, json, pickle, sys, warnings
    import numpy as np
    from repro.core.caesar import CaesarConfig
    from repro.fl.availability import AvailabilityConfig
    from repro.fl.simulation import SimConfig, Simulator
    cfg_kw, caesar_kw, modes, out, init_out = json.loads(sys.argv[1])
    base = SimConfig(backend="jnp", sharded=True, multi_host=True, **cfg_kw)
    res, sims = {}, {}
    for name, over in modes.items():
        over = dict(over)
        ckw = dict(caesar_kw, use_error_feedback=over.pop(
            "use_error_feedback", False))
        sim = Simulator(dataclasses.replace(
            base, caesar=CaesarConfig(**ckw), **over))
        assert sim.n_dev == 4, sim.n_dev
        log = []
        plan = sim.planner.plan
        step_name = "step_ragged" if sim.cfg.ragged else "step"
        step = getattr(sim.executor, step_name)

        def plan_rec(t, parts, *a, plan=plan, log=log):
            out = plan(t, parts, *a)
            log.append({"round": t, "parts": np.array(parts),
                        "plan": [np.asarray(x) for x in out]})
            return out

        def step_rec(*a, step=step, log=log, **k):
            out = step(*a, **k)
            e = next(e for e in log if e["round"] == k["t"])
            e["down_bits"] = np.asarray(out[1])
            e["up_bits"] = np.asarray(out[2])
            return out

        sim.planner.plan = plan_rec
        setattr(sim.executor, step_name, step_rec)
        sims[name] = (sim, log)
    # what the port's ranks start from (the initial vector and the static
    # importance and upload ratios), before any run
    init = {name: {"flat0": np.asarray(sim.flat0), "state": {
        k: np.asarray(getattr(sim.caesar_state, k))
        for k in ("importance", "upload_ratio")}}
        for name, (sim, _) in sims.items()}
    with open(init_out + ".tmp", "wb") as f:
        pickle.dump(init, f)
    os.replace(init_out + ".tmp", init_out)
    for name, (sim, log) in sims.items():
        h = sim.run()
        res[name] = {"log": log, "global": np.asarray(sim.global_flat),
                     **init[name],
                     "history": {k: list(getattr(h, k)) for k in (
                         "rounds", "sim_time", "traffic_bits", "accuracy",
                         "waiting", "waiting_per_round")}}
    caesar = CaesarConfig(**caesar_kw)
    refusals = {
        "multi_host_alone": dict(sharded=False),
        "wire": dict(wire="loopback"),
        "diurnal": dict(availability=AvailabilityConfig(kind="diurnal")),
        "indivisible": dict(n_clients=10),
        "cohort": dict(participation=0.25)}
    for name, over in refusals.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                Simulator(dataclasses.replace(base, caesar=caesar, **over))
                got = None
            except Exception as e:
                got = (type(e).__name__, str(e))
        res["refuse_" + name] = {"raised": got, "warnings": [
            str(w.message) for w in caught
            if issubclass(w.category, UserWarning)
            and "sharded mode" in str(w.message)]}
    with open(out, "wb") as f:
        pickle.dump(res, f)
""")


def _cfg(mode: str, **over) -> TSIM.SimConfig:
    m = dict(MODES[mode])
    ckw = dict(CAESAR, use_error_feedback=m.pop("use_error_feedback", False))
    return TSIM.SimConfig(device="cpu", caesar=TCaesar(**ckw),
                          **{**CFG, **m, **over})


def _spawn_ranks(start: dict, d) -> list:
    """The port's world of WORLD ranks from the reference's initial vector
    and importance (``start``: mode -> {"flat0", "state"})."""
    init = from_reference(start["ragged"]["flat0"], "cnn_har").numpy()
    cases = {m: (_cfg(m, sharded=True, multi_host=True), init,
                 start[m]["state"]) for m in MODES}
    cases["bf16"] = (_cfg("ragged", sharded=True,
                          buffer_dtype="bfloat16"), init, None)
    cases["capped"] = (_cfg("ragged", sharded=True, state_capacity=8,
                            state_offload="host"), init,
                       start["ragged"]["state"])
    refusals = {"refuse_indivisible": _cfg("ragged", sharded=True,
                                           n_clients=10),
                "refuse_cohort": _cfg("ragged", sharded=True,
                                      participation=0.25)}
    MESH.spawn(RK.sim_rank, WORLD,
               (WORLD, str(d / "pg"), str(d / "out"), cases, refusals,
                RESUME),
               timeout_s=SPAWN_TIMEOUT_S)
    return RK.load(str(d / "out"), WORLD)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the reference's results, every rank's), computed once for the
    module: the reference's subprocess writes each mode's initial vector
    and importance before its runs, and the port's ranks run from them
    while it runs."""
    d = tmp_path_factory.mktemp("world")
    out, init_out = d / "ref.pkl", d / "init.pkl"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE,
         json.dumps([CFG, CAESAR, MODES, str(out), str(init_out)])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        deadline = time.monotonic() + REFERENCE_TIMEOUT_S
        while not init_out.exists() and proc.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        if not init_out.exists():
            proc.kill()
            stdout, stderr = proc.communicate()
            pytest.fail("the reference wrote no initial state: "
                        + stdout + stderr)
        with open(init_out, "rb") as f:
            ranks = _spawn_ranks(pickle.load(f), d)
        stdout, stderr = proc.communicate(timeout=REFERENCE_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stdout + stderr
    with open(out, "rb") as f:
        return pickle.load(f), ranks


@pytest.fixture(scope="module")
def reference(world):
    return world[0]


@pytest.fixture(scope="module")
def ranks(world):
    return world[1]


def _flip_bits(rl, pl, scheme_bits=TOPK_ELEMENT_BITS):
    """Per round: (flips, |bits| difference) between the reference's and
    the port's per-participant payloads."""
    out = []
    for a, b in zip(rl, pl):
        dd = np.abs(b["down_bits"] - a["down_bits"])
        du = np.abs(b["up_bits"] - a["up_bits"])
        flips = dd.sum() / HYBRID_ELEMENT_BITS + du.sum() / scheme_bits
        assert flips == int(flips), "a payload differs by other than " \
            "whole elements"
        out.append((int(flips), float(dd.sum() + du.sum())))
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_participants_plans_and_time_exact(reference, ranks, mode):
    ref, port = reference[mode], ranks[0][mode]
    assert len(ref["log"]) == len(port["round_log"]) == CFG["rounds"]
    for a, b in zip(ref["log"], port["round_log"]):
        assert a["round"] == b["round"]
        np.testing.assert_array_equal(b["parts"], a["parts"])
        for x, k in zip(a["plan"], ("theta_d", "theta_u", "batch", "taus")):
            np.testing.assert_array_equal(b[k], x, err_msg=k)
    for k in ("rounds", "sim_time", "waiting", "waiting_per_round"):
        assert port["history"][k] == ref["history"][k], k
    # each shard drew its 2 participants from its own 6 clients
    for e in port["round_log"]:
        assert (np.bincount(e["parts"] // 6, minlength=WORLD) == 2).all()


@pytest.mark.parametrize("mode", list(MODES))
def test_traffic_global_and_accuracy(reference, ranks, mode):
    ref, port = reference[mode], ranks[0][mode]
    per_round = _flip_bits(ref["log"], port["round_log"])
    bits_so_far = np.cumsum([b for _, b in per_round])
    diff = np.abs(np.asarray(port["history"]["traffic_bits"])
                  - np.asarray(ref["history"]["traffic_bits"]))
    evals = [r - 1 for r in ref["history"]["rounds"]]
    assert (diff <= bits_so_far[evals]).all()
    flips = sum(f for f, _ in per_round)
    a = ref["global"]
    d = port["global"] - a
    rest = np.delete(d, np.argsort(-np.abs(d))[:flips])
    assert np.linalg.norm(rest) / np.linalg.norm(a) <= GLOBAL_REL_L2
    np.testing.assert_allclose(port["history"]["accuracy"],
                               ref["history"]["accuracy"], atol=ACC_TOL,
                               rtol=0)


@pytest.mark.parametrize("mode", list(MODES) + ["bf16"])
def test_every_rank_agrees_and_holds_its_segment(ranks, mode):
    first = ranks[0][mode]
    ef = mode == "ef"
    for r, res in enumerate(ranks):
        got = res[mode]
        assert got["history"] == first["history"]
        assert np.array_equal(got["global"], first["global"])
        assert np.isfinite(got["global"]).all()
        for a, b in zip(got["round_log"], first["round_log"]):
            for k in a:
                assert np.array_equal(a[k], b[k]), k
        assert (got["n_dev"], got["p_shard"]) == (WORLD, 2)
        cap = got["cap_per_shard"]
        assert got["pool_shape"] == (cap, first["global"].size)
        assert got["row0"] == r * cap
        assert got["ef_shape"] == (cap, first["global"].size if ef else 0)
        assert got["launches"] == first["launches"]
        assert got["launches"]["recover"] > 0
    assert first["pool_dtype"] == ("torch.bfloat16" if mode == "bf16"
                                   else "torch.float32")
    assert first["state_pool"].shape == (WORLD * first["cap_per_shard"],
                                         first["global"].size)
    for res in ranks[1:]:
        assert np.array_equal(res[mode]["state_pool"], first["state_pool"])


def test_capped_pool_with_offload_pages_exactly(ranks):
    """A pool of 8 rows (2 per shard: every round evicts, and each rank
    gathers its victims' rows from the others) with host offload equals
    the uncapped run bit for bit on every rank."""
    for res in ranks:
        got, want = res["capped"], res["ragged"]
        assert got["cap_per_shard"] == 2 and got["pool_shape"][0] == 2
        assert np.array_equal(got["global"], want["global"])
        assert got["history"] == want["history"]
        assert got["evictions"] > 0 and got["restores"]["offload"] > 0


def test_resume_places_each_rank_its_segment(ranks):
    """state_dict after round 2 of the capped run (the pool gathered from
    every rank, the offloaded rows) into a fresh simulator on every rank
    (each takes its own segment back), run on to round 4: bit-identical
    to the straight run."""
    for res in ranks:
        got, want = res["resume"], res[RESUME[0]]
        assert got["pool_shape"] == want["pool_shape"]
        assert np.array_equal(got["global"], want["global"])
        assert got["history"]["sim_time"] == \
            want["history"]["sim_time"][RESUME[1] // CFG["eval_every"]:]


@pytest.mark.parametrize("name,over", [
    ("multi_host_alone", dict(multi_host=True)),
    ("wire", dict(sharded=True, wire="loopback")),
    ("diurnal", dict(sharded=True, availability=TSIM.AvailabilityConfig(
        kind="diurnal"))),
])
def test_refusals_match_the_reference(reference, name, over):
    with pytest.raises(Exception) as e:
        TSIM.Simulator(_cfg("ragged", **over))
    assert (type(e.value).__name__, str(e.value)) == \
        reference["refuse_" + name]["raised"]


@pytest.mark.parametrize("name", ["indivisible", "cohort"])
def test_world_dependent_refusals_match_the_reference(reference, ranks,
                                                      name):
    want = reference["refuse_" + name]
    for res in ranks:
        got = res["refuse_" + name]
        assert got["raised"] == want["raised"]
        assert [w for w in got["warnings"] if "sharded mode" in w] == \
            want["warnings"]
    if name == "cohort":
        assert want["raised"] is None and len(want["warnings"]) == 1
