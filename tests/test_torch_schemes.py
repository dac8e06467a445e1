"""The baseline schemes (FedAvg, FIC, CAC, FlexCom, ProWD, PyramidFL) and the
cifar10 path of repro_torch's Simulator against the reference's, both
started from the reference's initial vector, the reference at
backend="jnp".

HAR fast config (12 clients, participation 0.25, data_scale 0.2, τ=2,
b_max=8, 3 rounds) for each scheme at seeds 0 and 1. Exact: participants,
plans (θ_d, θ_u, batch, τ), sim_time and waiting (the Eq.-7 model sees
only plans). PyramidFL's plans rank by the previous rounds' gradient
norms, which the two frameworks compute to f32 rounding, so its plans are
exact only while no two participants' norms tie within that rounding (none
do at these seeds). Within tolerances, with their reasons:
* traffic: rtol 1e-5 — upload thresholds are bin edges of deltas that
  differ by f32 rounding, so an element on an edge may flip;
* final global vector: relative L2 ≤ 1e-5 — f32 rounding of the two
  frameworks' convolutions and sums over 3 rounds — outside the elements
  whose selection flipped. A flip is an element that sits on its
  threshold's bin edge to within that rounding, so one framework keeps it
  and the other compresses it; it shows as a payload difference of one
  element in one participant's round (64 bits for a top-k upload element,
  31 for a hybrid one) and moves the global vector by about that
  element's magnitude over the cohort. The test counts the flips from the
  per-participant payload bits of both runs and excludes at most that
  many elements (the largest differences); FlexCom at seed 0 has one. Two
  flips that cancel within one payload are not counted, so they fail the
  check rather than pass it;
* accuracy: at most one test sample's argmax may flip (≤ 1/n_eval).

Also exact: the plans of FIC and CAC with ``fic_down_only`` /
``fic_up_only`` (planned from the same draws and snapshots), and
`History.to_target` on one series. Within the port, pipelined and
synchronous runs of PyramidFL (planned on the main thread after the worker
gathered) are bit-identical.

cifar10 (the paper's dataset, the reference's default model cnn_cifar,
ResNet-18 at width 16: 699,066 parameters): 8 clients, participation 0.25,
data_scale 0.01, τ=1, b_max=4, 2 rounds, for caesar and prowd, with the
same exact checks and tolerances.

The reference's runs are computed once for the module, each on a thread
of its own (`references`); the port's run in each case's fixture.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.caesar import CaesarConfig as RCaesar  # noqa: E402
from repro.fl import simulation as RSIM  # noqa: E402
from repro_torch.core.caesar import CaesarConfig as TCaesar  # noqa: E402
from repro_torch.fl import simulation as TSIM  # noqa: E402
from repro_torch.models.paper_models import from_reference  # noqa: E402

SCHEMES = ["fedavg", "fic", "cac", "flexcom", "prowd", "pyramidfl"]
HAR = dict(dataset="har", n_clients=12, participation=0.25, rounds=3,
           data_scale=0.2, eval_every=1)
HAR_CAESAR = dict(tau=2, b_max=8)
CIFAR = dict(dataset="cifar10", n_clients=8, participation=0.25, rounds=2,
             data_scale=0.01, eval_every=1)
CIFAR_CAESAR = dict(tau=1, b_max=4)
TRAFFIC_RTOL = 1e-5
GLOBAL_REL_L2 = 1e-5
TOPK_ELEMENT_BITS = 64      # index + f32 value of a top-k upload element
HYBRID_ELEMENT_BITS = 31    # f32 value less its 1-bit sign, hybrid payload
REFERENCE_THREADS = 4


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


def _run_reference(kw, ckw, **over):
    sim = RSIM.Simulator(RSIM.SimConfig(backend="jnp", caesar=RCaesar(**ckw),
                                        **kw, **over))
    log = []
    plan, step = sim.planner.plan, sim.executor.step_ragged

    def plan_rec(t, parts, *a):
        out = plan(t, parts, *a)
        log.append({"round": t, "parts": np.array(parts), "plan": out})
        return out

    def step_rec(*a, **k):
        out = step(*a, **k)
        e = next(e for e in log if e["round"] == k["t"])
        e["down_bits"], e["up_bits"] = np.asarray(out[1]), np.asarray(out[2])
        return out

    sim.planner.plan = plan_rec
    sim.executor.step_ragged = step_rec
    return sim, sim.run(), log


HAR_CASES = [(scheme, seed) for seed in (0, 1) for scheme in SCHEMES]
CIFAR_CASES = ["caesar", "prowd"]


@pytest.fixture(scope="module")
def references():
    """Every case's reference run, computed once for the module, each on a
    thread of its own: {(dataset, scheme, seed): (sim, History, log)}."""
    jobs = {("har", s, seed): (HAR, HAR_CAESAR, s, seed)
            for s, seed in HAR_CASES}
    jobs.update({("cifar10", s, 0): (CIFAR, CIFAR_CAESAR, s, 0)
                 for s in CIFAR_CASES})
    with concurrent.futures.ThreadPoolExecutor(REFERENCE_THREADS) as ex:
        futures = {k: ex.submit(_run_reference, kw, ckw, scheme=s, seed=seed)
                   for k, (kw, ckw, s, seed) in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def _pair(reference, kw, ckw, model, **over):
    ref, rh, rlog = reference
    port = TSIM.Simulator(
        TSIM.SimConfig(device="cpu", caesar=TCaesar(**ckw), **kw, **over),
        init_flat=from_reference(np.asarray(ref.flat0), model))
    return ref, rh, rlog, port, port.run()


@pytest.fixture(scope="module", params=HAR_CASES,
                ids=lambda p: f"{p[0]}-seed{p[1]}")
def har_runs(request, references):
    scheme, seed = request.param
    return _pair(references[("har", scheme, seed)], HAR, HAR_CAESAR,
                 "cnn_har", scheme=scheme, seed=seed)


@pytest.fixture(scope="module", params=CIFAR_CASES)
def cifar_runs(request, references):
    return _pair(references[("cifar10", request.param, 0)], CIFAR,
                 CIFAR_CAESAR, "cnn_cifar", scheme=request.param, seed=0)


def _check_plans(rlog, port, rounds):
    assert len(rlog) == len(port.round_log) == rounds
    for a, b in zip(rlog, port.round_log):
        assert a["round"] == b["round"]
        np.testing.assert_array_equal(b["parts"], a["parts"])
        for x, k in zip(a["plan"], ("theta_d", "theta_u", "batch", "taus")):
            np.testing.assert_array_equal(b[k], np.asarray(x), err_msg=k)


def _check_time(rh, ph):
    assert ph.sim_time == rh.sim_time
    assert ph.waiting == rh.waiting
    assert ph.waiting_per_round == rh.waiting_per_round


def _flips(rlog, port) -> int:
    """Selection flips between the two runs, counted from each participant's
    download (hybrid) and upload (top-k, or hybrid for ProWD) payload."""
    up_bits = (HYBRID_ELEMENT_BITS if port.cfg.scheme == "prowd"
               else TOPK_ELEMENT_BITS)
    n = 0.0
    for a, b in zip(rlog, port.round_log):
        n += (np.abs(b["down_bits"] - a["down_bits"]).sum()
              / HYBRID_ELEMENT_BITS)
        n += np.abs(b["up_bits"] - a["up_bits"]).sum() / up_bits
    assert n == int(n), "a payload differs by other than whole elements"
    return int(n)


def _check_tolerances(ref, rh, rlog, port, ph):
    np.testing.assert_allclose(ph.traffic_bits, rh.traffic_bits,
                               rtol=TRAFFIC_RTOL)
    a = np.asarray(ref.global_flat)
    d = port.global_flat.numpy() - a
    flipped = np.argsort(-np.abs(d))[:_flips(rlog, port)]
    rest = np.delete(d, flipped)
    assert np.linalg.norm(rest) / np.linalg.norm(a) <= GLOBAL_REL_L2
    n_eval = min(ref.cfg.eval_samples, len(ref.data.y_test))
    np.testing.assert_allclose(ph.accuracy, rh.accuracy, atol=1.0 / n_eval,
                               rtol=0)


def test_participants_and_plans_identical(har_runs):
    _, _, rlog, port, _ = har_runs
    _check_plans(rlog, port, HAR["rounds"])


def test_time_model_identical(har_runs):
    _, rh, _, _, ph = har_runs
    _check_time(rh, ph)


def test_traffic_global_and_accuracy_within_tolerance(har_runs):
    ref, rh, rlog, port, ph = har_runs
    _check_tolerances(ref, rh, rlog, port, ph)


def test_kernel_launches_follow_the_scheme(har_runs):
    """Recover only for Caesar, a second compress per chunk only for ProWD
    (the executor's launch arithmetic, read by chip_smoke.py)."""
    _, _, _, port, _ = har_runs
    ex = port.executor
    want = {"magnitude_histogram": ex.rounds + ex.chunk_calls,
            "hybrid_compress": ex.chunk_calls * (
                2 if port.cfg.scheme == "prowd" else 1),
            "recover": 0}
    assert ex.rounds == HAR["rounds"] and ex.chunk_calls > 0
    assert ex.kernel_launches() == want


def test_cifar10_plans_and_time_identical(cifar_runs):
    _, rh, rlog, port, ph = cifar_runs
    assert port.n_params == 699066
    _check_plans(rlog, port, CIFAR["rounds"])
    _check_time(rh, ph)


def test_cifar10_traffic_global_and_accuracy_within_tolerance(cifar_runs):
    ref, rh, rlog, port, ph = cifar_runs
    _check_tolerances(ref, rh, rlog, port, ph)


@pytest.mark.parametrize("scheme,flag", [
    ("fic", "fic_down_only"), ("fic", "fic_up_only"),
    ("cac", "fic_down_only"), ("cac", "fic_up_only")])
def test_one_direction_variants_plan_identically(scheme, flag):
    kw = dict(HAR, scheme=scheme, seed=1, **{flag: True})
    ref = RSIM.Simulator(RSIM.SimConfig(backend="jnp",
                                        caesar=RCaesar(**HAR_CAESAR), **kw))
    port = TSIM.Simulator(TSIM.SimConfig(device="cpu",
                                         caesar=TCaesar(**HAR_CAESAR), **kw))
    off = "theta_u" if flag == "fic_down_only" else "theta_d"
    for t in range(1, 4):
        parts = ref._select_participants(ref._round_rng(t), t)[0]
        np.testing.assert_array_equal(
            port._select_participants(port._round_rng(t), t)[0], parts)
        snap = ref.cap.snapshot(t)
        a = ref.planner.plan(t, parts, *snap)
        b = port.planner.plan(t, parts, *port.cap.snapshot(t))
        for x, y, k in zip(a, b, ("theta_d", "theta_u", "batch", "taus")):
            np.testing.assert_array_equal(y, np.asarray(x), err_msg=k)
            assert np.asarray(y).dtype == np.asarray(x).dtype
        assert not b[("theta_d", "theta_u").index(off)].any()


def test_history_to_target_matches_reference():
    series = dict(rounds=[2, 4, 6, 8], sim_time=[10.0, 25.5, 31.0, 50.0],
                  traffic_bits=[8e9, 2.4e10, 3.1e10, 4e10],
                  accuracy=[0.2, 0.45, 0.41, 0.6])
    a, b = RSIM.History(**series), TSIM.History(**series)
    for target in (0.0, 0.2, 0.3, 0.45, 0.5, 0.6, 0.61):
        assert b.to_target(target) == a.to_target(target)


def test_pyramidfl_pipelined_equals_synchronous_bit_for_bit():
    runs = []
    for pipelined in (True, False):
        sim = TSIM.Simulator(TSIM.SimConfig(
            device="cpu", scheme="pyramidfl", seed=0, pipelined=pipelined,
            caesar=TCaesar(**HAR_CAESAR), **HAR))
        runs.append((sim, sim.run()))
    (sp, hp), (ss, hs) = runs
    assert torch.equal(sp.global_flat, ss.global_flat)
    assert hp.traffic_bits == hs.traffic_bits
    assert hp.accuracy == hs.accuracy and hp.sim_time == hs.sim_time
    for a, b in zip(sp.round_log, ss.round_log):
        np.testing.assert_array_equal(a["taus"], b["taus"])
        np.testing.assert_array_equal(a["theta_u"], b["theta_u"])
    # PyramidFL's τ follows the participants' speed: more than one tier
    assert any(len(set(e["taus"].tolist())) > 1 for e in sp.round_log)


def test_unknown_scheme_raises():
    with pytest.raises(ValueError, match="scheme"):
        TSIM.Simulator(TSIM.SimConfig(device="cpu", scheme="nope", **HAR))


def test_default_config_is_cifar10_and_needs_a_card():
    """`Simulator(SimConfig())` builds the cifar10/cnn_cifar point; without
    a card it raises (no CPU fallback), with device="cpu" it constructs."""
    cfg = TSIM.SimConfig()
    assert cfg.dataset == "cifar10" and cfg.device == "cuda"
    small = dataclasses.replace(cfg, data_scale=0.01, device="cpu")
    sim = TSIM.Simulator(small)
    assert sim.n_params == 699066 and sim.executor.chunk == 8
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-fallback rule is "
                    "checked where there is none")
    with pytest.raises(RuntimeError, match="cuda"):
        TSIM.Simulator(cfg)
