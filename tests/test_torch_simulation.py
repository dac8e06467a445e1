"""The slice as a whole: repro_torch's Simulator against the reference's on
the fast HAR config (12 clients, participation 0.25, data_scale 0.2, τ=2,
b_max=8, 3 rounds), the reference at backend="jnp", both started from the
reference's initial vector.

Exact: participants, plans (θ_d, θ_u, batch, τ), sim_time and waiting (the
Eq.-7 model sees only plans), and round-1 download bits (histogram of the
identical initial vector). Within tolerances, with their reasons:
* traffic: rtol 1e-5 — from round 1 on, upload thresholds are bin edges of
  deltas that differ by f32 rounding (measured exact at seeds 1 and 2);
* final global vector: relative L2 ≤ 1e-5 — f32 rounding of the two
  frameworks' convolutions and sums over 3 rounds (measured 1.2e-7);
* accuracy: at most one test sample's argmax may flip (≤ 1/n_eval).

The slice runs seeds 0 and 1. Seed 0 holds two 8-sample clients whose
importances tie in exact arithmetic; they used to swap θ_u ranks because
the port summed the KL terms in another order than XLA. With the KL sum a
left fold (core/importance.py) their plans and sim_time are identical too.

Within the port, the pipelined and synchronous loops are bit-identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.caesar import CaesarConfig as RCaesar  # noqa: E402
from repro.fl import simulation as RSIM  # noqa: E402
from repro_torch.core.caesar import CaesarConfig as TCaesar  # noqa: E402
from repro_torch.fl import simulation as TSIM  # noqa: E402
from repro_torch.models.paper_models import from_reference  # noqa: E402

KW = dict(dataset="har", n_clients=12, participation=0.25, rounds=3,
          data_scale=0.2, eval_every=1)


def _run_reference(seed):
    sim = RSIM.Simulator(RSIM.SimConfig(backend="jnp", seed=seed,
                                        caesar=RCaesar(tau=2, b_max=8), **KW))
    log = []
    plan, step = sim.planner.plan, sim.executor.step_ragged

    def plan_rec(t, parts, *a):
        out = plan(t, parts, *a)
        log.append({"round": t, "parts": np.array(parts), "plan": out})
        return out

    def step_rec(*a, **k):
        out = step(*a, **k)
        next(e for e in log if e["round"] == k["t"])["down_bits"] = out[1]
        return out

    sim.planner.plan = plan_rec
    sim.executor.step_ragged = step_rec
    return sim, sim.run(), log


@pytest.fixture(scope="module", params=[0, 1])
def runs(request):
    ref, rh, rlog = _run_reference(request.param)
    port = TSIM.Simulator(
        TSIM.SimConfig(device="cpu", seed=request.param,
                       caesar=TCaesar(tau=2, b_max=8), **KW),
        init_flat=from_reference(np.asarray(ref.flat0)))
    return ref, rh, rlog, port, port.run()


def test_participants_and_plans_identical(runs):
    _, _, rlog, port, _ = runs
    assert len(rlog) == len(port.round_log) == KW["rounds"]
    for a, b in zip(rlog, port.round_log):
        assert a["round"] == b["round"]
        np.testing.assert_array_equal(b["parts"], a["parts"])
        for x, k in zip(a["plan"], ("theta_d", "theta_u", "batch", "taus")):
            np.testing.assert_array_equal(b[k], np.asarray(x), err_msg=k)


def test_time_model_identical_and_round1_download_exact(runs):
    _, rh, rlog, port, ph = runs
    assert ph.sim_time == rh.sim_time
    assert ph.waiting == rh.waiting
    assert ph.waiting_per_round == rh.waiting_per_round
    np.testing.assert_array_equal(port.round_log[0]["down_bits"],
                                  np.asarray(rlog[0]["down_bits"]))


def test_traffic_global_and_accuracy_within_tolerance(runs):
    ref, rh, _, port, ph = runs
    np.testing.assert_allclose(ph.traffic_bits, rh.traffic_bits, rtol=1e-5)
    a = np.asarray(ref.global_flat)
    b = port.global_flat.numpy()
    assert np.linalg.norm(b - a) / np.linalg.norm(a) <= 1e-5
    n_eval = min(ref.cfg.eval_samples, len(ref.data.y_test))
    np.testing.assert_allclose(ph.accuracy, rh.accuracy, atol=1.0 / n_eval,
                               rtol=0)


def test_pipelined_equals_synchronous_bit_for_bit(runs):
    _, _, _, port, ph = runs
    sync = TSIM.Simulator(dataclasses.replace(port.cfg, pipelined=False),
                          init_flat=port.flat0)
    sh = sync.run()
    assert torch.equal(sync.global_flat, port.global_flat)
    assert sh.traffic_bits == ph.traffic_bits
    assert sh.accuracy == ph.accuracy and sh.sim_time == ph.sim_time
    assert torch.equal(sync.store.pool, port.store.pool)
