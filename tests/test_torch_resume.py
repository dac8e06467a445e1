"""The capped client-state pool and checkpoint/resume of the port's
Simulator.

* Capped runs (state_capacity 4 for 12 clients, a cohort of 3, every
  offload kind) against the reference Simulator (backend="jnp") from the reference's
  initial vector: the same evictions and restores; sim_time and waiting
  identical; traffic rtol 1e-5, the global vector within relative L2 1e-5
  and accuracy within one test sample — the rules of
  tests/test_torch_simulation.py (f32 rounding of the two frameworks'
  convolutions; a centroid restore carries the same rounding).
* Exact paging: capped host/memmap runs equal the dense run bit for bit.
* Resume: a checkpoint through `CheckpointManager` after round k, loaded
  into a fresh Simulator and run from k + 1, replays the straight port run
  bit for bit — in process with a capped, offloaded pool, and through the
  loopback wire with faults (deferred uploads crossing the cut) and
  diurnal availability, as tests/test_faults.py's resume cases.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.caesar import CaesarConfig as RCaesar  # noqa: E402
from repro.fl import simulation as RSIM  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.core.caesar import CaesarConfig as TCaesar  # noqa: E402
from repro_torch.fl import simulation as TSIM  # noqa: E402
from repro_torch.models.paper_models import from_reference  # noqa: E402

KW = dict(dataset="har", rounds=4, n_clients=12, data_scale=0.2,
          participation=0.25, seed=1, eval_every=2)
CAP = 4


def _port(**kw):
    return TSIM.Simulator(TSIM.SimConfig(
        device="cpu", caesar=TCaesar(tau=2, b_max=8), **{**KW, **kw}))


@pytest.fixture(scope="module")
def dense():
    sim = _port(state_capacity=0)
    return sim, sim.run()


@pytest.mark.parametrize("offload", ["none", "host", "memmap"])
def test_capped_run_matches_reference(tmp_path, offload):
    (tmp_path / "ref").mkdir()
    ref = RSIM.Simulator(RSIM.SimConfig(
        backend="jnp", caesar=RCaesar(tau=2, b_max=8), state_capacity=CAP,
        state_offload=offload, state_dir=str(tmp_path / "ref"), **KW))
    rh = ref.run()
    port = TSIM.Simulator(
        TSIM.SimConfig(device="cpu", caesar=TCaesar(tau=2, b_max=8),
                       state_capacity=CAP, state_offload=offload,
                       state_dir=str(tmp_path / "port"), **KW),
        init_flat=from_reference(np.asarray(ref.flat0)))
    ph = port.run()
    rt, pt = ref.store.telemetry(), port.store.telemetry()
    assert pt["evictions"] == rt["evictions"] > 0
    assert pt["restores"] == rt["restores"]
    assert pt["offloaded"] == rt["offloaded"]
    np.testing.assert_array_equal(port.store.slot_of, ref.store.slot_of)
    np.testing.assert_array_equal(port.store.evicted_tier,
                                  ref.store.evicted_tier)
    assert ph.sim_time == rh.sim_time and ph.waiting == rh.waiting
    np.testing.assert_allclose(ph.traffic_bits, rh.traffic_bits, rtol=1e-5)
    a = np.asarray(ref.global_flat)
    b = port.global_flat.numpy()
    assert np.linalg.norm(b - a) / np.linalg.norm(a) <= 1e-5
    n_eval = min(ref.cfg.eval_samples, len(ref.data.y_test))
    np.testing.assert_allclose(ph.accuracy, rh.accuracy, atol=1.0 / n_eval,
                               rtol=0)
    if offload == "none":
        c = np.asarray(port.store.centroids)
        np.testing.assert_allclose(c, ref.store.centroids, rtol=0,
                                   atol=1e-5 * np.abs(c).max())


@pytest.mark.parametrize("offload", ["host", "memmap"])
def test_offloaded_pool_is_exact_paging(tmp_path, dense, offload):
    dsim, dh = dense
    sim = _port(state_capacity=CAP, state_offload=offload,
                state_dir=str(tmp_path))
    h = sim.run()
    tel = sim.store.telemetry()
    assert tel["evictions"] > 0 and tel["restores"]["offload"] > 0
    assert tel["capacity"] == CAP < tel["registered"]
    assert torch.equal(sim.global_flat, dsim.global_flat)
    assert h.accuracy == dh.accuracy and h.traffic_bits == dh.traffic_bits
    assert h.sim_time == dh.sim_time


def test_centroid_eviction_reports_restore_error(dense):
    sim = _port(state_capacity=CAP, measure_eviction_error=True)
    h = sim.run()
    err = sim.executor.telemetry()["restore_error"]
    tel = sim.store.telemetry()
    assert tel["restores"]["centroid"] == err["count"] > 0
    assert 0.0 < err["mean"] <= err["max"] and np.isfinite(err["max"])
    assert np.isfinite(h.accuracy[-1])


def _resume(tmp_path, cut, straight=None, **kw):
    """(straight run, resumed run): a checkpoint after ``cut`` rounds goes
    through CheckpointManager into a fresh Simulator."""
    if straight is None:
        straight = _port(**kw)
        straight.run()
    first = _port(**{**kw, "rounds": cut})
    first.run()
    snap = first.state_dict()
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(snap, step=cut)
    restored, step = mgr.restore_latest(snap)
    assert step == cut
    resumed = _port(**kw)
    resumed.load_state_dict(restored)
    hist = resumed.run(start_round=cut + 1)
    return straight, resumed, hist, snap


def test_capped_offloaded_resume_replays_bit_for_bit(tmp_path):
    straight, resumed, hist, snap = _resume(
        tmp_path, 2, state_capacity=CAP, state_offload="host")
    assert len(snap["store"]["offload_clients"]) > 0
    assert torch.equal(resumed.global_flat, straight.global_flat)
    assert torch.equal(resumed.store.pool, straight.store.pool)
    np.testing.assert_array_equal(resumed.store.slot_of,
                                  straight.store.slot_of)
    assert hist.rounds == [4]
    sh = straight.round_log
    for a, b in zip(resumed.round_log, sh[2:]):
        np.testing.assert_array_equal(a["parts"], b["parts"])
        np.testing.assert_array_equal(a["theta_d"], b["theta_d"])
        np.testing.assert_array_equal(a["up_bits"], b["up_bits"])
    assert resumed.avail_log == straight.avail_log


def test_start_round_needs_a_loaded_checkpoint():
    sim = _port(rounds=2)
    with pytest.raises(ValueError, match="load_state_dict"):
        sim.run(start_round=2)


DEFER = TSIM.FaultConfig(dropout_rate=0.1, straggler_deadline=1.2,
                         late_policy="defer", corrupt_rate=0.2,
                         byzantine_frac=0.2, attack="sign_flip",
                         attack_scale=5.0)


def test_wire_resume_with_faults_and_availability(tmp_path):
    """Cut between a deferral and its arrival, with diurnal availability:
    the deferred payload crosses the checkpoint and the tail replays the
    availability mask, the fault schedule and the deferred fold."""
    av = TSIM.AvailabilityConfig(kind="diurnal", day_rounds=4, duty=0.6,
                                 flake_rate=0.05)
    kw = dict(wire="loopback", faults=DEFER, availability=av,
              aggregation="trimmed_mean", participation=0.75, rounds=8,
              seed=5, n_clients=12)
    straight = _port(**kw)
    straight.run()
    cut = next(t + 1 for t, e in enumerate(straight.fault_log)
               if e["n_deferred_out"] > 0 and 2 < t + 1 < 8)
    straight, resumed, _, snap = _resume(tmp_path, cut, straight, **kw)
    assert len(snap["deferred"]) > 0
    assert torch.equal(resumed.global_flat, straight.global_flat)
    assert len(resumed.avail_log) == len(straight.avail_log) == 8
    assert resumed.avail_log == straight.avail_log
    assert len(resumed.fault_log) == 8
    for a, b in zip(resumed.fault_log, straight.fault_log):
        for k in ("parts", "status", "byz", "corrupt_first"):
            np.testing.assert_array_equal(a[k], b[k])
        for k in ("n_aggregated", "n_deferred_in", "n_deferred_out",
                  "n_crc_dropped", "wire_bytes"):
            assert a[k] == b[k], k
    assert resumed._wire_bits_cum == straight._wire_bits_cum
    assert resumed._acct == straight._acct


def test_resume_keeps_the_planner_state(tmp_path):
    """The Caesar participation record and gradient norms cross the
    checkpoint (the next round's θ_d depends on them)."""
    _, resumed, _, snap = _resume(tmp_path, 2, rounds=3)
    last = snap["caesar_leaves"][0]
    assert (last > 0).any()
    fresh = _port(rounds=3)
    fresh.load_state_dict(snap)
    assert torch.equal(fresh.caesar_state.last_round,
                       torch.from_numpy(last))
    assert dataclasses.fields(fresh.caesar_state)[0].name == "last_round"
