"""The wire-boundary round of repro_torch (`Simulator._wire_round`,
`RoundExecutor.step_ragged_deferred`) within the port and against the
reference, on the reference's fig11 smoke point (oppo_ts, ``n_features``
64 → lr, 12 clients, participation 0.5, τ 2, b_max 8, EF on, 8 rounds),
the reference at backend="jnp", both from the reference's initial vector.

* fig11's bit-identity gate in the port: zero faults through the loopback
  (and the multiprocessing queue) wire equal the in-process engine bit for
  bit — accuracy, traffic, sim_time and the global vector;
* port vs reference with dropout, stragglers (discarded and deferred),
  corruption and a sign-flip adversary, under every aggregation: the fault
  log (status, attackers, corrupted first transmissions, aggregated /
  deferred / CRC-dropped counts) and sim_time EXACT; serialized wire bytes
  and traffic rtol 1e-5 (a top-k element on its bin edge may flip, as in
  tests/test_torch_schemes.py); the global vector within relative L2 1e-5;
* fig11's robustness gate in the port: a 10% sign-flip adversary moves the
  mean aggregate at least 1.0 (relative to the fault-free global) while
  trimmed_mean stays within 0.8 and within 0.02 of the fault-free accuracy;
* fig11's soak gate on the port's queue transport: two producer processes
  against a queue bounded at 8 deliver what they report, every payload
  decodes, and at most half are rejected.
"""
import dataclasses
import multiprocessing as mp
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.caesar import CaesarConfig as RCaesar  # noqa: E402
from repro.fl import faults as R_F  # noqa: E402
from repro.fl import simulation as RSIM  # noqa: E402
from repro_torch.core import rng as T_RNG  # noqa: E402
from repro_torch.core.caesar import CaesarConfig as TCaesar  # noqa: E402
from repro_torch.fl import faults as T_F  # noqa: E402
from repro_torch.fl import robust as T_RB  # noqa: E402
from repro_torch.fl import simulation as TSIM  # noqa: E402
from repro_torch.fl import wire as T_W  # noqa: E402
from repro_torch.models.paper_models import from_reference  # noqa: E402

SMOKE = dict(dataset="oppo_ts", rounds=8, n_clients=12, data_scale=0.01,
             eval_every=4, participation=0.5,
             dataset_kwargs={"n_features": 64})
CAESAR = dict(tau=2, b_max=8, use_error_feedback=True)
GLOBAL_REL_L2 = 1e-5
BYTES_RTOL = 1e-5
# fig11's gates (benchmarks/fig11_faults.py:57,75-77,81)
ATTACK_SCALE = 10.0
MEAN_DEVIATION_MIN = 1.0
ROBUST_DEVIATION_MAX = 0.8
ROBUST_ACC_TOL = 0.02
SOAK_REJECT_MAX = 0.5
FAULTS = dict(dropout_rate=0.15, straggler_deadline=1.3, corrupt_rate=0.3,
              byzantine_frac=0.2, attack="sign_flip",
              attack_scale=ATTACK_SCALE)


def _port(init=None, **over):
    cfg = TSIM.SimConfig(device="cpu", caesar=TCaesar(**CAESAR), **SMOKE)
    return TSIM.Simulator(dataclasses.replace(cfg, **over), init_flat=init)


def _init(ref):
    return from_reference(np.asarray(ref.flat0), "lr",
                          n_classes=ref.data.n_classes,
                          n_features=ref.data.x_train.shape[-1])


@pytest.mark.parametrize("wire", ["loopback", "queue"])
def test_zero_fault_wire_is_bit_identical_to_inproc(wire):
    s0 = _port(wire="inproc")
    h0 = s0.run()
    s1 = _port(wire=wire)
    h1 = s1.run()
    assert h0.accuracy == h1.accuracy
    assert h0.traffic_bits == h1.traffic_bits
    assert h0.sim_time == h1.sim_time
    assert s0.global_flat.numpy().tobytes() == \
        s1.global_flat.numpy().tobytes()
    assert s0.ef_flat.numpy().tobytes() == s1.ef_flat.numpy().tobytes()
    assert h1.wire_bits and h1.wire_bits[-1] > 0 and not h0.wire_bits
    # every upload went over the wire once, priced at its exact size
    for e in s1.fault_log:
        assert e["n_aggregated"] == len(e["parts"])
        assert e["n_crc_dropped"] == 0


@pytest.fixture(scope="module", params=list(T_RB.AGGREGATIONS))
def fault_runs(request):
    agg = request.param
    late = "defer" if agg in ("mean", "median") else "discard"
    kw = dict(FAULTS, late_policy=late)
    ref = RSIM.Simulator(RSIM.SimConfig(
        backend="jnp", caesar=RCaesar(**CAESAR), wire="loopback",
        aggregation=agg, faults=R_F.FaultConfig(**kw), **SMOKE))
    rh = ref.run()
    port = _port(_init(ref), wire="loopback", aggregation=agg,
                 faults=T_F.FaultConfig(**kw))
    return ref, rh, port, port.run()


def test_fault_log_and_time_identical(fault_runs):
    ref, rh, port, ph = fault_runs
    assert len(port.fault_log) == len(ref.fault_log) == SMOKE["rounds"]
    seen = set()
    for a, b in zip(ref.fault_log, port.fault_log):
        for k in ("parts", "status", "byz", "corrupt_first"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        for k in ("n_aggregated", "n_deferred_in", "n_deferred_out",
                  "n_crc_dropped"):
            assert b[k] == a[k], k
        np.testing.assert_allclose(b["wire_bytes"], a["wire_bytes"],
                                   rtol=BYTES_RTOL)
        seen |= set(np.unique(b["status"]).tolist())
        seen |= {"byz"} if b["byz"].any() else set()
        seen |= {"corrupt"} if b["corrupt_first"].any() else set()
    # the config exercises every fault kind over the run
    assert {T_F.OK, T_F.DROP, T_F.LATE, "byz", "corrupt"} <= seen
    assert ph.sim_time == rh.sim_time and ph.waiting == rh.waiting
    np.testing.assert_allclose(ph.traffic_bits, rh.traffic_bits,
                               rtol=BYTES_RTOL)
    np.testing.assert_allclose(ph.wire_bits, rh.wire_bits, rtol=BYTES_RTOL)
    assert [e["staleness"] for e in port.avail_log] == \
        [e["staleness"] for e in ref.avail_log]


def test_faulty_global_matches_reference(fault_runs):
    ref, rh, port, ph = fault_runs
    g, r = port.global_flat.numpy(), np.asarray(ref.global_flat)
    assert np.isfinite(g).all()
    assert float(np.linalg.norm(g - r) / np.linalg.norm(r)) <= GLOBAL_REL_L2


def test_robust_aggregation_gate():
    def final(aggregation, byz):
        sim = _port(wire="loopback", aggregation=aggregation,
                    faults=T_F.FaultConfig(byzantine_frac=byz,
                                           attack="sign_flip",
                                           attack_scale=ATTACK_SCALE))
        h = sim.run()
        return sim.global_flat.numpy(), h.accuracy[-1]

    g_clean, acc_clean = final("mean", 0.0)
    g_mean, _ = final("mean", 0.1)
    g_trim, acc_trim = final("trimmed_mean", 0.1)
    ref = float(np.linalg.norm(g_clean))
    assert float(np.linalg.norm(g_mean - g_clean)) / ref >= \
        MEAN_DEVIATION_MIN
    assert float(np.linalg.norm(g_trim - g_clean)) / ref <= \
        ROBUST_DEVIATION_MAX
    assert acc_trim >= acc_clean - ROBUST_ACC_TOL


_DONE = b"SOAK-DONE:"


def _soak_producer(queue, results, producer_id: int, n_uploads: int,
                   n_params: int, k: int):
    """One soak producer (a spawned process): offer ``n_uploads`` payloads
    to the bounded queue with backoff, then a blocking sentinel."""
    tr = T_W.QueueTransport.attach(queue)
    rng = T_RNG.stream(4321, T_RNG.KIND_FAULTS, 1, producer_id)
    delivered = rejected = 0
    for seq in range(n_uploads):
        idx = rng.choice(n_params, size=k, replace=False).astype(np.int64)
        vals = rng.normal(0.0, 1e-2, size=k).astype(np.float32)
        payload = T_W.encode_upload(idx, vals, client=producer_id,
                                    round_=seq, n_params=n_params)
        ok, _retries, _waited = T_W.send_with_backoff(tr, payload)
        delivered += ok
        rejected += not ok
    queue.put(_DONE + str(producer_id).encode())
    results.put({"delivered": delivered, "rejected": rejected})


def test_soak_gate():
    n_prod, per, n_params = 2, 48, 1 << 13
    k = max(1, round(0.01 * n_params))
    ctx = mp.get_context("spawn")
    tr = T_W.QueueTransport(ctx=ctx, maxsize=8)
    results = ctx.Queue()
    procs = [ctx.Process(target=_soak_producer,
                         args=(tr.queue, results, i, per, n_params, k))
             for i in range(n_prod)]
    for p in procs:
        p.start()
    payloads, done = [], 0
    t0 = time.monotonic()
    try:
        while done < n_prod:
            payload = tr.get(timeout=120)
            if payload.startswith(_DONE):
                done += 1
            else:
                payloads.append(payload)
        stats = [results.get(timeout=60) for _ in range(n_prod)]
    finally:
        for p in procs:
            p.join(timeout=60)
    assert all(not p.is_alive() for p in procs)
    assert time.monotonic() - t0 < 240
    tr.close()
    delivered = sum(s["delivered"] for s in stats)
    rejected = sum(s["rejected"] for s in stats)
    agg = T_RB.make_aggregator("mean", cohort=max(3, len(payloads)),
                               device="cpu")
    _delta, n_ok, n_bad = T_RB.decode_and_aggregate(payloads, n_params, agg)
    assert len(payloads) == delivered
    assert n_bad == 0 and n_ok == delivered
    assert rejected / (n_prod * per) <= SOAK_REJECT_MAX
