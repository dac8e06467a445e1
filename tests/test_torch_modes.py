"""The masked engine, error feedback (EF) and the bf16 pool of repro_torch
against the reference's, both started from the reference's initial vector
(the reference at backend="jnp").

Config: the reference's fig11 smoke point (benchmarks/fig11_faults.py:
oppo_ts with ``n_features`` 64 → lr, 130 parameters; 12 clients,
participation 0.5, data_scale 0.01, τ 2, b_max 8, EF on, 8 rounds).
* masked and EF runs vs the reference's: participants, plans, sim_time and
  waiting EXACT; traffic rtol 1e-5; final global vector and EF pool within
  relative L2 1e-5 (f32 rounding of two frameworks over 8 rounds);
* within the port, ragged vs masked at the reference's chunked-parity
  tolerances (benchmarks/fig10_scales.py: accuracy 5e-3 absolute, traffic
  1e-5 relative), on this point and on the HAR fast config;
* stochastic rounding: bf16-representable values are fixed points; the
  mean rounding error over 4096 draws per element is within 4σ/√4096 with
  σ = half a bf16 ulp; the bits are the same on every call with one seed;
* a bf16 pool run vs the reference's bf16 run. Round to nearest even is
  deterministic in both packages: global within relative L2 1e-5. With
  stochastic rounding the two packages draw different noise (the port's
  counter hash vs ``jax.random.bits``), so the two runs are two draws of
  the rounding noise: global within relative L2 1e-2. Measured on the CPU
  after 8 rounds: 4.3e-3 at seed 0 and 3.4e-5–9.2e-4 at seeds 1–3, the
  scale by which one SR run leaves its own f32 run (4.3e-3 for the port
  and 4.6e-5 for the reference at seed 0, 1e-4–9e-4 at seeds 1–3);
* ``caesar_state`` equal (last_round exact, importance and upload ratio as
  in tests/test_torch_planning.py), ``grad_norms`` rtol 2e-5, ``splits``
  exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.caesar import CaesarConfig as RCaesar  # noqa: E402
from repro.fl import simulation as RSIM  # noqa: E402
from repro_torch.core import compression as TC  # noqa: E402
from repro_torch.core.caesar import CaesarConfig as TCaesar  # noqa: E402
from repro_torch.fl import simulation as TSIM  # noqa: E402
from repro_torch.models.paper_models import from_reference  # noqa: E402

SMOKE = dict(dataset="oppo_ts", rounds=8, n_clients=12, data_scale=0.01,
             eval_every=4, participation=0.5,
             dataset_kwargs={"n_features": 64})
SMOKE_CAESAR = dict(tau=2, b_max=8, use_error_feedback=True)
HAR = dict(dataset="har", n_clients=12, participation=0.5, rounds=4,
           data_scale=0.2, eval_every=2)
HAR_CAESAR = dict(tau=2, b_max=8)
GLOBAL_REL_L2 = 1e-5
TRAFFIC_RTOL = 1e-5
PARITY_ACC_TOL = 5e-3        # benchmarks/fig10_scales.py:194
PARITY_TRAFFIC_TOL = 1e-5    # benchmarks/fig10_scales.py:195
SR_GLOBAL_REL_L2 = 1e-2


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _run_reference(kw, ckw, **over):
    sim = RSIM.Simulator(RSIM.SimConfig(backend="jnp", caesar=RCaesar(**ckw),
                                        **kw, **over))
    log = []
    plan = sim.planner.plan

    def plan_rec(t, parts, *a):
        out = plan(t, parts, *a)
        log.append({"round": t, "parts": np.array(parts), "plan": out})
        return out
    sim.planner.plan = plan_rec
    return sim, sim.run(), log


def _run_port(ref, kw, ckw, model, **over):
    port = TSIM.Simulator(
        TSIM.SimConfig(device="cpu", caesar=TCaesar(**ckw), **kw, **over),
        init_flat=from_reference(np.asarray(ref.flat0), model,
                                 **_spec_kw(ref)))
    return port, port.run()


def _spec_kw(ref):
    if ref.cfg.dataset == "oppo_ts":
        return {"n_classes": ref.data.n_classes,
                "n_features": ref.data.x_train.shape[-1]}
    return {}


@pytest.fixture(scope="module", params=["ragged", "masked"])
def ef_runs(request):
    over = {} if request.param == "ragged" else {"ragged": False}
    ref, rh, rlog = _run_reference(SMOKE, SMOKE_CAESAR, **over)
    port, ph = _run_port(ref, SMOKE, SMOKE_CAESAR, "lr", **over)
    return ref, rh, rlog, port, ph


def test_ef_runs_plans_and_time_identical(ef_runs):
    ref, rh, rlog, port, ph = ef_runs
    assert len(rlog) == len(port.round_log) == SMOKE["rounds"]
    for a, b in zip(rlog, port.round_log):
        np.testing.assert_array_equal(b["parts"], a["parts"])
        for x, k in zip(a["plan"], ("theta_d", "theta_u", "batch", "taus")):
            np.testing.assert_array_equal(b[k], np.asarray(x), err_msg=k)
    assert ph.sim_time == rh.sim_time
    assert ph.waiting == rh.waiting
    np.testing.assert_allclose(ph.traffic_bits, rh.traffic_bits,
                               rtol=TRAFFIC_RTOL)


def test_ef_runs_global_and_residuals_match(ef_runs):
    ref, rh, rlog, port, ph = ef_runs
    assert port.executor.ef_width == ref.executor.ef_width == port.n_params
    assert port.executor.chunk == ref.executor.chunk
    assert _rel(port.global_flat.numpy(), ref.global_flat) <= GLOBAL_REL_L2
    r_ef = np.asarray(ref.ef_flat)
    t_ef = port.ef_flat.numpy()
    assert t_ef.shape == r_ef.shape and np.abs(r_ef).sum() > 0
    # the pools hold the same clients in the same slots
    np.testing.assert_array_equal(port.store.slot_of, ref.store.slot_of)
    assert _rel(t_ef, r_ef) <= GLOBAL_REL_L2


@pytest.mark.parametrize("point", ["fig11-smoke", "har"])
def test_port_ragged_vs_masked(point):
    kw, ckw = ((SMOKE, SMOKE_CAESAR) if point == "fig11-smoke"
               else (HAR, HAR_CAESAR))
    runs = {}
    for ragged in (True, False):
        sim = TSIM.Simulator(TSIM.SimConfig(
            device="cpu", ragged=ragged, caesar=TCaesar(**ckw), **kw))
        runs[ragged] = (sim, sim.run())
    (sr, hr), (sm, hm) = runs[True], runs[False]
    assert hr.sim_time == hm.sim_time and hr.waiting == hm.waiting
    assert max(abs(a - b) for a, b in zip(hr.accuracy, hm.accuracy)) \
        <= PARITY_ACC_TOL
    assert abs(hr.traffic_bits[-1] - hm.traffic_bits[-1]) \
        / hr.traffic_bits[-1] <= PARITY_TRAFFIC_TOL
    # the masked engine runs the cap shape in fixed chunks
    assert sm.executor.telemetry()["compiled_tier_shapes"] == 1
    assert sm.executor.kernel_launches()["recover"] == \
        sm.executor.chunk_calls


def test_sr_fixed_points():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 3001)) * 10.0 ** rng.integers(
        -30, 30, (5, 3001))).astype(np.float32)
    x[0, :6] = [0.0, -0.0, np.inf, -np.inf, 1e-40, -3e-39]   # ± zero, denorm
    xb = torch.from_numpy(x).to(torch.bfloat16).float()
    for seed in (0, 1, 2 ** 32 - 1):
        y = TC.stochastic_round_cast(xb, torch.bfloat16, seed)
        assert y.dtype == torch.bfloat16
        assert y.float().numpy().tobytes() == xb.numpy().tobytes()
    # an f32 target is a plain cast
    assert TC.stochastic_round_cast(torch.from_numpy(x), torch.float32,
                                    5).numpy().tobytes() == x.tobytes()


def test_sr_unbiased_and_repeatable():
    draws = 4096
    x = torch.tensor([[1.0 + 2 ** -9, -3.3, 1e-3 * np.pi, 7e5 + 123.0,
                       2.0 ** -100 * 1.37]], dtype=torch.float32)
    lo = x.to(torch.bfloat16).float()
    # the bf16 ulp at each x: the gap between its two bf16 neighbours
    nxt = torch.nextafter(lo.to(torch.bfloat16),
                          torch.full_like(lo, np.inf).to(torch.bfloat16))
    ulp = (nxt.float() - lo).abs()
    xs = x.expand(draws, -1).contiguous()
    y = torch.stack([TC.stochastic_round_cast(xs[i:i + 1], torch.bfloat16,
                                              i)[0].float()
                     for i in range(0, draws)])
    err = (y.double().mean(0) - x[0].double()).abs()
    bound = 4.0 * (ulp[0].double() / 2) / np.sqrt(draws)
    assert bool((err <= bound).all()), (err, bound)
    # every draw is one of the two neighbours
    assert bool(((y - x).abs() < ulp * 1.0001).all())
    # same seed, same bits; rows of one call draw independently
    a = TC.stochastic_round_cast(xs[:64], torch.bfloat16, 99)
    assert torch.equal(a, TC.stochastic_round_cast(xs[:64], torch.bfloat16,
                                                   99))
    assert not torch.equal(a[0], a[1])


@pytest.fixture(scope="module")
def bf16_runs():
    out = {}
    for sr in (False, True):
        over = dict(buffer_dtype="bfloat16", stochastic_round=sr)
        ref, rh, _ = _run_reference(SMOKE, SMOKE_CAESAR, **over)
        port, ph = _run_port(ref, SMOKE, SMOKE_CAESAR, "lr", **over)
        out[sr] = (ref, rh, port, ph)
    return out


def test_bf16_pool_round_to_nearest_matches_reference(bf16_runs):
    ref, rh, port, ph = bf16_runs[False]
    assert port.store.pool.dtype == torch.bfloat16
    assert ph.sim_time == rh.sim_time
    assert _rel(port.global_flat.numpy(), ref.global_flat) <= GLOBAL_REL_L2
    r_pool = np.asarray(ref.store.pool, np.float32)
    assert _rel(port.store.pool.float().numpy(), r_pool) <= GLOBAL_REL_L2


def test_bf16_pool_stochastic_rounding_near_reference(bf16_runs):
    ref, rh, port, ph = bf16_runs[True]
    assert ph.sim_time == rh.sim_time
    assert _rel(port.global_flat.numpy(), ref.global_flat) \
        <= SR_GLOBAL_REL_L2
    # the pool rows hold bf16 values (every one a fixed point)
    p = port.store.pool
    assert torch.equal(TC.stochastic_round_cast(p.float(), torch.bfloat16,
                                                3), p)


def test_planner_state_and_splits_equal_reference(ef_runs):
    ref, rh, rlog, port, ph = ef_runs
    rs, ts = ref.caesar_state, port.caesar_state
    np.testing.assert_array_equal(ts.last_round.numpy(),
                                  np.asarray(rs.last_round))
    np.testing.assert_allclose(ts.importance.numpy(),
                               np.asarray(rs.importance), rtol=1e-6)
    np.testing.assert_array_equal(ts.upload_ratio.numpy(),
                                  np.asarray(rs.upload_ratio))
    np.testing.assert_allclose(port.grad_norms, ref.grad_norms, rtol=2e-5)
    assert len(port.splits) == len(ref.splits) == SMOKE["n_clients"]
    for a, b in zip(port.splits, ref.splits):
        np.testing.assert_array_equal(a, b)
