"""The port's fault engine and availability schedule (`repro_torch.fl.faults`,
`repro_torch.fl.availability`, pure-numpy copies) against the reference's,
byte for byte: for the same (cfg, seed, t) the fault plan (status, attackers,
first-transmission corruption, adoption and record masks, deadline), the
persistent attacker set, every attack's payload, the ALIE vector, the bit
flip, the numpy Eq.-7 time model and the diurnal eligibility mask must be
identical arrays — the draws hang off the same (seed, KIND_FAULTS, ...)
SeedSequence streams."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.fl import availability as R_AV  # noqa: E402
from repro.fl import faults as R_F  # noqa: E402
from repro_torch.fl import availability as T_AV  # noqa: E402
from repro_torch.fl import faults as T_F  # noqa: E402

SEEDS_T = [(0, 1), (0, 7), (3, 2), (11, 40)]
CONFIGS = {
    "drop": dict(dropout_rate=0.3),
    "late-discard": dict(straggler_deadline=1.2, corrupt_rate=0.4),
    "late-defer": dict(straggler_deadline=1.1, late_policy="defer",
                       corrupt_rate=0.5, dropout_rate=0.1),
    "all": dict(dropout_rate=0.2, corrupt_rate=0.3, byzantine_frac=0.25,
                straggler_deadline=1.5),
}


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed,t", SEEDS_T)
def test_plan_faults_byte_equal(name, seed, t):
    kw = CONFIGS[name]
    rc, tc = R_F.FaultConfig(**kw), T_F.FaultConfig(**kw)
    n = 40
    rng = np.random.default_rng(seed + 100 * t)
    parts = rng.choice(n, 16, replace=False)
    times = rng.gamma(2.0, 10.0, 16)
    rb = R_F.byzantine_members(rc, seed, n)
    tb = T_F.byzantine_members(tc, seed, n)
    assert _same(rb, tb)
    rp = R_F.plan_faults(rc, seed, t, parts, times, rb)
    tp = T_F.plan_faults(tc, seed, t, parts, times, tb)
    for f in ("status", "byz", "corrupt_first", "adopt", "record"):
        assert _same(getattr(rp, f), getattr(tp, f)), f
    assert rp.deadline == tp.deadline
    assert _same(rp.uploads_sent(), tp.uploads_sent())
    assert _same(rp.aggregated(), tp.aggregated())


@pytest.mark.parametrize("attack", T_F.ATTACKS)
@pytest.mark.parametrize("seed,t", SEEDS_T[:2])
def test_attack_payloads_byte_equal(attack, seed, t):
    kw = dict(byzantine_frac=0.2, attack=attack, attack_scale=7.0,
              alie_z=0.8)
    rc, tc = R_F.FaultConfig(**kw), T_F.FaultConfig(**kw)
    rng = np.random.default_rng(seed)
    n = 500
    idx = np.sort(rng.choice(n, 37, replace=False)).astype(np.int64)
    vals = rng.standard_normal(37).astype(np.float32)
    hsum = rng.standard_normal(n)
    hsq = hsum ** 2 + rng.random(n)
    ra = R_F.alie_payload(rc, hsum, hsq, 5, 30, 1.7)
    ta = T_F.alie_payload(tc, hsum, hsq, 5, 30, 1.7)
    assert _same(ra[0], ta[0]) and _same(ra[1], ta[1])
    for client in (3, 17):
        assert _same(R_F.attack_values(rc, seed, t, client, vals),
                     T_F.attack_values(tc, seed, t, client, vals))
        for alie in (None, ta):
            ri, rv = R_F.attack_payload(rc, seed, t, client, idx, vals, n,
                                        alie=alie)
            ti, tv = T_F.attack_payload(tc, seed, t, client, idx, vals, n,
                                        alie=alie)
            assert _same(ri, ti) and _same(rv, tv)


@pytest.mark.parametrize("seed,t", SEEDS_T)
def test_flip_bit_and_round_times_equal(seed, t):
    payload = bytes(np.random.default_rng(seed).integers(
        0, 256, 123, dtype=np.uint8))
    for salt in (0, 1):
        for client in (0, 9):
            a = R_F.flip_bit(payload, seed, t, client, salt)
            b = T_F.flip_bit(payload, seed, t, client, salt)
            assert a == b and a != payload
    assert T_F.flip_bit(b"", seed, t, 1) == b""
    rng = np.random.default_rng(seed)
    args = (rng.random(9), rng.random(9), 1e6, rng.random(9) * 1e6 + 1,
            rng.random(9) * 1e6 + 1, rng.integers(1, 30, 9),
            rng.integers(1, 64, 9), rng.random(9))
    assert _same(R_F.round_times_np(*args), T_F.round_times_np(*args))


def test_fault_config_validation_matches():
    for bad in (dict(attack="nope"), dict(late_policy="x"),
                dict(dropout_rate=1.5), dict(alie_z=-1.0)):
        with pytest.raises(ValueError):
            R_F.FaultConfig(**bad)
        with pytest.raises(ValueError):
            T_F.FaultConfig(**bad)
    assert not T_F.FaultConfig().enabled()
    assert T_F.FaultConfig(corrupt_rate=0.1).enabled()


AV_CONFIGS = {
    "default": dict(kind="diurnal"),
    "tight": dict(kind="diurnal", day_rounds=10, duty=0.2, n_zones=3,
                  flake_rate=0.1),
    "no-flake": dict(kind="diurnal", duty=0.7, flake_rate=0.0),
}


@pytest.mark.parametrize("name", sorted(AV_CONFIGS))
@pytest.mark.parametrize("seed", [0, 5])
def test_eligible_mask_byte_equal(name, seed):
    rc = R_AV.AvailabilityConfig(**AV_CONFIGS[name])
    tc = T_AV.AvailabilityConfig(**AV_CONFIGS[name])
    n = 300
    rp, tp = R_AV.client_phases(rc, seed, n), T_AV.client_phases(tc, seed, n)
    assert _same(rp, tp)
    for t in (1, 2, 13, 24, 25, 97):
        assert _same(R_AV.eligible_mask(rc, seed, t, n, rp),
                     T_AV.eligible_mask(tc, seed, t, n, tp))
        assert _same(R_AV.eligible_mask(rc, seed, t, n),
                     T_AV.eligible_mask(tc, seed, t, n))
    always = T_AV.AvailabilityConfig()
    assert T_AV.eligible_mask(always, seed, 3, n).all()
    s = np.random.default_rng(seed).integers(1, 50, 40)
    assert R_AV.staleness_stats(s) == T_AV.staleness_stats(s)
