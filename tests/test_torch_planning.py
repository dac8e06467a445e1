"""repro_torch planning math against the reference: importance and upload
ratios, staleness clusters, Eq. 8–9 batch sizes, the Eq.-7 round times, the
LR schedule, tier quantization, and the RoundPlanner over several rounds.

Discrete results (ranks, clusters, leaders, batch sizes, tiers) are exact.

Importance: the KL of Eq. 4 sums its H label terms as a left fold, the
order of XLA's f32 row reduction, so KL equals the reference's bit for bit
wherever the two frameworks' f32 ``log`` agree (pinned below). Ranks and
θ_u are then identical on the 12- and 100-client populations. One recorded
fault remains (ROADMAP faults section): XLA's and PyTorch's f32 ``exp``
(and ``log``) differ by an ulp on some inputs, so in the 1000-client
populations a few clients whose importances TIE in exact arithmetic (label
distributions that are permutations of each other at equal volume) still
swap ranks. The tests pin that this is the only way ranks differ.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import batchsize as RBS  # noqa: E402
from repro.core import caesar as RCA  # noqa: E402
from repro.core import importance as RIMP  # noqa: E402
from repro.core import staleness as RST  # noqa: E402
from repro.data import partition as RPART  # noqa: E402
from repro.data import synthetic as RSYN  # noqa: E402
from repro.fl import capability as RCAP  # noqa: E402
from repro.fl import planner as RPL  # noqa: E402
from repro.optim import sgd as RSGD  # noqa: E402
from repro_torch.core import batchsize as TBS  # noqa: E402
from repro_torch.core import caesar as TCA  # noqa: E402
from repro_torch.core import importance as TIMP  # noqa: E402
from repro_torch.core import staleness as TST  # noqa: E402
from repro_torch.fl import planner as TPL  # noqa: E402
from repro_torch.optim import sgd as TSGD  # noqa: E402

Q_BITS = 164134 * 32.0


def _population(seed, n):
    d = RSYN.har_like(seed=seed, scale=0.2)
    _, ld, vol = RPART.dirichlet_partition(d.y_train, n, 5.0, seed)
    return vol, ld


POPULATIONS = [(0, 12), (1, 12), (0, 100), (2, 30), (0, 1000), (1, 1000)]


@pytest.mark.parametrize("seed,n", POPULATIONS)
def test_kl_is_the_reference_left_fold(seed, n):
    """At H = 6 the reference's KL is the sequential left fold of its own
    f32 terms, bit for bit, on every row; the port's KL equals it bit for
    bit on every row whose f32 ``log`` terms agree, and the rows where it
    differs are exactly rows where only ``log`` differs (the products and
    clipping agree everywhere)."""
    _, ld = _population(seed, n)
    e = jnp.clip(jnp.asarray(ld), 1e-12, 1.0)
    ref_terms = np.asarray(e * jnp.log(e * ld.shape[1]))
    ref_kl = np.asarray(RIMP.kl_to_uniform(jnp.asarray(ld)))
    fold = ref_terms[:, 0]
    for j in range(1, ld.shape[1]):
        fold = (fold + ref_terms[:, j]).astype(np.float32)
    np.testing.assert_array_equal(fold, ref_kl)

    te = torch.clamp(torch.tensor(ld, dtype=torch.float32), 1e-12, 1.0)
    np.testing.assert_array_equal((te * ld.shape[1]).numpy(),
                                  np.asarray(e * ld.shape[1]))
    log_same = (torch.log(te * ld.shape[1]).numpy()
                == np.asarray(jnp.log(e * ld.shape[1]))).all(axis=1)
    got = TIMP.kl_to_uniform(torch.tensor(ld, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(got[log_same], ref_kl[log_same])
    assert not (got != ref_kl)[log_same].any()


@pytest.mark.parametrize("seed,n", [(0, 12), (0, 100)])
def test_ranks_and_upload_ratios_exact(seed, n):
    """Seed 0 holds clients tied in exact arithmetic (ROADMAP's example:
    clients 10 and 11 of the 12-client population); with the left-fold KL
    the port ranks them as the reference does."""
    vol, ld = _population(seed, n)
    a = RIMP.importance(jnp.asarray(vol, jnp.float32), jnp.asarray(ld))
    b = TIMP.importance(torch.tensor(vol, dtype=torch.float32),
                        torch.tensor(ld, dtype=torch.float32))
    np.testing.assert_array_equal(TIMP.rank_descending(b).numpy(),
                                  np.asarray(RIMP.rank_descending(a)))
    np.testing.assert_array_equal(
        TIMP.upload_ratio(b, 0.1, 0.6).numpy(),
        np.asarray(RIMP.upload_ratio(a, 0.1, 0.6)))


@pytest.mark.parametrize("seed,n", POPULATIONS)
def test_importance_agrees_and_ranks_differ_only_on_ties(seed, n):
    vol, ld = _population(seed, n)
    a = np.asarray(RIMP.importance(jnp.asarray(vol, jnp.float32),
                                   jnp.asarray(ld)))
    b = TIMP.importance(torch.tensor(vol, dtype=torch.float32),
                        torch.tensor(ld, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(b, a, rtol=4e-7)    # ≤ ~2 ulp
    ra = np.asarray(RIMP.rank_descending(jnp.asarray(a)))
    rb = TIMP.rank_descending(torch.from_numpy(b)).numpy()
    tol = 4 * np.spacing(np.float32(a.max()))
    for i in np.flatnonzero(ra != rb):
        # the client that took i's rank in the port must be i's near-tie
        j = int(np.flatnonzero(ra == rb[i])[0])
        assert abs(float(a[i]) - float(a[j])) <= tol, (i, j, a[i], a[j])
    # given the SAME importance, ranks and Eq.-6 ratios are exact
    a = a.copy()
    np.testing.assert_array_equal(
        TIMP.rank_descending(torch.from_numpy(a)).numpy(), ra)
    np.testing.assert_array_equal(
        TIMP.upload_ratio(torch.from_numpy(a), 0.1, 0.6).numpy(),
        np.asarray(RIMP.upload_ratio(jnp.asarray(a), 0.1, 0.6)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("t", [1, 2, 7, 40])
def test_cluster_ratios_exact(seed, t):
    rng = np.random.default_rng(np.random.SeedSequence(seed, spawn_key=(95,)))
    n = 60
    last = rng.integers(0, t, n).astype(np.int32)
    mask = rng.random(n) < 0.3
    for m in (None, mask):
        da = RST.staleness(jnp.asarray(last), jnp.int32(t))
        ca, ra = RST.cluster_ratios(da, jnp.int32(t), 0.6, 8,
                                    None if m is None else jnp.asarray(m))
        db = TST.staleness(torch.from_numpy(last), t)
        cb, rb = TST.cluster_ratios(db, t, 0.6, 8,
                                    None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(cb.numpy(), np.asarray(ca))
        np.testing.assert_array_equal(rb.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(
        TST.download_ratio(db, t, 0.6).numpy(),
        np.asarray(RST.download_ratio(da, jnp.int32(t), 0.6)))


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_batch_sizes_and_round_times_exact(seed):
    n = 80
    mu, bw_d, bw_u = RCAP.CapabilityModel(n, seed).snapshot(seed + 1)
    rng = np.random.default_rng(np.random.SeedSequence(seed, spawn_key=(94,)))
    td = (rng.random(n) * 0.6).astype(np.float32)
    tu = (0.1 + rng.random(n) * 0.5).astype(np.float32)
    mask = rng.random(n) < 0.25
    f32 = np.float32
    for m in (None, mask):
        ba, la = RBS.optimize_batch_sizes(
            jnp.asarray(td), jnp.asarray(tu), Q_BITS,
            jnp.asarray(bw_d, f32), jnp.asarray(bw_u, f32), 5,
            jnp.asarray(mu, f32), 32, 1,
            mask=None if m is None else jnp.asarray(m))
        bb, lb = TBS.optimize_batch_sizes(
            torch.from_numpy(td), torch.from_numpy(tu), Q_BITS,
            torch.tensor(bw_d, dtype=torch.float32),
            torch.tensor(bw_u, dtype=torch.float32), 5,
            torch.tensor(mu, dtype=torch.float32), 32, 1,
            mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(bb.numpy(), np.asarray(ba))
        assert lb == int(la)
    batch = np.array(ba)
    # the simulator's f64 accounting path (fl/driver.py): same numpy math
    args64 = (td.astype(np.float64), tu.astype(np.float64), Q_BITS, bw_d,
              bw_u, np.full(n, 5.0), batch.astype(np.float64), mu)
    np.testing.assert_array_equal(TBS.round_times(*args64),
                                  np.asarray(RBS.round_times(*args64)))
    # the f32 planning path: same operator order, f32 rounding
    ra = np.asarray(RBS.round_times(jnp.asarray(td), jnp.asarray(tu), Q_BITS,
                                    jnp.asarray(bw_d, f32),
                                    jnp.asarray(bw_u, f32), 5,
                                    jnp.asarray(batch), jnp.asarray(mu, f32)))
    rb = TBS.round_times(torch.from_numpy(td), torch.from_numpy(tu), Q_BITS,
                         torch.tensor(bw_d, dtype=torch.float32),
                         torch.tensor(bw_u, dtype=torch.float32), 5,
                         torch.from_numpy(batch),
                         torch.tensor(mu, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(rb, ra)


def test_lr_schedule_within_an_ulp():
    """f32 pow differs between XLA and PyTorch by at most one ulp."""
    cfg_r, cfg_t = RSGD.SGDConfig(), TSGD.SGDConfig()
    t = np.arange(0, 400, dtype=np.float32)
    a = np.asarray(RSGD.lr_at(cfg_r, jnp.asarray(t)))
    b = TSGD.lr_at(cfg_t, torch.from_numpy(t)).numpy()
    assert np.all(np.abs(a - b) <= np.spacing(a)), np.abs(a - b).max()
    assert b[0] == np.float32(0.1)


@pytest.mark.parametrize("b_max,tau", [(8, 2), (32, 5), (30, 30)])
def test_tier_quantization_equal(b_max, tau):
    rng = np.random.default_rng(np.random.SeedSequence(b_max, spawn_key=(93,)))
    batch = rng.integers(1, b_max + 1, 50)
    taus = rng.integers(1, tau + 1, 50)
    np.testing.assert_array_equal(TBS.tier_rungs(1, b_max),
                                  RBS.tier_rungs(1, b_max))
    for x, y in zip(TBS.quantize_plan(batch, taus, 1, b_max, tau),
                    RBS.quantize_plan(batch, taus, 1, b_max, tau)):
        np.testing.assert_array_equal(x, y)
    assert TBS.tier_lattice_size(1, b_max, tau) == \
        RBS.tier_lattice_size(1, b_max, tau)


class _Cfg:
    scheme = "caesar"

    def __init__(self, n, ccfg):
        self.n_clients = n
        self.caesar = ccfg


@pytest.mark.parametrize("seed,n,share", [(1, 12, False), (0, 12, True),
                                          (4, 200, True), (0, 12, False)])
def test_planner_over_rounds(seed, n, share):
    """Same capability draws and participants, several rounds: batch sizes,
    taus and tier assignment identical; θ_d/θ_u equal. ``share`` hands the
    port the reference's importance so the remaining exp/log ulp fault
    (module docstring) cannot swap two clients' θ_u; the 12-client
    populations need no sharing since the KL sum is a left fold."""
    vol, ld = _population(seed, n)
    rc = RCA.CaesarConfig(tau=5, b_max=32)
    tc = TCA.CaesarConfig(tau=5, b_max=32)
    rp = RPL.RoundPlanner(_Cfg(n, rc), vol, ld, Q_BITS, None)
    tp = TPL.RoundPlanner(_Cfg(n, tc), vol, ld, Q_BITS, None)
    if share:
        tp.caesar_state.importance = torch.tensor(
            np.asarray(rp.caesar_state.importance))
        tp.caesar_state.upload_ratio = torch.tensor(
            np.asarray(rp.caesar_state.upload_ratio))
    cap = RCAP.CapabilityModel(n, seed)
    p = max(1, n // 4)
    for t in range(1, 7):
        parts = np.random.default_rng(
            np.random.SeedSequence(seed, spawn_key=(92, t))).choice(
                n, p, replace=False)
        mu, bw_d, bw_u = cap.snapshot(t)
        a = rp.plan(t, parts, mu, bw_d, bw_u)
        b = tp.plan(t, parts, mu, bw_d, bw_u)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, np.asarray(x))
        for x, y in zip(RBS.quantize_plan(a[2], a[3], 1, 32, 5),
                        TBS.quantize_plan(b[2], b[3], 1, 32, 5)):
            np.testing.assert_array_equal(x, y)
        rp.advance(t, parts)
        tp.advance(t, parts)
        np.testing.assert_array_equal(
            tp.caesar_state.last_round.numpy(),
            np.asarray(rp.caesar_state.last_round))


@pytest.mark.parametrize("variant", [
    dict(), dict(n_clusters=0), dict(use_batch_opt=False),
    dict(use_deviation_compress=False), dict(plan_scope="all")])
def test_plan_round_variants_equal_reference(variant):
    """The ablation switches of CaesarConfig (Caesar-DC, Caesar-BR,
    per-device ratios) and the all-device planning scope."""
    n, seed, t = 60, 2, 5
    vol, ld = _population(seed, n)
    rc, tc = RCA.CaesarConfig(**variant), TCA.CaesarConfig(**variant)
    rs = RCA.init_state(jnp.asarray(vol, jnp.float32), jnp.asarray(ld), rc)
    ts = TCA.init_state(torch.tensor(vol, dtype=torch.float32),
                        torch.tensor(ld, dtype=torch.float32), tc)
    ts.importance = torch.tensor(np.asarray(rs.importance))
    ts.upload_ratio = torch.tensor(np.asarray(rs.upload_ratio))
    rng = np.random.default_rng(np.random.SeedSequence(seed, spawn_key=(89,)))
    last = rng.integers(0, t, n).astype(np.int32)
    rs.last_round = jnp.asarray(last)
    ts.last_round = torch.from_numpy(last.copy())
    mask = rng.random(n) < 0.3
    scoped = tc.plan_scope == "participants"
    mu, bw_d, bw_u = RCAP.CapabilityModel(n, seed).snapshot(t)
    f32 = np.float32
    a = RCA.plan_round(rs, jnp.int32(t), rc, jnp.asarray(bw_d, f32),
                       jnp.asarray(bw_u, f32), jnp.asarray(mu, f32), Q_BITS,
                       jnp.asarray(mask) if scoped else None)
    b = TCA.plan_round(ts, t, tc, torch.tensor(bw_d, dtype=torch.float32),
                       torch.tensor(bw_u, dtype=torch.float32),
                       torch.tensor(mu, dtype=torch.float32), Q_BITS,
                       torch.from_numpy(mask) if scoped else None)
    for k in ("theta_d", "theta_u", "batch", "cluster_id"):
        np.testing.assert_array_equal(getattr(b, k).numpy(),
                                      np.asarray(getattr(a, k)), err_msg=k)
