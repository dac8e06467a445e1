"""The capped repro_torch ClientStateStore against the reference store, side
by side on the same seeded prepare sequences: slot maps, staleness tiers,
volume-weighted centroids, counters and pool rows equal bit for bit; exact
paging through host and memmap offload; the restore-error probe; and the
state_dict round trip through both checkpoint managers (bf16 lossless).

The cases mirror tests/test_state_store.py's TestEviction,
TestVolumeWeightedCentroids and TestCheckpointRoundTrip.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as RefManager  # noqa: E402
from repro.fl import state as RS  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.fl import state as TS  # noqa: E402

N_PARAMS = 8
MAPS = ("slot_of", "client_of", "last_used", "evicted_tier", "centroids",
        "centroid_n", "centroid_w", "row_weight")
COUNTERS = ("n_evictions", "n_grows", "n_restore_fresh",
            "n_restore_centroid", "n_restore_offload")


def _pair(n_clients=16, n_params=N_PARAMS, **kw):
    init = np.arange(n_params, dtype=np.float32)
    ref = RS.ClientStateStore(n_clients, n_params, init, **kw)
    tkw = dict(kw)
    if "dtype" in tkw:
        tkw["dtype"] = {jnp.bfloat16: torch.bfloat16}[tkw["dtype"]]
    port = TS.ClientStateStore(n_clients, n_params, torch.from_numpy(init),
                               device="cpu", **tkw)
    return ref, port


def _rows_for(clients, n_params, t, scale=100.0):
    return (np.asarray(clients, np.float32)[:, None] * scale + t
            + np.arange(n_params, dtype=np.float32)[None, :])


def _write(ref, port, clients, t):
    """prepare both stores, then give each participant a distinguishable
    row (and residual row) — the executor's in-place update."""
    a = ref.prepare(np.asarray(clients), t)
    b = port.prepare(np.asarray(clients), t)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    rows = _rows_for(clients, ref.n_params, t)
    ref.adopt(ref.pool.at[jnp.asarray(a)].set(
        jnp.asarray(rows).astype(ref.pool.dtype)),
              ref.ef_pool.at[jnp.asarray(a)].set(
                  jnp.asarray(-rows[:, :ref.ef_width])))
    idx = torch.from_numpy(b.astype(np.int64))
    port.pool.index_copy_(0, idx, torch.from_numpy(rows).to(port.dtype))
    port.ef_pool.index_copy_(0, idx,
                             torch.from_numpy(-rows[:, :port.ef_width]))
    return rows


def _assert_same(ref, port):
    for k in MAPS:
        a, b = getattr(ref, k), getattr(port, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in COUNTERS:
        assert getattr(ref, k) == getattr(port, k), k
    assert port.capacity == ref.capacity
    np.testing.assert_array_equal(port.pool.to(torch.float32).numpy(),
                                  np.asarray(ref.pool, np.float32))
    np.testing.assert_array_equal(port.ef_pool.numpy(),
                                  np.asarray(ref.ef_pool))
    rt, pt = ref.telemetry(), port.telemetry()
    assert rt == pt


def _sequence(n_clients, cohort, rounds, seed):
    rng = np.random.default_rng(np.random.SeedSequence(seed, spawn_key=(92,)))
    return [rng.choice(n_clients, cohort, replace=False)
            for _ in range(rounds)]


@pytest.mark.parametrize("offload", ["none", "host", "memmap"])
@pytest.mark.parametrize("n_clients,cohort,capacity,seed",
                         [(16, 4, 6, 0), (40, 6, 9, 1), (200, 17, 23, 2)])
def test_seeded_sequence_bit_equal_to_reference(tmp_path, offload, n_clients,
                                                cohort, capacity, seed):
    vols = np.random.default_rng(seed).integers(1, 60, n_clients)
    kw = dict(n_clients=n_clients, capacity=capacity, cohort=cohort,
              ef_width=3, offload=offload, volumes=vols,
              measure_restore_error=True)
    ref, port = _pair(offload_dir=str(tmp_path / "r"), **kw) \
        if offload == "memmap" else _pair(**kw)
    if offload == "memmap":
        port.offloader.path = str(tmp_path / "port_cold_rows.f32")
    for t, parts in enumerate(_sequence(n_clients, cohort, 25, seed), 1):
        _write(ref, port, parts, t)
        _assert_same(ref, port)
    assert port.n_evictions > 0
    if offload == "none":
        assert port.n_restore_centroid > 0
        assert port.restore_errors == ref.restore_errors
    else:
        assert port.n_restore_offload > 0 and port.n_restore_centroid == 0


class TestEviction:
    def test_capacity_must_cover_cohort(self):
        with pytest.raises(ValueError, match="cohort"):
            TS.ClientStateStore(16, N_PARAMS, torch.zeros(N_PARAMS),
                                capacity=2, cohort=4, device="cpu")

    def test_lru_coldest_evicted_first(self):
        ref, port = _pair(capacity=4, cohort=2)
        for parts, t in (([0, 1], 1), ([2, 3], 5), ([4, 5], 6)):
            _write(ref, port, parts, t)
        assert port.slot_of[0] < 0 and port.slot_of[1] < 0
        assert port.slot_of[2] >= 0 and port.slot_of[3] >= 0
        assert port.n_evictions == 2
        _assert_same(ref, port)

    def test_current_participants_never_evicted(self):
        ref, port = _pair(capacity=4, cohort=4)
        _write(ref, port, [0, 1, 2, 3], 1)
        _write(ref, port, [0, 1, 2, 8], 2)
        assert port.slot_of[3] < 0
        assert all(port.slot_of[c] >= 0 for c in (0, 1, 2, 8))
        _assert_same(ref, port)

    def test_reactivated_row_equals_cluster_centroid(self):
        ref, port = _pair(capacity=4, cohort=4)
        rows = _write(ref, port, [0, 1, 2, 3], 1)
        _write(ref, port, [4, 5, 6, 7], 10)    # evicts all of 0–3
        tier = int(port.evicted_tier[0])
        assert tier == 3 and (port.evicted_tier[:4] == tier).all()
        np.testing.assert_allclose(port.centroids[tier], rows.mean(axis=0),
                                   rtol=1e-6)
        _write(ref, port, [0], 11)             # re-activate from centroid
        _assert_same(ref, port)
        assert port.n_restore_centroid == 1

    @pytest.mark.parametrize("kind", ["host", "memmap"])
    def test_offload_restores_exact_row(self, tmp_path, kind):
        ref, port = _pair(capacity=4, cohort=4, ef_width=N_PARAMS,
                          offload=kind, offload_dir=str(tmp_path))
        if kind == "memmap":
            port.offloader.path = str(tmp_path / "port_cold_rows.f32")
        rows = _write(ref, port, [0, 1, 2, 3], 1)
        ref.prepare(np.array([4, 5, 6, 7]), 10)
        port.prepare(np.array([4, 5, 6, 7]), 10)
        ref.prepare(np.array([2]), 11)
        slot = port.prepare(np.array([2]), 11)[0]
        np.testing.assert_array_equal(port.pool[slot].numpy(), rows[2])
        np.testing.assert_array_equal(port.ef_pool[slot].numpy(), -rows[2])
        assert port.n_restore_offload == 1
        assert port.telemetry()["offloaded"] == 4
        _assert_same(ref, port)


class TestVolumeWeightedCentroids:
    def test_uniform_volumes_bit_identical_to_none(self):
        seq = [[0, 1, 2, 3], [4, 5, 6, 7], [0, 2, 9, 10], [1, 3, 5, 11]]
        _, a = _pair(capacity=6, cohort=4)
        _, b = _pair(capacity=6, cohort=4, volumes=np.full(16, 7.0))
        for t, parts in enumerate(seq, 1):
            for st in (a, b):
                slots = st.prepare(np.asarray(parts), t)
                st.pool[torch.from_numpy(slots.astype(np.int64))] = \
                    torch.from_numpy(_rows_for(parts, N_PARAMS, t))
        np.testing.assert_array_equal(a.centroids, b.centroids)
        np.testing.assert_array_equal(a.centroid_w, b.centroid_w)
        assert torch.equal(a.pool, b.pool)

    def test_nonuniform_volumes_weight_the_fold(self):
        vols = np.ones(16, np.float64)
        vols[0], vols[1] = 3.0, 1.0
        ref, port = _pair(capacity=2, cohort=2, volumes=vols)
        rows = _write(ref, port, [0, 1], 1)
        _write(ref, port, [4, 5], 10)          # evicts 0 and 1 (same tier)
        tier = int(port.evicted_tier[0])
        w = vols[:2] / vols.mean()
        expect = (rows * w[:, None]).sum(0) / w.sum()
        np.testing.assert_allclose(port.centroids[tier], expect, rtol=1e-6)
        assert not np.allclose(port.centroids[tier], rows.mean(0), rtol=1e-4)
        _assert_same(ref, port)

    def test_restore_error_telemetry(self):
        ref, port = _pair(capacity=2, cohort=2, measure_restore_error=True)
        rows = _write(ref, port, [0, 1], 1)
        _write(ref, port, [4, 5], 10)          # evict 0, 1 → shadow rows
        ref.prepare(np.array([0]), 11)
        slot = port.prepare(np.array([0]), 11)[0]
        tel = port.telemetry()["restore_error"]
        assert tel["count"] == 1
        approx = port.pool[slot].numpy()
        expect = np.linalg.norm(approx - rows[0]) / np.linalg.norm(rows[0])
        assert tel["mean"] == pytest.approx(expect, rel=1e-6)
        assert tel == ref.telemetry()["restore_error"]


class TestCheckpointRoundTrip:
    @pytest.mark.parametrize("manager", [CheckpointManager, RefManager],
                             ids=["port-manager", "ref-manager"])
    def test_state_dict_round_trips_with_eviction_metadata(self, tmp_path,
                                                           manager):
        ref, port = _pair(capacity=4, cohort=4, offload="host", ef_width=2)
        _write(ref, port, [0, 1, 2, 3], 1)
        _write(ref, port, [4, 5, 6, 7], 10)    # evict + centroid fold
        _write(ref, port, [0, 2], 11)          # offload restores
        sd = port.state_dict()
        rsd = ref.state_dict()
        assert sorted(sd) == sorted(rsd)
        for k in sd:
            a, b = np.asarray(sd[k]), np.asarray(rsd[k])
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        mgr = manager(tmp_path, keep=2)
        mgr.save(sd, step=11)
        like = {k: np.zeros_like(v) for k, v in sd.items()}
        restored, step = mgr.restore_latest(like)
        assert step == 11
        assert isinstance(restored["slot_of"], np.ndarray)
        _, st2 = _pair(capacity=4, cohort=4, offload="host", ef_width=2)
        st2.load_state_dict(restored)
        for k in MAPS + COUNTERS:
            assert np.array_equal(getattr(st2, k), getattr(port, k)), k
        assert torch.equal(st2.pool, port.pool)
        assert torch.equal(st2.ef_pool, port.ef_pool)
        assert sorted(st2.offloader.row_of) == sorted(port.offloader.row_of)
        # the restored store keeps operating: client 1 is still cold and
        # comes back bit-exact from its spilled row
        assert port.slot_of[1] < 0
        slot = st2.prepare(np.array([1]), 12)[0]
        np.testing.assert_array_equal(st2.pool[slot].numpy(),
                                      _rows_for([1], N_PARAMS, 1)[0])

    def test_bf16_pool_round_trips_losslessly(self, tmp_path):
        ref, port = _pair(n_clients=8, capacity=3, cohort=2,
                          dtype=jnp.bfloat16)
        for t, parts in enumerate([[0, 1], [2, 3], [0, 4], [5, 6]], 1):
            _write(ref, port, parts, t)
        _assert_same(ref, port)
        sd = port.state_dict()
        assert sd["pool"].dtype == np.float32      # serializable cast
        CheckpointManager(tmp_path).save(sd, step=4)
        restored = CheckpointManager(tmp_path).restore(
            4, {k: np.zeros_like(v) for k, v in sd.items()})
        _, st2 = _pair(n_clients=8, capacity=3, cohort=2,
                       dtype=jnp.bfloat16)
        st2.load_state_dict(restored)
        assert st2.pool.dtype == torch.bfloat16
        assert torch.equal(st2.pool.view(torch.int16),
                           port.pool.view(torch.int16))


def _stratified(rounds: int, seed: int) -> list:
    """Two participants from each shard's 8 clients per round."""
    rng = np.random.default_rng(np.random.SeedSequence(seed, spawn_key=(92,)))
    return [np.concatenate([rng.choice(np.arange(8 * s, 8 * s + 8), 2,
                                       replace=False) for s in range(2)])
            for _ in range(rounds)]


@pytest.mark.parametrize("capacity,cohort", [(8, 4), (None, 2)],
                         ids=["capped", "growable"])
def test_sharded_segments_name_item_13(capacity, cohort):
    """Sharded segments (item 13, now ported): the two-shard store in one
    process (both segments in one tensor) against the reference's
    ``ClientStateStore(16, …, capacity=8, cohort=4, n_shards=2)`` over 5
    stratified rounds — slot maps, client_of, tiers, centroids, eviction
    counts and pool rows equal bit for bit; per-shard sizes as the
    reference's; the grow-on-demand pool (sized for a cohort of 2, fed 4)
    regrows both segments and remaps their slots."""
    ref, port = _pair(capacity=capacity, cohort=cohort, n_shards=2,
                      ef_width=2)
    assert (port.rows_per_shard, port.cohort_per_shard,
            port.cap_per_shard) == (ref.rows_per_shard,
                                    ref.cohort_per_shard, ref.cap_per_shard)
    for t, parts in enumerate(_stratified(5, 3), 1):
        _write(ref, port, parts, t)
        _assert_same(ref, port)
        assert (port.slot_of[parts] // port.cap_per_shard
                == parts // port.rows_per_shard).all()
    assert port.n_evictions > 0 if capacity else port.n_grows > 0


@pytest.mark.parametrize("kw,match", [
    (dict(n_clients=15, n_shards=2), "divide over 2 shards"),
    (dict(capacity=2, cohort=4, n_shards=2), "per-shard cohort"),
])
def test_sharded_sizes_refuse_as_the_reference(kw, match):
    n = kw.pop("n_clients", 16)
    with pytest.raises(ValueError, match=match):
        RS.ClientStateStore(n, N_PARAMS, np.zeros(N_PARAMS, np.float32), **kw)
    with pytest.raises(ValueError, match=match):
        TS.ClientStateStore(n, N_PARAMS, torch.zeros(N_PARAMS), device="cpu",
                            **kw)


def test_unknown_offload_raises():
    with pytest.raises(ValueError, match="state_offload"):
        TS.ClientStateStore(16, N_PARAMS, torch.zeros(N_PARAMS), capacity=8,
                            offload="bogus", device="cpu")
