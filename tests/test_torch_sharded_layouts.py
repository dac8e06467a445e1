"""The sharded layout's edges in the port, on the CPU (split from
tests/test_torch_sharded.py, whose config they use): a world of 1 (no
group, and a gloo group of 1) runs bit-identical to the unsharded run,
ragged and masked; the two-shard ClientStateStore under a group of 2 gloo
ranks (tests/torch_sharded_ranks.py), each holding only its segment,
equals the reference store of tests/test_torch_state_store.py in one
process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_sharded_ranks as RK  # noqa: E402
from repro.fl import state as RS  # noqa: E402
from repro_torch.core.caesar import CaesarConfig as TCaesar  # noqa: E402
from repro_torch.fl import simulation as TSIM  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402

# tests/test_torch_sharded.py's config
CFG = dict(dataset="har", rounds=4, n_clients=24, data_scale=0.25,
           eval_every=2, participation=1 / 3, seed=3,
           dataset_kwargs={"sep": 1.8, "noise": 2.0}, chunk_size=2)
CAESAR = dict(tau=3, b_max=8)
SPAWN_TIMEOUT_S = 180.0


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


@pytest.mark.parametrize("ragged", [True, False], ids=["ragged", "masked"])
def test_world_of_one_is_bit_identical_to_unsharded(ragged, tmp_path):
    kw = dict(CFG, participation=0.25, rounds=2)
    ckw = TCaesar(**CAESAR)

    def run(**over):
        sim = TSIM.Simulator(TSIM.SimConfig(device="cpu", caesar=ckw,
                                            ragged=ragged, **kw, **over))
        return sim, sim.run()

    base, hb = run()
    alone, ha = run(sharded=True)
    assert alone.n_dev == 1 and alone.layout.group is None
    MESH.init_distributed(f"file://{tmp_path / 'pg'}", 1, 0,
                          backend="gloo")
    try:
        with pytest.warns(UserWarning, match="no multi-process"):
            grouped, hg = run(sharded=True, multi_host=True)
        assert grouped.layout.group is not None
    finally:
        dist.destroy_process_group()
    for sim, h in ((alone, ha), (grouped, hg)):
        assert torch.equal(sim.global_flat, base.global_flat)
        assert torch.equal(sim.store.pool, base.store.pool)
        assert h.traffic_bits == hb.traffic_bits
        assert h.accuracy == hb.accuracy and h.sim_time == hb.sim_time
        for a, b in zip(sim.round_log, base.round_log):
            assert np.array_equal(a["parts"], b["parts"])


# -- the two-shard store ----------------------------------------------------

N_PARAMS = 8
STORE_KW = dict(capacity=8, cohort=4, ef_width=2)
MAPS = ("slot_of", "client_of", "last_used", "evicted_tier", "centroids",
        "centroid_n", "centroid_w")


def _stratified(rounds=5, seed=7):
    rng = np.random.default_rng(seed)
    return [np.concatenate([rng.choice(np.arange(8 * s, 8 * s + 8), 2,
                                       replace=False) for s in range(2)])
            for _ in range(rounds)]


def test_two_ranks_each_hold_their_segment_of_the_reference_store(tmp_path):
    seq = _stratified()
    MESH.spawn(RK.store_rank, 2,
               (2, str(tmp_path / "pg"), str(tmp_path / "out"), STORE_KW,
                seq, N_PARAMS), timeout_s=SPAWN_TIMEOUT_S)
    per_rank = RK.load(str(tmp_path / "out"), 2)
    ref = RS.ClientStateStore(16, N_PARAMS, np.arange(N_PARAMS,
                                                      dtype=np.float32),
                              n_shards=2, **STORE_KW)
    for t, parts in enumerate(seq, 1):
        slots = ref.prepare(np.asarray(parts), t)
        rows = (np.asarray(parts, np.float32)[:, None] * 100.0 + t
                + np.arange(N_PARAMS, dtype=np.float32)[None, :])
        ref.adopt(ref.pool.at[jnp.asarray(slots)].set(jnp.asarray(rows)),
                  ref.ef_pool.at[jnp.asarray(slots)].set(
                      jnp.asarray(-rows[:, :2])))
        want = ref.state_dict()
        for r, rounds in enumerate(per_rank):
            got = rounds[t - 1]
            np.testing.assert_array_equal(got["slots"], slots)
            assert got["pool_rows"] == ref.cap_per_shard
            assert got["row0"] == r * ref.cap_per_shard
            for k in want:
                np.testing.assert_array_equal(got["state"][k], want[k],
                                              err_msg=k)
    assert ref.n_evictions > 0
