"""repro_torch ClientStateStore against the reference store: the same
participant sequence gives the same slot maps, capacity growth and resident
rows, in grow-on-demand (capacity=None) and dense (capacity=0) mode. The
capped mode is held to the reference in tests/test_torch_state_store.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.fl import state as RS  # noqa: E402
from repro_torch.fl import state as TS  # noqa: E402

N_PARAMS = 10


def _sequence(n_clients, cohort, rounds, seed):
    rng = np.random.default_rng(np.random.SeedSequence(seed, spawn_key=(91,)))
    return [rng.choice(n_clients, cohort, replace=False)
            for _ in range(rounds)]


@pytest.mark.parametrize("capacity", [None, 0])
@pytest.mark.parametrize("n_clients,cohort,seed", [(40, 3, 0), (300, 10, 1),
                                                   (1000, 37, 2)])
def test_slot_maps_equal_reference(capacity, n_clients, cohort, seed):
    init = np.arange(N_PARAMS, dtype=np.float32)
    ref = RS.ClientStateStore(n_clients, N_PARAMS, init, capacity=capacity,
                              cohort=cohort)
    port = TS.ClientStateStore(n_clients, N_PARAMS, torch.from_numpy(init),
                               capacity=capacity, cohort=cohort,
                               device="cpu")
    assert port.capacity == ref.capacity
    for t, parts in enumerate(_sequence(n_clients, cohort, 30, seed), 1):
        a, b = ref.prepare(parts, t), port.prepare(parts, t)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert port.capacity == ref.capacity
        assert np.array_equal(port.slot_of, ref.slot_of)
        assert np.array_equal(port.client_of, ref.client_of)
        assert np.array_equal(port.last_used, ref.last_used)
    assert port.n_grows == ref.n_grows
    assert port.pool.shape == tuple(ref.pool.shape)
    res = np.flatnonzero(port.client_of >= 0)
    np.testing.assert_array_equal(port.pool[res].numpy(),
                                  np.asarray(ref.pool)[res])
    tel = port.telemetry()
    assert tel["resident"] == ref.telemetry()["resident"]


def test_capped_pool_is_not_ported():
    """A capped pool (ported since item 10) must hold the cohort: a cap
    below it raises ValueError, as the reference's; one that holds it
    builds at its cap."""
    with pytest.raises(ValueError, match="cohort"):
        TS.ClientStateStore(10, N_PARAMS, torch.zeros(N_PARAMS), capacity=4,
                            cohort=5, device="cpu")
    with pytest.raises(ValueError, match="cohort"):
        RS.ClientStateStore(10, N_PARAMS, np.zeros(N_PARAMS, np.float32),
                            capacity=4, cohort=5)
    st = TS.ClientStateStore(10, N_PARAMS, torch.zeros(N_PARAMS),
                             capacity=4, cohort=4, device="cpu")
    assert st.capacity == 4 and tuple(st.pool.shape) == (4, N_PARAMS)
