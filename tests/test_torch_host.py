"""repro_torch's host-side copies against the reference, the import
boundary, and the device rule.

The numpy-only modules (rng streams, synthetic data, Dirichlet partition,
capability model) are copies: their arrays must be BYTE-equal to the
reference's at every seed, because same-seed participant draws, batches and
plans in the two packages hang off them.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import rng as R_RNG  # noqa: E402
from repro.data import partition as R_PART  # noqa: E402
from repro.data import synthetic as R_SYN  # noqa: E402
from repro.fl import capability as R_CAP  # noqa: E402
from repro_torch.core import caesar as T_CA  # noqa: E402
from repro_torch.core import rng as T_RNG  # noqa: E402
from repro_torch.data import partition as T_PART  # noqa: E402
from repro_torch.data import synthetic as T_SYN  # noqa: E402
from repro_torch.fl import capability as T_CAP  # noqa: E402
from repro_torch.fl.availability import AvailabilityConfig  # noqa: E402
from repro_torch.fl import simulation as T_SIM  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
SEEDS = [0, 1, 7]


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def test_rng_kinds_and_streams_identical():
    kinds = [k for k in dir(R_RNG) if k.startswith("KIND_")]
    assert kinds == [k for k in dir(T_RNG) if k.startswith("KIND_")]
    for k in kinds:
        assert getattr(R_RNG, k) == getattr(T_RNG, k)
    for seed in SEEDS:
        for kind in range(8):
            a = R_RNG.stream(seed, kind, 3, 5).integers(0, 1 << 62, 16)
            b = T_RNG.stream(seed, kind, 3, 5).integers(0, 1 << 62, 16)
            assert _same(a, b)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["har", "oppo_ts"])
def test_synthetic_datasets_byte_equal(seed, name):
    a = R_SYN.DATASETS[name](seed=seed, scale=0.05)
    b = T_SYN.DATASETS[name](seed=seed, scale=0.05)
    for f in ("x_train", "y_train", "x_test", "y_test"):
        assert _same(getattr(a, f), getattr(b, f)), f
    assert a.n_classes == b.n_classes


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("p", [0.0, 5.0])
def test_dirichlet_partition_byte_equal(seed, p):
    y = R_SYN.har_like(seed=seed, scale=0.1).y_train
    sa, la, va = R_PART.dirichlet_partition(y, 40, p, seed)
    sb, lb, vb = T_PART.dirichlet_partition(y, 40, p, seed)
    assert len(sa) == len(sb)
    assert all(_same(x, z) for x, z in zip(sa, sb))
    assert _same(la, lb) and _same(va, vb)


@pytest.mark.parametrize("seed", SEEDS)
def test_capability_snapshots_byte_equal(seed):
    a, b = R_CAP.CapabilityModel(50, seed), T_CAP.CapabilityModel(50, seed)
    for t in (1, 2, 19, 20, 41):
        for x, z in zip(a.snapshot(t), b.snapshot(t)):
            assert _same(x, z)


@pytest.mark.parametrize("module", ["repro_torch",
                                    "repro_torch.fl.simulation",
                                    "repro_torch.models.model",
                                    "repro_torch.configs",
                                    "repro_torch.kernels.flash_attention",
                                    "repro_torch.fl.baselines",
                                    "repro_torch.models.paper_models",
                                    "repro_torch.fl.wire",
                                    "repro_torch.fl.faults",
                                    "repro_torch.fl.availability",
                                    "repro_torch.fl.robust",
                                    "repro_torch.checkpoint.manager",
                                    "repro_torch.fl.distributed",
                                    "repro_torch.launch.train",
                                    "repro_torch.launch.elastic",
                                    "repro_torch.launch.mesh"])
def test_port_imports_neither_jax_nor_reference(module):
    code = (f"import sys; import {module}; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
            "or m.startswith('repro.')); print(bad); sys.exit(bool(bad))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_is_cuda_and_never_falls_back():
    cfg = T_SIM.SimConfig(dataset="har", n_clients=12, participation=0.25,
                          rounds=1, data_scale=0.2)
    assert cfg.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-fallback rule is "
                    "checked where there is none")
    with pytest.raises(RuntimeError, match="cuda"):
        T_SIM.Simulator(cfg)


_FAST = dict(dataset="har", n_clients=12, participation=0.25, rounds=1,
             data_scale=0.2, device="cpu")


@pytest.mark.parametrize("override,exc,match", [
    (dict(state_capacity=8, state_offload="bogus"), ValueError,
     "state_offload"),
    (dict(multi_host=True), ValueError, "requires sharded=True"),
    (dict(sharded=True, wire="loopback"), ValueError, "single-mesh"),
    (dict(sharded=True, availability=AvailabilityConfig(kind="diurnal")),
     ValueError, "single-mesh"),
])
def test_out_of_slice_configs_raise(override, exc, match):
    """The configurations the simulator refuses, as the reference does:
    multi_host without sharded, the wire engine or diurnal availability
    with sharded, an unknown offload of the capped pool."""
    cfg = dataclasses.replace(T_SIM.SimConfig(**_FAST), **override)
    with pytest.raises(exc, match=match):
        T_SIM.Simulator(cfg)


@pytest.mark.parametrize("override", [
    dict(ragged=False),
    dict(buffer_dtype="bfloat16"),
    dict(caesar=T_CA.CaesarConfig(tau=2, b_max=8, use_error_feedback=True)),
    dict(wire="loopback"),
    dict(availability=AvailabilityConfig(kind="diurnal")),
    dict(sharded=True),
    dict(sharded=True, multi_host=True, ragged=False),
], ids=["masked", "bf16", "ef", "loopback", "diurnal", "sharded",
        "multi_host"])
def test_ported_modes_run_one_round(override):
    """The modes of ROADMAP items 9, 11 and 13 (which raised before they
    were ported) build and run a round on the CPU; sharded without a
    process group is a world of 1, and multi_host says it found no
    multi-process runtime."""
    cfg = dataclasses.replace(T_SIM.SimConfig(**_FAST),
                              caesar=T_CA.CaesarConfig(tau=2, b_max=8))
    cfg = dataclasses.replace(cfg, **override)
    if cfg.multi_host:
        with pytest.warns(UserWarning, match="no multi-process"):
            sim = T_SIM.Simulator(cfg)
    else:
        sim = T_SIM.Simulator(cfg)
    assert sim.n_dev == 1
    hist = sim.run()
    assert len(hist.accuracy) == 1
    assert bool(torch.isfinite(sim.global_flat).all())


def test_state_dict_raises():
    """state_dict → load_state_dict → run(start_round=) on a fresh
    simulator resumes a capped run (what used to raise, item 10); a resume
    without a loaded checkpoint raises."""
    cfg = dataclasses.replace(T_SIM.SimConfig(**_FAST), rounds=2,
                              caesar=T_CA.CaesarConfig(tau=2, b_max=8),
                              state_capacity=4, state_offload="host")
    straight = T_SIM.Simulator(cfg)
    straight.run()
    first = T_SIM.Simulator(dataclasses.replace(cfg, rounds=1))
    first.run()
    resumed = T_SIM.Simulator(cfg)
    with pytest.raises(ValueError, match="load_state_dict"):
        resumed.run(start_round=2)
    resumed.load_state_dict(first.state_dict())
    resumed.run(start_round=2)
    assert torch.equal(resumed.global_flat, straight.global_flat)
