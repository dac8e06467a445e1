"""repro_torch.checkpoint.manager against the reference manager: the six
cases of tests/test_checkpoint.py on torch tensors, checkpoints of a numpy
tree written by either package restored by the other, and bf16 tensors
bit for bit."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as RefManager  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402


def _state(v=0.0):
    return {"params": {"w": torch.full((4, 4), v),
                       "b": torch.arange(3.0)},
            "step": torch.tensor(int(v), dtype=torch.int32)}


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(_state(3.0), step=3)
    restored, step = mgr.restore_latest(_state())
    assert step == 3
    assert torch.equal(restored["params"]["w"], torch.full((4, 4), 3.0))
    assert torch.equal(restored["params"]["b"], torch.arange(3.0))
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 3


def test_keeps_only_newest_k(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in [1, 2, 3, 4]:
        mgr.save(_state(float(s)), step=s)
    assert sorted(mgr.steps()) == [3, 4]


def _corrupt(mgr, step, value):
    d = mgr._step_dir(step)
    manifest = json.loads((d / "manifest.json").read_text())
    manifest["hash"] = value
    (d / "manifest.json").write_text(json.dumps(manifest))


def test_integrity_check_detects_corruption(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(_state(1.0), step=1)
    _corrupt(mgr, 1, "deadbeef")
    with pytest.raises(IOError):
        mgr.restore(1, _state())


def test_restart_falls_back_to_previous_good(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(_state(1.0), step=1)
    mgr.save(_state(2.0), step=2)
    _corrupt(mgr, 2, "bad")
    restored, step = mgr.restore_latest(_state())
    assert step == 1
    assert torch.equal(restored["params"]["w"], torch.full((4, 4), 1.0))


def test_structure_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(_state(1.0), step=1)
    with pytest.raises(ValueError):
        mgr.restore(1, {"different": torch.zeros(2)})


def test_resume_midtraining_semantics(tmp_path):
    mgr = CheckpointManager(tmp_path)
    state = _state(0.0)
    for step in range(1, 6):
        state = {"params": {"w": state["params"]["w"] + 1.0,
                            "b": state["params"]["b"]},
                 "step": torch.tensor(step, dtype=torch.int32)}
        if step == 4:
            mgr.save(state, step)
    got = mgr.restore_latest(_state())
    assert got is not None
    state2, step = got
    assert step == 4
    assert torch.equal(state2["params"]["w"], torch.full((4, 4), 4.0))


def _numpy_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"pool": rng.normal(size=(3, 5)).astype(np.float32),
            "slot_of": rng.integers(-1, 9, 7).astype(np.int64),
            "tier": np.array([1, -1, 3], np.int8),
            "logs": [{"round": 2, "w": 0.5},
                     (rng.normal(size=4), None)],
            "flag": np.array(True)}


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif a is None:
        assert b is None
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("writer,reader", [(RefManager, CheckpointManager),
                                           (CheckpointManager, RefManager)],
                         ids=["ref-to-port", "port-to-ref"])
def test_numpy_tree_restores_across_packages(tmp_path, writer, reader):
    tree = _numpy_tree()
    writer(tmp_path).save(tree, step=7)
    like = _numpy_tree(seed=1)
    got, step = reader(tmp_path).restore_latest(like)
    assert step == 7
    _assert_tree_equal(got, tree)
    # the same files: manifests (leaf keys, dtypes, hash) agree
    manifest = json.loads((tmp_path / "step_0000000007" / "manifest.json")
                          .read_text())
    assert set(manifest["leaves"]) == {"flag", "logs/0/round", "logs/0/w",
                                       "logs/1/0", "pool", "slot_of",
                                       "tier"}


@dataclasses.dataclass
class _Holder:
    params: dict
    extra: object = None


def test_dataclass_keys_match_the_reference(tmp_path):
    """A registered dataclass flattens to ".field" keys in the reference;
    the port's walker gives the same keys."""
    import jax

    from repro.fl.distributed import TrainState as RefTrainState
    ref = RefTrainState(params={"w": np.ones(3, np.float32)},
                        prev_params=None, ef=None, step=np.int32(4),
                        theta_d=np.float32(0.5), theta_u=np.float32(0.25))
    RefManager(tmp_path).save(jax.tree.map(np.asarray, ref), step=1)
    like = _Holder(params={"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="mismatch"):
        CheckpointManager(tmp_path).restore(1, like)
    from repro_torch.fl.distributed import TrainState
    tmpl = TrainState(params={"w": torch.zeros(3)}, prev_params=None,
                      ef=None, step=torch.zeros((), dtype=torch.int32),
                      theta_d=torch.zeros(()), theta_u=torch.zeros(()))
    got = CheckpointManager(tmp_path).restore(1, tmpl)
    assert torch.equal(got.params["w"], torch.ones(3))
    assert got.step.dtype == torch.int32 and int(got.step) == 4
    assert float(got.theta_d) == 0.5 and float(got.theta_u) == 0.25


def test_bf16_tensors_round_trip_bit_exactly(tmp_path):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(257, 3, generator=g).to(torch.bfloat16)
    # specials keep their bit patterns too
    x[0, :3] = torch.tensor([float("inf"), -0.0, float("nan")]).to(
        torch.bfloat16)
    mgr = CheckpointManager(tmp_path)
    mgr.save({"x": x, "y": x.to(torch.float32)}, step=1)
    manifest = json.loads((mgr._step_dir(1) / "manifest.json").read_text())
    assert manifest["leaves"]["x"]["dtype"] == "bfloat16"
    got = mgr.restore(1, {"x": torch.zeros(257, 3, dtype=torch.bfloat16),
                          "y": torch.zeros(257, 3, dtype=torch.bfloat16)})
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"].view(torch.int16), x.view(torch.int16))
    # an f32 leaf restored into a bf16 template is the exact bf16 value
    assert torch.equal(got["y"].view(torch.int16), x.view(torch.int16))
