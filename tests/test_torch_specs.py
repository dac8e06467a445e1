"""The port's partition specs against the reference's, exactly, on
``jax.sharding.AbstractMesh`` (no devices): `models.model.param_specs`,
`dp_axes`, `batch_spec`, `fl.distributed.state_specs` (error feedback and
the int8 stale model on) and every function of `launch.specs`, for every
arch at full width and under the ``dp_only`` policy, on the (16, 16)
("data", "model") and (1, 1) meshes and the (2, 16, 16) and (2, 2, 2)
("pod", "data", "model") meshes. A spec is compared as a tuple; the
stand-ins by shape and dtype. `launch.mesh`'s builders refuse a world of
the wrong size.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.fl import distributed as RD  # noqa: E402
from repro.launch import specs as RS  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.fl import distributed as TD  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

MESHES = [((16, 16), ("data", "model")), ((1, 1), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
DIST = dict(use_error_feedback=True, prev_int8=True)


def _port(tree):
    """A reference tree of PartitionSpecs / ShapeDtypeStructs (nested
    dicts, None for an empty subtree) in the port's terms."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _port(v) for k, v in tree.items()}
    if isinstance(tree, PartitionSpec):
        return tuple(tree)
    return (tuple(tree.shape), str(tree.dtype))


def _shapes(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


def _cfgs(arch):
    r, t = RC.get(arch), TC.get(arch)
    yield r, t
    if r.family != "moe":          # dp_only is for the TP-free archs
        yield (dataclasses.replace(r, dp_only=True),
               dataclasses.replace(t, dp_only=True))


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_specs_equal_the_reference(arch):
    for shape, names in MESHES:
        rm, tm = AbstractMesh(shape, names), MESH.abstract_mesh(shape, names)
        for cr, ct in _cfgs(arch):
            assert TM.param_specs(ct, tm) == _port(RM.param_specs(cr, rm))
            for manual in ((), ("pod",)):
                assert TM.dp_axes(ct, tm, manual) == RM.dp_axes(cr, rm,
                                                                manual)
            assert TM.batch_spec(ct, tm) == tuple(RM.batch_spec(cr, rm))
            rs = RD.state_specs(cr, RD.DistConfig(**DIST), rm)
            ts = TD.state_specs(ct, TD.DistConfig(**DIST), tm)
            for f in ("params", "prev_params", "ef", "step", "theta_d",
                      "theta_u"):
                assert getattr(ts, f) == _port(getattr(rs, f)), f
        cr, ct = RC.get(arch), TC.get(arch)
        for name, sh in RS.SHAPES.items():
            assert TS.SHAPES[name] == sh
            ok = RS.cell_supported(cr, name)
            assert TS.cell_supported(ct, name) == ok
            b, s = sh["batch"], sh["seq"]
            assert _shapes(TS.batch_struct(ct, b, s)) == _port(
                RS.batch_struct(cr, b, s))
            assert TS.batch_shardings(ct, tm, b) == _port(
                RS.batch_shardings(cr, rm, b))
            if sh["kind"] != "decode" or not ok[0]:
                continue
            got, want = TS.decode_inputs(ct, tm, b, s), \
                RS.decode_inputs(cr, rm, b, s)
            assert _shapes(got[0]) == _port(want[0])
            assert got[1] == _port(want[1])
            for g, w in zip(got[2::2], want[2::2]):
                assert _shapes(g) == _port(w)
            for g, w in zip(got[3::2], want[3::2]):
                assert g == tuple(w)


def test_dp_only_drops_the_model_axis_from_every_param_spec():
    cfg = dataclasses.replace(TC.get("mamba2_780m").smoke(), dp_only=True)
    specs = TM.param_specs(cfg, MESH.abstract_mesh((1, 1),
                                                   ("data", "model")))
    for leaf in TD.tree_leaves(specs):
        assert "model" not in [a for e in leaf for a in
                               ((e,) if isinstance(e, str) else e or ())]


def test_mesh_builders_refuse_a_world_of_the_wrong_size():
    with pytest.raises(ValueError, match="256"):
        MESH.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512"):
        MESH.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="8 ranks"):
        MESH.make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    mesh = MESH.make_local_mesh("cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == (0, 0)
    x = torch.arange(3.0)
    assert mesh.sum_axis(x, ("data", "model")) is x
    assert mesh.all_gather_axis(x, "model", 0) is x
