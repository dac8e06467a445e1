"""repro_torch.launch.mesh — the sharded engine's process layout — on the
CPU with gloo ranks (tests/torch_sharded_ranks.py, through `mesh.spawn`).

* `init_distributed`: the explicit path (a file store) brings up a world
  of 3 and a second call is a no-op; the torchrun environment path
  (MASTER_ADDR/PORT, RANK, WORLD_SIZE, LOCAL_RANK) with no arguments; with
  nothing to detect it returns False and leaves no group; explicit but
  partial arguments, or a backend torch does not know, raise;
* the default backend follows the rank's device: gloo for a CPU rank
  even where the host has a card, NCCL for a CUDA rank;
* `make_data_group`: rank, world and device of each rank; a world of 1
  without a group;
* `fetch_global` returns every rank's tensor in rank order;
* `fixed_order_sum` is bit for bit the left fold ``((x0 + x1) + …)`` of
  the ranks' vectors (of very different magnitudes, so another order would
  show), the same on every rank; a world of 1 returns its input itself;
* `spawn` raises when a rank fails, and kills a rank past its time limit;
* `repro_torch.kernels.build`: processes that start together build a
  kernel once (a stand-in compiler counts the calls).
"""
import socket

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

import torch_sharded_ranks as RK  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402

SPAWN_TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    MESH.spawn(RK.mesh_rank, 3, (3, str(d / "pg"), str(d / "out")),
               timeout_s=SPAWN_TIMEOUT_S)
    return RK.load(str(d / "out"), 3)


def test_explicit_init_brings_up_the_world_once(world3):
    for r, res in enumerate(world3):
        assert res["first"] is True and res["again"] is True
        assert (res["rank"], res["world"], res["device"]) == (r, 3, "cpu")


def test_fetch_global_is_every_rank_in_order(world3):
    for res in world3:
        assert len(res["gathered"]) == 3
        for got, other in zip(res["gathered"], world3):
            assert torch.equal(got, other["x"])


def test_fixed_order_sum_is_the_left_fold(world3):
    x0, x1, x2 = (res["x"] for res in world3)
    want = (x0 + x1) + x2
    assert not torch.equal(want, x0 + (x1 + x2))   # the order shows
    for res in world3:
        assert torch.equal(res["sum"], want)


def test_env_path_with_no_arguments(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    MESH.spawn(RK.env_rank, 2, (2, port, str(tmp_path / "out")),
               timeout_s=SPAWN_TIMEOUT_S)
    for r, res in enumerate(RK.load(str(tmp_path / "out"), 2)):
        assert res["up"] is True and (res["rank"], res["world"]) == (r, 2)
        assert torch.equal(res["sum"], torch.full((3,), 3.0))


def test_nothing_to_detect_stays_single(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert MESH.init_distributed() is False
    assert not dist.is_initialized()
    layout = MESH.make_data_group("cpu")
    assert (layout.rank, layout.world, layout.group) == (0, 1, None)
    assert layout.device == torch.device("cpu")


@pytest.mark.parametrize("kw,exc", [
    (dict(num_processes=1), ValueError),
    (dict(coordinator_address="x", process_id=0), ValueError),
    (dict(num_processes=1, process_id=0, backend="no-such-backend"),
     (AssertionError, ValueError, RuntimeError)),
], ids=["world-only", "no-world", "bad-backend"])
def test_explicit_failures_propagate(tmp_path, kw, exc):
    kw.setdefault("coordinator_address", f"file://{tmp_path / 'pg'}")
    with pytest.raises(exc):
        MESH.init_distributed(**kw)
    assert not dist.is_initialized()


@pytest.mark.parametrize("device,backend", [
    ("cpu", "gloo"), (torch.device("cpu"), "gloo"), ("cuda", "nccl"),
    ("cuda:1", "nccl"),
    (None, "nccl" if torch.cuda.is_available() else "gloo"),
])
def test_default_backend_follows_the_rank_device(device, backend):
    # a CPU rank on a host with a card still gets gloo
    assert MESH._default_backend(device) == backend


def test_world_of_one_is_the_identity():
    x = torch.arange(4.0)
    assert MESH.fixed_order_sum(x, None) is x
    assert MESH.fetch_global(x, MESH.make_data_group("cpu"))[0] is x
    assert MESH.rank_device("cpu", 3) == torch.device("cpu")


def _fail(rank):
    if rank == 1:
        raise RuntimeError("rank 1 fails")


def _hang(rank):
    import time
    time.sleep(60)


def test_spawn_fails_with_a_rank_and_times_out():
    with pytest.raises(Exception, match="rank 1 fails"):
        MESH.spawn(_fail, 2, timeout_s=SPAWN_TIMEOUT_S)
    with pytest.raises(TimeoutError):
        MESH.spawn(_hang, 1, timeout_s=2.0)


_FAKE_NVCC = """#!/bin/sh
# a stand-in compiler: log the call, take a while, write the -o target
echo "$$" >> "$(dirname "$0")/calls"
sleep 1
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo lib > "$2"; fi
  shift
done
"""


def test_ranks_starting_together_build_once(tmp_path):
    """Four processes that need the same kernel at once: one compiles it
    (under build.lock), the others wait for its library."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    out = tmp_path / "kernels"
    MESH.spawn(RK.build_rank, 4, (str(out), str(home)),
               timeout_s=SPAWN_TIMEOUT_S)
    assert len((home / "bin" / "calls").read_text().split()) == 1
    libs = [p.name for p in out.iterdir() if p.name.startswith("librecover")]
    assert len(libs) == 1 and libs[0].endswith(".so")
