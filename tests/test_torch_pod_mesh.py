"""Track B over a pod mesh on the port: one world of 8 gloo ranks on the
CPU as the ("pod", "data", "model") mesh (2, 2, 2)
(tests/torch_pod_mesh_ranks.py, through `mesh.spawn`), held to the
reference composed from its meshless functions: pod p runs
``repro.fl.distributed._cohort_round(..., mesh=None, backend="jnp")`` on
its block of the batch's rows, the aggregate is the mean of the pods'
wire-format deltas and the server step is ``(p − lr·agg.f32)`` cast back —
what the reference's ``shard_map`` over "pod" computes by construction
(GSPMD within a pod does not change the math).

Cases, two steps each from one seeded initial model (the port's
``init_params``, handed to both packages as numpy):
* the reference's multipod config (Qwen1.5-4B's smoke config at d_model
  64, 2 heads, vocab 128; batch 8 × 16) with error feedback and the bf16
  wire (``compressed_collective``), and with the int8 stale model;
* Llama-4-Scout's smoke config (experts over "model", a shared expert)
  and DeepSeek-V3's (MLA, a dense and MoE stack), with
  ``capacity_factor`` 8.0: a capacity of at least every token routed
  there, both for a data rank's 32 tokens and for the pod's 64, so no
  token is dropped on either side (a mesh routes each data rank's tokens
  with the capacity of its own count, the reference's ``t_loc``).

Each case's two steps are held to the reference's composition and to
the port's own (`fl.distributed.make_pods_step`, pod by pod on one device:
the mesh's sharding alone). Tolerances, those of
tests/test_torch_distributed.py: loss rtol 2e-6; params and stale models
rel. L2 1e-5 per leaf; residuals (EF) rel. L2 5e-4 per leaf, and per
[pod, layer, expert] slice of the routed experts, outside the flipped
elements, which are counted: an element one side holds at zero and the
other not (a delta at the upload threshold, or F4's download-threshold
edge moving a weight's stale copy), or whose two residuals have opposite
signs (under the bf16 wire a residual is the wire cast's rounding error,
which changes sign where the two deltas round to neighbouring bf16
values). At most FLIP_MAX flips per case, or WIRE_FLIP_SHARE of the
residual's elements under the wire (measured 0–7, and 0.47% of 296,320
against the reference, 0.02% against the port's composition; 0–8 cuda
against cpu ranks in chip_smoke.py's phase 11). A residual
element is a difference of two f32 weights (w_init − w_fin), so its
precision floor is an ulp of the weight: ULPS ulps of the stale weight
are added to the bound over the elements either side holds. Against the
reference MOVED_MAX leaf or slice may exceed the bound (measured: the
attention's key bias ``bk`` under the bf16 wire, whose gradient is zero
in exact arithmetic, the softmax being blind to a shift of every key's
logit: its delta is the frameworks' rounding noise); against the port's
composition none.

Exact checks: the sharded ``moe_ffn`` at the config's own capacity
factor, where tokens are dropped, against the reference's meshless
``moe_ffn`` (plus the shared expert) on each data rank's tokens (the same
expert ids and drop masks; outputs within the f32 atol of
test_torch_moe.py); the sharded histogram, thresholds, compress count and
max, top-k and payload bits equal the whole leaf's bit for bit; a resume
through `CheckpointManager` replays the straight run; in one process the
(1, 1) local mesh is bit-identical to ``mesh=None`` for every family.
"""
import concurrent.futures
import dataclasses
import pickle
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import torch_pod_mesh_ranks as RK  # noqa: E402
from repro.fl import distributed as RD  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as R_MOE  # noqa: E402
from repro_torch.fl import distributed as TD  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as T_MOE  # noqa: E402

WORLD = 8
N_PODS = 2
SPAWN_TIMEOUT_S = 240.0
LOSS_RTOL = 2e-6
LEAF_REL = 1e-5
EF_REL = 5e-4
FLIP_EDGE = 0.99
FLIP_MAX = 16
ULPS = 2
MOVED_MAX = 1
WIRE_FLIP_SHARE = 0.02
MOE_ATOL = 1e-5
MULTIPOD = dict(local_iters=1, d_model=64, n_heads=2, n_kv_heads=2,
                d_head=32, vocab=128)
NO_DROP = dict(capacity_factor=8.0)
KW = dict(theta_d=0.3, theta_u=0.4, local_lr=1e-2)
TRAIN = {
    "qwen_ef_wire": ("qwen1p5_4b", MULTIPOD,
                     dict(KW, use_error_feedback=True,
                          compressed_collective=True)),
    "qwen_int8": ("qwen1p5_4b", MULTIPOD, dict(KW, prev_int8=True)),
    "llama4": ("llama4_scout_17b_a16e", NO_DROP,
               dict(KW, use_error_feedback=True)),
    "deepseek": ("deepseek_v3_671b", NO_DROP,
                 dict(KW, use_error_feedback=True)),
}
MOE_ARCH = "llama4_scout_17b_a16e"
MOE_X_SHAPE = (8, 16)
COMP_SPECS = [("data", "model"), (None, ("pod", "data", "model"))]
COMP_RATIOS = [0.0, 0.3, 0.7, 1.0]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """This module's torch work is many small ops: one intra-op thread
    keeps them from waiting on a thread pool the other test workers'
    threads crowd out."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_cfg(arch, over):
    return dataclasses.replace(RC.get(arch).smoke(), **over)


def _batches(cfg, seed, steps=2, batch=8, seq=16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
        out.append({"tokens": toks, "labels": toks.copy()})
    return out


def _moe_case():
    cfg = TC.get(MOE_ARCH).smoke()
    params = TM.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    p = TD.tree_map(lambda a: a[0].numpy(), params["moe_layers"]["ffn"])
    x = np.random.default_rng(5).standard_normal(
        MOE_X_SHAPE + (cfg.d_model,)).astype(np.float32)
    return {"kind": "moe", "arch": MOE_ARCH, "p": p, "x": x}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    out = {}
    for i, (name, (arch, over, dist)) in enumerate(TRAIN.items()):
        cfg = dataclasses.replace(TC.get(arch).smoke(), **over)
        params = TD.tree_map(lambda a: a.numpy(), TM.init_params(
            cfg, torch.Generator().manual_seed(i), "cpu"))
        out[name] = {"kind": "train", "arch": arch, "cfg": over,
                     "dist": dist, "params": params,
                     "batches": _batches(cfg, 10 + i)}
    out["moe"] = _moe_case()
    out["compression"] = {
        "kind": "compression", "specs": COMP_SPECS, "ratios": COMP_RATIOS,
        "x": (np.random.default_rng(7).standard_normal((16, 24))
              * np.linspace(0.1, 3.0, 24)).astype(np.float32)}
    out["resume"] = {"kind": "resume", "cfg": MULTIPOD, "steps": 4,
                     "cut": 2,
                     "dir": str(tmp_path_factory.mktemp("pod_ckpt"))}
    return out


@pytest.fixture(scope="module")
def world(cases, tmp_path_factory):
    """(every rank's results, the reference's composed steps per case):
    the reference runs while the ranks do."""
    d = tmp_path_factory.mktemp("pod_mesh")
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    failed = []

    def go():
        try:
            MESH.spawn(RK.pod_mesh_rank, WORLD,
                       (WORLD, str(d / "pg"), str(d / "out"),
                        str(d / "cases.pkl")), timeout_s=SPAWN_TIMEOUT_S)
        except Exception as e:          # re-raised below
            failed.append(e)

    th = threading.Thread(target=go)
    th.start()
    try:
        # each case's reference compiles on its own thread
        with concurrent.futures.ThreadPoolExecutor(len(TRAIN)) as ex:
            oracles = dict(zip(TRAIN, ex.map(lambda n: _oracle(cases[n]),
                                             TRAIN)))
    finally:
        th.join()
    if failed:
        raise failed[0]
    return RK.load(str(d / "out"), WORLD), oracles


@pytest.fixture(scope="module")
def ranks(world):
    return world[0]


def _pod_rows(b, p):
    r = b["tokens"].shape[0] // N_PODS
    return {k: jnp.asarray(v[p * r:(p + 1) * r]) for k, v in b.items()}


def _oracle(case):
    """The reference's two steps composed pod by pod, jitted once."""
    cfg = _ref_cfg(case["arch"], case["cfg"])
    dcfg = RD.DistConfig(backend="jnp", **case["dist"])
    params = jax.tree.map(jnp.asarray, case["params"])
    st = RD.init_state(params, dcfg, mesh=None)

    def pods(t):
        return None if t is None else jax.tree.map(
            lambda a: jnp.broadcast_to(a, (N_PODS,) + a.shape[1:]), t)

    prev, ef = pods(st.prev_params), pods(st.ef)

    @jax.jit
    def pod_round(params, prev_p, ef_p, batch_p, theta_d, theta_u):
        return RD._cohort_round(params, prev_p, ef_p, batch_p, theta_d,
                                theta_u, cfg, dcfg, None, backend="jnp")

    def pick(t, p):
        return None if t is None else jax.tree.map(lambda a: a[p], t)

    def stack(*xs):
        return jnp.stack(xs)

    losses = []
    for b in case["batches"]:
        outs = [pod_round(params, pick(prev, p), pick(ef, p),
                          _pod_rows(b, p), st.theta_d, st.theta_u)
                for p in range(N_PODS)]
        agg = jax.tree.map(lambda *ds: sum(ds[1:], ds[0]) / N_PODS,
                           *[o[0] for o in outs])
        params = jax.tree.map(lambda p, d: (p - dcfg.server_lr * d.astype(
            jnp.float32)).astype(p.dtype), params, agg)
        prev = jax.tree.map(stack, *[o[1] for o in outs])
        ef = None if ef is None else jax.tree.map(stack,
                                                  *[o[2] for o in outs])
        losses.append(float(sum((o[3] for o in outs[1:]), outs[0][3])
                            / N_PODS))
    return losses, {"params": params, "prev_params": prev, "ef": ef}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)


def _port_oracle(case):
    """The port's own composition of the same two steps, pod by pod on
    one device (`fl.distributed.make_pods_step`)."""
    cfg = dataclasses.replace(TC.get(case["arch"]).smoke(), **case["cfg"])
    dcfg = TD.DistConfig(**case["dist"])
    st = TD.init_state(TM.from_reference(case["params"], cfg, "cpu"), dcfg)

    def pods(t):
        return None if t is None else TD.tree_map(
            lambda a: a.expand((N_PODS,) + tuple(a.shape[1:])).clone(), t)

    st = dataclasses.replace(st, prev_params=pods(st.prev_params),
                             ef=pods(st.ef))
    step = TD.make_pods_step(cfg, dcfg, N_PODS, device="cpu")
    losses = []
    for b in case["batches"]:
        st, m = step(st, {k: torch.from_numpy(v.copy())
                          for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, {f: (None if getattr(st, f) is None else TD.tree_map(
        lambda a: a.numpy(), getattr(st, f)))
        for f in ("params", "prev_params", "ef")}


def _compare(case, want_losses, want, got, moved_max):
    """Losses, params and stale models at the stated tolerances; the
    residuals outside their flips (counted), per expert for the routed
    experts' leaves, at most ``moved_max`` slices beyond the bound."""
    for lr_, lt in zip(want_losses, got["losses"]):
        assert lt == pytest.approx(lr_, rel=LOSS_RTOL)
    wire = case["dist"].get("compressed_collective", False)
    flips = n_ef = 0
    moved = []
    for field in ("params", "prev_params", "ef"):
        a_tree, b_tree = want[field], got["state"][field]
        if a_tree is None:
            assert b_tree is None
            continue
        for q in TD._leaf_paths(b_tree):
            a, b = np.asarray(TD._get(a_tree, q)), TD._get(b_tree, q)
            assert a.shape == b.shape and str(a.dtype) == str(b.dtype), q
            if field != "ef":
                assert _rel(a, b) <= LEAF_REL, (field, q, _rel(a, b))
                continue
            flip = ((a == 0) != (b == 0)) | (
                (a != 0) & (b != 0) & (np.sign(a) != np.sign(b)))
            flips += int(flip.sum())
            n_ef += a.size
            a, b = np.where(flip, 0, a), np.where(flip, 0, b)
            # a residual element is a difference of two f32 weights: its
            # precision floor is an ulp of the weight, where either holds it
            w = np.abs(TD._get(got["state"]["prev_params"], q)
                       .astype(np.float32))
            floor = np.where((a != 0) | (b != 0), ULPS * np.spacing(w), 0)
            expert = (q[0] == "moe_layers" and q[-2] == "ffn"
                      and q[-1] != "router")
            # [pod, layer, expert] slices of the routed experts' residuals
            for sl in (np.ndindex(a.shape[:3]) if expert else [()]):
                aa, bb = a[sl], b[sl]
                if np.linalg.norm(aa - bb) > (EF_REL * np.linalg.norm(aa)
                                              + np.linalg.norm(floor[sl])):
                    moved.append((q, sl))
    assert flips <= (WIRE_FLIP_SHARE * n_ef if wire else FLIP_MAX), flips
    assert len(moved) <= moved_max, moved


@pytest.mark.parametrize("name", list(TRAIN))
def test_pod_mesh_steps_match_the_composed_reference(cases, world, name):
    ranks, oracles = world
    got = ranks[0][name]
    for r in ranks[1:]:                      # every rank holds the same
        assert r[name]["losses"] == got["losses"]
    _compare(cases[name], *oracles[name], got, MOVED_MAX)


@pytest.mark.parametrize("name", list(TRAIN))
def test_pod_mesh_steps_match_the_port_composed_pod_by_pod(cases, ranks,
                                                           name):
    _compare(cases[name], *_port_oracle(cases[name]), ranks[0][name], 0)


def test_every_rank_holds_its_shards(ranks):
    """Each rank's params are its blocks: the Qwen case's lm_head [64, 128]
    is split over "data" and "model" (specs (data, model)), so a rank holds
    [32, 64] of it; the whole tree gathers to the same on every rank."""
    got = ranks[0]["qwen_int8"]
    shapes = got["local_shapes"]
    assert (32, 64) in shapes
    for r in ranks[1:]:
        assert r["qwen_int8"]["local_shapes"] == shapes
        for f in ("params", "prev_params"):
            for a, b in zip(TD.tree_leaves(r["qwen_int8"]["state"][f]),
                            TD.tree_leaves(got["state"][f])):
                assert np.array_equal(a, b)


def test_sharded_moe_ffn_drops_as_the_reference_per_data_shard(cases,
                                                               ranks):
    case = cases["moe"]
    cfg_r = RC.get(MOE_ARCH).smoke()
    cfg_t = TC.get(MOE_ARCH).smoke()
    p = case["p"]
    sh = p["shared"]
    r = MOE_X_SHAPE[0] // 2
    want = {}
    for d in range(2):                    # the reference, per data shard
        xd = case["x"][d * r:(d + 1) * r]
        xj = jnp.asarray(xd)
        y = np.asarray(R_MOE.moe_ffn(xj, jax.tree.map(jnp.asarray, p),
                                     cfg_r)
                       + RL.swiglu(xj, sh["w_gate"], sh["w_up"],
                                   sh["w_down"]))
        ids, _ = R_MOE.route(xj.reshape(-1, xd.shape[-1]), p["router"],
                             cfg_r.moe_top_k)
        T_MOE.record_routes = []
        T_MOE.moe_ffn(torch.from_numpy(xd.copy()),
                      {k: torch.from_numpy(v.copy()) for k, v in p.items()
                       if k != "shared"}, cfg_t)
        (_, drops), = T_MOE.record_routes
        T_MOE.record_routes = None
        want[d] = (y, np.asarray(ids), drops.numpy())
    for res in ranks:
        y, ids, drops = want[res["coords"][1]]
        got = res["moe"]
        np.testing.assert_allclose(got["y"], y, atol=MOE_ATOL)
        assert np.array_equal(got["ids"], ids)
        assert np.array_equal(got["drops"], drops)
    assert sum(int(w[2].sum()) for w in want.values()) > 0   # it binds


def test_sharded_thresholds_and_counts_are_the_whole_leafs(ranks):
    for res in ranks:
        for leaf in res["compression"]:
            for key in ("max", "cdf"):
                a, b = leaf[key]
                assert np.array_equal(a, b), key
            for (thr, thr_w), comp, topk in zip(leaf["thr"],
                                                leaf["compress"],
                                                leaf["topk"]):
                assert np.array_equal(thr, thr_w)
                for key in ("kept", "sign", "count", "max", "bits"):
                    a, b = comp[key]
                    assert np.array_equal(a, b), key
                np.testing.assert_allclose(*comp["sum_abs"], rtol=1e-6)
                for key in ("sparse", "bits"):
                    a, b = topk[key]
                    assert np.array_equal(a, b), key


def test_resume_on_the_mesh_replays_the_straight_run(ranks):
    for res in ranks:
        got = res["resume"]
        straight, resumed = got["losses"]
        assert got["start"] == 2
        assert resumed == straight[2:]
        assert got["same_state"]


FAMILIES = ["qwen1p5_4b", "llama4_scout_17b_a16e", "deepseek_v3_671b",
            "zamba2_1p2b", "mamba2_780m", "hubert_xlarge", "internvl2_2b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_local_mesh_is_bit_identical_to_no_mesh(arch):
    """Two steps on the (1, 1) mesh of a world of 1 and without a mesh:
    the same losses and states bit for bit (EF and the bf16 wire on the
    attention and MoE families, the int8 stale model on the others)."""
    cfg = dataclasses.replace(TC.get(arch).smoke(), local_iters=2)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    seq = 32 + (cfg.n_patches if cfg.frontend == "vision" else 0)
    rng = np.random.default_rng(0)
    batches = [train.make_batch(rng, cfg, 4, seq, "cpu") for _ in range(2)]
    wire = cfg.family in ("dense", "moe", "vlm")
    dcfg = TD.DistConfig(**KW, use_error_feedback=wire,
                         compressed_collective=wire, prev_int8=not wire)
    mesh = MESH.make_local_mesh("cpu")
    runs = []
    for m in (None, mesh):
        st = TD.init_state(params, dcfg, m, cfg)
        step = TD.make_train_step(cfg, dcfg, m, device="cpu")
        losses = []
        for b in batches:
            st, out = step(st, b)
            losses.append(out["loss"])
        runs.append((losses, st))
    (la, a), (lb, b) = runs
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    for f in ("params", "prev_params", "ef"):
        if getattr(a, f) is None:
            assert getattr(b, f) is None
            continue
        for x, y in zip(TD.tree_leaves(getattr(a, f)),
                        TD.tree_leaves(getattr(b, f))):
            assert torch.equal(x, y)
