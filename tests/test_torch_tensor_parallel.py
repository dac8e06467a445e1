"""Tensor parallelism over "model" on the port, against its meshless self
and the reference, on gloo ranks on the CPU (tests/torch_tp_ranks.py,
through `repro_torch.launch.mesh.spawn`).

* `Mesh.sum_axis` (an all-to-all, each rank's fold of its block, an
  all-gather) is bit-equal to the all-gather fold it replaced and to a
  left fold of every rank's operand in row-major rank order, on every
  rank of a (2, 2) ("data", "model") mesh: f32 and bf16, shapes (),
  (3,), (5, 7) and (1000,), over ("model",), ("data", "model") and
  ("model", "data"). `sharding.regroup_model` (one all-to-all of uneven
  blocks) on the same four ranks as (1, 4): pieces and gradients exact.
* On the (1, 2) mesh, `models.model.loss_fn` and its per-leaf gradients
  (gathered from each rank's shards) against the port's meshless
  `loss_fn` and the reference's (``jax.value_and_grad``), at the pod
  mesh's tolerances (tests/test_torch_pod_mesh.py): loss rtol 2e-6,
  rel. L2 1e-5 per leaf; and a few `decode_step`s (cache laid out by
  `cache_specs`) and `prefill` against both, rel. L2 1e-5
  (tests/test_torch_serve_mesh.py's bound). Cases, 2-layer smoke
  configs: Qwen1.5-4B (4 heads over 2 kv heads, QKV bias: the rank's q,
  k and v columns are whole heads), the same with 3 heads of 32 (q not
  whole heads: gathered as an activation, every rank attending over
  every head), with 6 heads over 3 kv heads (whole query heads, but the
  kv heads they read straddle the ranks: cut from the whole k/v,
  gathered as activations), with an odd vocabulary (the LM head and the
  embedding stay whole), Granite-34B (one kv head, read by every
  rank's query heads); DeepSeek-V3 (one dense and one MoE MLA layer, 4
  heads: MLA on the rank's heads), the same with 3 heads (``w_uq``'s
  columns split but not into whole heads, ``w_uk``/``w_uv`` whole: q
  gathered as an activation); Mamba2 (8 SSM heads: the rank's heads, its
  [z | x] block of ``w_zx`` exchanged into its z and x, the conv
  channels of the decode cache not aligned with them), the same at
  d_model 96 and head dim 64 (3 heads: z and x gathered as activations,
  every head on every rank, the rank's rows of the norm and of
  ``w_out``), the same at d_model 32 (the 32 training tokens are as many
  as d: ``w_zx``'s pieces move as weight columns, not as the product's);
  Zamba2 (Mamba2 layers and the shared GQA block).
* The census (`launch.dryrun`, on ``meta``) of a dense smoke prefill, of
  `loss_fn`'s forward and backward and of a Mamba2 smoke prefill on
  (1, 2): the bytes received over "model" equal the closed form of their
  activation sums, gathers and ``w_zx``'s exchange (`_model_bytes`);
  no whole-leaf gather over "model" in the Track-B train steps and
  decode steps of the dense, DeepSeek, Mamba2 and Zamba2 smoke configs
  on (1, 2), nor in ``decode_32k`` of Qwen1.5-4B, Mamba2-780M and
  Zamba2-1.2B on (16, 16), each of which receives under 0.1 GB over
  "model".
"""
import concurrent.futures
import dataclasses
import math
import pickle
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import torch_tp_ranks as RK  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.fl import distributed as TD  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

SPAWN_TIMEOUT_S = 120.0
LOSS_RTOL = 2e-6
LEAF_REL = 1e-5
LOGITS_REL = 1e-5
B, S, SEQ, STEPS = 2, 16, 8, 4
TP_CASES = {
    "qwen": ("qwen1p5_4b", dict(n_layers=2)),
    "qwen_3_heads": ("qwen1p5_4b", dict(n_layers=2, n_heads=3,
                                        n_kv_heads=3)),
    "qwen_6_over_3": ("qwen1p5_4b", dict(n_layers=2, n_heads=6,
                                         n_kv_heads=3)),
    "qwen_odd_vocab": ("qwen1p5_4b", dict(n_layers=2, vocab=511)),
    "granite": ("granite_34b", dict(n_layers=2)),
    "deepseek": ("deepseek_v3_671b", dict(n_layers=2)),
    "deepseek_3_heads": ("deepseek_v3_671b", dict(n_layers=2, n_heads=3)),
    "mamba2": ("mamba2_780m", {}),
    "mamba2_3_heads": ("mamba2_780m", dict(d_model=96, ssm_head_dim=64)),
    "mamba2_narrow": ("mamba2_780m", dict(d_model=32, ssm_head_dim=16)),
    "zamba2": ("zamba2_1p2b", {}),
}
META = torch.device("meta")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name: str, seed: int) -> dict:
    arch, over = TP_CASES[name]
    cfg = dataclasses.replace(TC.get(arch).smoke(), **over)
    rng = np.random.default_rng(np.random.SeedSequence(seed,
                                                       spawn_key=(25,)))
    params = TD.tree_map(lambda a: a.numpy(), TM.init_params(
        cfg, torch.Generator().manual_seed(seed), "cpu"))
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return {"name": name, "arch": arch, "cfg": over, "params": params,
            "batch": {"tokens": toks, "labels": toks.copy()},
            "tokens": toks[:, :STEPS].copy(), "seq": SEQ}


def _spawn(fn, world, args, failed):
    try:
        MESH.spawn(fn, world, args, timeout_s=SPAWN_TIMEOUT_S)
    except Exception as e:              # re-raised by the fixture
        failed.append(e)


def _load(out, world):
    res = []
    for r in range(world):
        with open(f"{out}.{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


def _port(case) -> dict:
    """The port's meshless loss, gradients, decode steps and prefill."""
    cfg = dataclasses.replace(TC.get(case["arch"]).smoke(), **case["cfg"])
    params = TM.from_reference(case["params"], cfg, "cpu")
    leaves = TD.tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    loss = TM.loss_fn(params, batch, cfg, "cpu")
    grads = torch.autograd.grad(loss, leaves)
    out = {"loss": float(loss.detach()), "grads": {
        "/".join(p): g.numpy() for p, g in zip(TD._leaf_paths(params),
                                               grads)}}
    tokens = torch.from_numpy(case["tokens"])
    with torch.no_grad():
        cache = TM.init_cache(cfg, B, SEQ, "cpu")
        length = torch.zeros(B, dtype=torch.int32)
        logits = []
        for i in range(STEPS):
            lg, cache = TM.decode_step(params, cache, {
                "tokens": tokens[:, i:i + 1]}, length, cfg, "cpu")
            logits.append(lg.numpy())
            length = length + 1
        out["decode"] = np.stack(logits)
        out["prefill"] = TM.prefill(params, {"tokens": tokens}, cfg,
                                    "cpu").numpy()
    return out


def _reference(case) -> dict:
    """The reference's meshless loss and gradients, decode steps and
    prefill, on the same parameters."""
    cfg = dataclasses.replace(RC.get(case["arch"]).smoke(), **case["cfg"])
    params = jax.tree.map(jnp.asarray, case["params"])
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: RM.loss_fn(p, batch, cfg)))(params)
    paths = TD._leaf_paths(case["params"])
    out = {"loss": float(loss), "grads": {
        "/".join(p): np.asarray(TD._get(grads, p)) for p in paths}}
    decode = jax.jit(lambda p, c, t, n: RM.decode_step(
        p, c, {"tokens": t}, n, cfg))
    cache = RM.init_cache(cfg, B, SEQ)
    length = jnp.zeros((B,), jnp.int32)
    logits = []
    for i in range(STEPS):
        lg, cache = decode(params, cache,
                           jnp.asarray(case["tokens"][:, i:i + 1]), length)
        logits.append(np.asarray(lg))
        length = length + 1
    out["decode"] = np.stack(logits)
    out["prefill"] = np.asarray(jax.jit(lambda p, t: RM.prefill(
        p, {"tokens": t}, cfg))(params, jnp.asarray(case["tokens"])))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(sum ranks, TP ranks, the cases, the port's and the reference's
    meshless results): both worlds and the oracles run at once."""
    d = tmp_path_factory.mktemp("tp")
    cases = {n: _case(n, i) for i, n in enumerate(TP_CASES)}
    failed = []
    threads = [threading.Thread(target=_spawn, args=(
        RK.sum_rank, 4, (4, str(d / "pg_sum"), str(d / "sum")), failed)),
        threading.Thread(target=_spawn, args=(
            RK.tp_rank, 2, (2, str(d / "pg_tp"), str(d / "tp"),
                            list(cases.values())), failed))]
    for th in threads:
        th.start()
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            refs = dict(zip(cases, ex.map(_reference, cases.values())))
        ports = {n: _port(c) for n, c in cases.items()}
    finally:
        for th in threads:
            th.join()
    if failed:
        raise failed[0]
    return (_load(d / "sum", 4), _load(d / "tp", 2), cases, ports, refs)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)


# ---------------------------------------------------------------------------
# The two-phase sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(RK.SUM_CASES)),
                         ids=[f"{dt}-{'x'.join(map(str, sh)) or 'scalar'}-"
                              f"{'+'.join(ax)}"
                              for dt, sh, ax in RK.SUM_CASES])
def test_sum_axis_is_the_old_fold_bit_for_bit(world, i):
    ranks = world[0]
    dt, shape, axes = RK.SUM_CASES[i]
    mesh = MESH.abstract_mesh(RK.SUM_SHAPE, RK.SUM_NAMES)
    first = None
    for res in ranks:
        new, old = res["sums"][i]
        assert new.dtype == old.dtype and tuple(new.shape) == shape
        assert torch.equal(new, old), res["coords"]
        # every rank of the group holds the same bits: a left fold of the
        # group's operands, row-major over the axes in the order given
        me = dataclasses.replace(mesh, coords=res["coords"])
        members = [r for r, o in enumerate(ranks) if all(
            o["coords"][RK.SUM_NAMES.index(a)] == me.coords[
                RK.SUM_NAMES.index(a)]
            for a in RK.SUM_NAMES if a not in axes)]
        members.sort(key=lambda r: dataclasses.replace(
            mesh, coords=ranks[r]["coords"]).index_over(axes))
        want = RK.sum_input(members[0], dt, shape)
        for r in members[1:]:
            want = want + RK.sum_input(r, dt, shape)
        assert torch.equal(new, want), res["coords"]
        if len(members) == 4:
            first = new if first is None else first
            assert torch.equal(new, first)


@pytest.mark.parametrize("i", range(len(RK.REGROUP_GROUPS)),
                         ids=[f"{g}-segments" for g in RK.REGROUP_GROUPS])
def test_regroup_model_moves_pieces_and_gradients(world, i):
    """`sharding.regroup_model` on four "model" ranks: each rank's
    contiguous block of a leaf of 2 or 3 segments becomes its piece of
    every segment, and each piece's gradient goes back to the rank that
    stores it, exactly."""
    for r, res in enumerate(world[0]):
        case = res["regroup"][i]
        want = RK.regroup_case(r, len(world[0]), RK.REGROUP_GROUPS[i])
        assert torch.equal(case["got"], want["want"]), r
        assert torch.equal(case["grad"], want["want_grad"]), r


# ---------------------------------------------------------------------------
# Loss, gradients, decode and prefill on (1, 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(TP_CASES))
def test_tp_loss_and_gradients_match_meshless_and_reference(world, name):
    _, ranks, cases, ports, refs = world
    got, other = ranks[0][name]["grads"], ranks[1][name]["grads"]
    assert got[0] == other[0]                   # every rank's loss, bits
    for k in got[1]:
        assert np.array_equal(got[1][k], other[1][k]), k
    for want in (ports[name], refs[name]):
        assert got[0] == pytest.approx(want["loss"], rel=LOSS_RTOL)
        assert set(got[1]) == set(want["grads"])
        for k, g in got[1].items():
            assert g.shape == want["grads"][k].shape, k
            assert _rel(want["grads"][k], g) <= LEAF_REL, (k, _rel(
                want["grads"][k], g))


@pytest.mark.parametrize("name", list(TP_CASES))
def test_tp_decode_and_prefill_match_meshless_and_reference(world, name):
    _, ranks, cases, ports, refs = world
    dec, pre = ranks[0][name]["serve"]
    assert np.array_equal(dec, ranks[1][name]["serve"][0])
    assert np.array_equal(pre, ranks[1][name]["serve"][1])
    for want in (ports[name], refs[name]):
        assert dec.shape == want["decode"].shape
        for i in range(STEPS):
            assert _rel(want["decode"][i], dec[i]) <= LOGITS_REL, i
        assert _rel(want["prefill"], pre) <= LOGITS_REL


# ---------------------------------------------------------------------------
# The census: bytes over "model" in closed form, no leaf gathered there
# ---------------------------------------------------------------------------

def _sum_bytes(numel: int, elem: int, n: int) -> int:
    """Bytes a rank receives in `Mesh.sum_axis` of ``numel`` elements of
    ``elem`` bytes over n ranks: the all-to-all's and the all-gather's
    (n − 1) blocks of ceil(numel / n) (a tensor of fewer than n elements:
    the other ranks' whole operands)."""
    if numel < n:
        return (n - 1) * numel * elem
    return 2 * (n - 1) * math.ceil(numel / n) * elem


def _model_bytes(census) -> int:
    return sum(c["received"] for c in census.calls if c["axes"] == ["model"])


def _ops(census, op) -> int:
    return sum(c["op"] == op and c["axes"] == ["model"]
               for c in census.calls)


def _meta_local(cfg, mesh):
    local = SH.shard_tree(TM.init_abstract(cfg), TM.param_specs(cfg, mesh),
                          mesh)
    for x in TD.tree_leaves(local):
        x.requires_grad_(True)
    return local


def test_census_model_bytes_are_the_closed_form():
    """Qwen1.5-4B's smoke config at 2 layers on (1, 2), f32, batch 2 ×
    16: a prefill receives over "model" the vocab-parallel embedding's sum
    of [B, S, d] and each layer's two sums of its f64 partial products
    [B, S, d] (attention after ``wo``, the SwiGLU after ``w_down``), plus
    the last position's logits gathered
    ([B, V/2] from the other rank); a training forward and backward adds
    the cross entropy's MAX of the [B, S − 1] row maxima and its two sums
    of [B, S − 1] (exps, label logit) and, backward, the sums at the
    three `copy_to_model` inputs (attention, SwiGLU, LM head) of [B, S,
    d] each per layer or head."""
    arch, over = TP_CASES["qwen"]
    cfg = dataclasses.replace(TC.get(arch).smoke(), **over)
    n, d, v, L = 2, cfg.d_model, cfg.vocab, cfg.n_layers
    act = _sum_bytes(B * S * d, 4, n)
    wide = _sum_bytes(B * S * d, 8, n)      # f64 partials of wo, w_down
    toks = torch.empty((B, S), dtype=torch.int32, device=META)

    mesh = MESH.census_mesh((1, n), ("data", "model"))
    DR.census(cfg, dict(kind="prefill", seq=S, batch=B), mesh)
    assert _model_bytes(mesh.census) == act + 2 * L * wide + (n - 1) * (
        B * (v // n) * 4)
    assert _ops(mesh.census, "all-gather") == _ops(mesh.census,
                                                   "all-to-all") + 1

    mesh = MESH.census_mesh((1, n), ("data", "model"))
    local = _meta_local(cfg, mesh)
    loss = TM.loss_fn(local, {"tokens": toks, "labels": toks}, cfg, "meta",
                      mesh)
    torch.autograd.grad(loss, TD.tree_leaves(local))
    rows = B * (S - 1)
    want = (act + 2 * L * wide + (n - 1) * rows * 4        # forward, MAX
            + 2 * _sum_bytes(rows, 4, n)                    # exps, label
            + (2 * L + 1) * act)                            # backward
    assert _model_bytes(mesh.census) == want
    assert _ops(mesh.census, "all-gather") == _ops(mesh.census,
                                                   "all-to-all")


def _model_gathers(monkeypatch) -> list:
    """Shapes of the leaves `sharding.gather_leaf` gathers over "model"
    from here on."""
    seen = []
    orig = SH.gather_leaf

    def gather_leaf(local, spec, mesh):
        if "model" in SH.spec_axes(spec):
            seen.append(tuple(local.shape))
        return orig(local, spec, mesh)

    monkeypatch.setattr(SH, "gather_leaf", gather_leaf)
    return seen


def test_census_mamba2_model_bytes_are_the_closed_form():
    """Mamba2's smoke config (8 SSM heads, d_inner 256) on (1, 2), f32,
    batch 2 × 16: a prefill receives over "model" the vocab-parallel
    embedding's sum of [B, S, d]; per layer the other rank's piece of
    ``x @ w_zx``, its [B, S, d_inner / 2] block of z or of x (the B·S
    tokens are fewer than d, so the product's pieces move, not the
    weight's: `regroup_model`), the gated norm's sum of its [B, S, 1] f32
    sums of squares and the sum of ``w_out``'s f64 partial products
    [B, S, d]; and the last position's logits gathered ([B, V/2] from the
    other rank). The exchange is the only all-to-all-v."""
    cfg = TC.get("mamba2_780m").smoke()
    n, d, v, L = 2, cfg.d_model, cfg.vocab, cfg.n_layers
    assert B * S < d
    zx_piece = B * S * (cfg.d_inner // n) * 4
    want = (_sum_bytes(B * S * d, 4, n)
            + L * (zx_piece + _sum_bytes(B * S, 4, n)
                   + _sum_bytes(B * S * d, 8, n))
            + (n - 1) * B * (v // n) * 4)
    mesh = MESH.census_mesh((1, n), ("data", "model"))
    DR.census(cfg, dict(kind="prefill", seq=S, batch=B), mesh)
    assert _model_bytes(mesh.census) == want
    assert _ops(mesh.census, "all-to-all-v") == L
    assert _ops(mesh.census, "all-gather") == _ops(mesh.census,
                                                   "all-to-all") + 1


def _model_gathers(monkeypatch) -> list:
    """Shapes of the leaves `sharding.gather_leaf` gathers over "model"
    from here on."""
    seen = []
    orig = SH.gather_leaf

    def gather_leaf(local, spec, mesh):
        if "model" in SH.spec_axes(spec):
            seen.append(tuple(local.shape))
        return orig(local, spec, mesh)

    monkeypatch.setattr(SH, "gather_leaf", gather_leaf)
    return seen


# the production decodes (rank 0 of (16, 16)) and the "model" bytes a step
# their leaves' gathers received before tensor parallelism (census (meta,
# CPU), PERF.md §5): the mesh receives far less now
NO_GATHER_DECODES = {"qwen1p5_4b": 5.0e9, "mamba2_780m": 0.88e9,
                     "zamba2_1p2b": 1.24e9}


def test_no_leaf_is_gathered_over_model(monkeypatch):
    """A Track-B train step and a decode step of the dense, DeepSeek,
    Mamba2 and Zamba2 smoke configs on (1, 2), and ``decode_32k`` of
    Qwen1.5-4B, Mamba2-780M and Zamba2-1.2B at full width on (16, 16),
    rank 0: every leaf the specs split over "model" is used as the rank's
    block; each production decode receives under 0.1 GB over "model"
    (against 0.88–5.0 GB a step when the leaves were gathered)."""
    seen = _model_gathers(monkeypatch)
    for name in ("granite", "deepseek", "mamba2", "zamba2"):
        arch, over = TP_CASES[name]
        cfg = dataclasses.replace(TC.get(arch).smoke(), **over)
        for cell in (dict(kind="train", seq=S, batch=B),
                     dict(kind="decode", seq=SEQ, batch=B)):
            DR.census(cfg, cell, MESH.census_mesh((1, 2), ("data",
                                                           "model")))
        assert seen == [], name
    for arch, before in NO_GATHER_DECODES.items():
        mesh = MESH.census_mesh((16, 16), ("data", "model"))
        DR.census(TC.get(arch), "decode_32k", mesh)
        assert seen == [], arch
        assert _model_bytes(mesh.census) < min(1e8, before / 10), arch
    # the cache splits the sequence over "model" (20 kv heads do not
    # divide 16): q, k and v are gathered there, never wq/wk/wv
    assert SP.cache_specs(TC.get("qwen1p5_4b"), MESH.abstract_mesh(
        (16, 16), ("data", "model")), 128, 32768)["layers"]["k"][2] == "model"


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_row_parallel_partials_stay_wide(dt):
    """A row-parallel partial product is its accumulator at twice the
    operands' precision (f32 for bf16, f64 for f32: the product of the
    casts, exact products, on the CPU), and its backward is the plain
    matmul's in the operands' dtype."""
    dtype = getattr(torch, dt)
    wide = torch.float64 if dtype == torch.float32 else torch.float32
    g = torch.Generator().manual_seed(4)
    y = torch.randn(2, 3, 40, generator=g).to(dtype)
    w = torch.randn(40, 24, generator=g).to(dtype)
    up = torch.randn(2, 3, 24, generator=g).to(dtype)
    y1, w1 = y.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = TL.WideMatmul.apply(y1, w1)
    assert out.dtype == wide
    assert torch.equal(out, torch.matmul(y.to(wide), w.to(wide)))
    out.backward(up.to(wide))
    y2, w2 = y.clone().requires_grad_(True), w.clone().requires_grad_(True)
    torch.matmul(y2, w2).backward(up)
    assert torch.equal(y1.grad, y2.grad) and torch.equal(w1.grad, w2.grad)
    meta = TL.WideMatmul.apply(y.to(META), w.to(META))
    assert meta.dtype == wide and meta.shape == out.shape
