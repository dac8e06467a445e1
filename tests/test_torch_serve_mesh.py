"""Serving and prefill under a mesh on the port: one world of 4 gloo ranks
on the CPU as the ("data", "model") mesh (2, 2)
(tests/torch_serve_mesh_ranks.py, through `mesh.spawn`), held to the
reference's meshless ``decode_step`` and ``prefill`` run on each data
rank's block of rows (its own mesh runs fail on this jax, ROADMAP R2).

Every decoding family's smoke config — Qwen1.5-4B (kv heads over
"model"), Granite-34B (one kv head: with the batch split, the sequence goes
over "model"), Llama-4-Scout (MoE, experts over "model"), DeepSeek-V3 (MLA
latents), Mamba2 (SSM heads and conv channels over "model"), Zamba2
(both, plus the shared attention) and InternVL2 (text decode; prefill with
image patches) — and HuBERT's prefill (the encoder does not decode), each
at B = 4 (the batch split over "data") and B = 1 (the sequence split over
"data", so the segments' softmax partials are merged across ranks). Each
is fed from one seeded ``init_params`` of the port, handed to both
packages, and a seeded random cache of 16 positions with lengths that
cross the segment boundary at 8 during the 3 decode steps (a rank whose
segment holds none of a row's positions gives an empty partial).

Tolerances, f32, the pod-mesh tests' (tests/test_torch_pod_mesh.py):
every step's logits and the prefill's, and every leaf of the gathered
cache after the steps, within relative L2 1e-5 of the reference (the two
frameworks' f32 matmuls and sums, and merged partials against one softmax
over the whole row: measured ≤ 1.9e-6 logits, 1.5e-6 prefill, 1.1e-6
cache).

In one process: kernel 4's plain twin in its lse mode, and the merge of
two halves of a cache (one of them empty), against the reference's
``decode_attention_jnp`` over the whole row; the (1, 1) local mesh is
bit-identical to ``mesh=None`` for every family (decode, cache, prefill).
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
import torch_serve_mesh_ranks as RK  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.fl import distributed as TD  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

WORLD = 4
SPAWN_TIMEOUT_S = 240.0
ORACLE_THREADS = 4
REL = 1e-5                 # logits, prefill and cache leaves, f32 rel. L2
TWIN_ATOL = 1e-6           # plain twin against decode_attention_jnp, f32
SEQ, STEPS, PROMPT = 16, 3, 8
LENGTHS = {4: np.array([3, 6, 8, 12], np.int32), 1: np.array([6], np.int32)}
DECODERS = ["qwen1p5_4b", "granite_34b", "llama4_scout_17b_a16e",
            "deepseek_v3_671b", "mamba2_780m", "zamba2_1p2b", "internvl2_2b"]
ENCODER = "hubert_xlarge"
CASES = [f"{a}-b{b}" for a in DECODERS + [ENCODER] for b in (4, 1)]
DECODE_CASES = [c for c in CASES if not c.startswith(ENCODER)]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Many small ops: one intra-op thread keeps them from waiting on a
    pool the other test workers' threads crowd out."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(np.random.SeedSequence(seed,
                                                        spawn_key=(21,)))


def _prompt(cfg, b, rng) -> dict:
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal(
            (b, PROMPT, cfg.frontend_dim)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab, (b, PROMPT)).astype(
        np.int32)}
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    return out


def _make_case(name: str, seed: int) -> dict:
    arch, b = name.rsplit("-b", 1)
    b = int(b)
    cfg = TC.get(arch).smoke()
    rng = _rng(seed)
    params = TD.tree_map(lambda a: a.numpy(), TM.init_params(
        cfg, torch.Generator().manual_seed(seed), "cpu"))
    case = {"arch": arch, "batch": b, "params": params,
            "prompt": _prompt(cfg, b, rng)}
    if cfg.supports_decode:
        case.update(seq=SEQ, length=LENGTHS[b], cache=TD.tree_map(
            lambda a: (0.5 * rng.standard_normal(tuple(a.shape))).astype(
                np.float32), TM.init_cache(cfg, b, SEQ, "cpu")),
            tokens=[rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
                    for _ in range(STEPS)])
    return case


@pytest.fixture(scope="module")
def cases():
    return {n: _make_case(n, i) for i, n in enumerate(CASES)}


def _blocks(b: int) -> list:
    """The data ranks' blocks of rows (one block when "data" does not
    divide the batch)."""
    n_dp = 2
    if b % n_dp:
        return [slice(0, b)]
    r = b // n_dp
    return [slice(i * r, (i + 1) * r) for i in range(n_dp)]


def _oracle(case: dict) -> dict:
    """The reference's meshless prefill and decode steps on each data
    block of rows, the blocks put back together."""
    cfg = RC.get(case["arch"]).smoke()
    params = jax.tree.map(jnp.asarray, case["params"])
    prefill = jax.jit(lambda p, b: RM.prefill(p, b, cfg))
    out = {"prefill": np.concatenate([np.asarray(prefill(
        params, {k: jnp.asarray(v[blk]) for k, v in case["prompt"].items()}))
        for blk in _blocks(case["batch"])])}
    if "cache" not in case:
        return out
    decode = jax.jit(lambda p, c, t, n: RM.decode_step(
        p, c, {"tokens": t}, n, cfg))
    logits, caches = [], []
    for blk in _blocks(case["batch"]):
        cache = jax.tree.map(lambda a: jnp.asarray(a[:, blk]), case["cache"])
        length = jnp.asarray(case["length"][blk])
        per = []
        for tok in case["tokens"]:
            lg, cache = decode(params, cache, jnp.asarray(tok[blk]), length)
            per.append(np.asarray(lg))
            length = length + 1
        logits.append(per)
        caches.append(cache)
    out["logits"] = [np.concatenate(s) for s in zip(*logits)]
    out["cache"] = jax.tree.map(
        lambda *xs: np.concatenate([np.asarray(x) for x in xs], axis=1),
        *caches)
    return out


@pytest.fixture(scope="module")
def world(cases, tmp_path_factory):
    """(every rank's results, the reference's per case): the reference
    runs while the ranks do."""
    d = tmp_path_factory.mktemp("serve_mesh")
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    failed = []

    def go():
        try:
            MESH.spawn(RK.serve_mesh_rank, WORLD,
                       (WORLD, str(d / "pg"), str(d / "out"),
                        str(d / "cases.pkl")), timeout_s=SPAWN_TIMEOUT_S)
        except Exception as e:          # re-raised below
            failed.append(e)

    th = threading.Thread(target=go)
    th.start()
    try:
        # the reference's compiles on threads of their own
        with concurrent.futures.ThreadPoolExecutor(ORACLE_THREADS) as ex:
            oracles = dict(zip(cases, ex.map(_oracle, cases.values())))
    finally:
        th.join()
    if failed:
        raise failed[0]
    return RK.load(str(d / "out"), WORLD), oracles


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)


def _my_rows(case, coords):
    return RK.rows(case["batch"], dataclasses.replace(
        MESH.abstract_mesh(RK.SHAPE, RK.NAMES), coords=coords))


@pytest.mark.parametrize("name", DECODE_CASES)
def test_decode_steps_match_the_reference_per_data_block(cases, world,
                                                          name):
    ranks, oracles = world
    want = oracles[name]
    for res in ranks:
        got = res[name]
        mine = _my_rows(cases[name], got["coords"])
        assert len(got["logits"]) == STEPS
        for step, (w, g) in enumerate(zip(want["logits"], got["logits"])):
            assert g.shape == w[mine].shape
            assert _rel(w[mine], g) <= REL, (got["coords"], step)
        for q in TD._leaf_paths(want["cache"]):
            a, b = TD._get(want["cache"], q), TD._get(got["cache"], q)
            assert a.shape == b.shape, q
            assert _rel(a, b) <= REL, (got["coords"], q, _rel(a, b))


@pytest.mark.parametrize("name", CASES)
def test_prefill_matches_the_reference_per_data_block(cases, world, name):
    ranks, oracles = world
    want = oracles[name]["prefill"]
    for res in ranks:
        got = res[name]
        mine = _my_rows(cases[name], got["coords"])
        assert got["prefill"].shape == want[mine].shape
        assert _rel(want[mine], got["prefill"]) <= REL, got["coords"]


@pytest.mark.parametrize("name", DECODE_CASES)
def test_every_rank_holds_its_shards_of_the_cache(cases, world, name):
    """Each rank's cache leaves have the block shapes `cache_specs` gives,
    and the case splits what its name promises."""
    ranks, _ = world
    case = cases[name]
    cfg = TC.get(case["arch"]).smoke()
    mesh = MESH.abstract_mesh(RK.SHAPE, RK.NAMES)
    specs = SP.cache_specs(cfg, mesh, case["batch"], SEQ)
    struct = SP.cache_struct(cfg, case["batch"], SEQ)
    want = {"/".join(q): tuple(SH.shard_leaf(TD._get(struct, q),
                                             TD._get(specs, q), mesh).shape)
            for q in TD._leaf_paths(struct)}
    for res in ranks:
        assert res[name]["local_cache_shapes"] == want
        assert res[name]["zeros_like_shards"]      # init_sharded_cache
    for q in TD._leaf_paths(specs):
        sp = TD._get(specs, q)
        if q[-1] in ("ssm", "conv"):     # heads / channels over "model"
            assert sp[1] == "data" if case["batch"] == 4 else sp[1] is None
            assert "model" in sp, (q, sp)
            continue
        if case["batch"] == 1:           # the sequence over "data"
            assert sp[1] is None and sp[2] == "data", (q, sp)
        elif case["arch"] == "granite_34b":   # one kv head
            assert sp[1] == "data" and sp[2] == "model", (q, sp)
        else:
            assert sp[1] == "data" and sp[2] is None, (q, sp)
        if q[-1] in ("k", "v") and case["arch"] != "granite_34b":
            assert sp[3] == "model", (q, sp)


def _attn_inputs(seed=0, b=3, h=4, hkv=2, d=32, s=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v, np.array([16, 5, 9], np.int32)


def test_twin_lse_mode_matches_the_reference_and_keeps_its_output():
    q, k, v, n = _attn_inputs()
    want = np.asarray(RL.decode_attention_jnp(*map(jnp.asarray,
                                                   (q, k, v, n))))
    tq, tk, tv, tn = map(torch.from_numpy, (q, k, v, n))
    lse = torch.empty(q.shape[:2])
    out = FA.decode_attention(tq, tk, tv, tn, lse)
    assert torch.equal(out, FA.decode_attention(tq, tk, tv, tn))
    np.testing.assert_allclose(out.numpy(), want, atol=TWIN_ATOL)
    b, h, d = q.shape
    g = h // k.shape[2]
    logits = np.einsum("bhd,bshd->bhs", q, np.repeat(k, g, axis=2)) \
        / np.sqrt(d)
    logits = np.where(np.arange(k.shape[1])[None, None] < n[:, None, None],
                      logits.astype(np.float64), -np.inf)
    np.testing.assert_allclose(lse.numpy(), np.logaddexp.reduce(logits, -1),
                               rtol=1e-6)
    empty = torch.empty(q.shape[:2])
    zero = FA.decode_attention(tq, tk, tv, torch.zeros_like(tn), empty)
    assert torch.equal(zero, torch.zeros_like(zero))
    assert bool(torch.all(empty == float("-inf")))


def test_twin_f32_output_of_bf16_inputs_rounds_to_the_bf16_output():
    """The mesh's partial: bf16 inputs with an f32 output and lse, whose
    bf16 rounding is the bf16 call's output and whose lse is the same."""
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _attn_inputs()[:3])
    tn = torch.from_numpy(_attn_inputs()[3])
    lse, lse32 = torch.empty(tq.shape[:2]), torch.empty(tq.shape[:2])
    out = FA.decode_attention(tq, tk, tv, tn, lse)
    out32 = FA.decode_attention(tq, tk, tv, tn, lse32, torch.float32)
    assert out.dtype == torch.bfloat16 and out32.dtype == torch.float32
    assert torch.equal(out32.to(torch.bfloat16), out)
    assert torch.equal(lse32, lse)
    with pytest.raises(TypeError):
        FA.decode_attention(tq, tk, tv, tn, lse, torch.float16)


@pytest.mark.parametrize("cut", [4, 8, 12])
def test_merged_halves_match_one_softmax_over_the_row(cut):
    """Two segments [0, cut) and [cut, S) through the twin's lse mode,
    merged in order, against the reference over the whole row; at cut 8
    and 12 the second segment holds none of row 1's 5 positions."""
    q, k, v, n = _attn_inputs()
    want = np.asarray(RL.decode_attention_jnp(*map(jnp.asarray,
                                                   (q, k, v, n))))
    tq, tk, tv, tn = map(torch.from_numpy, (q, k, v, n))
    outs, lses = [], []
    for lo, hi in ((0, cut), (cut, k.shape[1])):
        lse = torch.empty(q.shape[:2])
        local = torch.clamp(tn - lo, 0, hi - lo).to(torch.int32)
        outs.append(FA.decode_attention(tq, tk[:, lo:hi].contiguous(),
                                        tv[:, lo:hi].contiguous(), local,
                                        lse))
        lses.append(lse)
    merged = FA.merge_partials(torch.stack(outs), torch.stack(lses))
    np.testing.assert_allclose(merged.numpy(), want, atol=TWIN_ATOL)
    if cut >= 8:                         # an empty segment weighs 0
        assert bool(torch.all(lses[1][1] == float("-inf")))
        assert torch.equal(outs[1][1], torch.zeros_like(outs[1][1]))
        assert torch.equal(merged[1], outs[0][1])


@pytest.mark.parametrize("arch", DECODERS + [ENCODER])
def test_local_mesh_serving_is_bit_identical_to_no_mesh(cases, arch):
    case = cases[f"{arch}-b4"]
    cfg = TC.get(arch).smoke()
    params = TM.from_reference(case["params"], cfg, "cpu")
    mesh = MESH.make_local_mesh("cpu")
    prompt = {k: torch.from_numpy(v.copy())
              for k, v in case["prompt"].items()}
    with torch.no_grad():
        assert torch.equal(TD.make_prefill(cfg, None, "cpu")(params, prompt),
                           TD.make_prefill(cfg, mesh, "cpu")(params, prompt))
        if not cfg.supports_decode:
            return
        whole = TD.tree_map(lambda a: torch.from_numpy(a.copy()),
                            case["cache"])
        c0 = TD.tree_map(lambda a: a.clone(), whole)
        c1 = SP.shard_cache(whole, cfg, mesh, case["batch"], SEQ)
        s0 = TD.make_serve_step(cfg, None, "cpu")
        s1 = TD.make_serve_step(cfg, mesh, "cpu")
        length = torch.from_numpy(case["length"].copy())
        for tok in case["tokens"]:
            t = torch.from_numpy(tok.copy())
            l0, c0 = s0(params, c0, t, length)
            l1, c1 = s1(params, c1, t, length)
            assert torch.equal(l0, l1)
            length = length + 1
    for a, b in zip(TD.tree_leaves(c0),
                    TD.tree_leaves(SP.gather_cache(c1, mesh))):
        assert torch.equal(a, b)
