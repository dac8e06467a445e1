"""repro_torch.launch.dryrun, the per-rank census on ``meta`` tensors,
against what the reference and the port's real runs say, on the CPU:

* `rank_bytes` equals the shard bytes of the reference's `param_specs`,
  `state_specs` (error feedback and the int8 stale model on) and
  `cache_specs` on ``AbstractMesh``, leaf by leaf, for every arch at full
  width on (16, 16) and (2, 16, 16);
* the census's argument and output bytes equal the reference's compiled
  ``memory_analysis()`` on the (1, 1) mesh for the smoke Qwen1.5-4B and
  Mamba2 train and decode cells, less what XLA adds or drops (named per
  leaf below); the reference's flops are printed beside the census's,
  not compared (XLA counts elementwise ops too); the dense smoke
  prefill's census flops equal a closed-form 2·m·n·k count;
* the collective census of the smoke Qwen1.5-4B on (2, 2, 1) equals the
  collectives a real 4-rank gloo step runs, rank by rank;
* each kernel wrapper's meta branch gives its plain version's shapes and
  dtypes, records its launch at the kernel's bytes and leaves the launch
  counters alone;
* a leaf of more elements than one kernel call counts goes through the
  kernels in pieces with the whole leaf's threshold.
"""
import json
import math
import os
import pickle
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

_xla = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as RDR  # noqa: E402  (sets XLA_FLAGS)
if _xla is None:            # a 512-device CPU platform is not wanted here
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _xla

import repro.configs as RC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.kernels as K  # noqa: E402
import torch_dryrun_ranks as RK  # noqa: E402
from repro.fl import distributed as RD  # noqa: E402
from repro.launch import mesh as RML  # noqa: E402
from repro.launch import specs as RS  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.core import compression as C  # noqa: E402
from repro_torch.fl import distributed as D  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import hybrid_compress as HC  # noqa: E402
from repro_torch.kernels import meta as KMETA  # noqa: E402
from repro_torch.kernels import recover as RCV  # noqa: E402
from repro_torch.kernels import topk_threshold as TT  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

PROD = [((16, 16), ("data", "model")),
        ((2, 16, 16), ("pod", "data", "model"))]
DIST = dict(use_error_feedback=True, prev_int8=True)
META = torch.device("meta")


# ---------------------------------------------------------------------------
# rank_bytes against the reference's specs
# ---------------------------------------------------------------------------

def _axes(spec) -> list:
    return [a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))]


def _ref_bytes(tree, specs, mesh, prefix="") -> dict:
    """{path: shard bytes} of a reference tree of ShapeDtypeStructs."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    sps = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, PartitionSpec))
    assert len(leaves) == len(sps)
    out = {}
    for (path, leaf), sp in zip(leaves, sps):
        key = "/".join([prefix] * bool(prefix) + [p.key for p in path])
        whole = math.prod(leaf.shape) * leaf.dtype.itemsize
        out[key] = whole // math.prod(mesh.shape[a] for a in _axes(sp))
    return out


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_rank_bytes_equal_the_reference_specs(arch):
    cr, ct = RC.get(arch), TC.get(arch)
    for shape, names in PROD:
        rm, tm = AbstractMesh(shape, names), MESH.abstract_mesh(shape, names)
        got = DR.rank_bytes(ct, D.DistConfig(**DIST), tm, "train_4k")
        assert got["params"] == _ref_bytes(RM.init_abstract(cr),
                                           RM.param_specs(cr, rm), rm)
        rd = RD.DistConfig(**DIST)
        st = jax.eval_shape(lambda p: RD.init_state(p, rd, rm),
                            RM.init_abstract(cr))
        sp = RD.state_specs(cr, rd, rm)
        want = {}
        for f in ("params", "prev_params", "ef", "step", "theta_d",
                  "theta_u"):
            want.update(_ref_bytes(getattr(st, f), getattr(sp, f), rm, f))
        assert got["state"] == want
        assert got["cache"] is None
        for cell in ("decode_32k", "long_500k"):
            if not RS.cell_supported(cr, cell)[0]:
                continue
            b, s = RS.SHAPES[cell]["batch"], RS.SHAPES[cell]["seq"]
            cs, csp = RS.decode_inputs(cr, rm, b, s)[:2]
            got = DR.rank_bytes(ct, None, tm, cell)
            assert got["cache"] == _ref_bytes(cs, csp, rm)
            assert got["totals"]["cache"] == sum(got["cache"].values())


# ---------------------------------------------------------------------------
# memory_analysis on the (1, 1) mesh
# ---------------------------------------------------------------------------

# what XLA's numbers hold that the census does not, per leaf:
# - outputs: the step's results are one tuple, whose table holds an 8-byte
#   pointer per leaf (the new state's leaves and the loss; the logits and
#   the cache's leaves);
# - arguments: jit drops an argument the step never reads — the SSM's
#   decode does not read ``length`` ([4] int32, 16 bytes), which the port's
#   step takes all the same.
TUPLE_POINTER = 8
UNREAD = {("mamba2_780m", "decode"): {"length": 16}}
LOCAL_CELLS = [(a, k, s) for a in ("qwen1p5_4b", "mamba2_780m")
               for k, s in (("train", 32), ("decode", 64))]


@pytest.mark.parametrize("arch,kind,seq", LOCAL_CELLS)
def test_argument_and_output_bytes_equal_memory_analysis(arch, kind, seq,
                                                        monkeypatch):
    cell = dict(kind=kind, seq=seq, batch=4)
    monkeypatch.setitem(RS.SHAPES, "_census", cell)
    mesh = RML.make_local_mesh()
    with jax.set_mesh(mesh):
        lowered = RDR._lower_cell(RC.get(arch).smoke(), "_census", mesh)
        compiled = lowered.compile()
    mem = compiled.memory_analysis()
    n_out = len(jax.tree_util.tree_leaves(lowered.out_info))
    got = DR.census(TC.get(arch).smoke(), cell,
                    MESH.census_mesh((1, 1), ("data", "model")),
                    D.DistConfig())
    unread = sum(UNREAD.get((arch, kind), {}).values())
    assert (got["memory"]["argument_size_in_bytes"] - unread
            == mem.argument_size_in_bytes)
    assert (got["memory"]["output_size_in_bytes"] + TUPLE_POINTER * n_out
            == mem.output_size_in_bytes)
    print(f"{arch} {kind}: flops census {got['flops']:.4e}, reference "
          f"{compiled.cost_analysis().get('flops', 0.0):.4e}")


def test_dense_prefill_flops_are_the_closed_form():
    cfg = TC.get("qwen1p5_4b").smoke()
    b, s = 4, 64
    d, h, hkv, dh, ff, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, cfg.d_ff, cfg.vocab)
    t = b * s

    def mm(m, n, k):
        return 2 * m * n * k
    layer = (mm(t, h * dh, d) + 2 * mm(t, hkv * dh, d)      # q, k, v
             + 2 * b * h * mm(s, s, dh)                      # q·kᵀ, p·v
             + mm(t, d, h * dh)                               # o
             + 3 * mm(t, ff, d))                              # SwiGLU
    want = cfg.n_layers * layer + mm(t, v, d)                 # LM head
    got = DR.census(cfg, dict(kind="prefill", seq=s, batch=b),
                    MESH.census_mesh((1, 1), ("data", "model")))
    assert got["flops"] == want


def test_memoized_ops_change_nothing():
    cfg = TC.get("zamba2_1p2b").smoke()
    runs = [DR.census(cfg, dict(kind="train", seq=32, batch=8),
                      MESH.census_mesh((2, 2, 1), ("pod", "data", "model"),
                                       rank=1),
                      D.DistConfig(use_error_feedback=True), memo=memo)
            for memo in (False, True)]
    for r in runs:
        r.pop("trace_s")
    assert runs[0] == runs[1]


def test_cells_end_ok_or_skipped_with_the_references_why(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(DR, "OUT_DIR", tmp_path)
    DR.main(["--arch", "hubert_xlarge", "--shape", "decode_32k"])
    DR.main(["--arch", "qwen1p5_4b", "--shape", "decode_32k",
             "--multi-pod"])
    skip = json.loads(
        (tmp_path / "hubert-xlarge__decode_32k__pod16x16__baseline.json")
        .read_text())
    assert skip["status"] == "skipped"
    assert skip["why"] == RS.cell_supported(RC.get("hubert_xlarge"),
                                            "decode_32k")[1]
    ok = json.loads(
        (tmp_path / "qwen1.5-4b__decode_32k__pod2x16x16__baseline.json")
        .read_text())
    assert ok["status"] == "ok", ok.get("error")
    mesh = MESH.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert ok["rank_bytes"]["cache"] == DR.rank_bytes(
        TC.get("qwen1p5_4b"), None, mesh, "decode_32k")["totals"]["cache"]
    # every rank gathers each leaf over "data" and holds its kv heads
    assert ok["kernels"]["decode_attention"]["launches"] == 40
    # the step's temporaries are its gathered leaves, not a whole model
    # (the specs' meta tensors hold no memory on the card)
    whole = sum(x.numel() * x.element_size() for x in D.tree_leaves(
        TM.init_abstract(TC.get("qwen1p5_4b"))))
    assert ok["memory"]["temp_size_in_bytes"] < whole / 4
    assert ok["collectives"]["all-gather"]["count"] > 0


# ---------------------------------------------------------------------------
# The collective census against a real gloo step
# ---------------------------------------------------------------------------

WORLD = 4


def test_collective_census_equals_a_gloo_step(tmp_path):
    failed = []

    def go():
        try:
            MESH.spawn(RK.census_rank, WORLD, (WORLD, str(tmp_path / "pg"),
                                               str(tmp_path / "out")),
                       timeout_s=120.0)
        except Exception as e:          # re-raised below
            failed.append(e)

    th = threading.Thread(target=go)
    th.start()
    cfg = TC.get("qwen1p5_4b").smoke()
    dcfg = D.DistConfig(use_error_feedback=True)
    cell = dict(kind="train", seq=RK.SEQ, batch=RK.BATCH)
    census = []
    for r in range(WORLD):
        mesh = MESH.census_mesh(RK.SHAPE, RK.NAMES, r)
        census.append((DR.census(cfg, cell, mesh, dcfg),
                       [(c["op"], c["group"], c["bytes"])
                        for c in mesh.census.calls]))
    th.join()
    if failed:
        raise failed[0]
    for r, (rec, calls) in enumerate(census):
        with open(tmp_path / f"out.{r}.pkl", "rb") as f:
            real = pickle.load(f)
        assert tuple(real["coords"]) == tuple(rec["coords"])
        assert calls == real["calls"], r
        coll = rec["collectives"]
        for op in ("all-gather", "all-reduce"):
            mine = [c for c in real["calls"] if c[0] == op]
            assert coll[op]["count"] == len(mine)
            assert coll[op]["sent"] == sum(c[2] for c in mine)
            assert coll[op]["received"] == sum(c[2] * (c[1] - 1)
                                               for c in mine)
        rb = DR.rank_bytes(cfg, dcfg, MESH.census_mesh(RK.SHAPE, RK.NAMES, r),
                           cell)["state"]
        for f in ("params", "prev_params", "ef"):
            assert real["held"][f] == sum(b for k, b in rb.items()
                                          if k.startswith(f + "/")), f


# ---------------------------------------------------------------------------
# The kernels' meta branches
# ---------------------------------------------------------------------------

def _meta(t):
    return torch.empty_like(t, device=META)


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert [(tuple(g.shape), g.dtype, g.device.type) for g in got] == \
        [(tuple(w.shape), w.dtype, "meta") for w in want]


def _kernel_cases():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5000, generator=g)
    mx = torch.amax(x.abs(), dim=-1)
    thr = mx * 0.3
    yield ("magnitude_histogram", TT.magnitude_histogram, (x, mx), {},
           3 * 5000 * 4 + 3 * 4, 3 * 256 * 4)
    yield ("hybrid_compress", HC.hybrid_compress, (x[0], thr), {},
           5000 * 4 + 3 * 4, 3 * 5000 * 5 + 3 * 12)
    yield ("hybrid_compress", HC.hybrid_compress, (x, thr), {},
           3 * 5000 * 4 + 3 * 4, 3 * 5000 * 5 + 3 * 12)
    kept, sign, cnt, s, m = HC.hybrid_compress(x, thr)
    mean = s / torch.clamp(cnt, min=1).float()
    yield ("recover", RCV.recover, (kept, sign, x, mean, m), {},
           3 * 5000 * 9 + 3 * 8, 3 * 5000 * 4)
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn(2, 8, 64, generator=g).to(dt)
        k = torch.randn(2, 4000, 2, 64, generator=g).to(dt)
        length = torch.tensor([5, 4000], dtype=torch.int32)
        es = q.element_size()
        read = 2 * 8 * 64 * es + 2 * 2 * 4000 * 2 * 64 * es + 8
        yield ("decode_attention", FA.decode_attention, (q, k, k, length),
               {}, read, 2 * 8 * 64 * es)
        yield ("decode_attention", FA.decode_attention, (q, k, k, length),
               {"lse": torch.empty(2, 8), "out_dtype": torch.float32},
               read, 2 * 8 * 64 * 4 + 4 * 2 * 8)


@pytest.mark.parametrize("case", list(range(8)))
def test_kernel_meta_branches_mirror_the_plain_versions(case):
    name, fn, args, kw, read, written = list(_kernel_cases())[case]
    want = fn(*args, **kw)                       # CPU: the plain version
    K.reset_launch_counts()
    seen = []
    margs = tuple(_meta(a) for a in args)
    mkw = {k: (_meta(v) if isinstance(v, torch.Tensor) else v)
           for k, v in kw.items()}
    with KMETA.recording(lambda *r: seen.append(r)):
        got = fn(*margs, **mkw)
    _same(got, want)
    assert seen == [(name, read, written)]
    assert K.launch_counts() == dict.fromkeys(K.WRAPPERS, 0)
    assert all(not v for v in K.launch_counts_by_rows().values())


def test_meta_branches_make_the_cuda_branches_checks():
    q = torch.empty(2, 8, 48, device=META)          # D not a multiple of 32
    k = torch.empty(2, 16, 2, 48, device=META)
    with pytest.raises(ValueError, match="D in 32..256"):
        FA.decode_attention(q, k, k, torch.empty(2, dtype=torch.int32,
                                                 device=META))
    x = torch.empty(65536, 8, device=META)
    with pytest.raises(ValueError, match="65535 rows"):
        TT.magnitude_histogram(x, torch.empty(65536, device=META))
    with pytest.raises(TypeError):
        TT.magnitude_histogram(x.double(), torch.empty(65536, device=META))


# ---------------------------------------------------------------------------
# Leaves past one kernel call's int32 count
# ---------------------------------------------------------------------------

def test_a_leaf_in_pieces_keeps_the_whole_leafs_threshold(monkeypatch):
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal(5000).astype(np.float32))
    local = x + torch.from_numpy(
        rng.standard_normal(5000).astype(np.float32)) * 0.2
    whole = C.fused_hybrid_roundtrip(x, local, 0.3)
    wsp = C.fused_topk(x, 0.35)
    monkeypatch.setattr(C, "_PIECE", 1024)
    assert len(C._pieces(C._leaf_row(x))) == 5
    calls, compress = [], C.fused_compress
    monkeypatch.setattr(C, "fused_compress", lambda xr, thr: calls.append(
        xr.shape[1]) or compress(xr, thr))
    rec, bits = C.fused_hybrid_roundtrip(x, local, 0.3)
    assert calls == [1024] * 4 + [904]
    assert torch.equal(bits, whole[1])
    torch.testing.assert_close(rec, whole[0], rtol=1e-5, atol=0)
    sp, sbits = C.fused_topk(x, 0.35)
    assert torch.equal(sp, wsp[0]) and torch.equal(sbits, wsp[1])


def test_shard_tree_blocks_hold_no_whole_leaf():
    """A block cut along the first dim is a contiguous view; the shard
    must not keep the whole leaf's storage alive (the census counts
    storages, as the card's allocator does)."""
    from repro_torch.launch import sharding as SH
    mesh = MESH.abstract_mesh((2, 2), ("data", "model"))
    tree = {"a": torch.zeros(8, 6), "b": torch.zeros(6, 8)}
    specs = {"a": ("data", None), "b": (None, "model")}
    out = SH.shard_tree(tree, specs, mesh)
    for k, x in out.items():
        assert x.is_contiguous()
        assert x.untyped_storage().nbytes() == x.numel() * x.element_size()
        assert x.data_ptr() != tree[k].data_ptr()
    # an unsplit leaf is kept as it is
    whole = SH.shard_tree({"c": tree["a"]}, {"c": (None, None)}, mesh)
    assert whole["c"] is tree["a"]
