"""repro_torch decode attention: the plain twin (``kernels.ref``), the kernel
wrapper's CPU route and the model's plain decode function against the
reference's oracle (``repro.kernels.ref.decode_attention``), its jnp decode
path (``repro.models.layers.decode_attention_jnp``) and its Pallas kernel in
interpret mode (``repro.kernels.ops.decode_attention``); the wrapper's input
checks and split plan; and, on a card, the CUDA kernel against its twin.

Inputs are made with numpy from a seed. Tolerances are the reference's own
(tests/test_kernels.py): f32 rtol = atol = 3e-5 (the two softmaxes sum in
other orders; an online softmax rescales its partial sums), bf16 2e-2 (one
bf16 ulp of the output is 2^-8 relative).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels import ops as R_OPS  # noqa: E402
from repro.kernels import ref as R_REF  # noqa: E402
from repro.models import layers as R_L  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ref as T_REF  # noqa: E402
from repro_torch.models import layers as T_L  # noqa: E402

F32_TOL = 3e-5
BF16_TOL = 2e-2


def _inputs(b, h, hkv, d, s, seed, lengths=None):
    rng = np.random.default_rng(np.random.SeedSequence(seed,
                                                       spawn_key=(98,)))
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(1, s + 1, b)
        lengths[0] = s                      # the full cache is always in
        if b > 1:
            lengths[-1] = 1                 # and a single valid position
    return q, k, v, np.asarray(lengths, np.int32)


def _port(fn, q, k, v, length, dtype=torch.float32):
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
            for x in (q, k, v)]
    return fn(*args, torch.from_numpy(length)).to(torch.float32).numpy()


def _bf16(x):
    """numpy f32 → the bf16 values both frameworks see."""
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)


PORT_FNS = {"twin": T_REF.decode_attention, "wrapper": FA.decode_attention,
            "layers_plain": T_L.decode_attention_plain}

# the shapes of tests/test_kernels.py (b, h, hkv, d, s, kv_block), plus
# groups G = H/Hkv of 3 and 4 (the reference's shapes have G = 2, 4, 1)
# and Llama-4-Scout's heads (40 over 8 kv heads: G = 5, no power of two)
PALLAS_SHAPES = [
    (2, 8, 4, 64, 1024, 256),
    (1, 4, 1, 128, 512, 128),
    (3, 6, 6, 32, 768, 256),
    (2, 6, 2, 32, 512, 256),
    (3, 8, 2, 64, 512, 128),
    (2, 40, 8, 128, 512, 256),
]


@functools.lru_cache(maxsize=None)
def _reference_outputs(b, h, hkv, d, s, blk):
    """(inputs, {name: reference output}) — computed once per shape."""
    q, k, v, length = _inputs(b, h, hkv, d, s, seed=b * 100 + h + d)
    jq, jk, jv, jl = map(jnp.asarray, (q, k, v, length))
    want = {"pallas": R_OPS.decode_attention(jq, jk, jv, jl, kv_block=blk,
                                             interpret=True),
            "ref": R_REF.decode_attention(jq, jk, jv, jl),
            "jnp": R_L.decode_attention_jnp(jq, jk, jv, jl)}
    return (q, k, v, length), {n: np.asarray(w) for n, w in want.items()}


@pytest.mark.parametrize("fn", list(PORT_FNS))
@pytest.mark.parametrize("b,h,hkv,d,s,blk", PALLAS_SHAPES)
def test_f32_matches_pallas_ref_and_jnp(fn, b, h, hkv, d, s, blk):
    inputs, want = _reference_outputs(b, h, hkv, d, s, blk)
    got = _port(PORT_FNS[fn], *inputs)
    for name, w in want.items():
        np.testing.assert_allclose(got, w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("fn", list(PORT_FNS))
def test_bf16_matches_pallas_ref_and_jnp(fn):
    """The reference's bf16 test shape and lengths."""
    q, k, v, length = _inputs(2, 8, 4, 64, 512, seed=11,
                              lengths=[512, 300])
    q, k, v = _bf16(q), _bf16(k), _bf16(v)
    got = _port(PORT_FNS[fn], q.astype(np.float32), k.astype(np.float32),
                v.astype(np.float32), length, dtype=torch.bfloat16)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jl = jnp.asarray(length)
    for name, want in (
            ("pallas", R_OPS.decode_attention(jq, jk, jv, jl, kv_block=128,
                                              interpret=True)),
            ("ref", R_REF.decode_attention(jq, jk, jv, jl)),
            ("jnp", R_L.decode_attention_jnp(jq, jk, jv, jl))):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2, 3, 4, 5])
def test_every_length_of_a_ragged_cache_matches_jnp(g, dtype):
    """S = 48 (the serve path's prompt + new tokens) is no multiple of the
    Pallas kernel's 512-position block, which asserts it; so these compare
    with the jnp decode path and the oracle only. One row per length 1..S."""
    s, hkv, d = 48, 2, 32
    q, k, v, length = _inputs(s, g * hkv, hkv, d, s, seed=g,
                              lengths=np.arange(1, s + 1))
    tol = F32_TOL
    tdt = torch.float32
    if dtype == "bfloat16":
        q, k, v = (_bf16(x).astype(np.float32) for x in (q, k, v))
        tol, tdt = BF16_TOL, torch.bfloat16
    jargs = [jnp.asarray(x, dtype) for x in (q, k, v)] + [jnp.asarray(length)]
    for fn in PORT_FNS.values():
        got = _port(fn, q, k, v, length, dtype=tdt)
        for want in (R_L.decode_attention_jnp(*jargs),
                     R_REF.decode_attention(*jargs)):
            np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                       rtol=tol, atol=tol)


@pytest.mark.parametrize("g,d,itemsize,want", [
    (5, 128, 2, (8, 1)), (5, 128, 4, (8, 1)), (1, 128, 2, (1, 1)),
    (2, 128, 2, (2, 1)), (3, 64, 4, (4, 1)), (16, 128, 2, (8, 2))])
def test_group_plan_pads_a_group_to_the_next_block(g, d, itemsize, want):
    """A group of query heads runs in the smallest block size that holds
    it: Llama-4-Scout's G = 5 in one block of 8 with 3 heads idle. The
    kernel loads a zero query for an idle head and writes heads
    ``h0 + g`` for ``g < min(GT, G − gblk·GT)`` only (csrc: ``ng``), which
    the card's test with a canary past the output checks."""
    gt, n_gblk = FA.group_plan(g, d, itemsize)
    assert (gt, n_gblk) == want
    assert gt * n_gblk >= g > gt * (n_gblk - 1)


def test_cpu_route_is_the_twin_and_counts_no_launch():
    q, k, v, length = _inputs(2, 4, 2, 32, 40, seed=3)
    t = [torch.from_numpy(x) for x in (q, k, v, length)]
    K.reset_launch_counts()
    assert torch.equal(FA.decode_attention(*t), FA.decode_attention_plain(*t))
    assert K.launch_counts()["decode_attention"] == 0
    assert K.WRAPPERS["decode_attention"] is FA.decode_attention


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, length = (torch.from_numpy(x)
                       for x in _inputs(2, 6, 4, 32, 16, seed=4))
    with pytest.raises(ValueError, match="multiple"):
        FA.decode_attention(q, k, v, length)            # H % Hkv != 0
    q, k, v, length = (torch.from_numpy(x)
                       for x in _inputs(2, 4, 2, 32, 16, seed=4))
    with pytest.raises(TypeError):
        FA.decode_attention(q.double(), k.double(), v.double(), length)
    with pytest.raises(TypeError):
        FA.decode_attention(q, k.bfloat16(), v, length)
    with pytest.raises(TypeError):
        FA.decode_attention(q, k, v, length.long())
    with pytest.raises(ValueError):
        FA.decode_attention(q, k, v, length[:1])
    with pytest.raises(ValueError):
        FA.decode_attention(q[:, :, :16], k, v, length)
    with pytest.raises(ValueError):
        FA.decode_attention(q, k, v[:, :8], length)
    with pytest.raises(ValueError):
        FA.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                            v, length)


@pytest.mark.parametrize("b,h,hkv,s", [(4, 20, 20, 48), (4, 20, 20, 4096),
                                       (2, 8, 4, 2048), (1, 4, 1, 100_000),
                                       (64, 32, 8, 1)])
def test_split_plan_covers_the_cache(b, h, hkv, s):
    """Every position < S lies in exactly one split (the kernel's split i
    reads [i*chunk, min((i+1)*chunk, S))), every query head in exactly one
    block group, and the ticket buffer holds a counter for every (b,
    kv-head group) pair of the grid. S is split only into splits of at
    least MIN_SPLIT_BYTES, and then until the grid fills 132 SMs: the long
    cache does, the serve loop's 48 positions run unsplit."""
    for d, itemsize in ((128, 2), (64, 4), (96, 2), (256, 4)):
        p = FA.plan(b, h, hkv, d, s, itemsize, 132)
        assert p.gt in FA.GROUPS
        assert p.chunk % FA.MIN_CHUNK == 0 and p.n_split <= FA.MAX_SPLIT
        row = 2 * d * itemsize                  # K and V of one position
        assert p.n_split == 1 or p.chunk * row >= FA.MIN_SPLIT_BYTES
        if p.blocks(b, hkv) < 132:              # no shorter split allowed
            assert (p.n_split in (1, FA.MAX_SPLIT)
                    or (p.chunk - FA.MIN_CHUNK) * row < FA.MIN_SPLIT_BYTES)
        hits = np.zeros(s, np.int64)
        for i in range(p.n_split):
            hits[i * p.chunk:min((i + 1) * p.chunk, s)] += 1
        np.testing.assert_array_equal(hits, 1)
        assert p.chunk * (p.n_split - 1) < s         # no split is empty
        g = h // hkv
        heads = np.zeros(g, np.int64)
        for gblk in range(p.n_gblk):
            heads[gblk * p.gt:min((gblk + 1) * p.gt, g)] += 1
        np.testing.assert_array_equal(heads, 1)
        assert p.gt * FA.lane_elements(d, itemsize) <= FA.MAX_GROUP_REGS
        assert p.blocks(b, hkv) == b * hkv * p.n_gblk * p.n_split
        tickets = build.zeroed_scratch("decode_attention",
                                       torch.device("cpu"), p.pairs(b, hkv))
        assert tickets.numel() >= p.pairs(b, hkv)
        assert tickets.dtype == torch.int32 and not tickets.any()
        if (b, h, hkv, d, s, itemsize) == (4, 20, 20, 128, 48, 2):
            assert p.n_split == 1               # the serve loop's cache
        if (b, h, hkv, d, s, itemsize) == (4, 20, 20, 128, 4096, 2):
            assert p.n_split > 1 and p.blocks(b, hkv) >= 132


# --- on the card: the kernel against its twin --------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,d,s", [
    (4, 20, 20, 128, 48), (2, 8, 4, 64, 2048), (4, 20, 20, 128, 4096),
    (3, 12, 4, 96, 777), (5, 10, 2, 32, 300), (2, 16, 2, 256, 1500),
    # group sizes G = 1, 2, 3, 4, 8 over a cache of 37 positions (no
    # multiple of any tile or split), every length 1..S
    (4, 2, 2, 128, 37), (4, 4, 2, 64, 37), (4, 6, 2, 128, 37),
    (4, 8, 2, 32, 37), (4, 16, 2, 128, 37),
    # the families' serve shapes: Llama-4-Scout (G = 5), Zamba2's shared
    # block (G = 1) and InternVL2 (G = 2), every length 1..48
    (4, 40, 8, 128, 48), (4, 32, 32, 128, 48), (4, 16, 8, 128, 48),
    # split in 2 (bf16) or 3 (f32) with a short last split, every length
    # 1..S: some splits empty, some partial
    (2, 4, 2, 256, 150)])
def test_cuda_kernel_matches_twin(cuda, dtype, b, h, hkv, d, s):
    q, k, v, length = _inputs(b, h, hkv, d, s, seed=s + d)
    tdt = getattr(torch, dtype)
    args = [torch.from_numpy(x).to(cuda, tdt) for x in (q, k, v)]
    sweeps = [length]
    if s < 200:
        sweeps = [np.minimum(np.arange(i, i + b), s).astype(np.int32)
                  for i in range(1, s + 1, b)]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for lv in sweeps:
        ln = torch.from_numpy(lv).to(cuda)
        before = K.launch_counts()["decode_attention"]
        got = FA.decode_attention(*args, ln)
        want = FA.decode_attention_plain(*args, ln)
        torch.cuda.synchronize()
        assert K.launch_counts()["decode_attention"] == before + 1
        assert got.dtype == tdt and got.shape == (b, h, d)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(FA.decode_attention(*args, ln), got)  # same bits
    torch.cuda.synchronize()            # the merge's tickets are zero again
    assert not any(bool(buf.any()) for buf in build._ZEROED.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [48, 4096])
def test_cuda_idle_heads_write_nothing(cuda, dtype, s):
    """G = 5 runs in blocks of 8 query heads, 3 idle: the kernel, called
    with an output that is followed by canaries, writes exactly the B·H·D
    outputs (an idle head of the last kv head would land past the end)."""
    b, h, hkv, d = 4, 40, 8, 128
    q, k, v, length = _inputs(b, h, hkv, d, s, seed=5)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda, tdt) for x in (q, k, v))
    ln = torch.from_numpy(length).to(cuda)
    p = FA.plan(b, h, hkv, d, s, q.element_size(), build.sm_count(0))
    assert (p.gt, p.n_gblk) == (8, 1)
    buf = torch.full((b * h * d + 8 * d,), float("nan"), dtype=tdt,
                     device=cuda)
    out = buf[:b * h * d]
    part = ticket = None
    if p.n_split > 1:
        part = torch.empty(p.blocks(b, hkv) * p.gt * (d + 2),
                           dtype=torch.float32, device=cuda)
        ticket = build.zeroed_scratch("decode_attention", cuda,
                                      p.pairs(b, hkv), build.stream_of(q))
    code = FA._lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), ln.data_ptr(),
                     out.data_ptr(), None, part.data_ptr() if part is not None
                     else None, ticket.data_ptr() if ticket is not None
                     else None, b, h, hkv, s, d, p.gt, p.n_gblk, p.chunk,
                     p.n_split, FA._DTYPES[tdt], build.stream_of(q))
    build.check_launch(code, "decode_attention")
    torch.cuda.synchronize()
    assert bool(torch.isnan(buf[b * h * d:]).all())
    want = FA.decode_attention_plain(q, k, v, ln)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    torch.testing.assert_close(out.view(b, h, d).float(), want.float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,d,s", [
    (2, 10, 10, 128, 8), (1, 10, 10, 128, 2048), (2, 48, 1, 128, 512),
    (2, 4, 2, 256, 150)])
def test_cuda_lse_mode_matches_twin_and_keeps_the_output(cuda, dtype, b, h,
                                                         hkv, d, s):
    """The lse mode (a rank's softmax partial under a mesh): the output
    bit-equal to the call without lse, the lse within 1e-5 of the twin's
    and -inf exactly where the twin's is (length 0), unsplit and split
    plans alike; the f32 output of bf16 inputs (the mesh's partial) within
    F32_TOL of the twin's f32 output, and its bf16 rounding bit-equal to
    the bf16 output."""
    q, k, v, _ = _inputs(b, h, hkv, d, s, seed=s + h)
    tdt = getattr(torch, dtype)
    args = [torch.from_numpy(x).to(cuda, tdt) for x in (q, k, v)]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for lv in ([0] * b, [s] * b, [1 + i * (s - 1) // b for i in range(b)]):
        ln = torch.tensor(lv, dtype=torch.int32, device=cuda)
        lse = torch.empty((b, h), dtype=torch.float32, device=cuda)
        plse = torch.empty_like(lse)
        got = FA.decode_attention(*args, ln, lse)
        want = FA.decode_attention_plain(*args, ln, plse)
        torch.cuda.synchronize()
        assert torch.equal(got, FA.decode_attention(*args, ln))
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        inf = torch.isinf(plse)
        assert torch.equal(inf, torch.isinf(lse))
        assert torch.equal(lse[inf], plse[inf])
        torch.testing.assert_close(lse[~inf], plse[~inf], rtol=0, atol=1e-5)
        if tdt == torch.bfloat16:
            lse32 = torch.empty_like(lse)
            got32 = FA.decode_attention(*args, ln, lse32, torch.float32)
            want32 = FA.decode_attention_plain(*args, ln, None,
                                               torch.float32)
            torch.cuda.synchronize()
            assert got32.dtype == torch.float32
            assert torch.equal(got32.to(tdt), got)
            assert torch.equal(lse32, lse)
            torch.testing.assert_close(got32, want32, rtol=F32_TOL,
                                       atol=F32_TOL)
    torch.cuda.synchronize()
    assert not any(bool(buf.any()) for buf in build._ZEROED.values())
