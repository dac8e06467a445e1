"""repro_torch kernels: the plain PyTorch twins against the reference's Pallas
kernels (interpret mode, as tests/test_kernels.py runs them) and against
``repro.kernels.ref``; the wrappers' input checks; and, on a card, each CUDA
kernel against its twin.

Tolerances: histogram counts, thresholds, kept, sign, count, max and the
recovered values are EXACT (the same f32 operations in the same order per
element). Σ|x| over the compressed set is held to rtol 1e-5: it is a sum
of up to n f32 terms taken in another order (XLA's reduce, PyTorch's
vectorized sum, the kernel's block tree).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as R_OPS  # noqa: E402
from repro.kernels import ref as R_REF  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import hybrid_compress as HC  # noqa: E402
from repro_torch.kernels import recover as RC  # noqa: E402
from repro_torch.kernels import ref as T_REF  # noqa: E402
from repro_torch.kernels import topk_threshold as TT  # noqa: E402

SUM_RTOL = 1e-5
# lengths deliberately not multiples of the TPU kernels' 1024-lane BLOCK
SHAPES = [(1, 1000), (3, 5000), (4, 3001)]


def _x(rows, n, seed):
    """Seeded inputs with the edge cases the kernels must get right: exact
    zeros (sign 0, bin 0) and ties at the row maximum (last bin)."""
    rng = np.random.default_rng(np.random.SeedSequence(seed,
                                                       spawn_key=(99,)))
    x = (rng.standard_normal((rows, n)) * 3.0).astype(np.float32)
    x[:, ::97] = 0.0
    if n > 6:
        x[:, 5] = np.abs(x).max(axis=1)
        x[:, 6] = -x[:, 5]
    return x


@pytest.mark.parametrize("rows,n", SHAPES)
def test_histogram_twin_matches_pallas_and_ref(rows, n):
    x = _x(rows, n, 1)
    mx = np.abs(x).max(axis=1)
    got = TT.magnitude_histogram(torch.from_numpy(x), torch.from_numpy(mx))
    assert got.dtype == torch.int32 and got.shape == (rows, 256)
    for r in range(rows):
        pallas = np.asarray(R_OPS.magnitude_histogram(
            jnp.asarray(x[r]), jnp.float32(mx[r]), interpret=True))
        oracle = np.asarray(R_REF.magnitude_histogram(
            jnp.asarray(x[r]), 256, jnp.float32(mx[r])))
        np.testing.assert_array_equal(got[r].numpy(), pallas)
        np.testing.assert_array_equal(got[r].numpy(), oracle)
    assert int(got.sum()) == rows * n


@pytest.mark.parametrize("rows,n", SHAPES)
def test_threshold_from_histogram_exact(rows, n):
    x = _x(rows, n, 2)
    mx = np.abs(x).max(axis=1)
    ratio = np.linspace(0.0, 1.0, rows, dtype=np.float32)
    hist = TT.magnitude_histogram(torch.from_numpy(x), torch.from_numpy(mx))
    got = T_REF.threshold_from_histogram(hist, torch.from_numpy(mx),
                                         torch.from_numpy(ratio)).numpy()
    for r in range(rows):
        want = np.asarray(R_REF.threshold_from_histogram(
            jnp.asarray(hist[r].numpy()), jnp.float32(mx[r]),
            jnp.float32(ratio[r])))
        assert got[r] == want


def _check_compress(got, x_row, thr_r, r):
    kept, sign, cnt, ssum, smax = got
    pk, ps, pc, pss, pm = R_OPS.hybrid_compress(
        jnp.asarray(x_row), jnp.float32(thr_r), interpret=True)
    rk, rs, rc, rss, rm = R_REF.hybrid_compress(jnp.asarray(x_row),
                                                jnp.float32(thr_r))
    for k_ref, s_ref, c_ref, ss_ref, m_ref in ((pk, ps, pc, pss, pm),
                                               (rk, rs, rc, rss, rm)):
        np.testing.assert_array_equal(kept[r].numpy(), np.asarray(k_ref))
        np.testing.assert_array_equal(sign[r].numpy(), np.asarray(s_ref))
        assert int(cnt[r]) == int(c_ref)
        assert float(smax[r]) == float(m_ref)
        np.testing.assert_allclose(float(ssum[r]), float(ss_ref),
                                   rtol=SUM_RTOL)


@pytest.mark.parametrize("rows,n", SHAPES)
def test_compress_twin_matches_pallas_and_ref(rows, n):
    x = _x(rows, n, 3)
    thr = np.linspace(0.0, 4.0, rows, dtype=np.float32)
    got = HC.hybrid_compress(torch.from_numpy(x), torch.from_numpy(thr))
    assert got[1].dtype == torch.int8 and got[2].dtype == torch.int32
    for r in range(rows):
        _check_compress(got, x[r], thr[r], r)


def test_compress_shared_vector_matches_per_row():
    """The main path compresses ONE global vector at each participant's
    threshold: a [n] x with [rows] thresholds."""
    x = _x(1, 4099, 4)[0]
    thr = np.array([0.0, 0.5, 2.0, 1e9], np.float32)
    got = HC.hybrid_compress(torch.from_numpy(x), torch.from_numpy(thr))
    for r in range(len(thr)):
        _check_compress(got, x, thr[r], r)
    assert int(got[2][0]) == 0                    # thr=0 compresses nothing
    assert int(got[2][3]) == x.size               # every |x| < 1e9


@pytest.mark.parametrize("rows,n", SHAPES)
def test_recover_twin_matches_pallas_and_ref(rows, n):
    x = _x(rows, n, 5)
    rng = np.random.default_rng(np.random.SeedSequence(5, spawn_key=(98,)))
    local = (x + rng.standard_normal(x.shape) * 1.5).astype(np.float32)
    local[:, ::50] = 0.0
    thr = np.linspace(0.5, 3.0, rows, dtype=np.float32)
    kept, sign, cnt, ssum, smax = HC.hybrid_compress(torch.from_numpy(x),
                                                     torch.from_numpy(thr))
    mean = ssum / torch.clamp(cnt, min=1).float()
    got = RC.recover(kept, sign, torch.from_numpy(local), mean, smax).numpy()
    for r in range(rows):
        args = (jnp.asarray(kept[r].numpy()), jnp.asarray(sign[r].numpy()),
                jnp.asarray(local[r]), jnp.float32(mean[r]),
                jnp.float32(smax[r]))
        np.testing.assert_array_equal(
            got[r], np.asarray(R_OPS.recover(*args, interpret=True)))
        np.testing.assert_array_equal(got[r], np.asarray(R_REF.recover(*args)))


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    K.reset_launch_counts()
    x = torch.from_numpy(_x(2, 1000, 6))
    mx = torch.amax(x.abs(), dim=-1)
    TT.magnitude_histogram(x, mx)
    kept, sign, cnt, ssum, smax = HC.hybrid_compress(x, mx * 0.5)
    RC.recover(kept, sign, x, ssum / cnt.float(), smax)
    assert K.launch_counts() == {"magnitude_histogram": 0,
                                 "hybrid_compress": 0, "recover": 0,
                                 "decode_attention": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.from_numpy(_x(2, 100, 7))
    mx = torch.amax(x.abs(), dim=-1)
    with pytest.raises(TypeError):
        TT.magnitude_histogram(x.double(), mx)
    with pytest.raises(ValueError):
        TT.magnitude_histogram(x[0], mx[:1])          # not [rows, n]
    with pytest.raises(ValueError):
        TT.magnitude_histogram(x.t().contiguous().t(), mx)
    with pytest.raises(ValueError):
        HC.hybrid_compress(x, mx[:1])                 # rows mismatch
    with pytest.raises(TypeError):
        HC.hybrid_compress(x.half(), mx)
    kept, sign, cnt, ssum, smax = HC.hybrid_compress(x, mx)
    with pytest.raises(TypeError):
        RC.recover(kept, sign.int(), x, ssum, smax)
    with pytest.raises(ValueError):
        RC.recover(kept, sign, x[:1], ssum, smax)


def _kernel_slices(row_offset, start, stop):
    """The histogram kernel's cut of a slice [start, stop) of a row that
    begins row_offset floats after a 16-byte boundary: a scalar head up to
    the next boundary, a float4 body, a scalar tail."""
    head = min((-(row_offset + start)) % 4, stop - start)
    body_end = start + head + 4 * ((stop - start - head) // 4)
    return range(start, start + head), range(start + head, body_end), \
        range(body_end, stop)


@pytest.mark.parametrize("rows", [1, 25])
@pytest.mark.parametrize("n", [164134, 164133, 164135, 4097, 1023, 5])
def test_histogram_grid_plan_covers_every_element_once(rows, n):
    """``hist_plan``'s slices, cut as the kernel cuts them, read every
    element of every row exactly once, with aligned float4 bodies, whether
    the tensor starts on a 16-byte boundary or one float after it (odd n
    leaves every other row misaligned); the global model's row fills the
    card; the scratch buffer holds a zeroed accumulator row and ticket per
    row."""
    per_block, blocks = TT.hist_plan(rows, n, 132)
    assert per_block % 4 == 0
    assert (blocks - 1) * per_block < n <= blocks * per_block
    for base in (0, 1):
        for r in range(rows):
            hits = np.zeros(n, np.int64)
            for i in range(blocks):
                head, body, tail = _kernel_slices(
                    base + r * n, i * per_block, min((i + 1) * per_block, n))
                assert len(head) < 4 and len(tail) < 4 and len(body) % 4 == 0
                assert len(body) == 0 or (base + r * n + body.start) % 4 == 0
                for part in (head, body, tail):
                    hits[part.start:part.stop] += 1
            np.testing.assert_array_equal(hits, 1)
    if n > 100_000:
        assert rows * blocks >= 132
    scratch = build.zeroed_scratch("magnitude_histogram",
                                   torch.device("cpu"), rows * (TT.N_BINS + 1))
    assert scratch.numel() >= rows * (TT.N_BINS + 1) and not scratch.any()


PLAN_ROWS = [1, 2, 3, 8, 16, 25]
PLAN_N = [164134, 164133, 164135, 164136, 4097, 5, 1]   # n = 2, 1, 3, 0 mod 4


def _hits(ranges, n):
    """How often each of n elements is covered by the [a, b) ranges."""
    diff = np.zeros(n + 1, np.int64)
    for a, b in ranges:
        diff[a] += 1
        diff[b] -= 1
    return np.cumsum(diff[:-1])


@pytest.mark.parametrize("sm", [132, 8])
@pytest.mark.parametrize("n", PLAN_N)
@pytest.mark.parametrize("rows", PLAN_ROWS)
def test_recover_plan_covers_every_element_once(rows, n, sm):
    """``recover_plan``'s slices, cut as the kernel cuts them (a scalar head
    up to the first vector boundary of the flat [rows, n] index, whole
    vectors, a scalar tail), read and write every element of every row
    exactly once, with every vector on an aligned address of all four
    streams (aligned bases: 16-byte f32 rows, 4-byte int8 rows); the global
    model's row fills the card."""
    per_block, blocks = RC.recover_plan(rows, n, sm)
    assert per_block % 4 == 0
    assert (blocks - 1) * per_block < n <= blocks * per_block
    for r in range(rows):
        ranges = []
        for i in range(blocks):
            head, body, tail = _kernel_slices(
                r * n, i * per_block, min((i + 1) * per_block, n))
            assert len(head) < 4 and len(tail) < 4 and len(body) % 4 == 0
            assert len(body) == 0 or (r * n + body.start) % 4 == 0
            ranges += [(p.start, p.stop) for p in (head, body, tail)]
        np.testing.assert_array_equal(_hits(ranges, n), 1)
    if n > 100_000 and sm == 132:
        assert rows * blocks >= 132


@pytest.mark.parametrize("sm", [132, 8])
@pytest.mark.parametrize("n", PLAN_N)
@pytest.mark.parametrize("rows", PLAN_ROWS)
def test_compress_plan_covers_every_element_once(rows, n, sm):
    """``compress_plan``'s grid, cut as the kernel cuts it, for a shared x
    and for x per row: each block stages its x slice once (head, 16-byte
    body on x's own alignment, tail; x's base 0 or 1 float past a 16-byte
    boundary) and every row group's x is staged exactly once; each (row,
    sub-slice) unit stores a scalar head, whole float4 / 4-byte vectors on
    aligned addresses and a scalar tail, so every output element of every
    row is written exactly once; the sub-slices tile the block's slice and
    keep the warps busy; the shared vector's single row fills the card; the
    ticket scratch is a zeroed row-group counter each."""
    for shared in (True, False):
        per_block, cb, group, s = HC.compress_plan(rows, n, sm, shared)
        assert per_block % 4 == 0 and per_block <= HC.MAX_PER_BLOCK
        assert (cb - 1) * per_block < n <= cb * per_block
        assert 1 <= group <= (HC.MAX_GROUP if shared else 1)
        assert 1 <= s <= HC.NWARP
        assert group < HC.NWARP or s <= HC.MAX_SPLIT
        if group < HC.NWARP:
            assert group * s > HC.NWARP - group     # fewer idle than a row
        elif group == 25:
            assert s == 2                           # 50 units on 8 warps
        groups = -(-rows // group)
        out = {r: [] for r in range(rows)}
        for gi in range(groups):
            r0, nr = gi * group, min(group, rows - gi * group)
            for base in (0, 1):
                x_off = base + (0 if shared else r0 * n)
                staged = []
                for bx in range(cb):
                    start, stop = bx * per_block, min((bx + 1) * per_block, n)
                    head, body, tail = _kernel_slices(x_off, start, stop)
                    assert len(body) == 0 or (x_off + body.start) % 4 == 0
                    staged += [(p.start, p.stop) for p in (head, body, tail)]
                np.testing.assert_array_equal(_hits(staged, n), 1)
            for bx in range(cb):
                start, stop = bx * per_block, min((bx + 1) * per_block, n)
                length = stop - start
                sw = -(-(-(-length // s)) // 4) * 4
                for j in range(nr):
                    for k in range(s):
                        lo = min(k * sw, length)
                        hi = min(lo + sw, length)
                        assert lo % 4 == 0 or lo == length
                        head, body, tail = _kernel_slices(
                            (r0 + j) * n, start + lo, start + hi)
                        assert len(head) < 4 and len(tail) < 4
                        assert len(body) % 4 == 0
                        assert (len(body) == 0
                                or ((r0 + j) * n + body.start) % 4 == 0)
                        out[r0 + j] += [(p.start, p.stop)
                                        for p in (head, body, tail)]
        for r in range(rows):
            np.testing.assert_array_equal(_hits(out[r], n), 1)
        if n > 100_000 and sm == 132 and rows == 1:
            assert cb >= 132
    scratch = build.zeroed_scratch("hybrid_compress", torch.device("cpu"),
                                   rows)
    assert scratch.numel() >= rows and not scratch.any()


def test_launch_counts_by_rows_reset_and_skip_cpu_tensors():
    """The histogram, compress and recover count their launches per batch
    rows; CPU tensors count none, and reset clears the counts."""
    empty = {"magnitude_histogram": {}, "hybrid_compress": {}, "recover": {}}
    HC.hybrid_compress.launches_by_rows[25] = 3
    TT.magnitude_histogram.launches_by_rows[1] = 2
    K.reset_launch_counts()
    assert K.launch_counts_by_rows() == empty
    x = torch.from_numpy(_x(2, 100, 9))
    TT.magnitude_histogram(x, x.abs().amax(-1))
    kept, sign, cnt, ssum, smax = HC.hybrid_compress(x, x.abs().amax(-1))
    RC.recover(kept, sign, x, ssum, smax)
    assert K.launch_counts_by_rows() == empty


# --- on the card: each kernel against its twin ------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", SHAPES + [
    (25, 164134), (1, 164133), (2, 4099),    # n = 2, 1, 3 mod 4
    (25, 164135)] + [(r, m) for r in PLAN_ROWS for m in PLAN_N])
def test_cuda_kernels_match_twins(cuda, rows, n):
    """Each kernel against its twin on the card, compress on a shared x and
    on x per row, with ±0.0 in x, at thresholds ``mx * linspace(0, 0.9)``
    and at three edge sets in which every row takes in turn thr 0 (nothing
    compressed), +inf (everything) and thr equal to one of its |x| (kept:
    |x| < thr compresses); recover after each compression; the zeroed
    scratch is zero again after."""
    xn = _x(rows, n, 8)
    xn[:, 1::89] = -0.0
    x = torch.from_numpy(xn).to(cuda)
    mx = torch.amax(x.abs(), dim=-1)
    before = K.launch_counts()
    assert torch.equal(TT.magnitude_histogram(x, mx),
                       TT.magnitude_histogram_plain(x, mx))
    thr = mx * torch.linspace(0.0, 0.9, rows, device=cuda)
    kind = torch.arange(rows, device=cuda) % 3
    calls = 0
    for src in (x, x[0].contiguous()):
        on_x = src.abs().expand(rows, n)[:, n // 2]
        edges = [torch.where(k == 0, 0.0, torch.where(k == 1, float("inf"),
                                                      on_x))
                 for k in ((kind + shift) % 3 for shift in range(3))]
        for t in [thr] + edges:
            ck = HC.hybrid_compress(src, t)
            cp = HC.hybrid_compress_plain(src, t)
            for i in (0, 1, 2, 4):
                assert torch.equal(ck[i], cp[i])
            torch.testing.assert_close(ck[3], cp[3], rtol=SUM_RTOL,
                                       atol=0.0)
            none, every = t == 0, t == float("inf")
            assert not ck[2][none].any() and not ck[3][none].any()
            assert not ck[4][none].any()
            assert bool((ck[2][every] == n).all())
            kept, sign, cnt, ssum, smax = ck
            mean = ssum / torch.clamp(cnt, min=1).float()
            local = x * 0.9
            assert torch.equal(RC.recover(kept, sign, local, mean, smax),
                               RC.recover_plain(kept, sign, local, mean,
                                                smax))
            calls += 1
    after = K.launch_counts()
    torch.cuda.synchronize()    # the scratch counters are zero again
    assert not any(bool(buf.any()) for buf in build._ZEROED.values())
    assert after["magnitude_histogram"] == before["magnitude_histogram"] + 1
    assert after["hybrid_compress"] == before["hybrid_compress"] + calls
    assert after["recover"] == before["recover"] + calls
