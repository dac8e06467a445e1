"""The port's wire codec and aggregators (`repro_torch.fl.wire`,
`repro_torch.fl.robust`) against the reference's on the same numpy inputs.

Exact: encoded payloads (header, MSB-first bitpacked indices, f32 or
truncated-bf16 values, CRC-32) byte for byte, ``payload_nbytes``, decoded
indices and values, CRC and format rejection. Aggregators, each fed the
same serialized uploads through ``decode_and_aggregate``:
* median and Krum are host-side numpy in both packages — exact;
* mean, trimmed_mean and norm_clip fold on the device (the reference with
  XLA, the port with torch on the CPU here) — rtol 1e-6 (the folds add
  the same f32 values in another association where the reference reduces
  a chunk with ``jnp.sum``).
Also the fig11 chunking-invariance gate on the port's aggregators (chunks
of 5 and 16: bit-exact for median and Krum, allclose rtol 1e-5 / atol 1e-7
for the device folds — the gate's own tolerances) and the transports."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import rng as R_RNG  # noqa: E402
from repro.fl import robust as R_RB  # noqa: E402
from repro.fl import wire as R_W  # noqa: E402
from repro_torch.fl import robust as T_RB  # noqa: E402
from repro_torch.fl import wire as T_W  # noqa: E402

FOLD_RTOL = 1e-6


@pytest.mark.parametrize("n", [1, 2, 5, 8, 9, 4096, 164134, 11164362])
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_payloads_byte_equal(n, value_dtype):
    rng = np.random.default_rng(n)
    for k in sorted({0, 1, min(n, 3), min(n, 257)}):
        idx = rng.choice(n, k, replace=False)
        vals = (rng.standard_normal(k) * 1e-2).astype(np.float32)
        kw = dict(client=7, round_=3, n_params=n, value_dtype=value_dtype)
        a = T_W.encode_upload(idx, vals, **kw)
        b = R_W.encode_upload(idx, vals, **kw)
        assert a == b
        assert len(a) == T_W.payload_nbytes(n, k, value_dtype) == \
            R_W.payload_nbytes(n, k, value_dtype)
        ua, ub = T_W.decode_upload(a), R_W.decode_upload(a)
        assert (ua.client, ua.round, ua.n_params) == (ub.client, ub.round,
                                                      ub.n_params)
        assert ua.indices.dtype == ub.indices.dtype == np.int32
        np.testing.assert_array_equal(ua.indices, ub.indices)
        np.testing.assert_array_equal(ua.indices, idx)
        assert ua.values.tobytes() == ub.values.tobytes()
        np.testing.assert_array_equal(ua.densify(), ub.densify())


def test_bf16_values_truncate_like_the_reference():
    v = np.array([1.0, -1.0 - 2 ** -10, 3.14159, -0.0, 1e-30, 65504.5],
                 np.float32)
    assert T_W.f32_to_bf16_bytes(v) == R_W.f32_to_bf16_bytes(v)
    back = T_W.bf16_bytes_to_f32(T_W.f32_to_bf16_bytes(v))
    assert back.tobytes() == R_W.bf16_bytes_to_f32(
        R_W.f32_to_bf16_bytes(v)).tobytes()
    # truncation: |bf16(x)| <= |x| and within one bf16 ulp (2^-7 relative)
    assert (np.abs(back) <= np.abs(v)).all()
    assert (np.abs(v - back) <= np.abs(v) * 2 ** -7).all()


def test_crc_and_format_rejection():
    p = T_W.encode_upload(np.array([1, 4, 9]), np.ones(3, np.float32),
                          client=1, round_=2, n_params=16)
    for i in range(len(p) * 8):
        bad = bytearray(p)
        bad[i >> 3] ^= 1 << (i & 7)
        with pytest.raises(T_W.WireCRCError):
            T_W.decode_upload(bytes(bad))
        with pytest.raises(R_W.WireCRCError):
            R_W.decode_upload(bytes(bad))
    with pytest.raises(T_W.WireFormatError):
        T_W.decode_upload(p[:10])
    with pytest.raises(ValueError):
        T_W.encode_upload(np.arange(3), np.ones(2, np.float32), client=0,
                          round_=0, n_params=8)
    with pytest.raises(ValueError):
        T_W.encode_upload(np.arange(2), np.ones(2, np.float32), client=0,
                          round_=0, n_params=8, value_dtype="float16")
    assert [T_W.idx_bits(n) for n in (1, 2, 3, 4, 5, 1 << 20)] == \
        [R_W.idx_bits(n) for n in (1, 2, 3, 4, 5, 1 << 20)]


def test_loopback_transport_is_a_fifo():
    tr = T_W.make_transport("loopback")
    for i in range(5):
        tr.send(bytes([i]))
    assert tr.drain() == [bytes([i]) for i in range(5)]
    assert tr.drain() == []
    tr.close()
    with pytest.raises(ValueError):
        T_W.make_transport("carrier-pigeon")


def _payloads(n_params=1 << 12, k=40, n_up=23):
    """fig11's chunking-invariance payloads (its stream and sizes)."""
    rng = R_RNG.stream(7, R_RNG.KIND_FAULTS, 0, 99)
    out = []
    for c in range(n_up):
        idx = rng.choice(n_params, size=k, replace=False).astype(np.int64)
        vals = rng.normal(0.0, 1e-2, size=k).astype(np.float32)
        out.append(R_W.encode_upload(idx, vals, client=c, round_=0,
                                     n_params=n_params))
    return out, n_params, n_up


@pytest.mark.parametrize("name", T_RB.AGGREGATIONS)
@pytest.mark.parametrize("corrupt", [False, True])
def test_aggregator_matches_reference(name, corrupt):
    """Both servers' hot loops on the same payloads, in ONE chunk: the
    reference's loop refills one numpy buffer per chunk while its jitted
    update may still alias it (JAX on the CPU), so at several chunks its
    trimmed_mean and norm_clip results depend on timing (ROADMAP §3)."""
    payloads, n, n_up = _payloads()
    if corrupt:   # both servers must reject a flipped payload alike
        bad = bytearray(payloads[4])
        bad[30] ^= 4
        payloads = payloads + [bytes(bad)]
    chunk = 64
    ra = R_RB.make_aggregator(name, cohort=n_up)
    ta = T_RB.make_aggregator(name, cohort=n_up, device="cpu")
    rd, rok, rbad = R_RB.decode_and_aggregate(payloads, n, ra, chunk=chunk)
    td, tok, tbad = T_RB.decode_and_aggregate(payloads, n, ta, chunk=chunk)
    assert (tok, tbad) == (rok, rbad) == (n_up, int(corrupt))
    rd = np.asarray(rd)
    assert td.dtype == np.float32 and td.shape == (n,)
    if name in ("median", "krum"):
        assert td.tobytes() == rd.tobytes()
    else:
        np.testing.assert_allclose(td, rd, rtol=FOLD_RTOL)


@pytest.mark.parametrize("name", ["mean", "trimmed_mean", "norm_clip"])
def test_device_folds_match_reference_through_chunks(name):
    """update/finalize over masked, weighted [c, n] chunks (the wire
    round's replay), with -0.0, inf-free extremes and a zero-weight row."""
    rng = np.random.default_rng(3)
    n, cohort = 300, 12
    ra = R_RB.make_aggregator(name, cohort=cohort, trim_frac=0.2)
    ta = T_RB.make_aggregator(name, cohort=cohort, trim_frac=0.2,
                              device="cpu")
    rc, tc = ra.init(n), ta.init(n)
    cnt = 0
    for c in (4, 4, 2, 1):
        ups = (rng.standard_normal((c, n)) * 1e-2).astype(np.float32)
        ups[rng.random((c, n)) < 0.5] = 0.0
        w = np.ones(c, np.float32)
        w[-1] = 0.0 if c == 4 else 1.0
        if name == "norm_clip":
            w = w * ta.scales(np.linalg.norm(ups, axis=1)) * (w > 0)
            np.testing.assert_array_equal(
                ta.scales(np.linalg.norm(ups, axis=1)),
                ra.scales(np.linalg.norm(ups, axis=1)))
        rc = ra.update(rc, ups, w)
        tc = ta.update(tc, ups, w)
        cnt += int((w > 0).sum())
    g = (rng.standard_normal(n)).astype(np.float32)
    want = np.asarray(ra.finalize(jnp.asarray(g), rc, cnt))
    got = ta.finalize(torch.from_numpy(g), tc, cnt).numpy()
    np.testing.assert_allclose(got, want, rtol=FOLD_RTOL)


@pytest.mark.parametrize("name", T_RB.AGGREGATIONS)
def test_chunking_invariance_gate(name):
    """fig11's gate (c) on the port: the same row stream split at chunk 5
    and 16 — bit-exact for median/Krum, allclose for the device folds."""
    payloads, n, n_up = _payloads()
    deltas = []
    for chunk in (5, 16):
        agg = T_RB.make_aggregator(name, cohort=n_up, device="cpu")
        d, n_ok, n_bad = T_RB.decode_and_aggregate(payloads, n, agg,
                                                   chunk=chunk)
        assert n_ok == n_up and n_bad == 0
        deltas.append(d)
    if name in ("median", "krum"):
        assert np.array_equal(deltas[0], deltas[1])
    else:
        assert np.allclose(deltas[0], deltas[1], rtol=1e-5, atol=1e-7)


def test_make_aggregator_validation_matches():
    for kw in (dict(name="trimmed_mean", cohort=4, trim_frac=0.5),
               dict(name="krum", cohort=2), dict(name="krum", cohort=5,
                                                  krum_f=3),
               dict(name="nope", cohort=10)):
        with pytest.raises(ValueError):
            R_RB.make_aggregator(**kw)
        with pytest.raises(ValueError):
            T_RB.make_aggregator(**kw, device="cpu")
