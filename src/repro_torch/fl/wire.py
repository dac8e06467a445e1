"""Wire codec + transport for compressed uploads — the port's copy of
``repro.fl.wire`` (pure numpy; encoded payloads are byte-equal to the
reference's for the same inputs).

Today the engine aggregates in-process device arrays; Eq. 7 merely *prices*
the bytes those arrays would cost. This module makes the bytes real: each
participant's top-k upload is serialized to the exact payload the model
charges for — bitpacked indices at ``ceil(log2(n_params))`` bits each plus
an f32 (or bf16) value vector — so transport faults (fl/faults.py) can
corrupt, delay or drop something that actually exists.

Layout (little-endian)::

    offset  size  field
    0       2     magic  b"CW"
    2       1     version (currently 1)
    3       1     value dtype: 0 = float32, 1 = bfloat16
    4       4     client id       (u32)
    8       4     round           (u32)
    12      4     n_params        (u32)
    16      4     k = nnz         (u32)
    20      ...   indices, bitpacked MSB-first at idx_bits(n_params) bits
    ...     ...   values, k × (4 B f32 | 2 B bf16)
    end-4   4     CRC-32 (zlib) over everything before it

The CRC is the *only* integrity check — a flipped bit anywhere in header
or body surfaces as ``WireCRCError`` at decode, which the server answers
with a single retry request (see the fault engine's retry-once policy).

Transports carry opaque ``bytes``. ``LoopbackTransport`` is an in-process
FIFO — the default, and CI gates that a zero-fault run through it is
bit-identical to the legacy in-process path. ``QueueTransport`` wraps a
``multiprocessing`` queue so separate producer processes can hammer the
server (benchmarks/fig11_faults.py's load generator). Both are drained on
the MAIN thread only; the transport never touches the state store (REP008).
"""
from __future__ import annotations

import collections
import dataclasses
import struct
import zlib

import numpy as np

MAGIC = b"CW"
VERSION = 1
DTYPE_F32 = 0
DTYPE_BF16 = 1
_HEADER = struct.Struct("<2sBBIIII")
HEADER_BYTES = _HEADER.size    # 20
CRC_BYTES = 4


class WireError(ValueError):
    """Base class for malformed wire payloads."""


class WireFormatError(WireError):
    """Bad magic, unknown version/dtype, or truncated payload."""


class WireCRCError(WireError):
    """Payload failed its CRC-32 — corrupted in transit."""


def idx_bits(n_params: int) -> int:
    """Bits per bitpacked index: ceil(log2(n_params)), min 1."""
    if n_params < 1:
        raise ValueError(f"n_params={n_params} < 1")
    return max(1, int(n_params - 1).bit_length())


def payload_nbytes(n_params: int, k: int, value_dtype: str = "float32") -> int:
    """Exact serialized size of a k-sparse upload (what Eq. 7 should
    price under the wire engine)."""
    vb = 4 if value_dtype == "float32" else 2
    return HEADER_BYTES + (k * idx_bits(n_params) + 7) // 8 + k * vb + CRC_BYTES


@dataclasses.dataclass(frozen=True)
class WireUpload:
    """One decoded upload: the k-sparse compressed delta of ``client``."""
    client: int
    round: int
    n_params: int
    indices: np.ndarray    # [k] int32, ascending is NOT required
    values: np.ndarray     # [k] float32

    def densify(self) -> np.ndarray:
        out = np.zeros(self.n_params, np.float32)
        out[self.indices] = self.values
        return out


def _pack_indices(indices: np.ndarray, width: int) -> bytes:
    """MSB-first ``width``-bit packing: each index's big-endian u32 bytes
    unpacked to bits, its low ``width`` bits kept (the reference's
    shift-and-mask bit matrix, byte for byte, on uint8 instead of uint64
    — 32× less memory per index)."""
    be = np.asarray(indices).astype(">u4").view(np.uint8).reshape(-1, 4)
    if width % 8 == 0:      # whole bytes: the low width/8 of each index
        return be[:, 4 - width // 8:].tobytes()
    bits = np.unpackbits(be, axis=1)[:, 32 - width:]
    return np.packbits(bits.ravel()).tobytes()


def _unpack_indices(buf: bytes, k: int, width: int) -> np.ndarray:
    full = np.zeros((k, 4), np.uint8)
    if width % 8 == 0:
        full[:, 4 - width // 8:] = np.frombuffer(
            buf, np.uint8, count=k * width // 8).reshape(k, width // 8)
    else:
        bits = np.unpackbits(np.frombuffer(buf, np.uint8), count=k * width)
        wide = np.zeros((k, 32), np.uint8)
        wide[:, 32 - width:] = bits.reshape(k, width)
        full = np.packbits(wide, axis=1)
    return full.view(">u4")[:, 0].astype(np.int32)


def f32_to_bf16_bytes(values: np.ndarray) -> bytes:
    """Truncating f32→bf16 (drop the low mantissa half — round-to-zero,
    matching the accounting in core.compression for 16-bit payloads)."""
    u = np.ascontiguousarray(values, np.float32).view(np.uint32)
    return (u >> np.uint32(16)).astype(np.uint16).tobytes()


def bf16_bytes_to_f32(buf: bytes) -> np.ndarray:
    u = np.frombuffer(buf, np.uint16).astype(np.uint32) << np.uint32(16)
    return u.view(np.float32)


def encode_upload(indices: np.ndarray, values: np.ndarray, *, client: int,
                  round_: int, n_params: int,
                  value_dtype: str = "float32") -> bytes:
    """Serialize one k-sparse upload. ``indices``/``values`` are the
    top-k support and its f32 payload (exactly what the in-process path
    feeds the accumulator)."""
    indices = np.asarray(indices)
    values = np.asarray(values, np.float32)
    if indices.shape != values.shape or indices.ndim != 1:
        raise ValueError(f"indices {indices.shape} / values {values.shape} "
                         "must be matching 1-D arrays")
    k = len(indices)
    if value_dtype == "float32":
        dflag, vbytes = DTYPE_F32, values.tobytes()
    elif value_dtype == "bfloat16":
        dflag, vbytes = DTYPE_BF16, f32_to_bf16_bytes(values)
    else:
        raise ValueError(f"unknown value_dtype {value_dtype!r}")
    body = (_HEADER.pack(MAGIC, VERSION, dflag, client, round_, n_params, k)
            + _pack_indices(indices, idx_bits(n_params)) + vbytes)
    return body + struct.pack("<I", zlib.crc32(body))


def decode_upload(buf: bytes) -> WireUpload:
    """Parse + CRC-check one serialized upload.

    Raises ``WireCRCError`` on checksum mismatch (the retryable fault) and
    ``WireFormatError`` on anything structurally wrong."""
    if len(buf) < HEADER_BYTES + CRC_BYTES:
        raise WireFormatError(f"payload truncated at {len(buf)} B")
    (crc,) = struct.unpack_from("<I", buf, len(buf) - CRC_BYTES)
    if zlib.crc32(buf[:-CRC_BYTES]) != crc:
        raise WireCRCError("CRC-32 mismatch")
    magic, version, dflag, client, round_, n_params, k = \
        _HEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise WireFormatError(f"bad magic {magic!r}")
    if version != VERSION:
        raise WireFormatError(f"unknown version {version}")
    if dflag not in (DTYPE_F32, DTYPE_BF16):
        raise WireFormatError(f"unknown value dtype flag {dflag}")
    width = idx_bits(n_params)
    ib = (k * width + 7) // 8
    vb = k * (4 if dflag == DTYPE_F32 else 2)
    if len(buf) != HEADER_BYTES + ib + vb + CRC_BYTES:
        raise WireFormatError(
            f"length {len(buf)} != expected {HEADER_BYTES + ib + vb + CRC_BYTES}")
    indices = _unpack_indices(buf[HEADER_BYTES:HEADER_BYTES + ib], k, width)
    vraw = buf[HEADER_BYTES + ib:HEADER_BYTES + ib + vb]
    if dflag == DTYPE_F32:
        values = np.frombuffer(vraw, np.float32).copy()
    else:
        values = bf16_bytes_to_f32(vraw)
    if k and int(indices.max(initial=0)) >= n_params:
        raise WireFormatError("index out of range")
    return WireUpload(client=client, round=round_, n_params=n_params,
                      indices=indices, values=values)


class LoopbackTransport:
    """In-process FIFO of serialized payloads — the default wire. Sends
    and drains happen on the main thread; this exists so the byte path
    (encode → queue → decode) is exercised even with zero faults."""

    def __init__(self):
        self._q: collections.deque[bytes] = collections.deque()

    def send(self, payload: bytes) -> None:
        self._q.append(payload)

    def drain(self) -> list[bytes]:
        out = list(self._q)
        self._q.clear()
        return out

    def close(self) -> None:
        self._q.clear()


class QueueTransport:
    """Multi-process wire: producers (other processes) ``send`` serialized
    uploads into a ``multiprocessing`` queue; the server drains on the main
    thread. Used by the fig11 load generator and the backpressured soak.

    A bounded queue (``maxsize > 0``) models a server ingress buffer:
    ``try_send`` is the producer's non-blocking offer (False = buffer full
    — the producer's problem, see ``send_with_backoff``), ``get`` pulls
    one payload server-side, ``depth`` samples the instantaneous queue
    occupancy for backpressure telemetry."""

    def __init__(self, ctx=None, maxsize: int = 0):
        import multiprocessing as mp
        self._q = (ctx or mp.get_context("spawn")).Queue(maxsize)

    @classmethod
    def attach(cls, queue) -> "QueueTransport":
        """Wrap an existing mp queue handle (the picklable ``queue``
        property shipped to a producer process) back into a transport."""
        self = cls.__new__(cls)
        self._q = queue
        return self

    @property
    def queue(self):
        """The raw mp queue — picklable handle for producer processes."""
        return self._q

    def send(self, payload: bytes) -> None:
        self._q.put(payload)

    def try_send(self, payload: bytes) -> bool:
        """Non-blocking offer; False when the bounded buffer is full."""
        import queue as _queue
        try:
            self._q.put_nowait(payload)
            return True
        except _queue.Full:
            return False

    def get(self, timeout: float = 60.0) -> bytes:
        """Pull one payload (server side). Raises ``queue.Empty`` on
        timeout — the soak's drain loop treats that as 'producers done'."""
        return self._q.get(timeout=timeout)

    def depth(self) -> int:
        """Approximate current queue occupancy (mp.Queue.qsize is advisory
        by contract; good enough for telemetry, never for control flow)."""
        try:
            return self._q.qsize()
        except NotImplementedError:      # macOS sem_getvalue gap
            return -1

    def drain(self, n: int, timeout: float = 60.0) -> list[bytes]:
        return [self._q.get(timeout=timeout) for _ in range(n)]

    def close(self) -> None:
        self._q.close()
        self._q.join_thread()


def send_with_backoff(transport, payload: bytes, *, max_retries: int = 8,
                      base_s: float = 0.002, cap_s: float = 0.25):
    """Producer-side retry/backoff against a bounded queue: offer via
    ``try_send``; on Full, sleep ``min(cap_s, base_s · 2^attempt)`` and
    retry, up to ``max_retries`` times. Deterministic (no jitter — the
    soak wants reproducible-ish schedules and the producers are already
    decorrelated by their payload build times). Returns
    ``(delivered, retries, waited_s)`` so the soak can report reject and
    backoff telemetry per producer."""
    import time
    if transport.try_send(payload):
        return True, 0, 0.0
    waited = 0.0
    for attempt in range(max_retries):
        pause = min(cap_s, base_s * (2.0 ** attempt))
        time.sleep(pause)
        waited += pause
        if transport.try_send(payload):
            return True, attempt + 1, waited
    return False, max_retries, waited


def make_transport(name: str):
    if name == "loopback":
        return LoopbackTransport()
    if name == "queue":
        return QueueTransport()
    raise ValueError(f"unknown transport {name!r} (want loopback|queue)")
