"""The port's PS wire (byteps_tpu_torch/engine/wire.py) against the JAX
package's (byteps_tpu/engine/wire.py): frames byte-identical for every
wire dtype and for ``bpsc1`` compressed blobs, each package decoding the
other's, and ``ShardWorker``'s window, priority order, timeout abort and
whole-window failure on a reset, as ``tests/test_wire_pipeline.py`` holds
the JAX worker.  bfloat16 is a CPU tensor on the port's side and an
``ml_dtypes`` array on JAX's.  Inputs come from numpy with fixed seeds."""

import socket
import struct
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from byteps_tpu.compression import registry as jax_registry
from byteps_tpu.compression import wire as jax_cwire
from byteps_tpu.engine import wire as jw
from byteps_tpu_torch.compression import registry as port_registry
from byteps_tpu_torch.compression import wire as port_cwire
from byteps_tpu_torch.engine import ps_server
from byteps_tpu_torch.engine import wire as pw
from byteps_tpu_torch.engine.wire import ShardWorker, _encode_buffers
from byteps_tpu_torch.resilience.chaos import _read_frame

NUMPY_DTYPES = ("float32", "float64", "float16", "int8", "int16", "int32",
                "int64", "uint8", "uint16", "uint32", "uint64", "bool",
                "complex64")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _array(dtype, shape=(3, 5), seed=0):
    rng = np.random.RandomState(seed)
    if dtype == "bool":
        return rng.randint(0, 2, shape).astype(bool)
    if dtype.startswith("complex"):
        return np.asarray(rng.randn(*shape) + 1j * rng.randn(*shape),
                          dtype)
    if dtype.startswith(("int", "uint")):
        info = np.iinfo(dtype)
        return np.asarray(rng.randint(max(info.min, -1000),
                                      min(info.max, 1000), shape), dtype)
    return np.asarray(rng.randn(*shape), dtype)


def _decode_bytes(decode, data: bytes):
    a, b = socket.socketpair()
    try:
        a.sendall(data)
        return decode(b)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("dtype", NUMPY_DTYPES + ("bfloat16",))
@pytest.mark.parametrize("shape", [(3, 5), (0,), ()])
def test_frames_byte_identical_and_cross_decoded(dtype, shape):
    if dtype == "bfloat16":
        raw = _array("float32", shape, 1)
        jarr = raw.astype(ml_dtypes.bfloat16)
        parr = torch.from_numpy(raw).to(torch.bfloat16)
    else:
        jarr = parr = _array(dtype, shape, 2)
    jframe = jw._encode(1, "w#p3", jarr)
    pframe = pw._encode(1, "w#p3", parr)
    assert pframe == jframe
    assert b"".join(bytes(b) for b in _encode_buffers(1, "w#p3", parr)) \
        == jframe
    # each package decodes the other's frame to the same bytes
    op, name, arr, payload, tid = _decode_bytes(pw._decode_frame, jframe)
    assert (op, name, tid) == (1, "w#p3", b"")
    if dtype == "bfloat16":
        assert arr.dtype == torch.bfloat16
        assert arr.view(torch.int16).numpy().tobytes() == jarr.tobytes()
    else:
        assert arr.dtype == jarr.dtype and arr.tobytes() == jarr.tobytes()
    jop, jname, jarr2, _ = _decode_bytes(jw._decode, pframe)
    assert (jop, jname) == (1, "w#p3")
    assert jarr2.dtype == jarr.dtype and jarr2.tobytes() == jarr.tobytes()
    # a 0-d array travels as [1] in both packages
    assert tuple(arr.shape) == tuple(jarr2.shape) == (jarr.shape or (1,))


def test_raw_payload_and_trace_extension_frames():
    raw = struct.pack("<Q", 12345)
    assert pw._encode(3, "n", None, raw) == jw._encode(3, "n", None, raw)
    # a tracing JAX peer's frame: the port reads the extension, returns
    # the id, and decodes the rest
    x = _array("float32")
    tid = bytes(range(8))
    ext = b"".join(bytes(b) for b in jw._encode_buffers(1, "w", x,
                                                        trace_id=tid))
    op, name, arr, _, got = _decode_bytes(pw._decode_frame, ext)
    assert (op, name, got) == (1, "w", tid)
    assert arr.tobytes() == x.tobytes()
    bad = bytearray(ext)
    bad[5] = 2   # unknown extension version: loud
    with pytest.raises(ValueError, match="extension version"):
        _decode_bytes(pw._decode_frame, bytes(bad))


@pytest.mark.parametrize("scheme", ["bf16", "fp16", "int8", "topk",
                                    "onebit", "randomk"])
def test_compressed_blob_frames_byte_identical(scheme):
    x = np.random.RandomState(4).randn(64, 33).astype(np.float32)
    jblob, _ = jax_cwire.encode_blob(jax_registry.get_scheme(scheme), x,
                                     seed=7, ratio=0.05)
    pblob, _ = port_cwire.encode_blob(port_registry.get_scheme(scheme), x,
                                      seed=7, ratio=0.05)
    jframe = jw._encode(6, "g", jblob)
    assert pw._encode(6, "g", pblob) == jframe
    # the port decodes the compressed frame to JAX's dense values
    _, _, arr, _, _ = _decode_bytes(pw._decode_frame, jframe)
    _, _, jarr, _ = _decode_bytes(jw._decode, jframe)
    assert arr.tobytes() == jarr.tobytes()


def test_bf16_tensor_blob_names_bfloat16_as_jax():
    raw = np.random.RandomState(5).randn(40).astype(np.float32)
    jx = raw.astype(ml_dtypes.bfloat16)
    px = torch.from_numpy(raw).to(torch.bfloat16)
    for scheme in ("fp16", "onebit"):
        jblob, _ = jax_cwire.encode_blob(jax_registry.get_scheme(scheme), jx)
        pblob, _ = port_cwire.encode_blob(port_registry.get_scheme(scheme),
                                          px)
        assert pw._encode(6, "b", pblob) == jw._encode(6, "b", jblob)


# ------------------------------------------------------------ ShardWorker


class _ManualShard:
    """A hand-driven fake shard: the test reads frames and writes replies
    itself, so window, priority and abort behaviour are observable."""

    def __init__(self):
        self.listener = socket.socket()
        self.listener.bind(("127.0.0.1", 0))
        self.listener.listen(4)
        self.port = self.listener.getsockname()[1]
        self.conn = None

    def connect(self):
        s = socket.create_connection(("127.0.0.1", self.port), timeout=5.0)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def accept(self):
        self.listener.settimeout(5.0)
        self.conn, _ = self.listener.accept()
        self.conn.settimeout(5.0)
        return self.conn

    def read_frame_name(self):
        frame = _read_frame(self.conn)
        (nlen,) = struct.unpack("<I", frame[1:5])
        return bytes(frame[5:5 + nlen]).decode()

    def reply_ok(self):
        self.conn.sendall(pw._encode(0, "", None))

    def pending_bytes(self):
        self.conn.setblocking(False)
        try:
            return len(self.conn.recv(1, socket.MSG_PEEK))
        except BlockingIOError:
            return 0
        finally:
            self.conn.setblocking(True)
            self.conn.settimeout(5.0)

    def close(self):
        for s in (self.conn, self.listener):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass


def _ping(name):
    return _encode_buffers(ps_server.OP_PING, name, None)


def test_shard_worker_window_bounds_inflight():
    shard = _ManualShard()
    w = ShardWorker(shard.connect, window=2, recv_timeout=60.0)
    try:
        pend = [w.submit(_ping(f"r{i}"), key=i) for i in range(5)]
        shard.accept()
        assert shard.read_frame_name() == "r0"
        assert shard.read_frame_name() == "r1"
        time.sleep(0.1)
        assert shard.pending_bytes() == 0   # window 2: r2 is not sent
        for nxt in ("r2", "r3", "r4"):
            shard.reply_ok()                # one ack frees one slot
            assert shard.read_frame_name() == nxt
        shard.reply_ok()
        shard.reply_ok()
        for p in pend:
            assert w.wait(p, 5.0)[0] == 0
    finally:
        w.close()
        shard.close()


def test_shard_worker_priority_order_on_wire():
    """Frames queued while the window is full go out in (priority desc,
    key asc) order, not submission order."""
    shard = _ManualShard()
    w = ShardWorker(shard.connect, window=1, recv_timeout=60.0)
    try:
        first = w.submit(_ping("first"))
        shard.accept()
        assert shard.read_frame_name() == "first"
        low = w.submit(_ping("low"), priority=-5, key=0)
        hi2 = w.submit(_ping("hi2"), priority=10, key=2)
        hi1 = w.submit(_ping("hi1"), priority=10, key=1)
        time.sleep(0.1)
        for nxt in ("hi1", "hi2", "low"):
            shard.reply_ok()
            assert shard.read_frame_name() == nxt
        shard.reply_ok()
        for p in (first, hi1, hi2, low):
            assert w.wait(p, 5.0)[0] == 0
    finally:
        w.close()
        shard.close()


def test_shard_worker_timeout_aborts_connection():
    """A wait timeout on a SENT request kills the connection (FIFO
    matching cannot skip a frame) and raises socket.timeout; the next
    submit reconnects."""
    shard = _ManualShard()
    w = ShardWorker(shard.connect, window=2, recv_timeout=60.0)
    try:
        p = w.submit(_ping("hang"))
        shard.accept()
        assert shard.read_frame_name() == "hang"
        with pytest.raises(socket.timeout):
            w.wait(p, 0.2)
        with pytest.raises((ConnectionError, OSError)):
            if _read_frame(shard.conn) == b"":
                raise ConnectionError("eof")
        p2 = w.submit(_ping("again"))
        shard.accept()
        assert shard.read_frame_name() == "again"
        shard.reply_ok()
        assert w.wait(p2, 5.0)[0] == 0
    finally:
        w.close()
        shard.close()


def test_shard_worker_reset_fails_whole_window():
    """A mid-window reset fails every un-acked request; queued-but-unsent
    ones go out on the next connection."""
    shard = _ManualShard()
    resets = []
    w = ShardWorker(shard.connect, window=3, recv_timeout=60.0,
                    on_reset=lambda err, n: resets.append(n))
    try:
        pend = [w.submit(_ping(f"q{i}"), key=i) for i in range(5)]
        conn = shard.accept()
        for i in range(3):
            assert shard.read_frame_name() == f"q{i}"
        pw.hard_reset(conn)   # RST with 3 un-acked in flight
        for p in pend[:3]:
            with pytest.raises(OSError):
                w.wait(p, 5.0)
        shard.accept()
        for i in (3, 4):
            assert shard.read_frame_name() == f"q{i}"
            shard.reply_ok()
            assert w.wait(pend[i], 5.0)[0] == 0
        assert resets == [3]
    finally:
        w.close()
        shard.close()
