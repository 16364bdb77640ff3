"""Frame codec and pipelined per-shard I/O workers — the port of
``byteps_tpu/engine/wire.py``: the framing the serve frontend, its
client, the disaggregated KV ship and the parameter-server tier speak,
byte for byte the JAX package's, and the PS client's ``ShardWorker``.

Frame layout (little-endian)::

    u8 op | u32 name_len | [ext: u8 version, u8 len, body] | name
    | u32 dtype_len | dtype name | u8 ndim | ndim x u64 shape
    | u64 payload_len | payload

A frame whose op byte has bit 0x80 set carries the versioned header
extension (version 1: an 8-byte trace id).  This codec reads it, so
frames from a tracing JAX peer decode; it never writes it (RPC trace
ids are refused in the port).  The dtype is named as numpy names it
(``float32``, ``bfloat16``, ...).  bfloat16 has no numpy dtype in the
port, so a ``bfloat16`` payload decodes to a CPU ``torch.Tensor`` and
every other one to a numpy array; :func:`_encode_buffers` takes either.
A compressed payload rides the same frame under the versioned dtype tag
``bpsc1`` (compression/wire.py) and is decompressed at decode time, so
both ends of the wire see a dense array.

**ShardWorker** — one per (client, shard): a send loop draining a
priority ``ScheduledQueue`` ((priority desc, key asc), so first-needed
tensors win the wire) under a bounded in-flight window
(``BYTEPS_WIRE_WINDOW``), and a receive loop matching replies to
requests **by order**.  FIFO matching is sound because the PS server
serves one connection's requests strictly in arrival order.  The
failure contract:

  * any wire error (reset, garbled frame, timeout) kills the whole
    connection and fails every un-acked in-flight request — each then
    re-enters ``RemoteStore._rpc``'s retry / version-guard / failover
    machinery on its own;
  * a request still queued (never sent) survives a reset untouched and
    goes out on the fresh connection;
  * a caller abandoning a SENT request (op deadline) kills the
    connection too: forgetting one in-flight frame would desynchronize
    FIFO matching for every later reply.

``BYTEPS_WIRE_WINDOW=0`` disables the workers and restores the serial
blocking client.
"""

from __future__ import annotations

import collections
import os
import socket
import struct
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import logging as bps_log
from ..common.scheduler import ScheduledQueue
from ..common.types import TensorTaskEntry
from ..compression.wire import WIRE_MAGIC, WIRE_TAG, WireBlob, decode_blob

_MAX_NAME = 1 << 16
_MAX_PAYLOAD = 1 << 34  # 16 GiB sanity bound
_EXT_FLAG = 0x80
_EXT_VERSION = 1
_TRACE_ID_LEN = 8


# ---------------------------------------------------------------- wire codec


def _dtype_to_wire(dt) -> bytes:
    """A dtype's wire name — numpy's spelling (``float32``, ``bfloat16``)
    for a numpy or a torch dtype."""
    if isinstance(dt, torch.dtype):
        return str(dt).split(".", 1)[1].encode()
    return np.dtype(dt).name.encode()


def _wire_to_dtype(name: str):
    """A wire dtype name as a numpy dtype, or ``torch.bfloat16``."""
    if name == "bfloat16":
        return torch.bfloat16
    return np.dtype(name)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Read exactly ``n`` bytes into one preallocated buffer."""
    buf = bytearray(n)
    if n:
        view = memoryview(buf)
        got = 0
        while got < n:
            r = sock.recv_into(view[got:])
            if r == 0:
                raise ConnectionError("peer closed mid-message")
            got += r
    return buf


def hard_reset(sock: socket.socket) -> None:
    """Close with an RST (SO_LINGER 0), not a FIN: the peer sees
    ECONNRESET mid-RPC, the way a crashed process looks
    (``ServeFrontend.kill``, ``PSServer.kill``, the chaos proxy)."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _payload_view(arr):
    """Zero-copy byte view of a contiguous CPU ``torch.Tensor`` or numpy
    array: what a frame's payload slot hands to ``sendmsg`` instead of a
    ``tobytes()`` copy.  A tensor is reinterpreted as ``uint8``
    (``tensor.view(torch.uint8)``, bf16 included) and handed out as the
    numpy array sharing its memory."""
    if isinstance(arr, torch.Tensor):
        if arr.numel() == 0:
            return b""
        return arr.reshape(-1).view(torch.uint8).numpy()
    if arr.size == 0:
        return b""
    return arr.reshape(-1).view(np.uint8)


def _encode_buffers(op: int, name: str, arr, raw: bytes = b"") -> List:
    """One frame as a buffer list for scatter-gather send: ``[header,
    payload...]``, the payload a zero-copy view of the array (a numpy
    array, a CPU tensor or a ``WireBlob``), or ``raw``.  ``b"".join`` of
    the result is byte-identical to :func:`_encode`."""
    nb = name.encode()
    if isinstance(arr, WireBlob):
        dt = WIRE_TAG.encode()
        shape = arr.shape
        payload_bufs: Sequence = arr.buffers()
        plen = arr.nbytes
    elif arr is not None:
        if isinstance(arr, torch.Tensor):
            # at least 1-d, as numpy's ascontiguousarray makes it
            arr = arr.detach().contiguous().reshape(arr.shape or (1,))
        else:
            arr = np.ascontiguousarray(arr)
        dt = _dtype_to_wire(arr.dtype)
        plen = arr.nbytes
        shape = tuple(arr.shape)
        view = _payload_view(arr)
        payload_bufs = (view,) if len(view) else ()
    else:
        dt = b""
        shape = ()
        payload_bufs = (raw,) if len(raw) else ()
        plen = len(raw)
    head = struct.pack("<BI", op, len(nb)) + nb
    head += struct.pack("<I", len(dt)) + dt
    head += struct.pack("<B", len(shape)) + struct.pack(
        f"<{len(shape)}Q", *shape)
    head += struct.pack("<Q", plen)
    return [head, *payload_bufs]


def _encode(op: int, name: str, arr, raw: bytes = b"") -> bytes:
    """One frame: the header, then the array's bytes (or ``raw``) — the
    join of :func:`_encode_buffers`."""
    return b"".join(bytes(b) if not isinstance(b, bytes) else b
                    for b in _encode_buffers(op, name, arr, raw))


# sendmsg refuses iovecs longer than IOV_MAX (1024 on Linux) with
# EMSGSIZE; the sender caps each call there
try:
    _IOV_MAX = min(1024, os.sysconf("SC_IOV_MAX"))
except (AttributeError, OSError, ValueError):  # pragma: no cover
    _IOV_MAX = 1024


def _send_buffers(sock: socket.socket, buffers: Sequence) -> None:
    """``sendall`` a buffer list with ``sendmsg`` scatter-gather (no
    user-space join), across partial sends and at most ``IOV_MAX``
    buffers a call."""
    views = [memoryview(b).cast("B") for b in buffers if len(b)]
    while views:
        sent = sock.sendmsg(views[:_IOV_MAX])
        while views and sent >= len(views[0]):
            sent -= len(views[0])
            views.pop(0)
        if sent and views:
            views[0] = views[0][sent:]


def _decode_payload(dt: str, payload, shape):
    """A frame's payload as an array: decompressed for a ``bpsc`` tag, a
    ``torch.Tensor`` for bfloat16, numpy otherwise."""
    if dt.startswith(WIRE_MAGIC):
        return decode_blob(dt, bytes(payload), shape)
    dtype = _wire_to_dtype(dt)
    if not isinstance(dtype, np.dtype):
        if not len(payload):
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(payload, dtype=dtype).reshape(shape)
    return np.frombuffer(payload, dtype=dtype).reshape(shape)


def _decode_frame(sock: socket.socket):
    """Read one frame: ``(op, name, arr, payload, trace_id)``.  The
    trace id is b"" for unextended frames; an unknown extension version
    raises (loud, never a silent misread)."""
    op, nlen = struct.unpack("<BI", _recv_exact(sock, 5))
    if nlen > _MAX_NAME:
        raise ValueError(f"name too long: {nlen}")
    trace_id = b""
    if op & _EXT_FLAG:
        ver, elen = struct.unpack("<BB", _recv_exact(sock, 2))
        ext = bytes(_recv_exact(sock, elen))
        if ver != _EXT_VERSION:
            raise ValueError(f"unknown wire header extension version "
                             f"{ver} (peer newer than this build?)")
        trace_id = ext[:_TRACE_ID_LEN]
        op &= ~_EXT_FLAG
    name = _recv_exact(sock, nlen).decode()
    (dlen,) = struct.unpack("<I", _recv_exact(sock, 4))
    dt = _recv_exact(sock, dlen).decode()
    (ndim,) = struct.unpack("<B", _recv_exact(sock, 1))
    shape = (struct.unpack(f"<{ndim}Q", _recv_exact(sock, 8 * ndim))
             if ndim else ())
    (plen,) = struct.unpack("<Q", _recv_exact(sock, 8))
    if plen > _MAX_PAYLOAD:
        raise ValueError(f"payload too large: {plen}")
    payload = _recv_exact(sock, plen) if plen else b""
    arr = _decode_payload(dt, payload, shape) if dt else None
    return op, name, arr, payload, trace_id


def _decode(sock: socket.socket):
    """Read one frame: ``(op, name, arr, payload)``."""
    return _decode_frame(sock)[:4]


# ----------------------------------------------------------- shard workers


class PendingRpc:
    """One submitted request: its frame buffers and the future its
    caller blocks on.  Settling (resolve/fail) is idempotent — kill
    paths and late receivers may race, first one wins."""

    __slots__ = ("buffers", "state", "done", "event", "error",
                 "status", "rname", "out", "payload", "_plock")

    QUEUED, SENT = 0, 1

    def __init__(self, buffers: List):
        self.buffers = buffers
        self.state = PendingRpc.QUEUED  # wire bookkeeping (worker lock)
        self.done = False               # settled flag (own lock)
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        self.status = self.rname = self.out = self.payload = None
        self._plock = threading.Lock()

    def _settle(self) -> bool:
        with self._plock:
            if self.done:
                return False
            self.done = True
            return True

    def resolve(self, status, rname, out, payload) -> None:
        if self._settle():
            self.status, self.rname = status, rname
            self.out, self.payload = out, payload
            self.buffers = None  # free the request frame early
            self.event.set()

    def fail(self, err: BaseException) -> None:
        if self._settle():
            self.error = err
            self.buffers = None
            self.event.set()


class ShardWorker:
    """Per-shard I/O worker: priority send queue, bounded in-flight
    window, FIFO reply matching (module docstring has the contract).

    One sender and one receiver thread a shard connection.  The sender
    is its own thread because ``sendmsg`` of a large frame blocks at the
    pace the peer drains it: per-shard senders stream to every shard at
    once (the GIL is released inside send/recv).  The receiver never
    sends — a receiver blocked mid-``sendmsg`` while the server is
    itself blocked sending a large reply would deadlock both socket
    buffers.

    ``connect`` is a zero-arg callable returning a fresh connected
    socket.  ``on_reset(exc, n_inflight)`` fires once per connection
    kill (the store counts reconnects and window aborts there)."""

    def __init__(self, connect: Callable[[], socket.socket], window: int,
                 shard: int = 0, recv_timeout: float = 30.0,
                 on_reset: Optional[Callable] = None,
                 transport: str = "tcp"):
        from ..observability.metrics import get_registry

        self._connect = connect
        self._window = max(1, int(window))
        self._shard = shard
        self._recv_timeout = recv_timeout
        self._on_reset = on_reset
        self._queue = ScheduledQueue(name=f"wire-shard{shard}")
        self._inflight: "collections.deque[PendingRpc]" = collections.deque()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)  # window-slot wakeups
        self._free = self._window  # un-acked window slots left (lock)
        self._sock: Optional[socket.socket] = None
        self._gen = 0  # connection generation; bumped on every kill
        self._closed = threading.Event()
        self._sender: Optional[threading.Thread] = None
        # live wire metrics (process registry), resolved once: the I/O
        # loops must not pay a registry lookup per frame
        reg = get_registry()
        self._m_bytes = reg.counter("wire.bytes_sent", track="wire",
                                    instants=False, mirror=False,
                                    shard=shard, transport=transport)
        self._m_frames = reg.counter("wire.frames_sent", track="wire",
                                     instants=False, mirror=False,
                                     shard=shard, transport=transport)
        self._m_replies = reg.counter("wire.replies_received", track="wire",
                                      instants=False, mirror=False,
                                      shard=shard, transport=transport)
        self._m_inflight = reg.gauge("wire.inflight", track="wire",
                                     mirror=False, shard=shard)
        self._m_qdepth = reg.gauge("wire.queue_depth", track="wire",
                                   mirror=False, shard=shard)
        self._m_occ = reg.gauge("wire.window_occupancy", track="wire",
                                mirror=False, shard=shard)

    def _note_inflight_locked(self) -> None:
        """Caller holds ``_lock``; publishes the window state gauges."""
        used = self._window - self._free
        self._m_inflight.set(used)
        self._m_occ.set(used / self._window)

    # --------------------------------------------------------------- submit

    def submit(self, buffers: List, priority: int = 0,
               key: int = 0) -> PendingRpc:
        """Enqueue one request frame; returns its future.  Issue order is
        (priority desc, key asc), FIFO among equals.  Never blocks on the
        window: frames beyond it stay queued until replies free slots."""
        if self._closed.is_set():
            raise ConnectionError(f"shard {self._shard} wire worker closed")
        pending = PendingRpc(buffers)
        self._ensure_sender()
        self._queue.add_task(TensorTaskEntry(name="", key=key,
                                             priority=priority,
                                             payload=pending))
        self._m_qdepth.set(self._queue.pending())
        return pending

    def wait(self, pending: PendingRpc, timeout: Optional[float]):
        """Block on a submitted request.  A timeout ABORTS the request
        (see ``abort``) and raises ``socket.timeout``, which callers'
        retry machinery treats as the serial client's socket timeout."""
        if not pending.event.wait(timeout):
            self.abort(pending, socket.timeout(
                f"shard {self._shard}: no reply within {timeout:.3f}s"))
            pending.event.wait()  # abort settles it synchronously
        if pending.error is not None:
            raise pending.error
        return pending.status, pending.rname, pending.out, pending.payload

    def abort(self, pending: PendingRpc, err: BaseException) -> None:
        """Give up on one request.  Queued and unsent: cancel it (the
        sender skips settled pendings).  Already on the wire: the
        connection dies with it, failing the rest of the window into
        their own retries, as a peer reset would."""
        with self._lock:
            sent = pending.state == PendingRpc.SENT
            gen = self._gen
        if sent:
            self._kill(gen, err)
        pending.fail(err)  # idempotent; no-op if the kill settled it

    # ------------------------------------------------------------ send loop

    def _ensure_sender(self) -> None:
        if self._sender is None:
            with self._lock:
                if self._sender is None and not self._closed.is_set():
                    t = threading.Thread(
                        target=self._send_loop,
                        name=f"bps-wire-send-{self._shard}", daemon=True)
                    self._sender = t
                    t.start()

    def _send_loop(self) -> None:
        """Drain the priority queue onto the wire, window-gated; both
        waits time out shortly so ``close()`` is prompt."""
        while not self._closed.is_set():
            with self._cv:
                if self._free <= 0:
                    # only this thread decrements _free, so the re-check
                    # after the wake is race-free
                    self._cv.wait(0.25)
                    continue
            task = self._queue.wait_task(timeout=0.25)
            if task is None:
                continue
            pending: PendingRpc = task.payload
            if pending.done:  # aborted while queued
                continue
            try:
                sock, gen = self._ensure_sock()
            except OSError as e:
                pending.fail(e)
                continue
            with self._lock:
                if gen != self._gen:
                    # the connection died between connect and here
                    pending.fail(ConnectionError("connection reset"))
                    continue
                # read the buffer list once: a concurrent abort/kill
                # fail()s the pending under its own lock and nulls it
                bufs = pending.buffers
                if pending.done or bufs is None:
                    continue
                pending.state = PendingRpc.SENT
                self._inflight.append(pending)
                self._free -= 1
                self._note_inflight_locked()
            nbytes = sum(len(b) for b in bufs)
            try:
                _send_buffers(sock, bufs)
            except OSError as e:
                self._kill(gen, e)  # drains in-flight (this frame too)
            else:
                self._m_bytes.inc(nbytes)
                self._m_frames.inc()
                self._m_qdepth.set(self._queue.pending())
        for task in self._queue.drain():
            task.payload.fail(ConnectionError("wire worker closed"))

    # --------------------------------------------------------------- loops

    def _ensure_sock(self) -> Tuple[socket.socket, int]:
        """Sender thread only: connect lazily, start the paired
        receiver."""
        with self._lock:
            if self._sock is not None:
                return self._sock, self._gen
        sock = self._connect()
        sock.settimeout(self._recv_timeout)
        with self._lock:
            self._sock = sock
            gen = self._gen
        threading.Thread(target=self._recv_loop, args=(sock, gen),
                         name=f"bps-wire-recv-{self._shard}",
                         daemon=True).start()
        return sock, gen

    def _recv_loop(self, sock: socket.socket, gen: int) -> None:
        while True:
            try:
                status, rname, out, payload = _decode(sock)
            except socket.timeout:
                with self._lock:
                    stale = gen != self._gen
                    hung = bool(self._inflight)
                if stale:
                    return
                if hung:
                    # un-acked requests older than the socket timeout: a
                    # hung (not crashed) shard
                    self._kill(gen, socket.timeout(
                        f"shard {self._shard} stalled mid-window"))
                    return
                continue  # idle connection; keep listening
            except Exception as e:
                self._kill(gen, e if isinstance(e, (OSError, ValueError,
                                                    struct.error))
                           else ConnectionError(str(e)))
                return
            with self._cv:
                if gen != self._gen:
                    return  # replaced connection
                if not self._inflight:
                    break  # reply with no request: protocol violation
                pending = self._inflight.popleft()
                self._free += 1
                self._note_inflight_locked()
                self._cv.notify()  # wake a window-gated sender
            self._m_replies.inc()
            pending.resolve(status, rname, out, payload)
        self._kill(gen, ValueError(
            f"shard {self._shard}: reply with no request in flight"))

    def _kill(self, gen: int, err: BaseException) -> None:
        """Tear down one connection generation: close the socket, fail
        every un-acked in-flight request, leave queued-but-unsent ones
        for the next connection.  Idempotent per generation."""
        with self._cv:
            if gen != self._gen:
                return
            self._gen += 1
            sock, self._sock = self._sock, None
            victims = list(self._inflight)
            self._inflight.clear()
            self._free += len(victims)
            self._note_inflight_locked()
            self._cv.notify()
        if sock is not None:
            # shutdown() before close(): closing an fd another thread is
            # blocked reading does not reliably wake it
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        for p in victims:
            p.fail(err)
        if self._on_reset is not None and sock is not None:
            self._on_reset(err, len(victims))
        if victims:
            bps_log.debug("wire shard %d: reset failed %d in-flight (%s)",
                          self._shard, len(victims), err)

    # --------------------------------------------------------------- admin

    def drop_connection(self, err: Optional[BaseException] = None) -> None:
        """External poison request (heartbeat declared the shard down):
        kill the current connection, failing its window."""
        with self._lock:
            gen = self._gen
            has_sock = self._sock is not None
        if has_sock:
            self._kill(gen, err or ConnectionError("shard marked down"))

    def close(self) -> None:
        self._closed.set()
        self._queue.close()
        self.drop_connection(ConnectionError("wire worker closed"))
        with self._cv:
            self._cv.notify_all()
        sender = self._sender
        if sender is not None:
            sender.join(timeout=2.0)
        for task in self._queue.drain():
            task.payload.fail(ConnectionError("wire worker closed"))
