"""Deterministic fault injection between a client and a server of the
frame wire — the port's copy of ``FaultInjectingProxy`` from
``byteps_tpu/resilience/chaos.py`` (the JAX module's chaos harness
helpers are not ported).

``FaultInjectingProxy`` is a TCP shim that speaks the wire framing
(``engine/wire.py``): it reads one complete request frame from the
client, consults its fault plan, forwards the frame to the real server,
reads the complete reply frame and relays it back.  Operating on frame
boundaries (not raw bytes) makes faults *per-request* and exactly
reproducible:

  * ``"drop_before"`` — connection reset before the server sees the op
    (retry must resend: the mutation was NOT applied);
  * ``"drop_after"``  — op forwarded and applied, reply discarded,
    connection reset (the ambiguous case: a naive retry double-applies —
    this is the fault the version-guard exists for);
  * ``("delay", s)``  — hold the request ``s`` seconds before forwarding
    (exercises timeouts/stragglers);
  * ``"garble_reply"`` — corrupt the reply header so the client's
    decoder errors (exercises the poisoned-socket drop + reconnect);
  * ``("cut_stream", k)`` — serve-protocol streams only: relay ``k``
    reply frames, then reset — a replica dying mid-stream at a
    deterministic token (the router failover trigger, serving/router.py);
  * ``"pass"`` / None — forward untouched.

Serve-protocol awareness (``serve_stream_op=``): the serve frontend's
STREAM op answers one request frame with a *sequence* of reply frames
(one per token plus a terminal ``end`` frame — serving/frontend.py).
When the proxied protocol has such an op, pass its opcode and the proxy
relays the whole reply sequence per request, applying faults at frame
granularity (``drop_after`` discards the first reply frame and resets —
a replica that accepted the request and died before any token crossed
the wire; ``cut_stream`` cuts after exactly ``k`` tokens).  The default
(None) keeps the one-request-one-reply PS relay bit-identical.

Faults come from a scripted FIFO (``script(...)`` — consumed one per
request, exact) and/or seeded random rates (``set_rates`` — reproducible
via the constructor seed).  ``blackhole(True)`` makes the proxy accept
connections but answer nothing (a hung, not crashed, shard — distinct
from closing the listener, which looks like a dead host).

Only test/chaos code imports this module; the data path never does.
"""

from __future__ import annotations

import collections
import random
import socket
import struct
import threading
import time
from typing import List, Optional, Tuple, Union

from ..common import logging as bps_log
from ..engine.transport import maybe_nodelay
# one wire framing, one reader: a protocol change must break the proxy
# loudly at parse time, not silently diverge
from ..engine.wire import _recv_exact, hard_reset

Fault = Union[str, Tuple[str, float], None]


def _read_frame(sock: socket.socket) -> bytes:
    """Read one complete wire frame (request or reply — same layout)."""
    head = _recv_exact(sock, 5)
    op, nlen = struct.unpack("<BI", head)
    ext = b""
    if op & 0x80:
        # versioned header extension (trace ids, engine/wire.py): the
        # proxy relays any version opaquely — u8 ver | u8 len | body —
        # so a fault-injected run can still be traced end to end
        ext_head = _recv_exact(sock, 2)
        (_, elen) = struct.unpack("<BB", ext_head)
        ext = bytes(ext_head) + bytes(_recv_exact(sock, elen))
    name = _recv_exact(sock, nlen)
    dlen_b = _recv_exact(sock, 4)
    (dlen,) = struct.unpack("<I", dlen_b)
    dt = _recv_exact(sock, dlen)
    ndim_b = _recv_exact(sock, 1)
    (ndim,) = struct.unpack("<B", ndim_b)
    shape = _recv_exact(sock, 8 * ndim)
    plen_b = _recv_exact(sock, 8)
    (plen,) = struct.unpack("<Q", plen_b)
    payload = _recv_exact(sock, plen)
    return (head + ext + name + dlen_b + dt + ndim_b + shape + plen_b
            + payload)


def _frame_meta(frame: bytes) -> Tuple[int, str]:
    """(op-or-status, name) of an already-read frame — what the serve-
    stream relay needs to spot the terminal ``end`` frame (and error
    replies) without re-parsing payloads."""
    op, nlen = struct.unpack("<BI", frame[:5])
    off = 5
    if op & 0x80:
        (_, elen) = struct.unpack("<BB", frame[5:7])
        off = 7 + elen
        op &= 0x7F
    return op, frame[off:off + nlen].decode(errors="replace")


class FaultInjectingProxy:
    """One proxy instance fronts one server; point the client at
    ``proxy.addr`` instead of the real server address.

    TCP only, both sides: the port serves no Unix-socket or shared-memory
    endpoint, so the JAX proxy's ``listen_local`` and
    ``upstream_transport`` are not taken."""

    def __init__(self, target: str, seed: int = 0, host: str = "127.0.0.1",
                 serve_stream_op: Optional[int] = None):
        self._target = target
        # opcode whose replies are a frame SEQUENCE (the serve
        # frontend's STREAM op) — see the module docstring
        self._serve_stream_op = serve_stream_op
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._script: "collections.deque[Fault]" = collections.deque()
        self._drop_before_rate = 0.0
        self._drop_after_rate = 0.0
        self._delay = 0.0
        self._garble_rate = 0.0
        self._blackhole = False
        self._closed = threading.Event()
        self._conns: List[socket.socket] = []
        self.requests_seen = 0
        self.faults_injected = 0


        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, 0))
        self._listener.listen(16)
        self._host = host
        self._port = self._listener.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, args=(self._listener,),
            name="bps-chaos-accept", daemon=True)
        self._accept_thread.start()

    # ------------------------------------------------------------------ knobs

    @property
    def addr(self) -> str:
        return f"{self._host}:{self._port}"

    def script(self, *faults: Fault) -> None:
        """Queue faults consumed one per subsequent request (FIFO).
        ``None``/"pass" entries let a request through untouched."""
        with self._lock:
            self._script.extend(faults)

    def set_rates(self, drop_before: float = 0.0, drop_after: float = 0.0,
                  garble: float = 0.0, delay: float = 0.0) -> None:
        """Random faults (seeded — reproducible for a fixed seed and
        request order).  ``delay`` is seconds applied to every request."""
        with self._lock:
            self._drop_before_rate = drop_before
            self._drop_after_rate = drop_after
            self._garble_rate = garble
            self._delay = delay

    def blackhole(self, on: bool = True) -> None:
        """Accept but never answer (hung shard).  Existing connections
        are reset so in-flight clients fail fast rather than block."""
        with self._lock:
            self._blackhole = on
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closed.set()
        # shutdown() first: a thread blocked in accept(2) holds the
        # listener's file description past close() and could hand out
        # one more connection
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        self.blackhole(False)  # also resets lingering connections

    # ------------------------------------------------------------------ loops

    def _accept_loop(self, listener) -> None:
        while not self._closed.is_set():
            try:
                client, _ = listener.accept()
            except OSError:
                return
            if self._closed.is_set():
                try:
                    client.close()
                except OSError:
                    pass
                return
            with self._lock:
                self._conns.append(client)
            threading.Thread(target=self._serve_conn, args=(client,),
                             daemon=True).start()

    def _next_fault(self) -> Fault:
        with self._lock:
            self.requests_seen += 1
            if self._script:
                return self._script.popleft()
            if self._blackhole:
                return "blackhole"
            if self._drop_before_rate and self._rng.random() < self._drop_before_rate:
                return "drop_before"
            if self._drop_after_rate and self._rng.random() < self._drop_after_rate:
                return "drop_after"
            if self._garble_rate and self._rng.random() < self._garble_rate:
                return "garble_reply"
            if self._delay:
                return ("delay", self._delay)
            return None

    def _serve_conn(self, client: socket.socket) -> None:
        upstream: Optional[socket.socket] = None
        swallowing = False  # sticky: a hung stream answers NOTHING more
        try:
            maybe_nodelay(client)
            while not self._closed.is_set():
                try:
                    frame = _read_frame(client)
                except (ConnectionError, OSError):
                    return
                fault = self._next_fault()
                if swallowing or fault == "blackhole":
                    # swallow the request; never reply — the client's
                    # socket timeout (or heartbeat) must notice.  Sticky
                    # per connection: once one frame is swallowed, later
                    # frames of the same connection must not be relayed,
                    # or a pipelined client's FIFO reply matching would
                    # resolve an EARLIER request with a LATER reply
                    # (silent wrong data instead of the intended hang).
                    swallowing = True
                    self.faults_injected += 1
                    continue
                if fault in (None, "pass"):
                    pass
                elif fault == "drop_before":
                    self.faults_injected += 1
                    bps_log.debug("chaos: drop_before request #%d",
                                  self.requests_seen)
                    self._reset(client)
                    return
                elif isinstance(fault, tuple) and fault[0] == "delay":
                    self.faults_injected += 1
                    time.sleep(float(fault[1]))
                if upstream is None:
                    host, _, port = self._target.rpartition(":")
                    upstream = socket.create_connection(
                        (host, int(port)), timeout=30.0)
                    maybe_nodelay(upstream)
                upstream.sendall(frame)
                streaming = (self._serve_stream_op is not None
                             and (frame[0] & 0x7F)
                             == self._serve_stream_op)
                if streaming:
                    # multi-frame reply (serve STREAM): relay frames
                    # until the terminal/error frame, applying faults
                    # at frame granularity.  cut_stream resets after
                    # exactly k relayed frames — a deterministic
                    # mid-stream replica death; drop_after (request
                    # applied, nothing relayed) is cut_stream at 0.
                    cut_after = None
                    if isinstance(fault, tuple) and fault[0] == "cut_stream":
                        self.faults_injected += 1
                        cut_after = int(fault[1])
                    elif fault == "drop_after":
                        self.faults_injected += 1
                        cut_after = 0
                    relayed = 0
                    while True:
                        reply = _read_frame(upstream)
                        if cut_after is not None and relayed >= cut_after:
                            bps_log.debug(
                                "chaos: cut stream after %d frame(s), "
                                "request #%d", relayed,
                                self.requests_seen)
                            self._reset(client)
                            return
                        if fault == "garble_reply" and relayed == 0:
                            self.faults_injected += 1
                            reply = (reply[:1] + b"\xff\xff\xff\xff"
                                     + reply[5:])
                            try:
                                client.sendall(reply)
                            except OSError:
                                pass
                            self._reset(client)
                            return
                        client.sendall(reply)
                        relayed += 1
                        status, rname = _frame_meta(reply)
                        if status != 0 or rname.startswith("end"):
                            break
                    continue
                reply = _read_frame(upstream)
                if fault == "drop_after":
                    self.faults_injected += 1
                    bps_log.debug("chaos: drop_after request #%d (applied, "
                                  "reply discarded)", self.requests_seen)
                    self._reset(client)
                    return
                if fault == "garble_reply":
                    self.faults_injected += 1
                    # corrupt the name-length field: the client decoder
                    # hits its sanity bound and poisons the socket
                    reply = reply[:1] + b"\xff\xff\xff\xff" + reply[5:]
                    try:
                        client.sendall(reply)
                    except OSError:
                        pass
                    self._reset(client)
                    return
                client.sendall(reply)
        except (ConnectionError, OSError) as e:
            bps_log.debug("chaos proxy conn exit: %s", e)
        finally:
            for s in (client, upstream):
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass

    @staticmethod
    def _reset(sock: socket.socket) -> None:
        """Hard RST (not FIN) so the client sees ECONNRESET mid-RPC."""
        hard_reset(sock)
