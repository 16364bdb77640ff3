"""TCP parameter-server tier — the port of ``byteps_tpu/engine/ps_server.py``
(the ps-lite / MXNet-KVStore-server analog).

The asynchronous mode is a client/server interaction, not a collective:
workers push weight deltas and pull the global state at their own
cadence.  This module provides that tier, host code only (it creates no
CUDA context):

  * ``serve()`` — a threaded TCP server owning one ``AsyncParameterServer``
    shard; the summation runs through the port's native OpenMP reducer.
    Started by the launcher under ``DMLC_ROLE=server
    BYTEPS_ENABLE_ASYNC=1``.
  * ``RemoteStore`` — the worker-side client, with the in-process stores'
    interface (init_tensor/push_delta/pull/push_pull/version/names),
    placing each tensor on a server with the reference's key->server
    formula (global.cc:305-334).

Wire protocol (binary, length-prefixed; engine/wire.py, byte for byte
the JAX package's, so either package's client drives either package's
shard)::

    request :=  u8 op | u32 len(name) | name
               | u32 len(dtype) | dtype-str | u8 ndim | u64*ndim shape
               | u64 len(payload) | payload-bytes
    reply   :=  u8 status | <tensor encoded as above>

Ops: 0=INIT (first-push-wins), 1=PUSH_PULL (atomic add+read), 2=PULL,
3=VERSION (payload = u64), 4=NAMES (payload = '\\n'.join), 5=PING
(payload = the server's wall clock, f64), 6=PUSH (delta add,
status-only reply), 7=SET (force-overwrite: the failover/failback
re-seed), 8=STATS (JSON).  Store errors come back as status=1 replies
with the message in the payload; the connection survives.  Replies to
the versioned mutations (INIT, SET, PUSH, PUSH_PULL) carry the post-op
version counter as a decimal string in the reply's name field, which
``RemoteStore`` uses to dedup a retried mutation whose reply was lost.

Compressed payloads ride the same frame under the dtype tag ``bpsc1``
(compression/wire.py); the server decompresses at decode time and sums
the dense result into the store; replies are cast-compressed per
``BYTEPS_COMPRESSION_REPLY``.  ``RemoteStore`` partitions tensors larger
than ``BYTEPS_PARTITION_BYTES`` into independently keyed ``name#p{i}``
parts (reference PartitionTensor, operations.cc:95-132).

Pipelined client (engine/wire.py): with ``BYTEPS_WIRE_WINDOW`` > 0
(default 8) every shard gets a send/receive I/O worker with a bounded
in-flight window and FIFO reply matching, and multi-partition ops fan
their parts out across shards in priority order; ``BYTEPS_WIRE_WINDOW=0``
is the serial one-frame-in-flight client.

Not ported yet (queue A item 10; each refused by name): the hierarchical
slice methods (``hierarchical=True``, ``BYTEPS_HIERARCHICAL``), the Unix
socket and shared-memory transports, the ``/metrics`` scrape
(``BYTEPS_METRICS_PORT``) and RPC trace ids (``BYTEPS_TRACE_RPC``).
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import struct
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..common import logging as bps_log
from ..common.context import name_key
from ..compression.wire import WIRE_TAG, WireBlob, decode_blob
from .async_ps import AsyncParameterServer, _copy, _host, _like
from .transport import (connection_kind, maybe_nodelay, parse_overrides,
                        peer_label, resolve_transport, transport_connect)
from .wire import (ShardWorker, _decode, _decode_frame, _encode,
                   _encode_buffers, _send_buffers, hard_reset)

(OP_INIT, OP_PUSH_PULL, OP_PULL, OP_VERSION, OP_NAMES, OP_PING, OP_PUSH,
 OP_SET, OP_STATS) = range(9)

__all__ = ["serve", "PSServer", "RemoteStore", "ServerProfiler",
           "OP_INIT", "OP_PUSH_PULL", "OP_PULL", "OP_VERSION", "OP_NAMES",
           "OP_PING", "OP_PUSH", "OP_SET", "OP_STATS"]


def _refuse_unported(cfg, what: str) -> None:
    """The PS tier's knobs for features still missing, refused by name."""
    from ..common.config import check_transport

    check_transport(cfg.transport)
    if cfg.metrics_port:
        raise NotImplementedError(
            f"BYTEPS_METRICS_PORT={cfg.metrics_port}: the {what} has no "
            f"/metrics scrape in this port yet (queue A item 10: the "
            f"observability export and scrape); unset it")
    if cfg.trace_rpc:
        raise NotImplementedError(
            f"BYTEPS_TRACE_RPC: the {what} mints no RPC trace ids in this "
            f"port yet (queue A item 10: the observability trace); unset "
            f"it")


# -------------------------------------------------------------------- server


_PROFILED_OPS = {OP_PUSH: "push", OP_PULL: "pull", OP_PUSH_PULL: "push_pull"}


class ServerProfiler:
    """Per-key request timeline on the PS tier — the reference's
    straggler-hunting tool (``BYTEPS_SERVER_ENABLE_PROFILE``, reference
    docs/timeline.md:1-30): each push/pull request emits chrome-trace
    ``B``/``E`` events spanning arrival to completion, with the tensor's
    declared key as pid/tid and the requesting peer in the event name.

    Knobs: ``BYTEPS_SERVER_ENABLE_PROFILE=1``,
    ``BYTEPS_SERVER_PROFILE_OUTPUT_PATH=/path.json``,
    ``BYTEPS_SERVER_KEY_TO_PROFILE=<key>`` (restrict to one key)."""

    _AUTOFLUSH = 4096  # events buffered before an automatic flush

    def __init__(self, path: str, key_filter: Optional[int] = None):
        self._path = path
        self._key_filter = key_filter
        self._events: List[dict] = []
        self._lock = threading.Lock()        # guards the event buffer
        self._io_lock = threading.Lock()     # serializes file appends
        self._written = False  # file has an opening '[' + >=1 event
        self._closed = False
        # chrome-trace ts must be monotonic: stamps are perf_counter's,
        # mapped onto the wall clock once through this fixed epoch
        self._epoch = time.time() - time.perf_counter()

    def record(self, op: int, name: str, peer: str, t_begin: float,
               t_end: float, trace_id: str = "") -> None:
        opname = _PROFILED_OPS.get(op)
        if opname is None:
            return
        key = name_key(name)
        if self._key_filter is not None and key != self._key_filter:
            return
        ev = f"{opname}-{peer}"
        args = {"tensor": name}
        if trace_id:
            args["trace_id"] = trace_id
        b = {"name": ev, "ph": "B", "pid": key, "tid": key,
             "ts": int((self._epoch + t_begin) * 1e6), "args": args}
        e = {"name": ev, "ph": "E", "pid": key, "tid": key,
             "ts": int((self._epoch + t_end) * 1e6)}
        drained = None
        with self._lock:
            if self._closed:
                dropped = True
            else:
                dropped = False
                self._events.append(b)
                self._events.append(e)
                if len(self._events) >= self._AUTOFLUSH:
                    # swap under the lock, write outside it
                    drained, self._events = self._events, []
        if dropped:
            bps_log.debug("ps_server profiler: dropping 2 events recorded "
                          "after close()")
            return
        if drained:
            self._write(drained)

    def _append_locked(self, events: List[dict]) -> None:
        """Append events to the JSON array on disk; the caller holds
        ``_io_lock``."""
        mode = "a" if self._written else "w"
        with open(self._path, mode) as f:
            for ev in events:
                f.write(("[\n" if not self._written else ",\n")
                        + json.dumps(ev))
                self._written = True

    def _write(self, events: List[dict]) -> None:
        """Append drained events; the file stays a loadable chrome-trace
        array mid-run, and ``close()`` terminates it."""
        with self._io_lock:
            if self._closed:
                bps_log.debug("ps_server profiler: dropping %d events "
                              "raced against close()", len(events))
                return
            self._append_locked(events)

    def flush(self) -> None:
        with self._lock:
            events, self._events = self._events, []
        if events:
            self._write(events)

    def close(self) -> None:
        """Drain and terminate the JSON array (valid strict JSON)."""
        self.flush()
        with self._io_lock:
            with self._lock:
                self._closed = True
                stragglers, self._events = self._events, []
            if stragglers:
                self._append_locked(stragglers)
            if self._written:
                with open(self._path, "a") as f:
                    f.write("\n]\n")
                self._written = False


class _Handler(socketserver.BaseRequestHandler):
    """One connection, many requests — strictly FIFO: each request is
    fully served and its reply sent before the next is read.  The
    pipelined client relies on this order to match replies to requests
    without protocol tags."""

    def handle(self):
        store: AsyncParameterServer = self.server.store  # type: ignore[attr-defined]
        profiler: Optional[ServerProfiler] = self.server.profiler  # type: ignore[attr-defined]
        reply_c = self.server.reply_compress  # type: ignore[attr-defined]
        peer = peer_label(self.client_address)
        sock = self.request
        maybe_nodelay(sock)
        self.server.track_connection(sock)  # type: ignore[attr-defined]
        from ..observability.metrics import get_registry

        reg = get_registry()
        m_reqs = reg.counter("ps.requests", track="ps_server",
                             instants=False, mirror=False)
        m_errs = reg.counter("ps.request_errors", track="ps_server",
                             instants=False, mirror=False)
        m_treqs = reg.counter("ps.requests_by_transport",
                              track="ps_server", instants=False,
                              mirror=False, transport=connection_kind(sock))
        m_handle = reg.histogram("ps.handle_s")
        try:
            while True:
                try:
                    op, name, arr, _, tid = _decode_frame(sock)
                except ConnectionError:
                    return
                t_begin = time.perf_counter()
                failed = False
                try:
                    if op == OP_INIT:
                        # a first-push-wins loser gets the winning value;
                        # the creator a bare ack
                        v, created = store.init_tensor_info(name, arr)
                        reply = _encode_buffers(
                            0, str(v),
                            None if created else reply_c(store.pull(name)))
                    elif op == OP_PUSH_PULL:
                        # the version is read under the add's lock
                        out, v = store.push_pull_versioned(name, arr)
                        reply = _encode_buffers(0, str(v), reply_c(out))
                    elif op == OP_PUSH:
                        v = store.push_delta(name, arr)
                        reply = _encode_buffers(0, str(v), None)
                    elif op == OP_SET:
                        v = store.set_tensor(name, arr)
                        reply = _encode_buffers(0, str(v), None)
                    elif op == OP_PULL:
                        reply = _encode_buffers(0, "",
                                                reply_c(store.pull(name)))
                    elif op == OP_VERSION:
                        reply = _encode_buffers(
                            0, "", None, struct.pack("<Q",
                                                     store.version(name)))
                    elif op == OP_NAMES:
                        reply = _encode_buffers(
                            0, "", None, "\n".join(store.names()).encode())
                    elif op == OP_PING:
                        # this host's wall clock, for clock-offset
                        # estimates (record_clock_offsets)
                        reply = _encode_buffers(
                            0, "", None, struct.pack("<d", time.time()))
                    elif op == OP_STATS:
                        payload = json.dumps(
                            self.server.stats_payload())  # type: ignore[attr-defined]
                        reply = _encode_buffers(0, "", None,
                                                payload.encode())
                    else:
                        reply = _encode_buffers(1, "", None,
                                                f"bad op {op}".encode())
                except Exception as e:
                    failed = True
                    reply = _encode_buffers(
                        1, "", None, f"{type(e).__name__}: {e}".encode())
                t_end = time.perf_counter()
                m_reqs.inc()
                m_treqs.inc()
                if failed:
                    m_errs.inc()
                if op in _PROFILED_OPS:
                    m_handle.observe(t_end - t_begin)
                if profiler is not None:
                    profiler.record(op, name, peer, t_begin, t_end,
                                    trace_id=tid.hex() if tid else "")
                _send_buffers(sock, reply)
        except Exception as e:  # pragma: no cover - teardown races
            bps_log.debug("ps_server handler exit: %s", e)
        finally:
            self.server.untrack_connection(sock)  # type: ignore[attr-defined]


class PSServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, use_native: bool = True):
        from ..common.config import get_config

        cfg = get_config()
        _refuse_unported(cfg, "PS server")
        super().__init__(addr, _Handler)
        # anything failing after the bind releases the listening socket,
        # or a supervised restart hits EADDRINUSE on the same port
        try:
            self.profiler: Optional[ServerProfiler] = None
            self._t0 = time.monotonic()
            self.store = AsyncParameterServer(use_native=use_native)
            # live client connections, so kill() can sever them the way a
            # dying process would
            self._conns: set = set()
            self._conns_lock = threading.Lock()
            self.reply_compress = lambda a: a
            if cfg.compression_reply:
                from ..compression.wire import maybe_compress_reply

                self.reply_compress = (
                    lambda a, _s=cfg.compression_reply,
                    _m=cfg.compression_min_bytes:
                    maybe_compress_reply(a, _s, _m))
                bps_log.info("ps_server: reply compression -> %s",
                             cfg.compression_reply)
            if cfg.server_enable_profile:
                self.profiler = ServerProfiler(
                    cfg.server_profile_output_path, cfg.server_key_to_profile)
                bps_log.info("ps_server: per-key profiling on -> %s",
                             cfg.server_profile_output_path)
        except Exception:
            super().server_close()
            raise

    def reducer_info(self) -> dict:
        """Which reducer sums (``native`` with its OpenMP threads, or
        ``numpy``), and the bytes and seconds its sums took."""
        out = {"reducer": self.store.reducer,
               "sum_bytes": self.store.sum_bytes,
               "sum_seconds": self.store.sum_seconds}
        if self.store.reducer == "native":
            from ..native import reducer as native_reducer

            out["omp_threads"] = native_reducer.omp_max_threads()
            out["built_with"] = native_reducer.built_with
        return out

    def stats_payload(self) -> dict:
        """The ``OP_STATS`` reply body: shard identity, its reducer, the
        process's resident bytes now (``/proc/self/statm``; its
        ``ru_maxrss`` would carry a large parent's peak across the fork
        and exec that started it) and whether it holds a CUDA context (a
        shard never should), and the process metrics-registry snapshot."""
        from ..observability.metrics import get_registry

        try:
            with open("/proc/self/statm") as f:
                rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError, IndexError):
            rss = None
        return {
            "role": "ps_server",
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "tensors": len(self.store.names()),
            "local_endpoints": [],
            **self.reducer_info(),
            "rss_bytes": rss,
            "cuda_initialized": torch.cuda.is_initialized(),
            "metrics": get_registry().snapshot(),
        }

    def track_connection(self, sock) -> None:
        with self._conns_lock:
            self._conns.add(sock)

    def untrack_connection(self, sock) -> None:
        with self._conns_lock:
            self._conns.discard(sock)

    def kill(self) -> None:
        """Die like a crashed process: stop accepting AND sever every live
        client connection (clients see a reset, not a quiet stall)."""
        self.shutdown()
        with self._conns_lock:
            conns, self._conns = set(self._conns), set()
        for c in conns:
            hard_reset(c)
        self.server_close()

    def server_close(self):
        if getattr(self, "profiler", None) is not None:
            self.profiler.close()
        super().server_close()


def serve(port: int, host: str = "0.0.0.0", use_native: bool = True,
          in_thread: bool = False):
    """Run one PS shard.  ``in_thread=True`` returns (server, thread) for
    tests; otherwise blocks forever (the launcher's server role)."""
    srv = PSServer((host, port), use_native=use_native)
    info = srv.reducer_info()
    bps_log.info("byteps_tpu_torch PS server shard listening on %s:%d "
                 "(reducer %s%s)", host, srv.server_address[1],
                 info["reducer"],
                 f", {info['omp_threads']} OpenMP threads"
                 if "omp_threads" in info else "")
    if in_thread:
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        return srv, t
    try:
        srv.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover
        pass
    finally:
        srv.server_close()


# ------------------------------------------------------------ clock offsets


class ClockOffset:
    """One shard's estimated clock offset: ``t_server - t_client`` in
    seconds, and the RTT of the winning (minimum-RTT) sample — the true
    offset lies within +-rtt/2."""

    __slots__ = ("addr", "offset_s", "rtt_s", "samples")

    def __init__(self, addr: str, offset_s: float, rtt_s: float,
                 samples: int):
        self.addr, self.offset_s = addr, offset_s
        self.rtt_s, self.samples = rtt_s, samples

    def as_dict(self) -> dict:
        return {"addr": self.addr, "offset_us": self.offset_s * 1e6,
                "rtt_us": self.rtt_s * 1e6, "samples": self.samples}


def estimate_clock_offset(addr: str, n: int = 5,
                          timeout: float = 2.0) -> ClockOffset:
    """NTP-style offset of one shard's wall clock against ours: ``n``
    ``OP_PING`` round trips on fresh connections, the minimum-RTT
    sample's midpoint."""
    host, port = addr.rsplit(":", 1)
    best: Optional[ClockOffset] = None
    got = 0
    for _ in range(max(1, n)):
        try:
            with socket.create_connection((host, int(port)),
                                          timeout=timeout) as s:
                s.settimeout(timeout)
                t0 = time.time()
                s.sendall(_encode(OP_PING, "", None))
                status, _, _, payload = _decode(s)
                t1 = time.time()
        except (OSError, ValueError, struct.error):
            continue
        if status != 0 or len(payload) < 8:
            continue
        (t_server,) = struct.unpack_from("<d", payload)
        got += 1
        rtt = t1 - t0
        if best is None or rtt < best.rtt_s:
            best = ClockOffset(addr, t_server - (t0 + t1) / 2.0, rtt, 0)
    if best is None:
        raise ConnectionError(f"no clock sample from {addr}")
    best.samples = got
    return best


# -------------------------------------------------------------------- client


# wire-level failures (vs store-level status=1 replies, which are final):
# ConnectionError is an OSError; ValueError/struct.error = corrupt framing
_WIRE_ERRORS = (OSError, ValueError, struct.error)


class RemoteStore:
    """Worker-side client over >=1 PS server shards.

    Tensor -> server placement uses the declared-key formula of reference
    global.cc:305-334 (``ServerSharder`` over ``name_key``).

    Failure semantics (docs/resilience.md of the JAX package):

      * wire-level failures retry under ``RetryPolicy`` (exponential
        backoff + jitter, per-op deadline); a retried PUSH/PUSH_PULL is
        version-guarded via ``OP_VERSION`` so a mutation whose reply was
        lost is not applied twice (exactly-once per key for a single
        writer; the guard is off by default beyond one worker);
      * with >1 shards and ``BYTEPS_FAILOVER`` on (default), a shard that
        exhausts its retries is marked down and its keys re-route to the
        deterministic next alive shard, re-seeded there with SET from
        this client's last-seen global state (degraded mode);
      * a heartbeat ``FailureDetector`` (``BYTEPS_HEARTBEAT_INTERVAL_MS``,
        or started on the first failover) watches the dead shard; when it
        answers ``OP_PING`` again, failed-over keys migrate back;
      * a shard restarted with a fresh store answers KeyError for what it
        lost: the client re-seeds it once from the last-seen state.

    Wire compression: PUSH / PUSH_PULL deltas are compressed per the
    policy (``BYTEPS_COMPRESSION`` or ``compression=``); biased schemes
    run under client-side error feedback whose residual is committed
    only after the version-guarded ack.  Tensors above
    ``BYTEPS_PARTITION_BYTES`` are split into ``name#p{i}`` partitions,
    each compressed, retried and placed on its own; a tensor partitioned
    by another client is discovered through ``names()``.

    Values are numpy arrays, and bf16 tensors CPU ``torch.Tensor``.
    ``hierarchical=True`` (and ``BYTEPS_HIERARCHICAL``) is refused: the
    slice methods come with ``hierarchical.py`` (queue A item 10).
    """

    def __init__(self, addrs: List[str], use_hash: bool = False,
                 timeout: float = 30.0, retry_policy=None, counters=None,
                 heartbeat: Optional[float] = None, compression=None,
                 wire_window: Optional[int] = None, transport=None,
                 hierarchical: Optional[bool] = None):
        from ..common.config import get_config
        from ..common.context import ServerSharder
        from ..compression import (CompressionPolicy, WireCompressor,
                                   get_compression_stats)
        from ..resilience import (DegradedModeRouter, RetryPolicy,
                                  get_counters)
        from ..resilience import counters as cn

        if not addrs:
            raise ValueError("RemoteStore needs at least one server address")
        cfg = get_config()
        _refuse_unported(cfg, "PS client")
        if (cfg.hierarchical if hierarchical is None else hierarchical):
            raise NotImplementedError(
                "hierarchical push/pull (hierarchical=True or "
                "BYTEPS_HIERARCHICAL=1): RemoteStore's slice methods come "
                "with the port of hierarchical.py (queue A item 10)")
        self._addrs = list(addrs)
        # per-endpoint transport: ``transport=`` (a spec, or {addr:
        # spec}) beats BYTEPS_TRANSPORT_OVERRIDES beats BYTEPS_TRANSPORT;
        # every one resolves to TCP or is refused
        per_addr = dict(transport) if isinstance(transport, dict) else {}
        base_spec = (transport if isinstance(transport, str) and transport
                     else cfg.transport)
        env_over = parse_overrides(cfg.transport_overrides)
        self._tspec = [
            resolve_transport(a, per_addr.get(a, env_over.get(a, base_spec)))
            for a in addrs]
        self._transports = [k for k, _ in self._tspec]
        self._sharder = ServerSharder(len(addrs), use_hash=use_hash)
        self._socks: List[Optional[socket.socket]] = [None] * len(addrs)
        self._locks = [threading.Lock() for _ in addrs]
        self._timeout = timeout
        self._cn = cn
        self._policy = (retry_policy if retry_policy is not None
                        else RetryPolicy.from_config(cfg))
        self._counters = counters if counters is not None else get_counters()
        self._failover_enabled = cfg.failover and len(addrs) > 1
        # version-guarded retry dedup assumes a single writer per key;
        # with several workers pushing the same keys the counter is
        # ambiguous and suppressing a resend would silently drop a delta
        self._version_guard = (cfg.retry_version_guard
                               if cfg.retry_version_guard is not None
                               else cfg.num_worker <= 1)
        self._router = DegradedModeRouter(len(addrs),
                                          counters=self._counters)
        # serializes degraded-mode ops against recovery migration (held
        # across fallback I/O); healthy-shard ops never take it
        self._failover_lock = threading.RLock()
        # guards _last_global/_pushed_version — dict ops only, never I/O
        self._state_lock = threading.RLock()
        self._last_global: dict = {}      # name -> last seen global value
        # (name, shard) -> that shard's version after our last acked
        # mutation there (per shard: a failover episode gives one name
        # independent counters on the primary and the fallback)
        self._pushed_version: dict = {}
        if isinstance(compression, CompressionPolicy):
            policy = compression
        elif compression is not None:
            policy = CompressionPolicy(
                default=compression, min_bytes=cfg.compression_min_bytes,
                overrides=cfg.compression_overrides,
                ratio=cfg.compression_ratio, seed=cfg.compression_seed)
        else:
            policy = CompressionPolicy.from_config(cfg)
        self._wire_stats = get_compression_stats()
        self._compressor = WireCompressor(policy, stats=self._wire_stats)
        self._partition_bytes = cfg.effective_partition_bytes
        self._part_meta: dict = {}  # base name -> (nparts, shape, dtype)
        # the failover/restart seed cache; off without BYTEPS_FAILOVER
        self._seed_enabled = cfg.failover
        # name -> issue priority (earlier-declared = higher)
        self._prio: dict = {}
        self._window = (cfg.wire_window if wire_window is None
                        else int(wire_window))
        self._fanout = max(1, cfg.wire_fanout)
        self._workers: Optional[List[ShardWorker]] = None
        if self._window > 0:
            self._workers = [
                ShardWorker(
                    (lambda i=i: self._connect(i)), self._window, shard=i,
                    recv_timeout=self._timeout,
                    on_reset=(lambda err, n, i=i: self._on_wire_reset(i, n)),
                    transport=self._transports[i])
                for i in range(len(addrs))]
        self._hb_interval = cfg.heartbeat_interval_ms / 1e3
        self._hb_timeout = cfg.heartbeat_timeout_ms / 1e3
        self._hb_threshold = cfg.heartbeat_miss_threshold
        self._detector = None
        hb = self._hb_interval if heartbeat is None else heartbeat
        if hb and hb > 0:
            self._start_detector(hb)

    # ------------------------------------------------ sockets & heartbeat

    def _connect(self, i: int) -> socket.socket:
        kind, path = self._tspec[i]
        return transport_connect(kind, path, self._addrs[i],
                                 timeout=self._timeout)

    def _sock(self, i: int) -> socket.socket:
        if self._socks[i] is None:
            self._socks[i] = self._connect(i)
        return self._socks[i]

    def _on_wire_reset(self, shard: int, n_inflight: int) -> None:
        """A ShardWorker connection kill: count the reconnect, and a
        window abort when a whole in-flight window died at once."""
        self._counters.bump(self._cn.RECONNECT, shard=shard)
        if n_inflight > 1:
            self._counters.bump(self._cn.WINDOW_ABORT, shard=shard,
                                n=1, inflight=n_inflight)

    # -------------------------------------------------- part-level fan-out

    def _submit_part(self, shard: int, op: int, name: str, arr=None,
                     raw: bytes = b"", priority: int = 0, key: int = 0):
        """Optimistic pipelined first attempt of one part: issue the frame
        on the shard worker now and hand the future to ``_rpc`` as attempt
        #1.  None when the op must start inside ``_rpc``: serial mode, or
        the shard is routed away (degraded mode holds the failover lock
        around I/O)."""
        if self._workers is None:
            return None
        if self._failover_enabled and self._router.route(shard) != shard:
            return None
        try:
            return self._workers[shard].submit(
                _encode_buffers(op, name, arr, raw), priority=priority,
                key=key)
        except ConnectionError:
            return None

    def _pipeline_parts(self, op: int, parts, encode, prio: int):
        """Windowed fan-out over the partitions of one logical op: up to
        ``BYTEPS_WIRE_FANOUT`` parts are encoded and submitted ahead of
        the one being gathered.  ``encode(pname, part) -> (payload,
        commit)``; each part's ``commit`` (EF residual) fires only after
        its own ack.  Returns the per-part ``out`` values.  On a part
        failure the submitted siblings are still awaited (their residuals
        committed on success) before the error is re-raised."""
        n = len(parts)
        ahead = max(1, self._fanout)
        state: dict = {}

        def _issue(j):
            pname, part = parts[j]
            payload, commit = encode(pname, part)
            shard = self._shard_of(pname, 0 if part is None
                                   else part.nbytes)
            pend = self._submit_part(shard, op, pname, payload,
                                     priority=prio, key=j)
            state[j] = (shard, pname, payload, commit, pend)

        outs = [None] * n
        j = 0
        try:
            for i in range(n):
                while j < n and j < i + ahead:
                    _issue(j)
                    j += 1
                shard, pname, payload, commit, pend = state.pop(i)
                out, _ = self._rpc(shard, op, pname, payload,
                                   priority=prio, key=i, pending=pend)
                if commit is not None:
                    commit()
                outs[i] = out
        except BaseException:
            for k in sorted(state):
                shard, pname, payload, commit, pend = state[k]
                if pend is None:
                    continue
                try:
                    status, rname, out, _ = self._workers[shard].wait(
                        pend, self._timeout)
                    if status == 0:
                        # a drained sibling's ack is still an ack: record
                        # its version and fold it into the failover seed
                        self._note_success(op, pname, rname, out, payload,
                                           shard=shard)
                        if commit is not None:
                            commit()
                except Exception:
                    pass  # best-effort drain; the first error wins
            raise
        return outs

    def _priority_of(self, name: str) -> int:
        """First-touch order -> issue priority (earlier = higher)."""
        with self._state_lock:
            p = self._prio.get(name)
            if p is None:
                p = -len(self._prio)
                self._prio[name] = p
            return p

    def _drop_socket_locked(self, shard: int) -> None:
        """Drop the (possibly poisoned) serial socket so the next RPC
        reconnects; the caller holds the shard lock."""
        if self._socks[shard] is not None:
            try:
                self._socks[shard].close()
            except OSError:
                pass
            self._socks[shard] = None
            self._counters.bump(self._cn.RECONNECT, shard=shard)

    def ping_shard(self, shard: int) -> bool:
        """One short-timeout OP_PING round trip on a fresh connection —
        never the data sockets, so heartbeats cannot poison ops."""
        host, port = self._addrs[shard].rsplit(":", 1)
        try:
            with socket.create_connection(
                    (host, int(port)), timeout=self._hb_timeout) as s:
                s.settimeout(self._hb_timeout)
                s.sendall(_encode(OP_PING, "", None))
                status, _, _, _ = _decode(s)
                return status == 0
        except _WIRE_ERRORS:
            return False

    def _start_detector(self, interval: float) -> None:
        from ..resilience import FailureDetector

        with self._state_lock:
            if self._detector is None:
                self._detector = FailureDetector(
                    len(self._addrs), self.ping_shard, interval=interval,
                    miss_threshold=self._hb_threshold,
                    on_down=self._on_shard_down, on_up=self._on_shard_up,
                    counters=self._counters).start()

    def _ensure_detector(self) -> None:
        """A failover without a heartbeat would never notice recovery."""
        if self._detector is None:
            self._start_detector(self._hb_interval or 0.25)

    def _on_shard_down(self, shard: int) -> None:
        if self._failover_enabled and self._router.mark_down(shard):
            self._counters.bump(self._cn.FAILOVER, shard=shard)
        if self._workers is not None:
            self._workers[shard].drop_connection()
        with self._locks[shard]:
            self._drop_socket_locked(shard)

    def _on_shard_up(self, shard: int) -> None:
        """Recovery migration: move every failed-over key back onto the
        restarted shard, seeded with the latest state pulled from its
        fallback, under the failover lock."""
        if not self._failover_enabled:
            return
        with self._failover_lock:
            for name, fb in self._router.failed_over_names(shard):
                try:
                    _, out, _ = self._rpc_raw(fb, OP_PULL, name)
                    val = _copy(out)
                except Exception:
                    with self._state_lock:
                        val = self._last_global.get(name)
                    if val is None:
                        continue
                try:
                    # force-set: a shard that was only partitioned still
                    # holds older state, which must not shadow this
                    rname, _, _ = self._rpc_raw(shard, OP_SET, name, val)
                except Exception as e:
                    bps_log.warning(
                        "failback of %r to shard %d failed (%s); staying "
                        "degraded", name, shard, e)
                    # re-arm the detector, or the migration is never
                    # retried
                    if self._detector is not None:
                        self._detector.mark_down(shard)
                    return
                self._router.clear_failover(name)
                self._counters.bump(self._cn.REINIT, name=name, shard=shard)
                self._note_success(OP_SET, name, rname, None, val,
                                   shard=shard)
            if self._router.mark_up(shard):
                self._counters.bump(self._cn.FAILBACK, shard=shard)
                bps_log.warning("shard %d restored; routing returned to "
                                "primary placement", shard)

    # --------------------------------------------------------------- RPC

    def _shard_of(self, name: str, nbytes: int = 0) -> int:
        return self._sharder.place(name_key(name), nbytes)

    def _rpc_raw(self, shard: int, op: int, name: str, arr=None,
                 raw: bytes = b"", op_timeout: Optional[float] = None,
                 priority: int = 0, key: int = 0, pending=None):
        """One attempt against one shard; no retry, no routing.
        ``op_timeout`` clamps this attempt's wait to the op's deadline.
        Pipelined: the frame goes on the shard's I/O worker (or is the
        already-issued ``pending``) and this thread waits on its future;
        a wait timeout aborts through the worker."""
        wait = (self._timeout if op_timeout is None
                else max(0.05, min(self._timeout, op_timeout)))
        if self._workers is not None:
            worker = self._workers[shard]
            if pending is None:
                pending = worker.submit(
                    _encode_buffers(op, name, arr, raw), priority=priority,
                    key=key)
            status, rname, out, payload = worker.wait(pending, wait)
        else:
            with self._locks[shard]:
                try:
                    sock = self._sock(shard)
                    sock.settimeout(wait)
                    _send_buffers(sock, _encode_buffers(op, name, arr, raw))
                    status, rname, out, payload = _decode(sock)
                except _WIRE_ERRORS:
                    self._drop_socket_locked(shard)
                    raise
        if status != 0:
            raise RuntimeError(f"ps_server error: {bytes(payload).decode()!r}")
        return rname, out, payload

    def _rpc_once(self, shard: int, op: int, name: str, arr=None,
                  raw: bytes = b"", op_timeout: Optional[float] = None,
                  priority: int = 0, key: int = 0, pending=None):
        rname, out, payload = self._rpc_raw(shard, op, name, arr, raw,
                                            op_timeout, priority, key,
                                            pending)
        if self._detector is not None:
            self._detector.report_success(shard)
        self._note_success(op, name, rname, out, arr, shard=shard)
        return out, payload

    def _note_success(self, op: int, name: str, rname: str, out, arr=None,
                      shard: int = 0):
        """Record the server-acknowledged version (the reply's name field,
        per (name, shard)) and the last seen global value — the failover
        seed."""
        if op not in (OP_INIT, OP_SET, OP_PUSH, OP_PUSH_PULL, OP_PULL):
            return
        version = int(rname) if rname and rname.isdigit() else None
        snap = None
        if self._seed_enabled:
            if op in (OP_PULL, OP_PUSH_PULL, OP_INIT) and out is not None:
                # a reply's own buffer: a reference, not a copy (an INIT
                # loser records the winning value here)
                snap = out
            elif op == OP_SET and arr is not None:
                snap = _copy(arr)
            elif op == OP_PUSH and arr is not None:
                # status-only ack: fold the mutation into the seed, or a
                # later re-seed would erase every acked push since the
                # last pulled value
                snap = self._fold_seed(name, arr)
            elif op == OP_INIT and arr is not None and version == 0:
                snap = _copy(arr)
        with self._state_lock:
            if version is not None:
                self._pushed_version[(name, shard)] = version
            if snap is not None:
                self._last_global[name] = snap

    @staticmethod
    def _dense_delta(payload):
        """The dense array the server adds for a mutation payload: the
        blob's reconstruction for a compressed frame, else the array."""
        if isinstance(payload, WireBlob):
            return decode_blob(WIRE_TAG, payload.data, payload.shape)
        return payload

    def _fold_seed(self, name: str, payload):
        """``last_global[name] + dense(payload)`` — the post-mutation
        state computed here, exact for a single writer (the same
        elementwise add of the same dense delta in the store's dtype).
        None when there is no seed to fold into."""
        with self._state_lock:
            last = self._last_global.get(name)
        if last is None:
            return None
        return last + _like(self._dense_delta(payload), last)

    def _rpc(self, shard: int, op: int, name: str, arr=None,
             raw: bytes = b"", priority: int = 0, key: int = 0,
             pending=None):
        """Routed, retried RPC — the resilience front door.  ``pending``
        is an optimistic already-submitted first attempt, consumed as
        attempt #1 under the same policy, deadline and version guard."""
        primary = shard
        policy = self._policy
        deadline = policy.start()
        attempt = 0
        reseeded = False
        while True:
            target = primary
            if (self._failover_enabled
                    and self._router.route(primary) != primary):
                with self._failover_lock:
                    routed = self._router.route(primary)
                    if routed != primary:
                        if pending is not None:
                            # the optimistic frame went to the excluded
                            # primary; abort it (failback's SET heals the
                            # narrow race where it landed)
                            self._workers[primary].abort(
                                pending,
                                ConnectionError("re-routed to fallback"))
                            pending = None
                        try:
                            return self._rpc_on_fallback(
                                primary, routed, op, name, arr, raw)
                        except _WIRE_ERRORS as e:
                            err = e
                            target = routed
            if target == primary:
                try:
                    remaining = (None if deadline == float("inf")
                                 else deadline - time.monotonic())
                    first, pending = pending, None
                    return self._rpc_once(primary, op, name, arr, raw,
                                          op_timeout=remaining,
                                          priority=priority, key=key,
                                          pending=first)
                except _WIRE_ERRORS as e:
                    err = e
                except RuntimeError as e:
                    # store errors are final, except the KeyError of a
                    # shard restarted with a fresh store: re-seed once
                    # from the last-seen state and retry
                    if (not reseeded and name and "KeyError" in str(e)
                            and self._reseed_shard(primary, name)):
                        reseeded = True
                        continue
                    raise
            attempt += 1
            if self._detector is not None and target == primary:
                self._detector.report_failure(primary)
            if policy.should_retry(attempt, deadline):
                self._counters.bump(self._cn.RETRY, op=op, name=name,
                                    shard=target, attempt=attempt)
                policy.sleep(attempt + 1)
                if op in (OP_PUSH, OP_PUSH_PULL):
                    resolved = self._resolve_lost_mutation(target, op, name,
                                                           arr)
                    if resolved is not None:
                        return resolved
                continue
            # retries exhausted: exclude the shard we kept failing
            # against and re-route if that moves the op anywhere new
            if self._failover_enabled:
                if self._router.mark_down(target):
                    self._counters.bump(self._cn.FAILOVER, shard=target)
                    self._ensure_detector()
                    if self._detector is not None:
                        self._detector.mark_down(target)
                if self._router.route(primary) != target:
                    attempt = 0   # a fresh budget on the new home
                    continue
            self._counters.bump(self._cn.GIVE_UP, op=op, name=name,
                                shard=target)
            raise err

    def _reseed_shard(self, shard: int, name: str) -> bool:
        """Force-SET a tensor a shard lost (a restart with a fresh store)
        from the last-seen global state; False when there is none."""
        with self._state_lock:
            seed = self._last_global.get(name)
        if seed is None:
            return False
        try:
            rname, _, _ = self._rpc_raw(shard, OP_SET, name, seed)
        except Exception:
            return False
        self._counters.bump(self._cn.REINIT, name=name, shard=shard)
        self._note_success(OP_SET, name, rname, None, seed, shard=shard)
        bps_log.warning("shard %d lost %r (restarted with a fresh store?); "
                        "re-seeded from last-seen state", shard, name)
        return True

    def _resolve_lost_mutation(self, shard: int, op: int, name: str,
                               arr=None):
        """After a wire failure on PUSH/PUSH_PULL, decide whether the lost
        attempt was applied (reply lost) or not (request lost): if the
        server's version advanced past the last version it acknowledged
        to us, it landed and a resend would apply it twice.  Single
        writer per key only.  Returns the op's result when known applied
        (folded into the seed locally), else None (resend)."""
        if not self._version_guard:
            return None   # several writers: at-least-once resend
        with self._state_lock:
            expected = self._pushed_version.get((name, shard))
        if expected is None:
            return None
        payload = None
        for probe_attempt in range(self._policy.max_attempts):
            try:
                _, _, payload = self._rpc_raw(shard, OP_VERSION, name)
                break
            except RuntimeError:
                return None   # store-level: tensor unknown there
            except _WIRE_ERRORS:
                self._policy.sleep(probe_attempt + 2)
        if payload is None:
            return None
        v = struct.unpack("<Q", payload)[0]
        if v <= expected:
            return None   # not applied; safe to resend
        with self._state_lock:
            self._pushed_version[(name, shard)] = v
        self._counters.bump(self._cn.DEDUP, op=op, name=name, shard=shard)
        bps_log.debug("retry of %s on %r suppressed: server already at "
                      "version %d (> %d)", op, name, v, expected)
        post = self._fold_seed(name, arr) if arr is not None else None
        if post is not None:
            with self._state_lock:
                self._last_global[name] = post
        if op == OP_PUSH_PULL:
            if post is not None:
                return post, b""
            return self._rpc(shard, OP_PULL, name)
        return None, b""

    def _rpc_on_fallback(self, primary: int, fallback: int, op: int,
                         name: str, arr, raw):
        """Degraded mode: serve an op whose primary shard is down.  First
        touch of a name re-seeds it on the fallback with SET from this
        worker's last-seen state.  The caller holds the failover lock."""
        if op in (OP_NAMES, OP_PING):
            return self._rpc_once(fallback, op, name, arr, raw)
        if self._router.fallback_for(name) != fallback:
            with self._state_lock:
                seed = self._last_global.get(name)
            if seed is not None:
                rname, _, _ = self._rpc_raw(fallback, OP_SET, name, seed)
                self._counters.bump(self._cn.REINIT, name=name,
                                    shard=fallback)
                self._note_success(OP_SET, name, rname, None, seed,
                                   shard=fallback)
            self._router.note_failover(name, primary, fallback)
            bps_log.warning("shard %d down: %r re-homed to shard %d",
                            primary, name, fallback)
        return self._rpc_once(fallback, op, name, arr, raw)

    # ------------------------------------------------- store interface

    def _partition(self, name: str, arr):
        """``[(wire_name, part)]`` of ``arr``: flat slices named
        ``name#p{i}`` above ``BYTEPS_PARTITION_BYTES`` (reference
        PartitionTensor, operations.cc:95-132), and the reassembly meta
        ``pull``/``version`` need later."""
        from ..common.partition import partition_offsets

        arr = (arr.contiguous() if isinstance(arr, torch.Tensor)
               else np.ascontiguousarray(arr))
        parts = partition_offsets(arr.nbytes, self._partition_bytes)
        with self._state_lock:
            self._part_meta[name] = (max(1, len(parts)), tuple(arr.shape),
                                     arr.dtype)
        if len(parts) <= 1:
            return [(name, arr)]
        flat = arr.reshape(-1)
        return [(f"{name}#p{i}",
                 flat[off // arr.itemsize:(off + length) // arr.itemsize])
                for i, (off, length) in enumerate(parts)]

    def _part_names(self, name: str):
        """Reassembly meta, or None for an unpartitioned/unknown name."""
        with self._state_lock:
            meta = self._part_meta.get(name)
        if meta is None or meta[0] == 1:
            return None
        return meta

    def _discover_parts(self, name: str):
        """A tensor partitioned by another client lives on the servers as
        ``name#p{i}``: find them through ``names()`` and cache a flat meta
        (the original shape is the other client's).  None when the name
        does not exist partitioned."""
        prefix = f"{name}#p"
        idx = []
        for n in self.names():
            if n.startswith(prefix) and n[len(prefix):].isdigit():
                idx.append(int(n[len(prefix):]))
        if not idx or sorted(idx) != list(range(len(idx))):
            return None
        out, _ = self._rpc(self._shard_of(f"{name}#p0"), OP_PULL,
                           f"{name}#p0")
        bps_log.warning(
            "%r was partitioned by another client; reassembling %d parts "
            "as a flat [n] array (original shape is client-local — "
            "reshape against your template)", name, len(idx))
        meta = (len(idx), None, out.dtype)
        with self._state_lock:
            self._part_meta[name] = meta
        return meta

    @staticmethod
    def _encode_raw(pname, part):
        return part, None   # identity "encode" (INIT / PULL legs)

    @staticmethod
    def _assemble_flat(chunks, dtype=None):
        """Reassemble part arrays into one flat destination."""
        if chunks and isinstance(chunks[0], torch.Tensor):
            return torch.cat([c.reshape(-1) for c in chunks])
        flat = np.empty(sum(c.size for c in chunks), dtype or chunks[0].dtype)
        off = 0
        for c in chunks:
            flat[off:off + c.size] = c.reshape(-1)
            off += c.size
        return flat

    def init_tensor(self, name: str, value) -> None:
        # INIT stays raw: the authoritative state must not start quantized
        self._pipeline_parts(OP_INIT, self._partition(name, _host(value)),
                             self._encode_raw, self._priority_of(name))

    def push_delta(self, name: str, delta,
                   priority: Optional[int] = None) -> None:
        prio = self._priority_of(name) if priority is None else priority
        self._pipeline_parts(OP_PUSH, self._partition(name, _host(delta)),
                             self._compressor.encode_mutation, prio)

    def pull(self, name: str):
        prio = self._priority_of(name)
        meta = self._part_names(name)
        if meta is None:
            try:
                out, _ = self._rpc(self._shard_of(name), OP_PULL, name,
                                   priority=prio)
                return _copy(out)
            except RuntimeError as e:
                # maybe partitioned by another client (no meta here)
                if "KeyError" not in str(e):
                    raise
                meta = self._discover_parts(name)
                if meta is None:
                    raise
        nparts, shape, dtype = meta
        parts = [(f"{name}#p{i}", None) for i in range(nparts)]
        chunks = [o.reshape(-1) for o in self._pipeline_parts(
            OP_PULL, parts, self._encode_raw, prio)]
        flat = self._assemble_flat(chunks, dtype)
        return flat if shape is None else flat.reshape(shape)

    def pull_many(self, names) -> dict:
        """Pull several tensors through ONE windowed fan-out pass:
        ``{name: array}``.  Names this client holds no meta for fall back
        to :meth:`pull`'s discovery path one by one."""
        names = list(names)
        parts, counts, fast = [], [], []
        for name in names:
            meta = self._part_names(name)
            with self._state_lock:
                known = name in self._part_meta
            if meta is None and not known:
                fast.append(False)
                continue
            fast.append(True)
            if meta is None:
                parts.append((name, None))
                counts.append((1, None, None))
            else:
                nparts, shape, dtype = meta
                parts.extend((f"{name}#p{i}", None) for i in range(nparts))
                counts.append((nparts, shape, dtype))
        outs = (self._pipeline_parts(OP_PULL, parts, self._encode_raw, 0)
                if parts else [])
        result, off, ci = {}, 0, 0
        for name, is_fast in zip(names, fast):
            if not is_fast:
                result[name] = self.pull(name)
                continue
            k, shape, dtype = counts[ci]
            ci += 1
            if k == 1 and shape is None:
                result[name] = _copy(outs[off])
            else:
                flat = self._assemble_flat([o.reshape(-1)
                                            for o in outs[off:off + k]],
                                           dtype)
                result[name] = flat if shape is None else flat.reshape(shape)
            off += k
        return result

    def push_pull(self, name: str, delta,
                  priority: Optional[int] = None):
        d = _host(delta)
        prio = self._priority_of(name) if priority is None else priority
        outs = [o.reshape(-1) for o in self._pipeline_parts(
            OP_PUSH_PULL, self._partition(name, d),
            self._compressor.encode_mutation, prio)]
        if len(outs) == 1:
            return _copy(outs[0]).reshape(tuple(d.shape))
        return self._assemble_flat(outs).reshape(tuple(d.shape))

    def version(self, name: str) -> int:
        meta = self._part_names(name)
        qname = name if meta is None else f"{name}#p0"
        try:
            _, payload = self._rpc(self._shard_of(qname), OP_VERSION, qname)
        except RuntimeError as e:
            if meta is not None or "KeyError" not in str(e):
                raise
            if self._discover_parts(name) is None:
                raise
            qname = f"{name}#p0"
            _, payload = self._rpc(self._shard_of(qname), OP_VERSION, qname)
        return struct.unpack("<Q", payload)[0]

    def names(self) -> List[str]:
        """Union of tensor names across the alive shards, queried
        concurrently, deduplicated in shard order."""
        alive = [i for i in range(len(self._addrs))
                 if not (self._failover_enabled and self._router.is_down(i))]
        pend = {i: self._submit_part(i, OP_NAMES, "") for i in alive}
        payloads = [self._rpc(i, OP_NAMES, "", pending=pend[i])[1]
                    for i in alive]
        out: List[str] = []
        seen: set = set()
        for payload in payloads:
            for n in (bytes(payload).decode().split("\n") if payload else []):
                if n and n not in seen:
                    seen.add(n)
                    out.append(n)
        return out

    def ping(self) -> bool:
        """True iff every shard ADDRESS answers (not routed: a fallback
        answering for a dead primary must not look healthy)."""
        return all(self.ping_shard(i) for i in range(len(self._addrs)))

    def health(self) -> List[bool]:
        """Per-shard routing health (True = primary placement active)."""
        return [not self._router.is_down(i) for i in range(len(self._addrs))]

    def shard_stats(self, shard: int) -> dict:
        """Live ``OP_STATS`` scrape of one shard."""
        _, payload = self._rpc(shard, OP_STATS, "")
        return json.loads(bytes(payload).decode())

    def record_clock_offsets(self, samples: int = 5) -> List[ClockOffset]:
        """Estimate every shard's wall-clock offset (NTP-style over
        ``OP_PING``) and drop each into the worker's trace as a
        ``clock_offset`` instant event.  Unreachable shards are skipped
        with a warning."""
        from ..common.tracing import get_tracer

        tracer = get_tracer()
        out = []
        for addr in self._addrs:
            try:
                off = estimate_clock_offset(addr, n=samples)
            except (ConnectionError, OSError) as e:
                bps_log.warning("clock offset for %s unavailable: %s",
                                addr, e)
                continue
            out.append(off)
            if tracer.enabled:
                tracer.instant("clock_offset", "client", **off.as_dict())
        return out

    def close(self) -> None:
        if self._detector is not None:
            self._detector.stop()
            self._detector = None
        if self._workers is not None:
            for w in self._workers:
                w.close()
        for i, s in enumerate(self._socks):
            if s is not None:
                try:
                    s.close()
                finally:
                    self._socks[i] = None
        try:
            self._wire_stats.log_summary()
        except Exception:  # pragma: no cover - logging must never mask
            pass

