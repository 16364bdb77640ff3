"""Serving frontends — the port of ``byteps_tpu/serving/frontend.py``:
the in-process :class:`ServeClient`, a TCP :class:`ServeFrontend` and
:func:`serve`, the :class:`RemoteServeClient`, and the launcher's
``serve`` role (:func:`serve_from_env`).

The wire is the JAX package's, byte for byte (``engine/wire.py``), so a
JAX ``RemoteServeClient`` — and a JAX ``ServeRouter`` — talks to this
frontend and vice versa.  Ops (one request frame per round trip; STREAM
replies a sequence):

    0 = SUBMIT  name = JSON {"max_new_tokens", "seed", "priority",
                             "resume", ...}; arr = int32 prompt tokens,
                the trailing ``resume`` entries being tokens already
                emitted elsewhere.  reply: status=0, name = request id
                (a disagg prefill leg: the ship report's JSON), arr =
                int32 tokens; typed rejections come back as status=1
                with "ErrorName: message".
    1 = STATS   reply payload = JSON engine metrics summary
    2 = PING    liveness
    3 = STREAM  as SUBMIT; one frame per token (name "t", arr [tok]),
                then a terminal frame (name "end", arr = all tokens).
    4 = CANCEL  name = JSON {"rid"[, "epoch"]}: cancel the in-flight
                request submitted with that ``rid`` (from a second
                connection); a rid that has not arrived yet is
                tombstoned, one that finished lately is too late.
                reply payload = JSON {"cancelled": bool}.
    5 = JOURNAL router-HA journal pushes are taken by routers only: a
                serve frontend answers "bad op 5", as JAX's does.
    6 = KV_BLOCKS one shipped KV block of a disaggregated prefill
                (``serving/disagg/ship.py``): name = JSON {"key", "i",
                "n", "pos", "geom", "digest"}, payload = the block's
                bytes.  reply: status=0 JSON ack, or status=1 with a
                typed ``KVShip*`` error.

SUBMIT/STREAM params may also carry ``epoch`` (the dispatching router's
fencing token: below the engine's high-water the typed
``EpochFencedError``), ``rid`` (for OP_CANCEL), ``tenant`` and ``slo``
(router-tier accounting; a replica ignores them), ``timeout`` (SUBMIT's
wait, seconds), and for a disaggregated tier ``ship_to`` + ``kv_ship``
(a prefill leg: park the finished KV and ship it to ``ship_to`` under
``kv_ship`` before replying) or ``kv_ship`` alone (a decode leg: adopt
the staged blocks instead of prefilling).

The router tier over these frontends is ``router.py``; the client below
fails over between routers when given several addresses.  Not ported:
the Unix-socket and shared-memory transports (``BYTEPS_TRANSPORT`` other
than ``auto`` / ``tcp`` is refused; a JAX client's ``auto`` finds no
rendezvous here and stays on TCP).
"""

from __future__ import annotations

import collections
import json
import socket
import socketserver
import threading
import time
from typing import List, Optional

import numpy as np

from ..common import logging as bps_log
from ..engine.wire import _decode, _encode, hard_reset
from .engine import Request, ServingEngine

OP_SUBMIT, OP_STATS, OP_PING, OP_STREAM, OP_CANCEL, OP_JOURNAL = range(6)
OP_KV_BLOCKS = 6

__all__ = ["ServeClient", "ServeFrontend", "RemoteServeClient",
           "ServeConnectionError", "ServeReplyError", "serve",
           "serve_from_env", "OP_SUBMIT", "OP_STATS", "OP_PING",
           "OP_STREAM", "OP_CANCEL", "OP_JOURNAL", "OP_KV_BLOCKS"]

# the rid registry's bounds: tombstoned early cancels, finished rids
_RID_MEMORY = 1024

# status=1 names another router could serve (a standby's refusal), and
# the overload sheds a caller may retry later (JAX's two sets)
_RETRYABLE_REPLY_NAMES = frozenset({"RouterStandbyError"})
_SHED_REPLY_NAMES = frozenset({"OverloadShedError"})


class ServeConnectionError(ConnectionError):
    """The serve frontend went away mid-conversation (connection died or
    stalled past the client timeout)."""


class ServeReplyError(RuntimeError):
    """A status=1 reply: the endpoint answered with a typed error;
    ``name`` is the server-side error class name, ``retryable`` whether
    another router could serve the request (a standby's refusal), and
    ``shed`` whether it was an overload shed (retry later)."""

    def __init__(self, msg: str, name: str = ""):
        self.name = name
        self.retryable = name in _RETRYABLE_REPLY_NAMES
        self.shed = name in _SHED_REPLY_NAMES
        super().__init__(msg)


class ServeClient:
    """In-process client: submit -> stream tokens, cancel, drain.  Starts
    the engine's tick thread on first use and owns its shutdown."""

    def __init__(self, engine: ServingEngine):
        self.engine = engine

    def submit(self, prompt, max_new_tokens: int, *, seed: int = 0,
               priority: int = 0) -> Request:
        self.engine.start()
        return self.engine.submit(prompt, max_new_tokens, seed=seed,
                                  priority=priority)

    def stream(self, prompt, max_new_tokens: int, *, seed: int = 0,
               priority: int = 0):
        """Iterator of tokens as the engine emits them."""
        return iter(self.submit(prompt, max_new_tokens, seed=seed,
                                priority=priority))

    def generate(self, prompt, max_new_tokens: int, *, seed: int = 0,
                 priority: int = 0,
                 timeout: Optional[float] = None) -> np.ndarray:
        """Blocking submit -> full token array."""
        return self.submit(prompt, max_new_tokens, seed=seed,
                           priority=priority).result(timeout)

    def cancel(self, req: Request) -> None:
        self.engine.cancel(req)

    def drain(self, timeout: Optional[float] = None) -> None:
        self.engine.drain(timeout)

    def close(self) -> None:
        self.engine.stop()


# ------------------------------------------------------------------ TCP tier


def _split_resume(params: dict, arr):
    """The SUBMIT/STREAM array contract: ``resume`` = k > 0 marks the
    trailing k entries as already-emitted tokens; the rest is the
    prompt."""
    toks = np.asarray(arr, np.int32).reshape(-1)
    k = int(params.get("resume", 0))
    return (toks[:-k], toks[-k:]) if k > 0 else (toks, None)


def _connect(addr: str, timeout: Optional[float]) -> socket.socket:
    host, _, port = str(addr).strip().rpartition(":")
    s = socket.create_connection((host, int(port)), timeout=timeout)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


def _reply_error(payload) -> "ServeReplyError":
    msg = bytes(payload).decode()
    return ServeReplyError(f"serve error: {msg!r}",
                           name=msg.split(":", 1)[0].strip())


def _wire_cancel(addr: str, params: dict, timeout: Optional[float]) -> bool:
    """One OP_CANCEL round trip on a fresh short-lived connection (the
    streaming one is busy relaying the stream being cancelled)."""
    try:
        s = _connect(addr, timeout)
    except OSError as e:
        raise ServeConnectionError(
            f"serve frontend {addr} unreachable for cancel: {e}") from e
    try:
        s.sendall(_encode(OP_CANCEL, json.dumps(params), None))
        status, _, _, payload = _decode(s)
    except (ConnectionError, OSError, ValueError) as e:
        raise ServeConnectionError(
            f"serve frontend {addr} died mid-cancel: {e}") from e
    finally:
        try:
            s.close()
        except OSError:
            pass
    if status != 0:
        raise _reply_error(payload)
    return bool(json.loads(bytes(payload).decode()).get("cancelled"))


def _parse_submit(engine: ServingEngine, name: str, arr, stager=None):
    """Decode a SUBMIT/STREAM frame into an engine submit.  A disagg
    DECODE leg (``kv_ship`` without ``ship_to``) claims its staged
    blocks from the stager, adopted at admission when the staging is
    whole and its position is the prompt's length (else released, and
    the request prefills).  The epoch fence rides into the submit, so
    check and admission are one step."""
    params = json.loads(name) if name else {}
    prompt, resumed = _split_resume(params, arr)
    kv = None
    if (stager is not None and params.get("kv_ship")
            and not params.get("ship_to")):
        staged = stager.take(str(params["kv_ship"]))
        if staged is not None:
            if staged["pos"] == int(prompt.shape[0]):
                kv = staged["ids"]
            else:
                engine.release_kv_ids(staged["ids"])
    try:
        req = engine.submit(
            prompt, int(params.get("max_new_tokens", 16)),
            seed=int(params.get("seed", 0)),
            priority=int(params.get("priority", 0)),
            resume_tokens=resumed, epoch=params.get("epoch"),
            keep_kv=bool(params.get("ship_to")), kv_blocks=kv)
    except Exception:
        # the engine owns the blocks only once submit returned
        engine.release_kv_ids(kv)
        raise
    return req, params


def _error_frame(e: BaseException) -> bytes:
    return _encode(1, "", None, f"{type(e).__name__}: {e}".encode())


class _ServeHandler(socketserver.BaseRequestHandler):
    def setup(self):
        self.server._track_conn(self.request)  # type: ignore

    def _stream(self, engine: ServingEngine, sock, req: Request) -> bool:
        """Relay ``req``'s tokens one frame each, then the terminal
        frame.  False when the client went away (the request is then
        cancelled so its slot and blocks free this tick)."""
        try:
            for tok in req:
                sock.sendall(_encode(0, "t", np.asarray([tok], np.int32)))
            sock.sendall(_encode(0, "end",
                                 np.asarray(req.tokens, np.int32)))
            return True
        except RuntimeError as e:
            # engine died mid-stream: a typed status=1 frame ends it
            try:
                sock.sendall(_error_frame(e))
            except OSError:
                pass
            return True
        except OSError:
            engine.cancel(req)
            return False

    def _stats(self, engine: ServingEngine) -> bytes:
        payload = json.dumps(
            {**engine.metrics.summary(),
             "weights_fingerprint": engine.weights_fp,
             "step_counts": engine.step_counts(),
             "occupancy": engine.pool.occupancy(),
             "queue_depth": engine.scheduler.depth,
             "prefix_cache": (engine.prefix.stats()
                              if engine.prefix is not None else None),
             "kv_blocks": (engine.pool.block_stats() if engine.paged
                           else None),
             "device": str(engine.device),
             "metrics": engine.metrics.registry.snapshot()})
        return _encode(0, "", None, payload.encode())

    def _submit(self, engine: ServingEngine, sock, op: int, name: str,
                arr) -> Optional[bytes]:
        """A SUBMIT (the reply frame) or STREAM (relayed here; None, or
        the connection is gone: raises ``ConnectionAbortedError``)."""
        srv = self.server
        req, params = _parse_submit(engine, name, arr,
                                    stager=srv.kv_stager(create=False))
        rid = params.get("rid")
        if rid and srv.register_rid(str(rid), req):
            # an OP_CANCEL for this rid arrived first (tombstoned)
            engine.cancel(req)
        try:
            if op == OP_STREAM:
                if not self._stream(engine, sock, req):
                    raise ConnectionAbortedError("stream client left")
                return None
            toks = req.result(timeout=float(params.get("timeout", 300.0)))
            if params.get("ship_to"):
                # disagg prefill leg: ship the parked KV after the
                # request finished; the report rides the reply's name
                return _encode(0, json.dumps(srv.ship_kv(req, params)),
                               toks)
            return _encode(0, str(req.id), toks)
        finally:
            if rid:
                srv.unregister_rid(str(rid), req)

    def _cancel(self, engine: ServingEngine, name: str) -> bytes:
        params = json.loads(name) if name else {}
        rid = str(params.get("rid", ""))
        if "epoch" in params:
            # a deposed router must not cancel what the takeover epoch
            # re-dispatched: the fence is held across the cancel
            with engine.epoch_fence(int(params["epoch"])):
                ok = self.server.cancel_rid(rid)
        else:
            ok = self.server.cancel_rid(rid)
        return _encode(0, "", None, json.dumps({"cancelled": ok}).encode())

    def handle(self):  # one connection, many requests
        engine: ServingEngine = self.server.engine  # type: ignore
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                op, name, arr, payload_in = _decode(sock)
            except (ConnectionError, OSError, ValueError):
                return
            try:
                if op in (OP_SUBMIT, OP_STREAM):
                    reply = self._submit(engine, sock, op, name, arr)
                    if reply is None:
                        continue
                elif op == OP_CANCEL:
                    reply = self._cancel(engine, name)
                elif op == OP_STATS:
                    reply = self._stats(engine)
                elif op == OP_KV_BLOCKS:
                    reply = self.server.kv_stager().handle(  # type: ignore
                        name, payload_in)
                elif op == OP_PING:
                    reply = _encode(0, "", None)
                else:
                    reply = _encode(1, "", None, f"bad op {op}".encode())
            except ConnectionAbortedError:
                return
            except Exception as e:  # noqa: BLE001 — every error is a reply
                reply = _error_frame(e)
            try:
                sock.sendall(reply)
            except OSError:
                return


class ServeFrontend(socketserver.ThreadingTCPServer):
    """TCP frontend over one engine (whose tick thread it starts): the
    request ops, OP_CANCEL's rid registry, the decode side's KV stager
    (built on the first OP_KV_BLOCKS frame) and the prefill side's
    ship, and :meth:`kill`, which dies like a crashed replica."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, engine: ServingEngine):
        from ..common.config import check_transport, get_config

        check_transport(get_config().transport)
        super().__init__(addr, _ServeHandler)
        self.engine = engine
        # live client sockets, so kill() can sever them mid-stream
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._killing = False
        # OP_CANCEL: rid -> in-flight request, cancels that came ahead
        # of their submit (tombstones) and rids finished lately (a late
        # cancel is too late, not early), both bounded
        self._rids: dict = {}
        self._rid_lock = threading.Lock()
        self._rid_tombs: "collections.OrderedDict[str, None]" = \
            collections.OrderedDict()
        self._rid_done: "collections.OrderedDict[str, None]" = \
            collections.OrderedDict()
        self._kv_stager = None
        self._kv_stager_lock = threading.Lock()
        engine.start()

    # ------------------------------------------------- disagg KV ship

    def kv_stager(self, create: bool = True):
        """The decode side's KV stager.  ``create=False`` returns None
        until the first OP_KV_BLOCKS frame built it.  Raises typed on a
        dense engine: there is no block pool to stage into."""
        with self._kv_stager_lock:
            if self._kv_stager is None and create:
                from .disagg.ship import KVShipGeometryError, KVStager

                if not self.engine.paged:
                    raise KVShipGeometryError(
                        "this replica's engine is dense (paged=False) "
                        "— it cannot stage shipped KV blocks")
                self._kv_stager = KVStager(self.engine)
            return self._kv_stager

    def ship_kv(self, req: Request, params: dict) -> dict:
        """Prefill leg: ship ``req``'s parked KV to the decode replica
        named by ``ship_to``.  Never raises — a failure is reported as
        ``{"shipped": False, "error": ...}`` beside the (valid) tokens,
        and the router re-prefills on the decode side."""
        from .disagg.ship import KVShipError, ship_parked

        parked = self.engine.take_parked_kv(req.id)
        if parked is None:
            return {"shipped": False,
                    "error": "no parked KV (dense engine, non-DONE "
                             "finish, or parked-cap eviction)"}
        try:
            return ship_parked(
                self.engine, str(params["ship_to"]),
                str(params.get("kv_ship", req.id)), parked,
                metrics=self.engine.metrics)
        except KVShipError as e:
            bps_log.warning("disagg ship for request %d failed: %s",
                            req.id, e)
            return {"shipped": False,
                    "error": f"{type(e).__name__}: {e}"}
        finally:
            self.engine.release_kv_ids(parked["ids"])

    # ------------------------------------------------ OP_CANCEL registry

    def register_rid(self, rid: str, req: Request) -> bool:
        """Associate ``rid`` with its in-flight request; True when an
        OP_CANCEL for it already arrived (the caller cancels now)."""
        with self._rid_lock:
            self._rids[rid] = req
            self._rid_done.pop(rid, None)
            tombed = rid in self._rid_tombs
            if tombed:
                del self._rid_tombs[rid]
            return tombed

    def unregister_rid(self, rid: str, req: Optional[Request] = None
                       ) -> None:
        """Drop the registration while it still names ``req`` (a late
        old leg must not clobber a re-dispatch's), and remember the rid
        as finished."""
        with self._rid_lock:
            if req is not None and self._rids.get(rid) is not req:
                return
            self._rids.pop(rid, None)
            self._rid_done[rid] = None
            while len(self._rid_done) > _RID_MEMORY:
                self._rid_done.popitem(last=False)

    def cancel_rid(self, rid: str) -> bool:
        """Cancel the in-flight request under ``rid`` (slot and blocks
        freed now).  An unknown rid is tombstoned, unless it finished
        lately (then the cancel is too late).  Returns whether a live
        request was cancelled."""
        with self._rid_lock:
            req = self._rids.get(rid)
            if req is None:
                if rid not in self._rid_done:
                    self._rid_tombs[rid] = None
                    while len(self._rid_tombs) > _RID_MEMORY:
                        self._rid_tombs.popitem(last=False)
                return False
        self.engine.cancel(req)
        return True

    def _track_conn(self, sock) -> None:
        with self._conns_lock:
            # checked inside kill()'s critical section, so no connection
            # registers after kill() took the set
            if not self._killing:
                self._conns = {s for s in self._conns if s.fileno() != -1}
                self._conns.add(sock)
                return
        hard_reset(sock)   # accepted while dying: served by nobody

    def kill(self) -> None:
        """Die like a crashed replica: hard-reset every live client
        connection first (in-flight streams see ECONNRESET mid-frame),
        then stop accepting and stop the engine."""
        with self._conns_lock:
            self._killing = True
            conns, self._conns = set(self._conns), set()
        for c in conns:
            hard_reset(c)
        self.shutdown()
        self.server_close()

    def server_close(self):
        self.engine.stop()
        super().server_close()


def serve(engine: ServingEngine, port: int, host: str = "0.0.0.0",
          in_thread: bool = False):
    """Run the TCP frontend over ``engine``.  ``in_thread=True`` returns
    ``(server, thread)``; otherwise blocks (launcher mode)."""
    srv = ServeFrontend((host, port), engine)
    bps_log.info("byteps_tpu_torch serve frontend listening on %s:%d",
                 host, srv.server_address[1])
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


def _submit_frame(op: int, prompt, max_new_tokens: int, seed: int,
                  priority: int, resume, extra: Optional[dict] = None
                  ) -> bytes:
    """A SUBMIT/STREAM request; ``extra`` (epoch, rid, tenant, slo, the
    disagg params) is left out when unused, so a plain client's frame is
    the pre-router one."""
    resume = [] if resume is None else [int(t) for t in resume]
    p = {"max_new_tokens": max_new_tokens, "seed": seed,
         "priority": priority, "resume": len(resume)}
    if extra:
        p.update({k: v for k, v in extra.items() if v is not None})
    toks = np.concatenate([np.asarray(prompt, np.int32).reshape(-1),
                           np.asarray(resume, np.int32)])
    return _encode(op, json.dumps(p), toks)


class RemoteServeClient:
    """TCP client of a serve frontend or a router (this package's or the
    JAX package's — same frames).  Every read is bounded by ``timeout``
    (default ``BYTEPS_SERVE_CLIENT_TIMEOUT_MS``); a dead or stalled
    endpoint raises :class:`ServeConnectionError`.  One in-flight call
    per client (it holds the connection); :meth:`cancel` uses a
    connection of its own.  ``transport`` (default ``BYTEPS_TRANSPORT``)
    must be ``auto`` or ``tcp``.

    **Multi-router failover**: ``addr`` may be a comma-separated router
    list.  A ``ServeConnectionError`` mid-call (a dead router) or a
    *retryable* typed refusal (a standby answering before its takeover)
    rotates to the next address and re-issues the request — mid-stream
    with ``resume=`` the tokens already received, which the engine's
    resume argument makes token-identical.  Non-retryable typed errors
    (``ServeReplyError.retryable`` False, e.g. a
    ``WeightsMismatchError`` surfaced through a router) propagate at
    once.  The failover loop is bounded by ``timeout`` without
    progress."""

    def __init__(self, addr: str, timeout: Optional[float] = None,
                 transport: Optional[str] = None):
        from ..common.config import check_transport, get_config

        cfg = get_config()
        check_transport(transport or cfg.transport)
        self._addrs = [a.strip() for a in str(addr).split(",")
                       if a.strip()]
        if not self._addrs:
            raise ValueError("RemoteServeClient needs at least one "
                             "address")
        self.timeout = (timeout if timeout is not None
                        else cfg.serve_client_timeout_ms / 1e3)
        self._lock = threading.Lock()
        self._cur = 0
        self._sock = None
        # set when a stream() was abandoned mid-flight: the server keeps
        # sending that stream's frames, so the connection can no longer
        # pair requests with replies.  A single-address client stays
        # poisoned; a multi-router client clears it by reconnecting.
        self._poisoned = False
        if len(self._addrs) == 1:
            self._connect(0)  # eager: the single-endpoint contract
        else:
            self._connect_any()

    # ------------------------------------------------------- connections

    def _connect(self, idx: int) -> None:
        self.addr = self._addrs[idx]
        self._sock = _connect(self.addr, self.timeout)
        self._poisoned = False
        self._cur = idx

    def _connect_any(self) -> None:
        """Connect to the first reachable address from the cursor on
        (lock held, or single-threaded init)."""
        errs = []
        for j in range(len(self._addrs)):
            idx = (self._cur + j) % len(self._addrs)
            try:
                self._connect(idx)
                return
            except OSError as e:
                errs.append(f"{self._addrs[idx]}: {e}")
        raise ServeConnectionError(
            f"no serve endpoint reachable: {'; '.join(errs)}")

    def _rotate_locked(self) -> None:
        """Drop the connection and point the cursor at the next address
        (lock held); the next call reconnects."""
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._poisoned = False
        self._cur = (self._cur + 1) % len(self._addrs)

    def _check_usable(self) -> None:
        """Lock held (the poison flag is written under it).  A
        multi-router client reconnects out of a poisoned or dropped
        connection; a single-address one raises."""
        if (self._poisoned or self._sock is None) \
                and len(self._addrs) > 1:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
            self._connect_any()
            return
        if self._poisoned:
            raise ServeConnectionError(
                f"client for {self.addr} abandoned an in-flight stream(); "
                f"the connection is desynced — open a new client")

    def _send(self, frame: bytes) -> None:
        try:
            self._sock.sendall(frame)
        except OSError as e:
            raise ServeConnectionError(
                f"serve frontend {self.addr} unreachable: {e}") from e

    def _read_frame(self):
        try:
            status, rname, out, payload = _decode(self._sock)
        except (ConnectionError, OSError, ValueError) as e:
            raise ServeConnectionError(
                f"serve frontend {self.addr} died or stalled "
                f"({type(e).__name__}: {e}); timeout={self.timeout}s"
            ) from e
        if status != 0:
            raise _reply_error(payload)
        return rname, out, payload

    def _rpc(self, op: int, name: str = "", arr=None):
        with self._lock:
            self._check_usable()
            self._send(_encode(op, name, arr))
            return self._read_frame()

    @staticmethod
    def _extra(epoch, rid, tenant, extra=None, slo=None) -> Optional[dict]:
        out = dict(extra) if extra else {}
        for k, v in (("epoch", epoch), ("rid", rid), ("tenant", tenant),
                     ("slo", slo)):
            if v is not None:
                out[k] = v
        return out or None

    def generate(self, prompt, max_new_tokens: int, *, seed: int = 0,
                 priority: int = 0, resume=None, epoch=None, rid=None,
                 tenant=None, slo=None, extra=None) -> np.ndarray:
        """Blocking submit -> the full token array.  ``epoch``, ``rid``,
        ``tenant`` and ``slo`` ride the frame as the JAX client sends
        them; ``extra`` merges more wire params (a disagg decode leg's
        ``kv_ship``).  On a multi-router client the call fails over
        within ``timeout``."""
        kw = dict(seed=seed, priority=priority, resume=resume,
                  epoch=epoch, rid=rid, tenant=tenant, slo=slo,
                  extra=extra)
        if len(self._addrs) == 1:
            return self._generate_once(prompt, max_new_tokens, **kw)
        deadline = time.monotonic() + self.timeout
        while True:
            try:
                return self._generate_once(prompt, max_new_tokens, **kw)
            except (ServeConnectionError, ServeReplyError) as e:
                self._note_failover(e, deadline)

    def _generate_once(self, prompt, max_new_tokens: int, *, seed,
                       priority, resume, epoch, rid, tenant, slo,
                       extra) -> np.ndarray:
        with self._lock:
            self._check_usable()
            self._send(_submit_frame(
                OP_SUBMIT, prompt, max_new_tokens, seed, priority, resume,
                self._extra(epoch, rid, tenant, extra, slo)))
            _, out, _ = self._read_frame()
        return np.array(out)

    def prefill_ship(self, prompt, *, seed: int = 0, priority: int = 0,
                     ship_to: str, kv_ship: str, epoch=None, rid=None,
                     tenant=None):
        """A disagg prefill leg: submit the prompt for one token with
        ``ship_to`` and ``kv_ship``; the frontend prefills, parks and
        ships the KV to ``ship_to`` under ``kv_ship``, and replies with
        the first token and the ship report.  Returns ``(tokens,
        info)``; ``info["shipped"]`` False is a downgrade (the tokens
        are valid, the decode side re-prefills)."""
        with self._lock:
            self._check_usable()
            self._send(_submit_frame(
                OP_SUBMIT, prompt, 1, seed, priority, None,
                self._extra(epoch, rid, tenant,
                            {"ship_to": str(ship_to),
                             "kv_ship": str(kv_ship)})))
            rname, out, _ = self._read_frame()
        info = (json.loads(rname) if rname.startswith("{")
                else {"shipped": False, "error": "no ship report"})
        return np.array(out), info

    def _note_failover(self, e: BaseException, deadline: float) -> None:
        """One failover step: a non-retryable typed refusal propagates,
        a spent deadline raises, else rotate to the next router after a
        short pause (a standby needs its takeover window)."""
        if isinstance(e, ServeReplyError) and not e.retryable:
            raise e
        with self._lock:
            self._rotate_locked()
        if time.monotonic() + 0.05 > deadline:
            raise ServeConnectionError(
                f"no serve endpoint of {self._addrs} could complete "
                f"the request within timeout={self.timeout}s "
                f"(last: {type(e).__name__}: {e})") from e
        time.sleep(0.05)

    def stream(self, prompt, max_new_tokens: int, *, seed: int = 0,
               priority: int = 0, resume=None, epoch=None, rid=None,
               tenant=None, slo=None, extra=None):
        """Token iterator over OP_STREAM (``resume``: tokens already
        emitted; only new ones stream back).  Abandoning it mid-stream
        poisons a single-address client (later calls raise).  With
        several router addresses the stream is failover-wrapped: a dead
        router, or a standby's typed refusal, re-issues the request to
        the next address with ``resume=`` the tokens received so far,
        and the consumer sees one uninterrupted sequence."""
        kw = dict(seed=seed, priority=priority, epoch=epoch, rid=rid,
                  tenant=tenant, slo=slo, extra=extra)
        if len(self._addrs) == 1:
            return self._stream_once(prompt, max_new_tokens,
                                     resume=resume, **kw)
        return self._stream_failover(prompt, max_new_tokens,
                                     resume=resume, **kw)

    def _stream_failover(self, prompt, max_new_tokens: int, *, resume,
                         **kw):
        emitted: List[int] = ([int(t) for t in resume]
                              if resume is not None else [])
        deadline = time.monotonic() + self.timeout
        while True:
            try:
                for tok in self._stream_once(
                        prompt, max_new_tokens, resume=emitted or None,
                        **kw):
                    emitted.append(int(tok))
                    # the budget is timeout WITHOUT PROGRESS: every
                    # token re-arms it, so a healthy stream longer than
                    # the timeout keeps its failover protection
                    deadline = time.monotonic() + self.timeout
                    yield int(tok)
                return
            except (ServeConnectionError, ServeReplyError) as e:
                if len(emitted) >= max_new_tokens:
                    # the endpoint died between the last token and the
                    # terminal frame: the stream was fully delivered
                    return
                self._note_failover(e, deadline)

    def _stream_once(self, prompt, max_new_tokens: int, *, seed, priority,
                     resume, epoch, rid, tenant, slo, extra):
        with self._lock:
            self._check_usable()
            in_flight = False
            try:
                self._send(_submit_frame(
                    OP_STREAM, prompt, max_new_tokens, seed, priority,
                    resume, self._extra(epoch, rid, tenant, extra, slo)))
                in_flight = True
                while True:
                    try:
                        rname, out, _ = self._read_frame()
                    except ServeReplyError:
                        in_flight = False  # a typed frame ended it
                        raise
                    if rname == "t":
                        yield int(out[0])
                    else:  # "end"
                        in_flight = False
                        return
            finally:
                if in_flight:
                    self._poisoned = True

    def cancel(self, rid: str, epoch=None) -> bool:
        """OP_CANCEL of the in-flight request submitted with ``rid=``,
        on a fresh connection (the streaming one is busy).  Returns
        whether a live request was found.  With several router
        addresses every sweep tries them all (one router's False is not
        authoritative while another is the active); a sweep that met
        only dead routers and standby refusals retries until
        ``timeout``, so a cancel issued during a takeover lands once the
        standby promotes.  Non-retryable typed errors propagate."""
        params = {"rid": str(rid)}
        if epoch is not None:
            params["epoch"] = int(epoch)
        # no client lock: a stream() holds it for its whole life, and
        # this cancel must not wait behind the stream it cancels
        cur = self._cur
        addrs = [self._addrs[(cur + j) % len(self._addrs)]
                 for j in range(len(self._addrs))]
        if len(addrs) == 1:
            return _wire_cancel(addrs[0], params, self.timeout)
        deadline = time.monotonic() + self.timeout
        while True:
            answered = False
            errs = []
            for a in addrs:
                try:
                    if _wire_cancel(a, params, self.timeout):
                        return True
                    answered = True
                except ServeConnectionError as e:
                    errs.append(str(e))
                except ServeReplyError as e:
                    if not e.retryable:
                        raise
                    errs.append(f"{a}: {e.name}")
            if answered:
                # an active router answered and none held the rid
                return False
            if time.monotonic() + 0.05 > deadline:
                raise ServeConnectionError(
                    f"no serve endpoint of {addrs} accepted cancel"
                    f"({rid!r}) within timeout={self.timeout}s: "
                    f"{'; '.join(errs)}")
            time.sleep(0.05)

    def journal(self, entries: list) -> dict:
        """A router-HA journal push (OP_JOURNAL; routers only — a serve
        frontend refuses it, "bad op 5").  The ack ``{"epoch": N}`` is
        how a deposed active learns that a standby took over."""
        _, _, payload = self._rpc(OP_JOURNAL, json.dumps(entries))
        return json.loads(bytes(payload).decode()) if payload else {}

    def stats(self) -> dict:
        _, _, payload = self._rpc(OP_STATS)
        return json.loads(bytes(payload).decode())

    def ping(self) -> bool:
        try:
            self._rpc(OP_PING)
            return True
        except (OSError, RuntimeError):
            return False

    def close(self) -> None:
        if self._sock is None:
            return
        try:
            self._sock.close()
        except OSError:
            pass


# ------------------------------------------------------------ launcher role


def _model_from_env(cfg_str: str, device, seed: int = 0):
    """A model from ``BYTEPS_SERVE_MODEL``: comma-separated integer
    ``k=v`` TransformerConfig overrides (vocab_size, num_layers,
    num_heads, d_model, d_ff, max_seq_len, ...), the JAX serve role's
    defaults and fp32, weights random from ``seed``."""
    import torch

    from ..models.transformer import (Transformer, TransformerConfig,
                                      init_weights)

    kw = {}
    if cfg_str:
        for pair in cfg_str.split(","):
            k, _, v = pair.partition("=")
            kw[k.strip()] = int(v)
    kw.setdefault("vocab_size", 256)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("d_model", 128)
    kw.setdefault("d_ff", 256)
    kw.setdefault("max_seq_len", 512)
    model = Transformer(TransformerConfig(dtype=torch.float32, **kw),
                        device=device)
    init_weights(model, seed)
    return model


def serve_from_env(env=None, device=None, port: Optional[int] = None,
                   in_thread: bool = False):
    """The launcher's ``serve`` role: build the engine from
    ``BYTEPS_SERVE_*`` and ``BYTEPS_TP`` and run the TCP frontend
    (blocking, or with ``in_thread`` returning ``(server, thread)``).
    ``device`` defaults to ``cuda`` and raises without a GPU.  Without
    ``BYTEPS_SERVE_PAGED`` the engine is the dense slot engine, as in
    JAX, with its row-copy prefix store (``BYTEPS_SERVE_PREFIX_CACHE``,
    matching at ``BYTEPS_SERVE_PREFIX_BLOCK``) and speculation
    (``BYTEPS_SERVE_SPEC``); with it the paged engine, on the kernel or
    (``BYTEPS_SERVE_PAGED_KERNEL=off``) the gather fallback.
    ``BYTEPS_SERVE_CHECKPOINT`` names a port checkpoint of the model's
    parameters (``save_checkpoint(path, model)``,
    training/checkpoint.py), loaded over the random weights as the JAX
    role's ``restore_checkpoint(path, params, broadcast=False)`` does.
    A ``BYTEPS_SERVE_PREFIX_BLOCK`` other than ``BYTEPS_SERVE_BLOCK`` on
    a paged engine is refused, and so are the metrics scrape and the RPC
    trace knobs (``BYTEPS_METRICS_PORT``, ``BYTEPS_TRACE_RPC``,
    ``BYTEPS_TRACE_PATH``)."""
    import os

    from ..common.config import check_observability, get_config, reset_config
    from .engine import resolve_device

    if env is not None:
        os.environ.update({k: str(v) for k, v in env.items()
                           if k.startswith(("BYTEPS_", "DMLC_"))})
    reset_config()
    cfg = get_config()
    check_observability(cfg, "serve")
    dev = resolve_device(device)
    model = _model_from_env(cfg.serve_model, dev)
    if cfg.serve_checkpoint:
        from ..training.checkpoint import restore_checkpoint

        restore_checkpoint(cfg.serve_checkpoint, model, broadcast=False)
    engine = ServingEngine(
        model,
        n_slots=cfg.serve_slots,
        max_seq=(cfg.serve_max_seq or model.cfg.max_seq_len),
        temperature=cfg.serve_temperature,
        top_k=cfg.serve_top_k, top_p=cfg.serve_top_p,
        eos_id=cfg.serve_eos_id,
        max_queue=cfg.serve_max_queue,
        prefill_credits=cfg.serve_prefill_credits,
        chunk=cfg.serve_chunk,
        block=cfg.serve_block,
        kv_mb=cfg.serve_kv_mb,
        kv_dtype=cfg.serve_kv_dtype,
        tp=cfg.serve_tp,
        prefix_cache=cfg.serve_prefix_cache,
        prefix_block=cfg.serve_prefix_block,
        prefix_bytes=cfg.serve_prefix_mb << 20,
        paged=cfg.serve_paged,
        paged_kernel=cfg.serve_paged_kernel,
        spec_k=(cfg.serve_spec_k if cfg.serve_spec else 0),
        spec_ngram=cfg.serve_spec_ngram,
        device=dev)
    out = serve(engine, cfg.serve_port if port is None else port,
                in_thread=in_thread)
    return out if in_thread else 0
