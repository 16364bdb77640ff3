"""Serving frontends — the port of ``byteps_tpu/serving/frontend.py``:
the in-process :class:`ServeClient`, a TCP :class:`ServeFrontend` and
:func:`serve`, the :class:`RemoteServeClient`, and the launcher's
``serve`` role (:func:`serve_from_env`).

The wire is the JAX package's, byte for byte (``engine/wire.py``), so a
JAX ``RemoteServeClient`` talks to this frontend and vice versa.  Ops
ported (one request frame per round trip; STREAM replies a sequence):

    0 = SUBMIT  name = JSON {"max_new_tokens", "seed", "priority",
                             "resume"}; arr = int32 prompt tokens, the
                trailing ``resume`` entries being tokens already emitted
                elsewhere.  reply: status=0, name = request id, arr =
                int32 tokens; typed rejections come back as status=1
                with "ErrorName: message".
    1 = STATS   reply payload = JSON engine metrics summary
    2 = PING    liveness
    3 = STREAM  as SUBMIT; one frame per token (name "t", arr [tok]),
                then a terminal frame (name "end", arr = all tokens).

Not ported in this slice: OP_CANCEL, the router journal, disaggregated
KV ship frames, router epochs, and the Unix-socket / shared-memory
transports (a JAX client's "auto" transport finds no rendezvous here
and stays on TCP).  Requests carrying those params are refused typed.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from typing import Optional

import numpy as np

from ..common import logging as bps_log
from ..engine.wire import _decode, _encode
from .engine import Request, ServingEngine

OP_SUBMIT, OP_STATS, OP_PING, OP_STREAM = range(4)

__all__ = ["ServeClient", "ServeFrontend", "RemoteServeClient",
           "ServeConnectionError", "ServeReplyError", "serve",
           "serve_from_env", "OP_SUBMIT", "OP_STATS", "OP_PING",
           "OP_STREAM"]

# submit params that belong to tiers this slice does not port
_UNPORTED_PARAMS = ("epoch", "ship_to", "kv_ship")


class ServeConnectionError(ConnectionError):
    """The serve frontend went away mid-conversation (connection died or
    stalled past the client timeout)."""


class ServeReplyError(RuntimeError):
    """A status=1 reply: the endpoint answered with a typed error;
    ``name`` is the server-side error class name."""

    def __init__(self, msg: str, name: str = ""):
        self.name = name
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


def _parse_submit(engine: ServingEngine, name: str, arr):
    """Decode a SUBMIT/STREAM frame into an engine submit; ``resume`` =
    k > 0 marks the trailing k tokens as already emitted."""
    params = json.loads(name) if name else {}
    unported = [p for p in _UNPORTED_PARAMS if p in params]
    if unported:
        raise ValueError(f"submit params {unported} belong to serving "
                         f"tiers this engine does not implement")
    toks = np.asarray(arr, np.int32).reshape(-1)
    k = int(params.get("resume", 0))
    prompt, resumed = (toks[:-k], toks[-k:]) if k > 0 else (toks, None)
    req = engine.submit(
        prompt, int(params.get("max_new_tokens", 16)),
        seed=int(params.get("seed", 0)),
        priority=int(params.get("priority", 0)),
        resume_tokens=resumed)
    return req, params


def _error_frame(e: BaseException) -> bytes:
    return _encode(1, "", None, f"{type(e).__name__}: {e}".encode())


class _ServeHandler(socketserver.BaseRequestHandler):
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

    def handle(self):  # one connection, many requests
        engine: ServingEngine = self.server.engine  # type: ignore
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                op, name, arr, _ = _decode(sock)
            except (ConnectionError, OSError):
                return
            try:
                if op in (OP_SUBMIT, OP_STREAM):
                    req, params = _parse_submit(engine, name, arr)
                    if op == OP_STREAM:
                        if not self._stream(engine, sock, req):
                            return
                        continue
                    toks = req.result(timeout=float(
                        params.get("timeout", 300.0)))
                    reply = _encode(0, str(req.id), toks)
                elif op == OP_STATS:
                    reply = self._stats(engine)
                elif op == OP_PING:
                    reply = _encode(0, "", None)
                else:
                    reply = _encode(1, "", None, f"bad op {op}".encode())
            except Exception as e:  # noqa: BLE001 — every error is a reply
                reply = _error_frame(e)
            try:
                sock.sendall(reply)
            except OSError:
                return


class ServeFrontend(socketserver.ThreadingTCPServer):
    """TCP frontend over one engine (whose tick thread it starts)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, engine: ServingEngine):
        super().__init__(addr, _ServeHandler)
        self.engine = engine
        engine.start()

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
                  priority: int, resume) -> bytes:
    resume = [] if resume is None else [int(t) for t in resume]
    p = {"max_new_tokens": max_new_tokens, "seed": seed,
         "priority": priority, "resume": len(resume)}
    toks = np.concatenate([np.asarray(prompt, np.int32).reshape(-1),
                           np.asarray(resume, np.int32)])
    return _encode(op, json.dumps(p), toks)


class RemoteServeClient:
    """TCP client of one serve frontend (this package's or the JAX
    package's — same frames).  Every read is bounded by ``timeout``
    (default ``BYTEPS_SERVE_CLIENT_TIMEOUT_MS``); a dead or stalled
    frontend raises :class:`ServeConnectionError`.  One in-flight call
    per client (it holds the connection)."""

    def __init__(self, addr: str, timeout: Optional[float] = None):
        from ..common.config import get_config

        self.addr = str(addr).strip()
        host, _, port = self.addr.rpartition(":")
        self.timeout = (timeout if timeout is not None
                        else get_config().serve_client_timeout_ms / 1e3)
        self._lock = threading.Lock()
        self._poisoned = False
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=self.timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _send(self, frame: bytes) -> None:
        if self._poisoned:
            raise ServeConnectionError(
                f"client for {self.addr} abandoned an in-flight stream(); "
                f"the connection is desynced — open a new client")
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
            msg = bytes(payload).decode()
            raise ServeReplyError(f"serve error: {msg!r}",
                                  name=msg.split(":", 1)[0].strip())
        return rname, out, payload

    def _rpc(self, op: int):
        with self._lock:
            self._send(_encode(op, "", None))
            return self._read_frame()

    def generate(self, prompt, max_new_tokens: int, *, seed: int = 0,
                 priority: int = 0, resume=None) -> np.ndarray:
        """Blocking submit -> the full token array."""
        with self._lock:
            self._send(_submit_frame(OP_SUBMIT, prompt, max_new_tokens,
                                     seed, priority, resume))
            _, out, _ = self._read_frame()
        return np.array(out)

    def stream(self, prompt, max_new_tokens: int, *, seed: int = 0,
               priority: int = 0, resume=None):
        """Token iterator over OP_STREAM.  Abandoning it mid-stream
        poisons the client (later calls raise)."""
        with self._lock:
            in_flight = False
            try:
                self._send(_submit_frame(OP_STREAM, prompt, max_new_tokens,
                                         seed, priority, resume))
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
    (``BYTEPS_SERVE_PAGED_KERNEL=off``) the gather fallback.  A
    checkpoint (``BYTEPS_SERVE_CHECKPOINT``), which the port cannot load
    yet, is refused, never ignored; so is a ``BYTEPS_SERVE_PREFIX_BLOCK``
    other than ``BYTEPS_SERVE_BLOCK`` on a paged engine."""
    import os

    from ..common.config import get_config, reset_config
    from .engine import resolve_device

    if env is not None:
        os.environ.update({k: str(v) for k, v in env.items()
                           if k.startswith(("BYTEPS_", "DMLC_"))})
    reset_config()
    cfg = get_config()
    if cfg.serve_checkpoint:
        raise NotImplementedError(
            "['BYTEPS_SERVE_CHECKPOINT'] selects a checkpoint, which this "
            "port cannot load yet")
    dev = resolve_device(device)
    model = _model_from_env(cfg.serve_model, dev)
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
