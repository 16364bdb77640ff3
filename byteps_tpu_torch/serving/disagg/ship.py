"""KV block shipping: the prefill -> decode wire leg of disaggregation —
the port of ``byteps_tpu/serving/disagg/ship.py``, frame for frame.

One ``OP_KV_BLOCKS`` frame per paged block, sent on a fresh connection
to the decode replica's serve frontend:

    name    = JSON {"key", "i", "n", "pos", "geom", "digest"}
    payload = the block's raw K/V bytes, every layer's cache tensors in
              sorted-name order (scatter-gather views of one host copy
              of the ship — no user-space join on the send path)

``key`` is the router-minted ship id the decode dispatch later claims
the staged blocks under; ``i``/``n`` sequence the blocks, so a torn or
reordered ship aborts the whole staging (``KVShipSequenceError`` —
partial KV is never attended); ``digest`` is a blake2b-128 of the
payload, checked before the block is written (a corrupt block is
refused typed and resent, at most ``BYTEPS_DISAGG_SHIP_RETRIES``
times); ``geom`` commits both pools to one (layers, block size,
per-block elements and dtype of every cache tensor) tuple.  The
geometry names neither the layout nor the tp: a grouped ``[block, KV,
D]`` row and a flat ``[block, KV*D]`` row are the same bytes, and a tp
pool ships its shards side by side, head-major — the unsharded row —
so a grouped-pool or tp=2 prefill replica feeds a flat tp=1 decode
replica, and either package feeds the other.  Dtypes are named as
numpy names them (``float32``, ``bfloat16``, ``int8``), as the JAX
package writes them.

Every failure downgrades, never corrupts: the sender raises a typed
``KVShipError`` subclass, the frontend reports ``{"shipped": False}``
beside the (valid) first token, and the router falls back to
decode-side re-prefill.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ...common import logging as bps_log
from ...engine.wire import (_decode, _encode, _encode_buffers,
                             _payload_view, _send_buffers)
from .. import metrics as sm

__all__ = ["KVShipError", "KVShipGeometryError", "KVShipSequenceError",
           "KVShipDigestError", "KVShipAbortedError", "KVStager",
           "pool_geometry", "ship_parked", "on_block_sent"]


class KVShipError(RuntimeError):
    """Base of the typed ship failures.  Every subclass means the same
    thing to the router: this request's KV did not arrive whole — fall
    back to decode-side re-prefill."""


class KVShipGeometryError(KVShipError):
    """The two pools disagree on (layers, block, per-block elements,
    dtype) — nothing can be shipped between them."""


class KVShipSequenceError(KVShipError):
    """A block arrived out of order (or for an unknown ship): the
    staging is torn and has been aborted receiver-side."""


class KVShipDigestError(KVShipError):
    """A block's payload failed its blake2b check.  The receiver's
    expected index is unchanged — the sender retries the same block."""


class KVShipAbortedError(KVShipError):
    """The ship died wholesale: unreachable decode replica, connection
    cut mid-transfer, receiver out of blocks, or an unrecognized typed
    refusal."""


# test hook: called as on_block_sent(key, i, n) after each block is
# acknowledged; an exception raised here aborts the ship like a wire cut
on_block_sent = None


def _dtype_name(dt: torch.dtype) -> str:
    """A torch dtype as numpy (and the JAX package's geometry) names it."""
    return str(dt).replace("torch.", "")


def pool_geometry(engine) -> str:
    """The compatibility string both ends of a ship must agree on: layer
    count, block size, and per-block element count and dtype of every
    cache tensor in sorted-name order (the payload order), from the
    engine's :meth:`~ServingEngine.kv_block_schema` — the same string
    whatever the layout or tp, and the JAX package's for the same
    pool."""
    schema = engine.kv_block_schema()
    parts = [f"L{len(schema)}", f"B{engine.pool.block}"]
    for name, shape, dt in schema[0]:
        parts.append(f"{name}={int(np.prod(shape))}:{_dtype_name(dt)}")
    return "/".join(parts)


def _digest(bufs) -> str:
    h = hashlib.blake2b(digest_size=16)
    for b in bufs:
        h.update(b)
    return h.hexdigest()


_TYPED_SHIP_ERRORS = {
    "KVShipGeometryError": KVShipGeometryError,
    "KVShipSequenceError": KVShipSequenceError,
    "KVShipDigestError": KVShipDigestError,
    "KVShipAbortedError": KVShipAbortedError,
}


def ship_parked(engine, addr: str, key: str, parked: dict, *,
                metrics=None, transport: Optional[str] = None) -> dict:
    """Ship a parked prefill's KV blocks to the decode replica at
    ``addr`` under ship id ``key``.  ``parked`` is the engine's
    ``take_parked_kv`` entry; the CALLER keeps ownership of its block
    refs (release them in a ``finally`` — this function only reads).
    Returns ``{"shipped": True, "blocks": n, "bytes": total, "ms": t,
    "extract_ms": x}`` (host wall times of the whole ship and of its
    locked extract); raises a :class:`KVShipError` subclass on any
    failure."""
    from ...common.config import check_transport, get_config
    from ..frontend import OP_KV_BLOCKS, _connect

    cfg = get_config()
    check_transport(transport or cfg.transport)
    ids = parked["ids"]
    n = len(ids)
    geom = pool_geometry(engine)
    t0 = time.monotonic()
    # one gather + host copy for the whole ship; block i's payload is
    # row i of it, sent as a view
    rows = engine.extract_kv_payloads(ids)
    extract_ms = (time.monotonic() - t0) * 1e3
    try:
        sock = _connect(addr, cfg.disagg_ship_timeout_ms / 1e3)
    except OSError as e:
        raise KVShipAbortedError(
            f"decode replica {addr} unreachable for KV ship: {e}") from e
    total = 0
    try:
        try:
            for i in range(n):
                view = _payload_view(rows[i])
                plen = len(view)
                meta = {"key": key, "i": i, "n": n,
                        "pos": int(parked["pos"]), "geom": geom,
                        "digest": _digest([view])}
                attempts = 0
                while True:
                    _send_buffers(sock, _encode_buffers(
                        OP_KV_BLOCKS, json.dumps(meta), None, raw=view))
                    status, _, _, payload = _decode(sock)
                    if status == 0:
                        break
                    msg = bytes(payload).decode()
                    ename = msg.split(":", 1)[0].strip()
                    if (ename == "KVShipDigestError"
                            and attempts < cfg.disagg_ship_retries):
                        attempts += 1
                        bps_log.warning(
                            "disagg ship %s: block %d/%d digest refused, "
                            "retry %d", key, i, n, attempts)
                        continue
                    raise _TYPED_SHIP_ERRORS.get(
                        ename, KVShipAbortedError)(msg)
                total += plen
                if metrics is not None:
                    metrics.bump(sm.KV_BLOCKS_SHIPPED)
                    metrics.bump(sm.KV_BLOCKS_SHIPPED_BYTES, plen)
                hook = on_block_sent
                if hook is not None:
                    hook(key, i, n)
        except (ConnectionError, OSError, ValueError) as e:
            raise KVShipAbortedError(
                f"KV ship {key} to {addr} died after {total} bytes: "
                f"{type(e).__name__}: {e}") from e
    finally:
        try:
            sock.close()
        except OSError:
            pass
    ship_s = time.monotonic() - t0
    if metrics is not None:
        metrics._hist("ship").observe(ship_s)
    return {"shipped": True, "blocks": n, "bytes": total,
            "ms": ship_s * 1e3, "extract_ms": extract_ms}


class _Staged:
    __slots__ = ("ids", "n", "pos", "next", "t", "buf")


class KVStager:
    """Decode-side receiver: verifies, stages, and hands over shipped
    KV blocks.

    A ship's blocks are allocated from the engine's pool UP FRONT at
    block 0 (``BlocksExhaustedError`` propagates typed — the sender
    aborts and the router re-prefills).  Each verified frame's payload
    is kept in the staging's host buffer, and the last one writes the
    whole ship into those blocks in one copy
    (``ServingEngine.write_kv_payloads``): a block's write would
    otherwise cost one host-side op a cache tensor, which a process
    serving decode ticks pays for dearly.
    ``take(key)`` consumes a COMPLETE staging for the decode dispatch's
    adoption; a partial one is released, never adopted.  Stranded
    entries (the router died between ship and dispatch, or the request
    finished at the prefill leg) are TTL-swept."""

    def __init__(self, engine, ttl: float = 60.0):
        self.engine = engine
        self.ttl = ttl
        self._lock = threading.Lock()
        self._entries: Dict[str, _Staged] = {}
        self._geom = pool_geometry(engine)
        self._block_bytes = sum(
            int(np.prod(shape)) * dt.itemsize
            for layer in engine.kv_block_schema() for _, shape, dt in layer)

    # ------------------------------------------------------------- wire

    def handle(self, name: str, payload) -> bytes:
        """One OP_KV_BLOCKS frame -> one encoded reply frame.  Typed
        ship errors ride status=1 with the error-name prefix the sender
        maps back; anything else propagates to the handler's generic
        error reply."""
        try:
            ack = self._accept(name, payload)
        except KVShipError as e:
            return _encode(1, "", None,
                           f"{type(e).__name__}: {e}".encode())
        return _encode(0, "", None, json.dumps(ack).encode())

    def _accept(self, name: str, payload) -> dict:
        meta = json.loads(name)
        key, i, n = str(meta["key"]), int(meta["i"]), int(meta["n"])
        if meta.get("geom") != self._geom:
            raise KVShipGeometryError(
                f"pool geometry mismatch: ship says {meta.get('geom')!r},"
                f" this pool is {self._geom!r}")
        if len(payload) != self._block_bytes:
            raise KVShipGeometryError(
                f"block payload is {len(payload)} bytes, this pool's "
                f"blocks are {self._block_bytes}")
        self.sweep()
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                if i != 0:
                    raise KVShipSequenceError(
                        f"block {i} for unknown ship {key} — torn "
                        f"staging refused")
                ent = _Staged()
                # allocate the WHOLE staging up front: a mid-ship pool
                # exhaustion would strand a half-written staging
                ent.ids = self.engine.stage_alloc(n)
                ent.n = n
                ent.pos = int(meta["pos"])
                ent.next = 0
                ent.t = time.monotonic()
                ent.buf = bytearray(n * self._block_bytes)
                self._entries[key] = ent
            if i != ent.next:
                stale = self._entries.pop(key)
                self.engine.release_kv_ids(stale.ids)
                raise KVShipSequenceError(
                    f"ship {key}: got block {i}, expected {ent.next} — "
                    f"staging aborted")
        # digest + write OUTSIDE the stager lock (hash and copy are the
        # slow parts; frames for one key are serial on their connection,
        # so ent is not contended)
        h = hashlib.blake2b(digest_size=16)
        h.update(payload)
        if h.hexdigest() != meta.get("digest"):
            # expected index unchanged: the sender resends this block
            raise KVShipDigestError(
                f"ship {key} block {i}/{n}: payload digest mismatch")
        nb = self._block_bytes
        ent.buf[i * nb:(i + 1) * nb] = payload
        if i == n - 1:
            self.engine.write_kv_payloads(ent.ids, ent.buf)
            ent.buf = None
        with self._lock:
            if self._entries.get(key) is ent:
                ent.next = i + 1
                ent.t = time.monotonic()
        return {"i": i, "complete": bool(ent.next >= n)}

    # --------------------------------------------------------- handover

    def take(self, key: str) -> Optional[dict]:
        """Claim the staged entry for ``key``.  A COMPLETE staging
        transfers block ownership to the caller (``{"ids", "pos"}``);
        a partial or unknown one returns None (partials are released
        here — the torn ship is never attended)."""
        with self._lock:
            ent = self._entries.pop(key, None)
        if ent is None:
            return None
        if ent.next >= ent.n:
            return {"ids": ent.ids, "pos": ent.pos}
        bps_log.warning(
            "disagg: ship %s claimed at %d/%d blocks — releasing the "
            "torn staging, decode falls back to re-prefill",
            key, ent.next, ent.n)
        self.engine.release_kv_ids(ent.ids)
        return None

    def sweep(self) -> int:
        """Release stagings idle past the TTL (the router died between
        ship and dispatch, or the request needed no decode leg)."""
        now = time.monotonic()
        dead = []
        with self._lock:
            for k in list(self._entries):
                if now - self._entries[k].t > self.ttl:
                    dead.append(self._entries.pop(k))
        for ent in dead:
            self.engine.release_kv_ids(ent.ids)
        return len(dead)

    def stats(self) -> dict:
        with self._lock:
            return {"staged": len(self._entries)}
