"""Router-HA journal transport: the active router's state stream — the
port's copy of ``byteps_tpu/serving/journal.py``.  Its entries are the
JAX package's, so a JAX standby folds a port active's journal and the
reverse.

The active :class:`~byteps_tpu_torch.serving.router.ServeRouter` replicates a
compact journal to its standby peers over the existing serve wire
(``frontend.py`` ``OP_JOURNAL`` — one frame per batch, one ack per
frame), so a standby that takes over already holds the affinity map,
the replica health/fingerprint verdicts, and the per-request in-flight
records (id, seed, params, replica, emitted-token COUNT — counts, not
tokens: the client holds the tokens and re-supplies them as
``resume_tokens`` on failover).  Entry layout and application live in
``router.py`` (``ServeRouter.apply_journal``); this module is only the
transport:

  * **Asynchronous, bounded, honest.**  ``publish()`` enqueues and
    returns — journaling must never sit on the dispatch path.  The
    queue is bounded; overflow drops the OLDEST batch and counts it
    (``dropped``), because a slow standby must throttle replication
    fidelity, not the serving tier.  The recovery contract tolerates
    loss by design: anything between the last applied entry and the
    takeover is recovered from the clients' ``resume_tokens``, not the
    journal (docs/serving.md "Router HA" — the honest window).
  * **Per-peer isolation.**  A dead or lagging standby costs its own
    connection a timeout and a reconnect on the next batch; other
    peers and the active's dispatch path never notice.
  * **Split-brain discovery on the ack.**  Every journal ack carries
    the receiver's epoch.  A receiver answering with a HIGHER epoch
    than the sender's means a takeover already happened — the sender
    is deposed and must demote (``on_stale`` callback), mirroring the
    replica-side ``EpochFencedError`` fence one tier up.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..common import logging as bps_log

__all__ = ["JournalSender"]

_BATCH_MAX = 256


class JournalSender:
    """Fan journal entries out to the standby peers (daemon thread).

    ``epoch_of`` is read per batch (the router's CURRENT epoch — the
    ack comparison must track promotions); ``on_stale(higher_epoch)``
    fires when any peer acks with a higher epoch than ours."""

    def __init__(self, peers: Sequence[str], *, timeout: float = 1.0,
                 epoch_of: Callable[[], int] = lambda: 0,
                 on_stale: Optional[Callable[[int], None]] = None,
                 snapshot_fn: Optional[Callable[[], List[dict]]] = None,
                 max_queue: int = 4096):
        self.peers = list(peers)
        self.timeout = timeout
        self._epoch_of = epoch_of
        self._on_stale = on_stale
        # full-state dump sent to a peer on every (re)connect: a
        # standby that boots AFTER the active (or drops and comes
        # back) must not miss the verdicts/affinity that were
        # journaled while it was away
        self._snapshot_fn = snapshot_fn
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._conns: Dict[str, object] = {}
        # per-peer reconnect backoff: a dead standby must cost at most
        # one connect timeout per backoff window, not one per batch
        # (head-of-line isolation for the healthy peers); batches
        # skipped while a peer is down are recovered by the snapshot
        # its reconnect always starts with
        self._down_until: Dict[str, float] = {}
        self.retry_after = max(0.2, timeout)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._idle = threading.Condition()
        self._inflight = 0
        self.dropped = 0
        self.sent = 0

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "JournalSender":
        if self._thread is None and self.peers:
            self._thread = threading.Thread(
                target=self._loop, name="bps-router-journal", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        for c in self._conns.values():
            try:
                c.close()
            except OSError:
                pass
        self._conns.clear()

    def kill(self) -> None:
        """Crash semantics (chaos): stop NOW and drop everything still
        queued — a crashed router flushes nothing, and the takeover
        contract must be proven against exactly that (the standby's
        orphaned in-flight records are recovered from client
        ``resume_tokens``, not from a last-gasp flush)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
                self.dropped += 1
        except queue.Empty:
            pass
        with self._idle:
            self._inflight = 0
            self._idle.notify_all()

    # -------------------------------------------------------------- produce

    def publish(self, entry: dict) -> None:
        """Enqueue one journal entry (never blocks the caller).  On
        overflow the OLDEST entry is dropped and counted — replication
        lag must never backpressure dispatch."""
        with self._idle:
            self._inflight += 1
        while True:
            try:
                self._q.put_nowait(entry)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()
                    self.dropped += 1
                    with self._idle:
                        self._inflight -= 1
                except queue.Empty:
                    pass

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until every published entry has been offered to every
        peer (or ``timeout``).  Test/diagnostic hook — production
        callers rely on the honest-window contract instead."""
        with self._idle:
            return self._idle.wait_for(lambda: self._inflight == 0,
                                       timeout)

    # --------------------------------------------------------------- consume

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                # idle tier: still (re)connect+snapshot disconnected
                # peers — a standby that boots AFTER the active (with
                # no traffic flowing) must not sit cold until the
                # first dispatch happens to publish something
                self._probe_disconnected()
                continue
            batch: List[dict] = [first]
            while len(batch) < _BATCH_MAX:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            try:
                self._send_batch(batch)
            finally:
                with self._idle:
                    self._inflight -= len(batch)
                    self._idle.notify_all()

    def _ensure_conn(self, peer: str, snap: Optional[list] = None):
        """(Re)connect one peer, sending the full-state snapshot first
        (the snapshot reflects NOW, so everything a downed peer missed
        is covered; ``snap`` lets a caller that already built one pass
        it in rather than serializing the state twice).  Returns
        (conn, snapshotted) — conn None while the peer is in its
        reconnect-backoff window or unreachable."""
        from .frontend import RemoteServeClient

        c = self._conns.get(peer)
        if c is not None:
            return c, False
        if time.monotonic() < self._down_until.get(peer, 0.0):
            return None, False
        c = RemoteServeClient(peer, timeout=self.timeout)
        self._conns[peer] = c
        snapshotted = False
        if self._snapshot_fn is not None:
            if snap is None:
                snap = self._snapshot_fn()
            if snap:
                self._check_ack(c.journal(snap))
                self.sent += len(snap)
                snapshotted = True
        return c, snapshotted

    def _drop_conn(self, peer: str, why: BaseException) -> None:
        bps_log.debug("router journal: peer %s unreachable (%s); "
                      "entries dropped for it until reconnect",
                      peer, why)
        c = self._conns.pop(peer, None)
        if c is not None:
            try:
                c.close()
            except OSError:
                pass
        self._down_until[peer] = time.monotonic() + self.retry_after

    def _probe_disconnected(self) -> None:
        from .frontend import ServeConnectionError, ServeReplyError

        # cheap gates FIRST: the snapshot serializes the whole state
        # under the router lock, so it must not be built on every
        # 100ms idle tick while a crashed peer sits in its backoff
        # window (the normal post-takeover steady state)
        now = time.monotonic()
        due = [p for p in self.peers
               if p not in self._conns
               and now >= self._down_until.get(p, 0.0)]
        if not due:
            return
        snap = (self._snapshot_fn() if self._snapshot_fn is not None
                else None)
        if self._snapshot_fn is not None and not snap:
            return  # nothing to warm peers with (standby / killed)
        for peer in due:
            try:
                self._ensure_conn(peer, snap=snap)
            except (ServeConnectionError, ServeReplyError, OSError,
                    ValueError) as e:
                self._drop_conn(peer, e)

    def _send_batch(self, batch: List[dict]) -> None:
        from .frontend import ServeConnectionError, ServeReplyError

        for peer in self.peers:
            try:
                c, snapshotted = self._ensure_conn(peer)
                if c is None:
                    continue  # backoff window: snapshot covers it later
                if snapshotted:
                    # the snapshot was built NOW, so it already
                    # reflects (supersedes) every entry in this batch —
                    # sending the older batch after it could regress a
                    # replica verdict the snapshot just updated
                    continue
                self._check_ack(c.journal(batch))
                self.sent += len(batch)
            except (ServeConnectionError, ServeReplyError, OSError,
                    ValueError) as e:
                # this peer missed the batch; its journal is behind
                # until the reconnect snapshot — the takeover contract
                # absorbs that (clients re-supply emitted tokens)
                self._drop_conn(peer, e)

    def _check_ack(self, ack: dict) -> None:
        higher = int(ack.get("epoch", 0))
        if higher > self._epoch_of() and self._on_stale:
            # the peer lives in a NEWER epoch: we are deposed
            self._on_stale(higher)
