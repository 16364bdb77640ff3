"""Tier load signals for the autoscaling control loop — the port's copy
of ``byteps_tpu/serving/autoscale/signals.py``.

``TierSignals`` turns point-in-time polls of the serving tier into the
windowed aggregate the :class:`~.policy.ScalePolicy` tracks.  The poll
itself is a seam (``poll_fn``) so every layer can feed it:

  * ``poll_router(router)`` — the cheap in-process source: the
    router's own ``signal_snapshot()`` (inflight vs placeable credit
    capacity, admission-queue depth) — no extra RPCs in the loop.
  * ``poll_replicas(addrs)`` — the wire source: one ``OP_STATS``
    round-trip per replica, folding queue depth, TTFT p99, credit
    starvation (queue-wait p99) and free KV blocks into one sample.
    This is what a controller *outside* the router process would run.
  * scripted lists of samples — what the tier-1 tests inject.

The scalar the policy consumes is ``load``: placeable-tier utilization
plus normalized queue pressure, optionally floored by KV-block
pressure.  1.0 = exactly saturated; above 1.0 work is queueing.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, Optional, Tuple

__all__ = ["SignalSample", "SignalAggregate", "TierSignals",
           "poll_router", "poll_replicas"]


@dataclass(frozen=True)
class SignalSample:
    """One poll of the tier.  ``capacity`` is the placeable tier's
    total credits; ``inflight`` the streams holding one; ``queued`` the
    admitted-but-unplaced streams waiting at the router.  Optional
    fields default to "unknown" (None) and are simply absent from the
    aggregate."""

    inflight: int
    capacity: int
    queued: int = 0
    ttft_p99_s: Optional[float] = None
    queue_wait_p99_s: Optional[float] = None
    kv_blocks_free: Optional[int] = None
    kv_blocks_total: Optional[int] = None

    @property
    def load(self) -> float:
        cap = max(1, self.capacity)
        load = (self.inflight + self.queued) / cap
        if self.kv_blocks_total:
            # KV pressure floors the signal: a tier can be credit-idle
            # yet block-starved (long contexts), and that too is load
            kv_used = 1.0 - (self.kv_blocks_free or 0) / self.kv_blocks_total
            load = max(load, kv_used)
        return load


@dataclass(frozen=True)
class SignalAggregate:
    """Windowed view over recent samples: mean ``load`` (what the
    policy tracks — the mean rides out single-poll spikes; the window
    is the real smoothing knob), plus the worst-case latency signals
    for dashboards and shedding heuristics."""

    load: float
    utilization: float
    queued: int
    capacity: int
    ttft_p99_s: float
    queue_wait_p99_s: float
    n_samples: int


class TierSignals:
    """Windowed sampler: ``sample(now)`` polls once and returns the
    aggregate over the trailing ``window_s`` seconds.  ``now`` is
    injected (like ``ScalePolicy.decide``) so scripted tests control
    the window deterministically."""

    def __init__(self, poll_fn: Callable[[], SignalSample],
                 window_s: float = 5.0):
        self._poll_fn = poll_fn
        self.window_s = float(window_s)
        self._window: Deque[Tuple[float, SignalSample]] = deque()
        self._lock = threading.Lock()

    def sample(self, now: Optional[float] = None) -> SignalAggregate:
        if now is None:
            now = time.monotonic()
        s = self._poll_fn()
        with self._lock:
            self._window.append((now, s))
            while self._window and \
                    self._window[0][0] < now - self.window_s:
                self._window.popleft()
            return self._aggregate_locked()

    def aggregate(self) -> SignalAggregate:
        with self._lock:
            return self._aggregate_locked()

    def _aggregate_locked(self) -> SignalAggregate:
        if not self._window:
            return SignalAggregate(0.0, 0.0, 0, 0, 0.0, 0.0, 0)
        samples = [s for _, s in self._window]
        latest = samples[-1]
        cap = max(1, latest.capacity)
        return SignalAggregate(
            load=sum(s.load for s in samples) / len(samples),
            utilization=latest.inflight / cap,
            queued=latest.queued,
            capacity=latest.capacity,
            ttft_p99_s=max((s.ttft_p99_s or 0.0) for s in samples),
            queue_wait_p99_s=max((s.queue_wait_p99_s or 0.0)
                                 for s in samples),
            n_samples=len(samples))


# ---------------------------------------------------------------- pollers


def poll_router(router) -> Callable[[], SignalSample]:
    """The in-process source: closes over ``ServeRouter`` and reads its
    ``signal_snapshot()`` (no wire traffic)."""

    def _poll() -> SignalSample:
        snap = router.signal_snapshot()
        return SignalSample(**snap)

    return _poll


def poll_replicas(addrs, timeout: float = 2.0,
                  client_factory=None) -> Callable[[], SignalSample]:
    """The ``OP_STATS`` source: one stats round-trip per replica
    address, summed/folded into a tier sample.  An unreachable replica
    contributes nothing this poll (the detector owns liveness — the
    sampler must not double-judge it).  ``client_factory(addr,
    timeout)`` defaults to ``RemoteServeClient`` and is a seam for
    tests."""
    addrs = list(addrs)

    def _poll() -> SignalSample:
        from ..frontend import RemoteServeClient

        factory = client_factory or (
            lambda a, t: RemoteServeClient(a, timeout=t))
        inflight = capacity = queued = 0
        ttft = qwait = 0.0
        kv_free: Optional[int] = None
        kv_total: Optional[int] = None
        for a in addrs:
            try:
                cli = factory(a, timeout)
                try:
                    st: Dict = cli.stats()
                finally:
                    cli.close()
            except Exception:
                continue
            slots = st.get("occupancy")
            # occupancy is a fraction of slots; treat each replica as
            # one unit of capacity at that utilization
            capacity += 1
            inflight += 1 if (slots or 0) >= 1.0 else 0
            queued += int(st.get("queue_depth") or 0)
            ttft = max(ttft, float(st.get("ttft_p99_s") or 0.0))
            qwait = max(qwait, float(st.get("queue_wait_p99_s") or 0.0))
            kv = st.get("kv_blocks")
            if kv:
                kv_free = (kv_free or 0) + int(kv.get("free", 0))
                kv_total = (kv_total or 0) + int(kv.get("n_blocks", 0))
        return SignalSample(inflight=inflight, capacity=capacity,
                            queued=queued, ttft_p99_s=ttft,
                            queue_wait_p99_s=qwait,
                            kv_blocks_free=kv_free,
                            kv_blocks_total=kv_total)

    return _poll
