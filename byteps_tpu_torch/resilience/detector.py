"""Heartbeat failure detector — the port's copy of
``byteps_tpu/resilience/detector.py``.  A "shard" is whatever the caller
numbers: the serving router's replicas, or its peer routers.

A daemon thread pings every shard each ``interval`` seconds via a
caller-supplied ``ping_fn(shard) -> bool`` (the router supplies a
one-shot short-timeout ``OP_PING`` round-trip, so heartbeats never
contend with in-flight data legs).  A shard is
declared DOWN after ``miss_threshold`` consecutive misses and UP again
on the first successful ping; transitions fire ``on_down(shard)`` /
``on_up(shard)`` callbacks outside the detector's lock (the router
migration work they trigger may itself do RPCs).

RPC paths can feed observed failures in via ``report_failure`` so a
dead shard is detected at the speed of traffic, not only at heartbeat
cadence.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from ..common import logging as bps_log
from . import counters as cn


class FailureDetector:
    def __init__(
        self,
        num_shards: int,
        ping_fn: Callable[[int], bool],
        interval: float = 0.5,
        miss_threshold: int = 3,
        on_down: Optional[Callable[[int], None]] = None,
        on_up: Optional[Callable[[int], None]] = None,
        counters=None,
    ):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.num_shards = num_shards
        self._ping = ping_fn
        self.interval = max(0.01, interval)
        self.miss_threshold = max(1, miss_threshold)
        self._on_down = on_down
        self._on_up = on_up
        self._counters = counters if counters is not None else cn.get_counters()
        self._lock = threading.Lock()
        self._misses: Dict[int, int] = {i: 0 for i in range(num_shards)}
        self._down: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- lifecycle

    def start(self) -> "FailureDetector":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="bps-heartbeat", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # ----------------------------------------------------------------- state

    def is_up(self, shard: int) -> bool:
        with self._lock:
            return shard not in self._down

    def down_shards(self) -> List[int]:
        with self._lock:
            return sorted(self._down)

    def grow(self, n: int = 1) -> int:
        """Extend the monitored range by ``n`` shards (elastic serving
        tiers add replicas at runtime).  New shards start with a clean
        miss count; the heartbeat loop picks them up on its next pass.
        Returns the new shard count."""
        if n < 1:
            raise ValueError("n must be >= 1")
        with self._lock:
            for i in range(self.num_shards, self.num_shards + n):
                self._misses[i] = 0
            self.num_shards += n
            return self.num_shards

    # ------------------------------------------------------------ transitions

    def report_failure(self, shard: int) -> None:
        """An RPC to ``shard`` failed at the wire level — count it as a
        heartbeat miss so detection tracks traffic, not just the ping
        cadence."""
        self._observe(shard, ok=False)

    def report_success(self, shard: int) -> None:
        self._observe(shard, ok=True)

    def mark_down(self, shard: int) -> None:
        """Force a shard down without firing ``on_down`` — used when the
        caller (router/RPC path) already initiated the failover and only
        needs the detector to watch for recovery."""
        with self._lock:
            self._misses[shard] = max(self._misses[shard],
                                      self.miss_threshold)
            self._down.add(shard)

    def _observe(self, shard: int, ok: bool) -> None:
        fire_down = fire_up = False
        with self._lock:
            if ok:
                self._misses[shard] = 0
                if shard in self._down:
                    self._down.discard(shard)
                    fire_up = True
            else:
                self._misses[shard] += 1
                if (shard not in self._down
                        and self._misses[shard] >= self.miss_threshold):
                    self._down.add(shard)
                    fire_down = True
        if not ok:
            self._counters.bump(cn.HEARTBEAT_MISS, shard=shard)
        if fire_down:
            self._counters.bump(cn.SHARD_DOWN, shard=shard)
            bps_log.warning("heartbeat: shard %d DOWN (%d consecutive misses)",
                            shard, self.miss_threshold)
            if self._on_down is not None:
                self._on_down(shard)
        if fire_up:
            self._counters.bump(cn.SHARD_UP, shard=shard)
            bps_log.warning("heartbeat: shard %d UP", shard)
            if self._on_up is not None:
                self._on_up(shard)

    # ------------------------------------------------------------------ loop

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            with self._lock:
                count = self.num_shards  # grow() moves it at runtime
            for shard in range(count):
                if self._stop.is_set():
                    return
                try:
                    ok = bool(self._ping(shard))
                except Exception:
                    ok = False
                self._observe(shard, ok)
