"""Degraded-mode key routing around dead shards — the port's copy of
``byteps_tpu/resilience/router.py``.  The serving router remaps a dead
replica's prefix groups through it; the parameter-server client (a
later port) uses the failover ledger below as well.

Placement stays the reference formula (``ServerSharder.place``); this
router only *excludes* shards currently marked down, remapping their
keys to the deterministic next alive shard (``ServerSharder.remap`` —
every worker computes the same fallback without coordination, the same
property the original placement formula has).

The router also keeps the failover ledger: which tensor names are
currently being served by a fallback shard on behalf of which primary
(the JAX ``RemoteStore`` records entries when it re-inits a tensor on a
fallback and drains the ledger during recovery migration).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

from ..common.context import ServerSharder
from . import counters as cn


class DegradedModeRouter:
    def __init__(self, num_shards: int, counters=None):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.num_shards = num_shards
        self._counters = counters if counters is not None else cn.get_counters()
        self._lock = threading.Lock()
        self._down: set = set()
        # name -> (primary shard, fallback shard) for keys re-homed while
        # their primary was down
        self._failed_over: Dict[str, Tuple[int, int]] = {}

    # ----------------------------------------------------------------- state

    def is_degraded(self) -> bool:
        with self._lock:
            return bool(self._down)

    def is_down(self, shard: int) -> bool:
        with self._lock:
            return shard in self._down

    def down_shards(self) -> List[int]:
        with self._lock:
            return sorted(self._down)

    def grow(self, n: int = 1) -> int:
        """Extend the routable range by ``n`` shards (elastic serving
        tiers add replicas at runtime).  Remap targets recompute from
        the new count on the next ``route`` call.  Returns the new
        shard count."""
        if n < 1:
            raise ValueError("n must be >= 1")
        with self._lock:
            self.num_shards += n
            return self.num_shards

    def mark_down(self, shard: int) -> bool:
        """Exclude ``shard`` from routing; True if this call changed
        state (callers bump the failover counter only on the edge)."""
        with self._lock:
            if shard in self._down:
                return False
            if len(self._down) + 1 >= self.num_shards:
                # never exclude the last shard: with nowhere to fail over
                # to, callers should keep retrying the primary instead
                return False
            self._down.add(shard)
            return True

    def mark_up(self, shard: int) -> bool:
        with self._lock:
            if shard not in self._down:
                return False
            self._down.discard(shard)
            return True

    # --------------------------------------------------------------- routing

    def route(self, primary: int) -> int:
        """Shard that currently serves keys whose placement is
        ``primary`` — the primary itself when healthy, else the
        deterministic next alive shard."""
        with self._lock:
            if primary not in self._down:
                return primary
            return ServerSharder.remap(primary, self._down, self.num_shards)

    # -------------------------------------------------------- failover ledger

    def note_failover(self, name: str, primary: int, fallback: int) -> None:
        with self._lock:
            self._failed_over[name] = (primary, fallback)

    def fallback_for(self, name: str):
        """Current fallback shard serving ``name``, or None when the
        name is not failed over."""
        with self._lock:
            entry = self._failed_over.get(name)
            return None if entry is None else entry[1]

    def failed_over_names(self, primary: int) -> List[Tuple[str, int]]:
        """(name, fallback) pairs currently re-homed away from
        ``primary``."""
        with self._lock:
            return [(n, fb) for n, (p, fb) in self._failed_over.items()
                    if p == primary]

    def clear_failover(self, name: str) -> None:
        with self._lock:
            self._failed_over.pop(name, None)
