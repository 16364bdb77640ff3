"""Resilience event counters, surfaced through the metrics registry —
the port's copy of ``byteps_tpu/resilience/counters.py``.

One process-wide ``ResilienceCounters`` instance (``get_counters()``)
accumulates named monotonic counts in the shared
:class:`~byteps_tpu_torch.observability.metrics.MetricsRegistry` (the
global instance for ``get_counters()``, a private one per standalone
``ResilienceCounters()``), so a STATS reply sees retry/failover activity
as it happens.  The JAX package also mirrors every bump onto its
chrome-trace ``Tracer``; the port has no tracer, so a bump's keyword
arguments are logged at debug level and otherwise dropped.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..common import logging as bps_log
from ..observability.metrics import MetricsRegistry, get_registry

# canonical counter names (free-form names are allowed; these are the
# ones the subsystem itself emits)
RETRY = "resilience.retry"
RECONNECT = "resilience.reconnect"
# a connection reset failed a whole un-acked in-flight window of the
# pipelined wire client (engine/wire.py) — every request in it re-enters
# its own retry/version-guard machinery
WINDOW_ABORT = "resilience.window_abort"
HEARTBEAT_MISS = "resilience.heartbeat_miss"
SHARD_DOWN = "resilience.shard_down"
SHARD_UP = "resilience.shard_up"
FAILOVER = "resilience.failover"
FAILBACK = "resilience.failback"
REINIT = "resilience.reinit"
GIVE_UP = "resilience.give_up"
DEDUP = "resilience.retry_dedup"  # retried mutation found already applied
DISPATCH_FAILURE = "resilience.engine_dispatch_failure"
TASK_FAILURE = "resilience.engine_task_failure"


class ResilienceCounters:
    """Thread-safe monotonic counters, registry-backed.

    ``registry=None`` builds a private :class:`MetricsRegistry` —
    isolated counting for tests/benches, the semantics standalone
    instances always had.  ``get_counters()`` binds the process-global
    registry so the scrape endpoints see resilience activity."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._registry = (registry if registry is not None
                          else MetricsRegistry())
        # names this instance has bumped: snapshot() reports exactly
        # what went through *this* instance, even on a shared registry
        self._names: Dict[str, None] = {}
        self._lock = threading.Lock()

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry

    def bump(self, counter: str, n: int = 1, **args) -> int:
        with self._lock:
            self._names.setdefault(counter, None)
        total = self._registry.counter(counter, track="resilience").inc(
            n, **args)
        bps_log.debug("%s -> %d %s", counter, total, args or "")
        return total

    def get(self, name: str) -> int:
        m = self._registry.get(name)
        return m.value if m is not None else 0

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            names = list(self._names)
        return {n: self.get(n) for n in names}


_counters: Optional[ResilienceCounters] = None
_counters_lock = threading.Lock()


def get_counters() -> ResilienceCounters:
    global _counters
    with _counters_lock:
        if _counters is None:
            _counters = ResilienceCounters(registry=get_registry())
        return _counters


def reset_counters() -> None:
    """Forget the singleton AND its counts.  The backing metrics live in
    the process-global registry, which outlives the singleton — without
    explicit removal a rebuilt ``get_counters()`` would resolve the same
    metric objects and report pre-reset totals."""
    global _counters
    with _counters_lock:
        inst, _counters = _counters, None
    if inst is not None:
        for n in inst.snapshot():
            inst.registry.remove(n)
