"""Resilience subsystem — the port's copy of ``byteps_tpu/resilience``:
retry pacing, failure detection, degraded-mode routing and
deterministic fault injection, as the serving router tier and the
parameter-server client use them.

  * ``RetryPolicy`` (policy.py) — bounded exponential backoff + jitter
    with a per-op deadline;
  * ``FailureDetector`` (detector.py) — a heartbeat thread pinging
    numbered endpoints, publishing per-endpoint health and firing
    down/up callbacks;
  * ``DegradedModeRouter`` (router.py) — excludes dead endpoints from
    placement (deterministic next-alive remap via
    ``ServerSharder.remap``);
  * ``FaultInjectingProxy`` (chaos.py) — a frame-aware TCP shim that
    drops / delays / garbles / resets / cuts individual requests
    deterministically (tests and chaos runs only);
  * ``ResilienceCounters`` (counters.py) — retries, heartbeat misses,
    failovers, ... in the metrics registry.

The router sets its own policy, detectors and ping bound
(``BYTEPS_ROUTER_*``, ``BYTEPS_HEARTBEAT_TIMEOUT_MS``); the
parameter-server client (``engine/ps_server.py:RemoteStore``) takes the
``BYTEPS_RETRY_*`` knobs through ``RetryPolicy.from_config`` and the
``BYTEPS_HEARTBEAT_*`` ones for its detector.
"""

from .counters import ResilienceCounters, get_counters, reset_counters
from .detector import FailureDetector
from .policy import RetryPolicy
from .router import DegradedModeRouter
from .chaos import FaultInjectingProxy

__all__ = [
    "ResilienceCounters",
    "get_counters",
    "reset_counters",
    "FailureDetector",
    "RetryPolicy",
    "DegradedModeRouter",
    "FaultInjectingProxy",
]
