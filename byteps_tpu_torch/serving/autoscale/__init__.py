"""Elastic capacity subsystem: the closed loop from observed tier load
to replica count and per-request admission (docs/serving.md "Elastic
capacity & SLO classes") — the port's copy of
``byteps_tpu/serving/autoscale``.

Layout mirrors the control loop:

  * :mod:`signals` — ``TierSignals``: windowed samples of queue depth,
    utilization, TTFT p99, credit starvation and KV pressure, polled
    from the router in-process or from replica ``OP_STATS``.
  * :mod:`policy` — ``ScalePolicy``: pure hysteresis-banded target
    tracking emitting typed ``ScaleDecision``s (injected clock — the
    tier-1 tests drive it on scripted traces).
  * :mod:`actuator` — ``ReplicaLauncher`` + ``AutoscaleController``:
    spawn through ``byteps_tpu_torch.launcher``, register via the
    weights-fingerprint handshake, retire via zero-client-error
    ``drain()``; scale events
    journaled so router takeover mid-scale is safe.
  * :mod:`admission` — SLO classes (``guaranteed``/``standard``/
    ``best-effort``), deadline-aware shedding (typed
    ``OverloadShedError``), and work-conserving tenant shares
    (borrow idle credits, clawback on demand).
"""

from .admission import (SLO_BEST_EFFORT, SLO_CLASSES, SLO_GUARANTEED,
                        SLO_STANDARD, AdmissionController, Lease,
                        OverloadShedError, TenantShares, normalize_slo)
from .actuator import (AUTOSCALE_REPLICAS, SCALE_EVENTS,
                       AutoscaleController, ReplicaHandle,
                       ReplicaLauncher)
from .policy import ScaleDecision, ScalePolicy
from .signals import (SignalAggregate, SignalSample, TierSignals,
                      poll_replicas, poll_router)

__all__ = [
    "SLO_GUARANTEED", "SLO_STANDARD", "SLO_BEST_EFFORT", "SLO_CLASSES",
    "normalize_slo", "OverloadShedError", "AdmissionController",
    "Lease", "TenantShares",
    "ScaleDecision", "ScalePolicy",
    "SignalSample", "SignalAggregate", "TierSignals", "poll_router",
    "poll_replicas",
    "AUTOSCALE_REPLICAS", "SCALE_EVENTS", "ReplicaHandle",
    "ReplicaLauncher", "AutoscaleController",
]
