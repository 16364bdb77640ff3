"""SLO-aware admission: priority classes, deadline-aware shedding, and
work-conserving tenant shares (docs/serving.md "Elastic capacity & SLO
classes") — the port's copy of ``byteps_tpu/serving/autoscale/admission.py``.

Three pieces, all wired into ``ServeRouter.stream``:

  * **SLO classes** — the ``slo=`` submit param: ``guaranteed`` /
    ``standard`` / ``best-effort``.  Classes are a *shedding* order,
    not a scheduling order: the engine-level priority field still
    orders work once admitted.
  * **Deadline-aware shedding** — ``AdmissionController.admit``
    estimates queue wait from the live backlog and an EWMA of recent
    service times (``est = backlog x service / capacity`` — the same
    M/M/c-shaped estimate vLLM-style schedulers use) and raises the
    typed, retryable :class:`OverloadShedError` at the door when the
    class's deadline cannot be met.  ``guaranteed`` has an infinite
    deadline by default: it is never shed, it queues — the whole point
    of shedding best-effort is to keep the guaranteed queue short.
  * **Work-conserving shares** — :class:`TenantShares` wraps the
    router's strict per-tenant credit pools: a tenant whose own pool is
    empty may *borrow* an idle credit from a tenant with no waiters,
    recorded as a loan.  When the lender comes back and starves,
    ``clawback`` flags the youngest reclaimable (best-effort) loan;
    the router aborts that in-flight stream with ``OverloadShedError``
    (the engine's preemption, one tier up) and the credit flows home.
    Guaranteed/standard borrowers are never reclaimed mid-flight —
    the lender waits at most one service time for those.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..scheduler import AdmissionError

__all__ = ["SLO_GUARANTEED", "SLO_STANDARD", "SLO_BEST_EFFORT",
           "SLO_CLASSES", "normalize_slo", "OverloadShedError",
           "AdmissionController", "Lease", "TenantShares"]

SLO_GUARANTEED = "guaranteed"
SLO_STANDARD = "standard"
SLO_BEST_EFFORT = "best-effort"
SLO_CLASSES = (SLO_GUARANTEED, SLO_STANDARD, SLO_BEST_EFFORT)


def normalize_slo(value: Optional[str],
                  default: str = SLO_STANDARD) -> str:
    """Map a wire ``slo`` param to a class name; ``None``/empty means
    the default.  Unknown classes are a *typed* admission failure — a
    typo'd class must not silently become standard."""
    if not value:
        return default
    v = str(value).strip().lower().replace("_", "-")
    if v not in SLO_CLASSES:
        raise AdmissionError(
            f"unknown slo class {value!r}; expected one of "
            f"{'/'.join(SLO_CLASSES)}")
    return v


class OverloadShedError(AdmissionError):
    """Typed at-the-door shed: the request's SLO deadline cannot be met
    at the current backlog (or its borrowed credit was clawed back).
    ``retryable`` is True — the client should back off and retry; the
    request was never placed, so a retry is always safe."""

    retryable = True

    def __init__(self, slo: str, est_wait_s: float, deadline_s: float,
                 reason: str = "backlog"):
        self.slo = slo
        self.est_wait_s = float(est_wait_s)
        self.deadline_s = float(deadline_s)
        self.reason = reason
        super().__init__(
            f"shed {slo} request ({reason}): estimated queue wait "
            f"{est_wait_s:.2f}s exceeds deadline {deadline_s:.2f}s; "
            f"retry with backoff")


class AdmissionController:
    """Deadline-aware shedding at the router door.

    ``deadlines`` maps SLO class -> max tolerable queue wait in
    seconds (``float('inf')`` = never shed).  ``note_service`` feeds an
    EWMA of observed per-request service times; until the first
    completion, ``service_estimate_s`` seeds it.
    """

    _ALPHA = 0.2  # EWMA weight of the newest observation

    def __init__(self, deadlines: Optional[Dict[str, float]] = None,
                 service_estimate_s: float = 0.5):
        self.deadlines = {SLO_GUARANTEED: float("inf"),
                          SLO_STANDARD: 10.0,
                          SLO_BEST_EFFORT: 1.0}
        if deadlines:
            self.deadlines.update(deadlines)
        self._service_s = float(service_estimate_s)
        self._lock = threading.Lock()
        self.shed_count: Dict[str, int] = {c: 0 for c in SLO_CLASSES}

    def note_service(self, seconds: float) -> None:
        with self._lock:
            self._service_s += self._ALPHA * (float(seconds)
                                              - self._service_s)

    @property
    def service_estimate_s(self) -> float:
        with self._lock:
            return self._service_s

    def estimate_wait(self, inflight: int, queued: int,
                      capacity: int) -> float:
        """Queue-wait estimate for the NEXT arrival: requests beyond
        capacity wait, draining ``capacity`` at a time, one EWMA
        service time per drain round."""
        backlog = inflight + queued + 1 - max(1, capacity)
        if backlog <= 0:
            return 0.0
        return backlog * self.service_estimate_s / max(1, capacity)

    def admit(self, slo: str, inflight: int, queued: int,
              capacity: int) -> float:
        """Admit or raise :class:`OverloadShedError`.  Returns the wait
        estimate so callers can log it."""
        est = self.estimate_wait(inflight, queued, capacity)
        deadline = self.deadlines.get(slo, self.deadlines[SLO_STANDARD])
        if est > deadline:
            with self._lock:
                self.shed_count[slo] = self.shed_count.get(slo, 0) + 1
            raise OverloadShedError(slo, est, deadline)
        return est


class Lease:
    """One admitted stream's credit: from the tenant's own pool
    (``lender is None``) or borrowed from ``lender``'s.  ``reclaimed``
    flips under the shares lock when clawback targets this loan; the
    router's per-token pace check treats it like a cancel and sheds
    the stream typed."""

    __slots__ = ("tenant", "lender", "reclaimable", "reclaimed")

    def __init__(self, tenant: str, lender: Optional[str],
                 reclaimable: bool = False):
        self.tenant = tenant
        self.lender = lender
        self.reclaimable = reclaimable
        self.reclaimed = False

    @property
    def borrowed(self) -> bool:
        return self.lender is not None


class TenantShares:
    """Work-conserving wrapper over the per-tenant credit pools.

    ``pools`` is the router's strict apportionment (tenant ->
    ``ScheduledQueue``).  Strict shares remain the floor: a tenant can
    always (eventually) use its own credits.  Idle credits are lent —
    never to a pool with live waiters — and clawed back on demand.
    """

    def __init__(self, pools: Dict[str, object], borrow: bool = True,
                 on_borrow: Optional[Callable[[str, str], None]] = None):
        self._pools = pools
        self._borrow = bool(borrow)
        self._on_borrow = on_borrow
        self._lock = threading.Lock()
        self._waiters: Dict[str, int] = {t: 0 for t in pools}
        # outstanding loans keyed by LENDER, youngest last
        self._loans: Dict[str, List[Lease]] = {t: [] for t in pools}
        self.borrowed_total = 0
        self.clawbacks_total = 0

    # ----------------------------------------------------------- acquire

    def acquire(self, tenant: str, reclaimable: bool = False,
                timeout: float = 0.0,
                should_abort: Optional[Callable[[], bool]] = None
                ) -> Optional[Lease]:
        """One admission credit for ``tenant``.  Own pool first, then a
        borrow from an idle tenant, then block on the own pool (clawing
        outstanding loans we made) until ``timeout``.  Returns None on
        timeout or when ``should_abort()`` goes true (the caller owns
        the typed error); a tenant with no configured pool gets a free
        lease — unknown tenants were never gated (the strict pools'
        semantics)."""
        pool = self._pools.get(tenant)
        if pool is None:
            return Lease(tenant, None, reclaimable)
        if pool.try_debit(1):
            return Lease(tenant, None, reclaimable)
        lease = self._try_borrow(tenant, reclaimable)
        if lease is not None:
            return lease
        # strict-share floor: block on our own pool; flag one of OUR
        # outstanding loans per wait chunk so borrowed credits flow home
        deadline = time.monotonic() + max(0.0, timeout)
        with self._lock:
            self._waiters[tenant] = self._waiters.get(tenant, 0) + 1
        try:
            while True:
                self.clawback(tenant)
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                if should_abort is not None and should_abort():
                    return None
                if pool.debit_wait(1, min(0.05, left)):
                    return Lease(tenant, None, reclaimable)
        finally:
            with self._lock:
                self._waiters[tenant] -= 1

    def _try_borrow(self, tenant: str,
                    reclaimable: bool) -> Optional[Lease]:
        if not self._borrow:
            return None
        with self._lock:
            candidates = [(t, p) for t, p in self._pools.items()
                          if t != tenant
                          and self._waiters.get(t, 0) == 0]
        for t, p in candidates:
            if p.try_debit(1):
                lease = Lease(tenant, t, reclaimable)
                with self._lock:
                    self._loans.setdefault(t, []).append(lease)
                    self.borrowed_total += 1
                if self._on_borrow is not None:
                    self._on_borrow(tenant, t)
                return lease
        return None

    # ----------------------------------------------------------- release

    def release(self, lease: Optional[Lease]) -> None:
        """Return the lease's credit: borrowed credits flow back to the
        LENDER's pool (that is the entire clawback mechanism — the
        starved lender's ``debit_wait`` wakes on this credit)."""
        if lease is None:
            return
        if lease.borrowed:
            with self._lock:
                loans = self._loans.get(lease.lender)
                if loans is not None and lease in loans:
                    loans.remove(lease)
            pool = self._pools.get(lease.lender)
        else:
            pool = self._pools.get(lease.tenant)
        if pool is not None:
            pool.credit(1)

    # ---------------------------------------------------------- clawback

    def clawback(self, lender: str, need: int = 1) -> int:
        """Flag up to ``need`` reclaimable loans lent BY ``lender``
        (youngest first — the engine's preemption order: the newest work
        has the least sunk cost).  The flagged streams shed themselves
        at their next pace check; their release credits the lender.
        Returns how many loans were flagged."""
        flagged = 0
        with self._lock:
            for lease in reversed(self._loans.get(lender, [])):
                if flagged >= need:
                    break
                if lease.reclaimable and not lease.reclaimed:
                    lease.reclaimed = True
                    flagged += 1
            self.clawbacks_total += flagged
        return flagged

    # ------------------------------------------------------------- stats

    def outstanding_loans(self, lender: Optional[str] = None) -> int:
        with self._lock:
            if lender is not None:
                return len(self._loans.get(lender, []))
            return sum(len(v) for v in self._loans.values())

    def waiters(self, tenant: str) -> int:
        with self._lock:
            return self._waiters.get(tenant, 0)
