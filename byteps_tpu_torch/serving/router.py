"""Fault-tolerant serving router: health-checked replica failover with
deterministic request re-dispatch — the port's copy of
``byteps_tpu/serving/router.py``.

The router is host code: a TCP tier over numpy token arrays that never
touches a device (importing and running it creates no CUDA context).
It speaks the JAX package's wire, placement hash and journal, so it
drives this package's serve replicas (``frontend.py``) or the JAX
package's, gives the same replica order for the same prompts and
addresses, and exchanges journals with a JAX router in both directions.
The JAX router's Prometheus scrape (``BYTEPS_METRICS_PORT``) is not
ported: STATS carries the same counters.

One ``ServingEngine`` is one slot pool on one machine; this tier fans
client traffic out over N ``ServeFrontend`` replicas while speaking the
SAME wire protocol clients already use (``frontend.py`` ops — a router
is indistinguishable from a big frontend).  Robustness is the headline
(docs/serving.md "Router tier"):

  * **Health-checked replicas.**  A :class:`resilience.FailureDetector`
    heartbeats every replica over the serve protocol (one-shot OP_PING
    round trips); replica-leg wire failures feed the same detector so
    death is noticed at traffic speed.  Replicas move through typed
    states: HEALTHY -> SUSPECT (missed pings / leg failures, still
    routable) -> DEAD (excluded, detector watches for recovery) and
    back (failback re-admission), or HEALTHY -> DRAINING (operator
    drain — no new placements, in-flight finishes, then retired).

  * **Deterministic re-dispatch.**  The router records every request's
    prompt and the tokens that crossed the wire so far.  When a replica
    dies mid-stream, the request is re-submitted to a survivor with the
    emitted prefix (``resume`` submits — engine.py ``resume_tokens``):
    the new replica re-prefills prompt + emitted (position-wise
    determinism rebuilds the exact K/V the dead replica's decode wrote
    — the engine's preempt/resume argument, one machine wider), restores
    the parked next-input token, and under sampling recomputes the
    carried key as the k-fold split chain of ``PRNGKey(seed)``.  The
    spliced stream is token-identical to a never-interrupted run —
    greedy by construction, seeded because the key state is a pure
    function of ``(seed, tokens emitted)``.  (If a future sampling
    scheme made key state non-derivable — external entropy, per-tick
    reseeding — resume would be inexact; the engine refuses resume
    loudly for the configs where bit-exactness already cannot hold:
    ``kv_quant`` and flash-prefill models.)

  * **Bounded, typed failure.**  Queued-but-unstarted requests retry
    transparently under :class:`resilience.RetryPolicy` backoff; every
    request carries a deadline, and when no replica can complete it in
    time it fails with the typed :class:`ReplicaLostError` — never a
    hang, never a silent drop.  Every wire read is timeout-bounded.

  * **Prefix-affinity placement.**  Requests are steered by a digest of
    the prompt's leading block (the rolling-hash discipline of
    serving/prefix.py), so shared-system-prompt traffic lands on the
    replica whose prefix cache is warm — SGLang-style cache-aware load
    balancing.  First placement of a prefix group is rendezvous-hashed
    (HRW: deterministic, stable under replica-set changes) and then
    sticky; dead primaries remap through the reused
    :class:`resilience.DegradedModeRouter` (the deterministic
    next-alive scan every PS worker already agrees on).

  * **Credit backpressure.**  Each replica holds ``credits`` in-flight
    requests; a full replica sheds to the next-best candidate instead
    of queueing blind, and total saturation becomes backoff-then-typed
    failure, not an unbounded queue.

  * **Router high availability** (docs/serving.md "Router HA").  The
    router itself must not be the tier's single point of failure.  A
    priority-ordered peer list (``BYTEPS_ROUTER_PEERS``) makes the
    lowest-priority-index live router the ACTIVE one; it streams a
    compact journal to the standbys over the serve wire
    (``OP_JOURNAL`` — serving/journal.py): affinity-map entries,
    replica health/fingerprint verdicts, and per-request in-flight
    records (id, seed, params, replica, emitted-token COUNT — the
    client holds the tokens).  Every dispatch to a replica carries a
    monotonic **epoch**; on active death (each standby runs a
    ``FailureDetector`` over the routers' own OP_PING) the
    highest-priority standby assumes the journaled state — warm
    affinity map, verified replicas, no cold re-probe storm — and
    bumps the epoch, so replicas FENCE the deposed epoch
    (``EpochFencedError``): a stale active that comes back is refused
    by the very replicas it tries to reach and demotes itself (it
    also demotes on a journal ack carrying a higher epoch).  Clients
    hold the multi-router address list and re-issue mid-stream with
    ``resume_tokens`` — token-identical by the resume argument, one
    tier higher.

  * **Per-tenant fair share.**  With ``tenant_weights`` configured
    (``BYTEPS_ROUTER_TENANT_WEIGHTS``), dispatch debits a per-tenant
    credit pool (the ``ScheduledQueue`` credit machinery) sized by
    weight over the tier's total credits, so one tenant flooding the
    router cannot starve another's share of in-flight capacity.

  * **Wire-level cancel.**  ``OP_CANCEL`` propagates
    client -> router -> replica: cancelling a routed request reclaims
    the replica's slot and paged KV blocks same-tick, not when the
    abandoned stream would have finished.

Metrics land on the registry (``router.*``): per-replica state and
in-flight gauges, failover / redispatch / shed / retry counters, and
the affinity hit rate.  The launcher grows a ``router`` role
(``DMLC_ROLE=router``, knobs ``BYTEPS_ROUTER_*`` — docs/env.md).
"""

from __future__ import annotations

import collections
import enum
import hashlib
import itertools
import json
import re
import socketserver
import threading
import time
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ..common import logging as bps_log
from ..common.scheduler import ScheduledQueue
from ..engine.transport import maybe_nodelay
from ..engine.wire import _decode, _encode, hard_reset
from ..observability.metrics import MetricsRegistry, get_registry
from ..resilience.detector import FailureDetector
from ..resilience.policy import RetryPolicy
from ..resilience.router import DegradedModeRouter
from .autoscale.admission import (SLO_BEST_EFFORT, SLO_GUARANTEED,
                                  SLO_STANDARD, AdmissionController,
                                  Lease, OverloadShedError, TenantShares,
                                  normalize_slo)
from .frontend import (OP_CANCEL, OP_JOURNAL, OP_PING, OP_STATS,
                       OP_STREAM, OP_SUBMIT, RemoteServeClient,
                       ServeConnectionError, ServeReplyError,
                       _split_resume, _wire_cancel)
from .journal import JournalSender

__all__ = ["ReplicaState", "ReplicaLostError", "RouterStandbyError",
           "WeightsMismatchError", "ServeRouter", "RouterFrontend",
           "serve_router", "router_from_env"]

# ------------------------------------------------------------- metric names
REQUESTS = "router.requests"
COMPLETED = "router.requests_completed"
FAILED = "router.requests_failed"
# replica-leg wire failures (the request then re-dispatches or retries)
FAILOVERS = "router.failovers"
# re-dispatches that carried an emitted prefix (mid-stream failover)
REDISPATCHES = "router.redispatches"
# placements diverted off a full (or replica-side-rejecting) candidate
SHEDS = "router.sheds"
# backoff waits (no placeable replica / transient leg failure)
RETRIES = "router.retries"
AFFINITY_HITS = "router.affinity_hits"
AFFINITY_MISSES = "router.affinity_misses"
DRAINS = "router.drains"
# replicas refused placement because their STATS weights fingerprint
# disagrees with the tier's (resume across different checkpoints would
# be silently wrong — docs/serving.md "Router tier")
WEIGHTS_REFUSED = "router.weights_refused"
# labeled per-replica gauges
REPLICA_STATE = "router.replica_state"      # 0 healthy 1 suspect 2 dead
REPLICA_INFLIGHT = "router.replica_inflight"  # 3 draining/retired
# --- router HA (docs/serving.md "Router HA")
EPOCH = "router.epoch"                      # gauge: this router's epoch
TAKEOVERS = "router.takeovers"
# journaled in-flight records orphaned at takeover (the clients hold
# their tokens and re-issue with resume — the honest recovery window)
TAKEOVER_ORPHANS = "router.takeover_orphans"
DEMOTIONS = "router.demotions"
STANDBY_REFUSED = "router.standby_refused"
JOURNAL_SENT = "router.journal_entries_sent"
JOURNAL_APPLIED = "router.journal_entries_applied"
# --- wire-level cancel propagation
CANCELS = "router.cancels"
CANCELLED = "router.requests_cancelled"
# --- per-tenant fair share (labeled gauge: credits remaining)
TENANT_CREDITS = "router.tenant_credits"
# --- disaggregated prefill/decode (docs/serving.md "Disaggregated
# tiers"): prefill legs dispatched to the prefill tier, KV blocks
# their ships delivered, and legs that fell back to decode-side
# re-prefill (failed/partial ship or a dead prefill replica — the
# availability floor is the colocated path)
DISAGG_PREFILLS = "router.disagg_prefills"
DISAGG_SHIPPED_BLOCKS = "router.disagg_shipped_blocks"
DISAGG_FALLBACKS = "router.disagg_fallbacks"
# --- elastic capacity (docs/serving.md "Elastic capacity & SLO
# classes"): per-class door sheds (incl. clawed-back borrows), total
# credits borrowed across tenant pools, and journaled QUEUED requests
# the NEW active re-dispatched itself at takeover
SHED_GUARANTEED = "router.shed_guaranteed"
SHED_STANDARD = "router.shed_standard"
SHED_BEST_EFFORT = "router.shed_best_effort"
BORROWED_CREDITS = "router.borrowed_credits"
QUEUED_REDISPATCHES = "router.queued_redispatches"

_SHED_COUNTER = {SLO_GUARANTEED: SHED_GUARANTEED,
                 SLO_STANDARD: SHED_STANDARD,
                 SLO_BEST_EFFORT: SHED_BEST_EFFORT}

# journaled in-flight record fields ("p" — a still-QUEUED record's
# prompt — rides separately, only while r is None)
_JOURNAL_FIELDS = ("rid", "seed", "prio", "mnt", "tenant", "slo",
                   "r", "n", "st")


class ReplicaState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"    # missed pings / leg failures; still routable
    DEAD = "dead"          # excluded; detector watches for failback
    DRAINING = "draining"  # no new placements; retires when empty


_STATE_GAUGE = {ReplicaState.HEALTHY: 0, ReplicaState.SUSPECT: 1,
                ReplicaState.DEAD: 2, ReplicaState.DRAINING: 3}


class ReplicaLostError(RuntimeError):
    """No replica could complete the request within its deadline: the
    serving tier lost the replica(s) serving it and ran out of retry
    budget.  ``emitted`` carries any tokens already streamed (the
    client saw them; they are valid — the sequence is just truncated)."""

    def __init__(self, msg: str, attempts: int = 0,
                 emitted: Sequence[int] = ()):
        self.attempts = attempts
        self.emitted = list(emitted)
        super().__init__(msg)


class RouterStandbyError(RuntimeError):
    """This router is a STANDBY (or a deposed active): it holds the
    journal but must not place traffic — only the epoch owner may
    dispatch, or two routers would split the affinity map and the
    in-flight bookkeeping (the exact failure HA exists to close).
    Typed AND client-retryable (``ServeReplyError.retryable``): a
    multi-router client rotates to the next address instead of failing
    the request."""


class WeightsMismatchError(RuntimeError):
    """A replica's STATS weights fingerprint disagrees with the tier's:
    it serves a different checkpoint, so a mid-stream re-dispatch onto
    it would splice a silently-wrong continuation.  Raised typed at
    registration (``ServeRouter.start``); at ping/failback time the
    replica is refused placement instead (it stays alive but never
    receives traffic until its fingerprint matches again)."""


class _Replica:
    __slots__ = ("idx", "addr", "role", "inflight", "suspect", "dead",
                 "draining", "retired", "refused", "verified")

    def __init__(self, idx: int, addr: str, role: str = "both"):
        self.idx = idx
        self.addr = addr
        # serving role (docs/serving.md "Disaggregated tiers"):
        # "prefill" replicas only ever receive prefill+ship legs,
        # "decode" / "both" replicas take normal placement ("both"
        # additionally runs its own prefill — the colocated default)
        self.role = role
        self.inflight = 0
        self.suspect = False
        self.dead = False
        self.draining = False
        self.retired = False
        # weights handshake: ``verified`` = fingerprint checked against
        # the tier's; ``refused`` = checked and DISAGREED (alive but
        # unplaceable until a later check matches — e.g. the operator
        # restarted it on the right checkpoint)
        self.refused = False
        self.verified = False

    @property
    def state(self) -> ReplicaState:
        if self.draining or self.retired:
            return ReplicaState.DRAINING
        if self.dead or self.refused:
            return ReplicaState.DEAD
        if self.suspect:
            return ReplicaState.SUSPECT
        return ReplicaState.HEALTHY

    @property
    def placeable(self) -> bool:
        return not (self.dead or self.draining or self.retired
                    or self.refused)


class ServeRouter:
    """Fan requests out over N serve replicas; see the module docstring
    for the failover / placement / backpressure contracts.

    ``registry=None`` binds the process-global metrics registry (what
    the router's OP_STATS reports); tests pass a
    private :class:`MetricsRegistry` to count in isolation.  Call
    :meth:`start` to run the heartbeat detector (per-request failover
    works without it — leg failures are detected at traffic speed —
    but only the detector takes a silent replica out of placement and
    re-admits it on recovery)."""

    def __init__(self, replicas: Sequence[str], *,
                 credits: int = 16,
                 affinity: bool = True,
                 affinity_block: int = 16,
                 deadline: float = 60.0,
                 stream_timeout: float = 30.0,
                 retry: Optional[RetryPolicy] = None,
                 heartbeat_interval: float = 0.5,
                 miss_threshold: int = 3,
                 ping_timeout: float = 1.0,
                 registry: Optional[MetricsRegistry] = None,
                 expected_weights_fp: Optional[str] = None,
                 peers: Optional[Sequence[str]] = None,
                 self_addr: str = "",
                 epoch_timeout: float = 0.5,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 journal_every: int = 8,
                 roles: Optional[Sequence[str]] = None,
                 disagg: bool = True,
                 slo_default: str = SLO_STANDARD,
                 slo_deadlines: Optional[Dict[str, float]] = None,
                 service_estimate_s: float = 0.5,
                 slo_borrow: bool = True):
        if not replicas:
            raise ValueError(
                "ServeRouter needs at least one replica address "
                "(BYTEPS_ROUTER_REPLICAS=host:port,host:port)")
        self._replicas = [_Replica(i, a) for i, a in enumerate(replicas)]
        # ---- disaggregated tiers (docs/serving.md) -------------------
        # ``roles`` mirrors ``replicas`` positionally (BYTEPS_ROUTER_
        # ROLES=prefill,decode,...).  Omitted/empty = every replica is
        # "both" (colocated — today's behaviour, bit for bit).
        if roles:
            roles = [str(x).strip() for x in roles]
            if len(roles) != len(self._replicas):
                raise ValueError(
                    f"roles has {len(roles)} entries for "
                    f"{len(self._replicas)} replicas (BYTEPS_ROUTER_ROLES "
                    f"must mirror BYTEPS_ROUTER_REPLICAS positionally)")
            for r, role in zip(self._replicas, roles):
                if role not in ("prefill", "decode", "both"):
                    raise ValueError(
                        f"unknown replica role {role!r} (want prefill, "
                        f"decode, or both)")
                r.role = role
            if all(r.role == "prefill" for r in self._replicas):
                raise ValueError(
                    "every replica is prefill-role: at least one decode "
                    "or both replica must exist to run decode")
        # disaggregation is live only when the operator actually split
        # the pool; the flag (BYTEPS_DISAGG=0) force-colocates even then
        self._disagg = bool(disagg) and any(
            r.role == "prefill" for r in self._replicas)
        self.credits = max(1, credits)
        self.affinity = bool(affinity)
        self.affinity_block = max(1, affinity_block)
        self.deadline = deadline
        self.stream_timeout = stream_timeout
        # the policy paces attempts; the router's per-request deadline
        # is passed to should_retry as the bound (the policy's own
        # deadline field is unused here)
        self.retry = retry if retry is not None else RetryPolicy(
            max_attempts=6, backoff_base=0.05, backoff_mult=2.0,
            backoff_cap=1.0, jitter=0.1, deadline=0.0)
        self.ping_timeout = ping_timeout
        self._degraded = DegradedModeRouter(len(self._replicas))
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)  # drain waits here
        # prefix-group digest -> replica idx (sticky placements),
        # LRU-bounded so a long-tailed prompt population cannot grow it
        # without bound
        self._affinity_map: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()
        self._affinity_cap = 4096
        self._rr = itertools.count()
        self._registry = registry if registry is not None else get_registry()
        self._detector = FailureDetector(
            len(self._replicas), self._ping_replica,
            interval=heartbeat_interval, miss_threshold=miss_threshold,
            on_down=self._on_replica_down, on_up=self._on_replica_up)
        for r in self._replicas:
            self._gauge_state(r)

        # the tier's weights anchor.  Default: first-verified-wins —
        # the first fingerprint a replica proves becomes the tier's.
        # ``expected_weights_fp`` (BYTEPS_ROUTER_WEIGHTS_FP) lets the
        # operator PIN the anchor instead: WHICH checkpoint wins is
        # then an explicit deployment decision, not an accident of
        # which replica registered first, and a replica that cannot
        # prove the pinned fingerprint (including pre-handshake builds
        # that report none) is refused placement.
        self._expected_fp: Optional[str] = expected_weights_fp or None
        self._fp_pinned = bool(expected_weights_fp)

        # ---- router HA (docs/serving.md "Router HA") -----------------
        # ``peers`` is the PRIORITY-ORDERED router address list (index
        # 0 = initially active); ``self_addr`` names this router in it.
        # Without peers the router is a plain single active (epoch 1 —
        # still stamped on dispatches, so replicas always fence).
        self.peers = ([p.strip() for p in peers if p.strip()]
                      if peers else [])
        self.self_addr = self_addr
        if self.peers:
            if self_addr not in self.peers:
                raise ValueError(
                    f"self_addr {self_addr!r} must appear in the peer "
                    f"list {self.peers} (BYTEPS_ROUTER_SELF names this "
                    f"router's own entry in BYTEPS_ROUTER_PEERS)")
            self._self_idx = self.peers.index(self_addr)
        else:
            self._self_idx = 0
        self.epoch_timeout = epoch_timeout
        self.journal_every = max(1, journal_every)
        self._active = self._self_idx == 0
        self.epoch = 1 if self._active else 0
        self._journal_epoch = 0   # highest epoch seen in the journal
        # peer index of the current epoch owner, as far as we know
        self._active_peer: Optional[int] = (0 if self.peers else None)
        self._promoting = False
        self._killed = False
        # standby-side journal state: per-request in-flight records
        # (bounded — the takeover contract tolerates loss; clients
        # hold the tokens)
        self._journal_inflight: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        # active-side live dispatch records (rid -> record) + cancel
        # tombstones for OP_CANCELs racing their own submit
        self._inflight: Dict[str, dict] = {}
        self._cancel_tombs: "collections.OrderedDict[str, None]" = \
            collections.OrderedDict()
        # recently-FINISHED rids (bounded): a too-late cancel must not
        # be tombstoned — the tombstone would cancel the next request
        # reusing the rid at admission (mirrors ServeFrontend._rid_done)
        self._rid_done: "collections.OrderedDict[str, None]" = \
            collections.OrderedDict()
        self._rid_seq = itertools.count()
        self._journal: Optional[JournalSender] = None
        if self.peers:
            self._journal = JournalSender(
                [p for p in self.peers if p != self_addr],
                timeout=ping_timeout, epoch_of=lambda: self.epoch,
                on_stale=self._demote,
                snapshot_fn=self._journal_snapshot)
        self._peer_detector: Optional[FailureDetector] = None
        if len(self.peers) > 1:
            self._peer_detector = FailureDetector(
                len(self.peers), self._ping_peer,
                interval=heartbeat_interval,
                miss_threshold=miss_threshold,
                on_down=lambda i: self._maybe_takeover())
        self._registry.gauge(EPOCH, track="router").set(self.epoch)

        # ---- per-tenant fair share -----------------------------------
        # weight -> a ScheduledQueue credit pool sized as this tenant's
        # share of the tier's total in-flight credits; tenants not
        # named in the config (and untagged requests) share the
        # "default" bucket.  Strict reservation, deliberately NOT
        # work-conserving: a flooding tenant is bounded by its share
        # even when others are idle (the starvation guard is the
        # contract; docs/serving.md "Per-tenant fair share").
        self.tenant_weights: Dict[str, float] = dict(tenant_weights or {})
        self._tenant_pools: Dict[str, ScheduledQueue] = {}
        if self.tenant_weights:
            buckets = dict(self.tenant_weights)
            buckets.setdefault("default", 1.0)
            for t, w in buckets.items():
                if w <= 0:
                    raise ValueError(
                        f"tenant weight must be > 0, got {t}={w}")
            cap = self.credits * len(self._replicas)
            if cap < len(buckets):
                raise ValueError(
                    f"tenant fair share needs at least one credit per "
                    f"bucket: {len(buckets)} buckets (incl. 'default') "
                    f"but the tier only has {cap} credits "
                    f"(credits x replicas)")
            # largest-remainder apportionment: the pools sum EXACTLY to
            # the tier's total credits (the documented invariant —
            # naive per-bucket rounding can over-admit past the tier
            # cap and flatten configured ratios), then a 1-credit floor
            # funded by the largest shares so no tenant is configured
            # into permanent starvation
            total_w = sum(buckets.values())
            raw = {t: cap * w / total_w for t, w in buckets.items()}
            share = {t: int(raw[t]) for t in buckets}
            order = sorted(buckets, key=lambda t: raw[t] - share[t],
                           reverse=True)
            for t in order[:cap - sum(share.values())]:
                share[t] += 1
            while min(share.values()) == 0:
                share[min(share, key=share.get)] += 1
                share[max(share, key=share.get)] -= 1
            for t in buckets:
                self._tenant_pools[t] = ScheduledQueue(
                    scheduled=True, credit_bytes=share[t],
                    name=f"router.tenant.{t}")
                self._gauge_tenant(t)

        # ---- SLO admission + work-conserving shares ------------------
        # (docs/serving.md "Elastic capacity & SLO classes"): classes
        # shed at the door when the estimated queue wait blows their
        # deadline, and the strict tenant pools above become a FLOOR —
        # idle credits are lent across tenants and clawed back on
        # demand (TenantShares).
        self.slo_default = normalize_slo(slo_default)
        self._admission = AdmissionController(
            deadlines=slo_deadlines,
            service_estimate_s=service_estimate_s)
        self._shares = TenantShares(self._tenant_pools,
                                    borrow=slo_borrow,
                                    on_borrow=self._on_borrow)
        # takeover re-dispatch: rid -> parked token buffer the client's
        # retry attaches to (bounded — see _park_redispatch)
        self._parked: Dict[str, dict] = {}
        self._parked_cv = threading.Condition()
        # the scale intent (k="scale" journal entry) currently open —
        # kept on the active AND folded on standbys, so a takeover
        # mid-scale reconciles it instead of orphaning the spawn
        self._pending_scale: Optional[dict] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "ServeRouter":
        """Run the registration handshake, then the heartbeat detector.

        Registration compares every reachable replica's STATS weights
        fingerprint (the same digest the prefix-store salt commits to —
        serving/prefix.py ``weights_fingerprint``): the first fingerprint
        seen becomes the tier's — unless the operator pinned the anchor
        via ``expected_weights_fp`` (BYTEPS_ROUTER_WEIGHTS_FP), in which
        case every replica must prove THAT checkpoint — and a
        disagreeing replica raises the typed
        :class:`WeightsMismatchError`: refusing to build a tier
        whose failover re-dispatch would splice tokens from different
        checkpoints.  Replicas unreachable right now are re-checked on
        their first successful ping and at failback.

        A STANDBY router starts only its peer detector: replica health
        and weights verdicts arrive through the journal, so takeover
        needs no registration round and no cold re-probe storm."""
        if self._peer_detector is not None:
            self._peer_detector.start()
        if self._journal is not None:
            self._journal.start()
        if not self._active:
            return self
        for r in self._replicas:
            self._verify_replica_weights(r, raising=True)
        self._detector.start()
        self._jpub(k="hello")
        for r in self._replicas:
            self._jpub_replica(r)
        return self

    def close(self) -> None:
        self._detector.stop()
        if self._peer_detector is not None:
            self._peer_detector.stop()
        if self._journal is not None:
            self._journal.close()

    def kill(self) -> None:
        """Crash semantics (chaos): journaling stops IMMEDIATELY —
        in-flight "done" entries and queued state never reach the
        standbys, exactly like a crashed process — then the detectors
        come down.  The standby's takeover must recover the orphaned
        records from client ``resume_tokens``, which is the honest
        window the docs promise."""
        self._killed = True
        if self._journal is not None:
            self._journal.kill()
        self.close()

    # --------------------------------------------------------- HA: journal

    @property
    def active(self) -> bool:
        return self._active

    def _jpub(self, **ent) -> None:
        """Publish one journal entry to the standbys (active only —
        a standby publishing would be the split brain itself)."""
        if self._journal is None or not self._active or self._killed:
            return
        ent["e"] = self.epoch
        ent["src"] = self._self_idx
        self._journal.publish(ent)
        self._bump(JOURNAL_SENT)

    def _jpub_replica(self, r: _Replica) -> None:
        self._jpub(**self._replica_entry(r))

    def _replica_entry(self, r: _Replica) -> dict:
        # the address rides along so standbys can APPEND replicas the
        # active scaled up at runtime (add_replica), not just fold
        # verdicts for a roster they already share
        return {"k": "replica", "r": r.idx, "addr": r.addr,
                "role": r.role, "dead": r.dead,
                "refused": r.refused, "verified": r.verified,
                "draining": r.draining or r.retired,
                "fp": self._expected_fp}

    def _journal_snapshot(self) -> List[dict]:
        """Full-state dump for a peer (re)connect: epoch hello, every
        replica's verdict, the whole affinity map, and the live
        in-flight records — a standby that booted late (or dropped and
        returned) warms up to the same state incremental entries would
        have built."""
        if not self._active or self._killed:
            return []
        with self._lock:
            ents: List[dict] = [{"k": "hello"}]
            ents.extend(self._replica_entry(r) for r in self._replicas)
            ents.extend({"k": "affinity", "d": d.hex(), "r": i}
                        for d, i in self._affinity_map.items())
            for rec in self._inflight.values():
                ent = {"k": "inflight",
                       **{f: rec[f] for f in _JOURNAL_FIELDS}}
                if rec.get("r") is None and "p" in rec:
                    # QUEUED records carry their prompt: a takeover
                    # re-dispatches them instead of orphaning them
                    ent["p"] = rec["p"]
                ents.append(ent)
            if self._pending_scale is not None:
                ents.append(dict(self._pending_scale))
            for ent in ents:
                ent["e"] = self.epoch
                ent["src"] = self._self_idx
        return ents

    def apply_journal(self, entries: Sequence[dict]) -> Dict[str, int]:
        """Standby side: fold a journal batch into local state.  The
        ack carries OUR epoch — an active sender seeing a higher one
        knows it was deposed and demotes.  Entries from an epoch lower
        than the highest already seen are stale (a deposed active
        still flushing its queue) and are ignored."""
        # deposed-discovery first, OUTSIDE the state lock (_demote
        # takes it): one pass over the batch's epochs, not per-entry
        if self._active:
            newest = max((int(ent.get("e", 0)) for ent in entries),
                         default=0)
            if newest > self.epoch:
                # a peer owns a NEWER epoch: we are deposed
                self._demote(newest)
        applied = 0
        # one lock hold for the whole batch (a reconnect snapshot can
        # carry thousands of entries — per-entry acquire/release would
        # churn against the dispatch path for no isolation gain)
        with self._lock:
            for ent in entries:
                if self._active:
                    continue  # stale sender; the ack will demote it
                e = int(ent.get("e", 0))
                if e < self._journal_epoch:
                    continue
                self._journal_epoch = e
                if ent.get("src") is not None:
                    self._active_peer = int(ent["src"])
                k = ent.get("k")
                if k == "affinity":
                    d = bytes.fromhex(ent["d"])
                    self._affinity_map[d] = int(ent["r"])
                    self._affinity_map.move_to_end(d)
                    while len(self._affinity_map) > self._affinity_cap:
                        self._affinity_map.popitem(last=False)
                elif k == "inflight":
                    rid = str(ent["rid"])
                    old = self._journal_inflight.get(rid)
                    # MERGE, don't replace: the queued record's prompt
                    # ("p") arrives once at admission — a later count
                    # update must not erase it
                    self._journal_inflight[rid] = (
                        {**old, **ent} if old else ent)
                    self._journal_inflight.move_to_end(rid)
                    while len(self._journal_inflight) > 4096:
                        self._journal_inflight.popitem(last=False)
                elif k == "done":
                    self._journal_inflight.pop(str(ent["rid"]), None)
                elif k == "scale":
                    self._pending_scale = (
                        None if ent.get("phase") in ("done", "abort")
                        else dict(ent))
                elif k == "replica":
                    i = int(ent["r"])
                    if i == len(self._replicas) and ent.get("addr"):
                        # a replica the active scaled UP at runtime
                        # (add_replica journals the address): append it
                        # so a takeover owns the grown tier
                        self._replicas.append(_Replica(
                            i, str(ent["addr"]),
                            str(ent.get("role") or "both")))
                        self._detector.grow(1)
                        self._degraded.grow(1)
                    if 0 <= i < len(self._replicas):
                        r = self._replicas[i]
                        r.dead = bool(ent.get("dead"))
                        r.suspect = False
                        r.refused = bool(ent.get("refused"))
                        r.verified = bool(ent.get("verified"))
                        if bool(ent.get("draining")):
                            r.draining = True
                        if r.dead:
                            self._degraded.mark_down(i)
                        else:
                            self._degraded.mark_up(i)
                        if ent.get("fp") and not self._fp_pinned:
                            self._expected_fp = str(ent["fp"])
                        self._gauge_state(r)
                # k == "hello": epoch/src bookkeeping above is the point
                applied += 1
            # ack epoch computed while the batch's epoch bump is still
            # pinned under the lock: read after release, a concurrent
            # batch could promote _journal_epoch between our last apply
            # and the read, acking an epoch whose entries we never
            # folded (the lock-unguarded-field lint finding here)
            ack = max(self.epoch, self._journal_epoch)
        if applied:
            self._bump(JOURNAL_APPLIED, applied)
        return {"epoch": ack}

    # -------------------------------------------------- HA: role movement

    def _ping_peer(self, idx: int) -> bool:
        if idx == self._self_idx:
            return True
        ok = False
        try:
            c = RemoteServeClient(self.peers[idx],
                                  timeout=self.ping_timeout)
            try:
                ok = c.ping()
            finally:
                c.close()
        except (OSError, ValueError):
            ok = False
        if not ok and not self._active:
            # the detector only fires on_down on the TRANSITION; an
            # aborted takeover (grace re-ping briefly succeeded) must
            # re-arm while the blockers stay dead
            self._maybe_takeover()
        return ok

    def _takeover_blockers(self) -> Set[int]:
        """Peers that must ALL be dead before this router may assume
        the epoch: every higher-priority peer, plus the current epoch
        owner wherever it sits — determinism: for any set of live
        routers exactly one satisfies this.  A router DEPOSED by an
        owner it cannot name yet (_active_peer == -1: fenced before
        the new active's journal reconnected) must treat every other
        peer as a blocker — it KNOWS a higher epoch lives somewhere,
        so promoting while any peer is up risks seizing the epoch
        from the live active it just lost to."""
        need = set(range(self._self_idx))
        if self._active_peer is not None and self._active_peer < 0:
            need.update(j for j in range(len(self.peers))
                        if j != self._self_idx)
        elif (self._active_peer is not None
                and self._active_peer != self._self_idx):
            need.add(self._active_peer)
        return need

    def _maybe_takeover(self) -> None:
        if self._active or self._peer_detector is None:
            return
        blockers = self._takeover_blockers()
        if any(self._peer_detector.is_up(j) for j in blockers):
            return
        with self._lock:
            if self._active or self._promoting:
                return
            self._promoting = True
        threading.Thread(target=self._takeover_after_grace,
                         daemon=True).start()

    def _takeover_after_grace(self) -> None:
        """The epoch-timeout grace window: a transiently-stalled active
        must not trigger a takeover it would immediately fence.  After
        the wait every blocker is re-pinged directly — only when all
        are STILL dead does this router assume the epoch."""
        try:
            time.sleep(self.epoch_timeout)
            for j in sorted(self._takeover_blockers()):
                if self._ping_peer(j):
                    return  # active (or a better-priority peer) lives
            self._become_active()
        finally:
            with self._lock:
                self._promoting = False

    def _become_active(self) -> None:
        with self._lock:
            if self._active:
                return
            # the floor of 1 matters: a takeover epoch must be
            # STRICTLY greater than any epoch a router can BOOT with
            # (index 0 boots at 1).  Without it, a standby that never
            # received a journal entry would take over at epoch 1 and
            # a stalled-but-alive old active would never be fenced
            # (equal epochs pass) — permanent split brain.  With the
            # snapshot-on-connect warmup the journal epoch is normally
            # known anyway; this closes the cold-standby window.
            self.epoch = max(self.epoch, self._journal_epoch, 1) + 1
            self._journal_epoch = self.epoch
            self._active = True
            self._active_peer = self._self_idx
            # journaled in-flight records split two ways: QUEUED ones
            # (never placed, emitted nothing, prompt journaled) are
            # re-dispatched by US — the client's retry attaches to the
            # parked stream by rid; records that already reached a
            # replica stay orphans (their clients hold the tokens and
            # re-issue with resume — the honest recovery window)
            requeue: List[dict] = []
            orphans = 0
            for ent in self._journal_inflight.values():
                if (ent.get("r") is None and not ent.get("n")
                        and ent.get("p")
                        and len(requeue) < self._parked_cap):
                    requeue.append(dict(ent))
                else:
                    orphans += 1
            self._journal_inflight.clear()
        self._bump(TAKEOVERS)
        if orphans:
            self._bump(TAKEOVER_ORPHANS, orphans)
        self._registry.gauge(EPOCH, track="router").set(self.epoch)
        # the journaled verdicts ARE the warm state: verified replicas
        # stay verified (no registration storm), dead ones stay out of
        # placement until the detector — started here — re-admits them
        self._detector.start()
        self._jpub(k="hello")
        for r in self._replicas:
            self._jpub_replica(r)
        for ent in requeue:
            self._park_redispatch(ent)
        bps_log.warning(
            "router %s: TAKEOVER — assuming epoch %d with %d journaled "
            "affinity group(s), %d queued request(s) re-dispatched, "
            "%d orphaned in-flight record(s) (clients recover them "
            "via resume_tokens)",
            self.self_addr or self._self_idx, self.epoch,
            len(self._affinity_map), len(requeue), orphans)

    def _demote(self, higher_epoch: int) -> None:
        """A higher epoch exists (journal ack, incoming journal, or a
        replica's EpochFencedError): this router is deposed.  It keeps
        its journal state and its detectors — it is now a standby that
        may take over again if the whole newer chain dies."""
        with self._lock:
            self._journal_epoch = max(self._journal_epoch, higher_epoch)
            if not self._active:
                return
            self._active = False
            # the epoch owner is SOMEONE ELSE now, identity unknown
            # until their journal names it (-1 sentinel, distinct from
            # the boot-time None): leaving _active_peer at self would
            # make our own blocker set empty and re-promote us over
            # the live active on the next peer-down transition
            self._active_peer = -1
        self._bump(DEMOTIONS)
        bps_log.warning(
            "router %s: DEMOTED — epoch %d fenced by epoch %d; "
            "standing by", self.self_addr or self._self_idx,
            self.epoch, higher_epoch)

    # ------------------------------------------------- HA: cancel registry

    def cancel(self, rid: str) -> bool:
        """Wire-cancel propagation (OP_CANCEL): mark the in-flight
        record cancelled — the dispatch loop stops re-dispatching it —
        and forward the cancel to the replica currently serving it so
        the slot and paged KV blocks reclaim same-tick.  Unknown rids
        are tombstoned (bounded) to absorb a cancel racing its own
        submit.  A STANDBY refuses typed (client-retryable) instead of
        tombstoning: it has no in-flight records, so a False here would
        read as "already finished" while the active router's leg keeps
        generating."""
        rid = str(rid)
        if not self._active:
            self._bump(STANDBY_REFUSED)
            raise RouterStandbyError(
                f"router {self.self_addr or self._self_idx} is standby "
                f"(epoch owner: peer {self._active_peer}); cancel via "
                f"the active router")
        with self._lock:
            rec = self._inflight.get(rid)
            if rec is None:
                if rid not in self._rid_done:
                    # too EARLY (racing its own submit): tombstone.  A
                    # recently-finished rid is too LATE — tombstoning
                    # it would cancel the rid's next reuse
                    self._cancel_tombs[rid] = None
                    while len(self._cancel_tombs) > 1024:
                        self._cancel_tombs.popitem(last=False)
                return False
            rec["cancelled"] = True
            ridx = rec.get("r")
            addr = (self._replicas[ridx].addr
                    if ridx is not None else None)
        self._bump(CANCELS)
        if addr is None:
            # not dispatched yet: the cancelled flag drops it before
            # any replica leg is placed
            return True
        try:
            # one fresh connection (a RemoteServeClient would eagerly
            # open a second, unused one just to be constructed)
            _wire_cancel(addr, {"rid": rid, "epoch": self.epoch},
                         self.ping_timeout)
        except ServeReplyError as e:
            if e.name == "EpochFencedError":
                # the replica is ALIVE and refusing our epoch: a newer
                # active owns this request now and its leg keeps
                # driving the replica — claiming "cancelled" would lie
                # to the client.  Demote and report failure; the client
                # re-issues the cancel to the new active.
                m = re.search(r"high-water (\d+)", str(e))
                self._demote(int(m.group(1)) if m else self.epoch)
                return False
            bps_log.debug("router cancel: replica %s refused (%s)",
                          addr, e)
        except (OSError, RuntimeError) as e:
            # replica unreachable / leg already dead: leg death
            # reclaims the slot on its own and the cancelled record
            # stops re-dispatch — only the eager reclaim is lost
            bps_log.debug("router cancel: replica %s unreachable "
                          "(%s)", addr, e)
        return True

    def _gauge_tenant(self, tenant: str) -> None:
        self._registry.gauge(TENANT_CREDITS, track="router",
                             tenant=tenant).set(
            self._tenant_pools[tenant].credits)

    def _on_borrow(self, tenant: str, lender: str) -> None:
        self._bump(BORROWED_CREDITS)
        self._gauge_tenant(lender)

    # -------------------------------------------------------------- metrics

    def _bump(self, name: str, n: int = 1) -> None:
        self._registry.counter(name, track="router").inc(n)

    def _gauge_state(self, r: _Replica) -> None:
        self._registry.gauge(REPLICA_STATE, track="router",
                             replica=r.idx, role=r.role
                             ).set(_STATE_GAUGE[r.state])

    def _gauge_inflight(self, r: _Replica) -> None:
        self._registry.gauge(REPLICA_INFLIGHT, track="router",
                             replica=r.idx, role=r.role).set(r.inflight)

    # --------------------------------------------------------------- health

    def _verify_replica_weights(self, r: _Replica, *,
                                raising: bool) -> bool:
        """Weights handshake against one replica: fetch its STATS
        fingerprint and compare with the tier's (the first fingerprint
        seen).  A mismatch marks the replica REFUSED — alive, heartbeat-
        tracked, but never placed — and raises the typed
        :class:`WeightsMismatchError` when ``raising`` (registration
        path).  A later matching check (operator restarted it on the
        right checkpoint) clears the refusal.  Replicas that do not
        report a fingerprint (pre-handshake builds) are accepted — the
        operator-guarantees-homogeneity contract they were deployed
        under.  Returns True when the replica is verified placeable."""
        try:
            c = RemoteServeClient(r.addr, timeout=self.ping_timeout)
            try:
                fp = c.stats().get("weights_fingerprint")
            finally:
                c.close()
        except (OSError, ValueError, RuntimeError):
            return False  # unreachable: re-checked at ping/failback
        with self._lock:
            if fp is None and not self._fp_pinned:
                # no fingerprint, no pin: the operator-guarantees-
                # homogeneity contract pre-handshake builds were
                # deployed under
                r.verified = True
                r.refused = False
                self._jpub_replica(r)
                return True
            if fp is not None:
                if self._expected_fp is None:
                    self._expected_fp = fp
                if fp == self._expected_fp:
                    r.verified = True
                    r.refused = False
                    self._jpub_replica(r)
                    return True
            first_refusal = not r.refused
            r.refused = True
            r.verified = True
            self._jpub_replica(r)
            # snapshot the tier anchor for the messages below while
            # still holding _lock: a journal batch can overwrite
            # _expected_fp between release and the read, and the
            # refusal must name the anchor it was judged against
            # (lock-unguarded-field lint finding)
            expected_fp = self._expected_fp
        if first_refusal:
            self._bump(WEIGHTS_REFUSED)
        self._gauge_state(r)
        if fp is None:
            msg = (f"replica {r.idx} ({r.addr}) reports no weights "
                   f"fingerprint but the operator pinned "
                   f"BYTEPS_ROUTER_WEIGHTS_FP="
                   f"{expected_fp[:16]}...: refusing placement — "
                   f"an unverifiable replica cannot prove it serves "
                   f"the pinned checkpoint.")
        else:
            msg = (f"replica {r.idx} ({r.addr}) serves different "
                   f"weights (fingerprint {fp[:16]}... != "
                   f"{'pinned' if self._fp_pinned else 'tier'} "
                   f"{expected_fp[:16]}...): refusing placement "
                   f"— a mid-stream re-dispatch onto it would splice "
                   f"a silently-wrong continuation.  Restart it on "
                   f"the tier's checkpoint to re-admit it.")
        if raising:
            raise WeightsMismatchError(msg)
        bps_log.warning("router: %s", msg)
        return False

    def _ping_replica(self, idx: int) -> bool:
        """Serve-protocol liveness probe: one short-timeout OP_PING
        round trip on a fresh connection (never contends with data
        legs).  Drives the detector's suspect/dead transitions.  Also
        the retry path of the weights handshake: an alive replica that
        was unreachable at registration (or refused since) re-verifies
        here, so fixing its checkpoint re-admits it within a ping
        interval."""
        r = self._replicas[idx]
        ok = False
        try:
            c = RemoteServeClient(r.addr, timeout=self.ping_timeout)
            try:
                ok = c.ping()
            finally:
                c.close()
        except (OSError, ValueError):
            ok = False
        if ok:
            r.suspect = False
            if not r.verified or r.refused:
                self._verify_replica_weights(r, raising=False)
        elif not r.dead:
            r.suspect = True
        self._gauge_state(r)
        return ok

    def _on_replica_down(self, idx: int) -> None:
        r = self._replicas[idx]
        r.dead, r.suspect = True, False
        # a dead replica's identity is stale the moment it dies: the
        # operator may restart it on a different checkpoint, and a
        # transiently-failing failback re-check must not leave a stale
        # verified=True letting it back in unchecked — clear it so the
        # failback/ping/dispatch paths all re-verify until a STATS
        # fetch actually succeeds
        r.verified = False
        self._degraded.mark_down(idx)
        self._gauge_state(r)
        self._jpub_replica(r)
        bps_log.warning("router: replica %d (%s) DEAD", idx, r.addr)

    def _on_replica_up(self, idx: int) -> None:
        r = self._replicas[idx]
        if r.draining or r.retired:
            return  # drained replicas never re-enter placement
        r.dead = r.suspect = False
        self._degraded.mark_up(idx)
        # failback handshake: a replica that went away and came back may
        # have restarted on a different checkpoint — it must prove its
        # weights before placement resumes (a mismatch leaves it alive
        # but refused; matching again later re-admits it)
        self._verify_replica_weights(r, raising=False)
        self._gauge_state(r)
        self._jpub_replica(r)
        if r.refused:
            return
        bps_log.warning("router: replica %d (%s) re-admitted (failback)",
                        idx, r.addr)

    def _note_leg_failure(self, r: _Replica) -> None:
        """A data leg to ``r`` died: feed the detector (detection at
        traffic speed, not ping cadence) and mark the replica suspect
        until a ping succeeds."""
        if not r.dead:
            r.suspect = True
            self._gauge_state(r)
        self._detector.report_failure(r.idx)

    # ------------------------------------------------------------ placement

    def _digest(self, prompt: np.ndarray) -> bytes:
        """Prefix-group key: digest of the prompt's leading affinity
        block (shorter prompts digest whole) — the rolling-block-hash
        discipline of serving/prefix.py, truncated to the one block
        that defines a shared-system-prompt group."""
        toks = np.ascontiguousarray(prompt[:self.affinity_block])
        return hashlib.blake2b(toks.tobytes(), digest_size=16).digest()

    def _hrw_order(self, digest: bytes) -> List[int]:
        """Rendezvous (highest-random-weight) order of ALL replicas for
        this prefix group: deterministic, and stable under replica-set
        changes (a dead replica's groups re-home without reshuffling
        everyone else's)."""
        scored = sorted(
            (hashlib.blake2b(digest + r.addr.encode(),
                             digest_size=8).digest(), r.idx)
            for r in self._replicas)
        return [idx for _, idx in reversed(scored)]

    def _acquire(self, digest: bytes,
                 tried: Set[int]) -> Optional[_Replica]:
        """Pick a replica for this request and take one credit.  None =
        nothing placeable right now (dead / draining / full / already
        tried this round) — the caller backs off and retries.

        Candidate order: the sticky affinity target (or the rendezvous
        winner) first — remapped around dead replicas by the reused
        ``DegradedModeRouter`` scan — then the remaining rendezvous
        order; round-robin mode replaces the whole ranking with a
        rotating scan."""
        with self._lock:
            n = len(self._replicas)
            mapped = (self._affinity_map.get(digest)
                      if self.affinity else None)
            if self.affinity:
                order = self._hrw_order(digest)
                primary = mapped if mapped is not None else order[0]
                try:
                    first = self._degraded.route(primary)
                except RuntimeError:
                    first = primary  # every replica down: scan anyway
                cands = [first] + [i for i in order if i != first]
            else:
                start = next(self._rr) % n
                cands = [(start + j) % n for j in range(n)]
            preferred = cands[0]
            preferred_full = False
            for idx in cands:
                r = self._replicas[idx]
                # prefill-role replicas never take normal placement:
                # they only ever see the prefill+ship leg
                if idx in tried or not r.placeable or r.role == "prefill":
                    continue
                if r.inflight >= self.credits:
                    if idx == preferred:
                        preferred_full = True
                    continue
                r.inflight += 1
                self._gauge_inflight(r)
                if self.affinity:
                    if mapped == idx:
                        self._bump(AFFINITY_HITS)
                    else:
                        self._bump(AFFINITY_MISSES)
                    # stickiness survives a transient shed: re-home the
                    # group only when it has no home or its home is
                    # gone (dead/draining) — one credit-full blip must
                    # not move every later request off the warm cache
                    if (mapped is None
                            or not self._replicas[mapped].placeable):
                        self._affinity_map[digest] = idx
                        # warm placements must survive a takeover:
                        # replicate the group -> replica binding
                        self._jpub(k="affinity", d=digest.hex(), r=idx)
                        while (len(self._affinity_map)
                                > self._affinity_cap):
                            self._affinity_map.popitem(last=False)
                    if digest in self._affinity_map:
                        self._affinity_map.move_to_end(digest)
                if preferred_full:
                    # the best candidate was full: we shed to the
                    # next-best instead of queueing blind behind it
                    self._bump(SHEDS)
                return r
            return None

    def _release(self, r: _Replica) -> None:
        with self._lock:
            r.inflight -= 1
            self._gauge_inflight(r)
            self._cv.notify_all()

    def _acquire_prefill(self, tried: Set[int]) -> Optional[_Replica]:
        """Queue-depth placement for the prefill leg: the prefill-role
        replica with the fewest in-flight legs (every dispatch flows
        through the router, so ``inflight`` IS the queue depth) that
        still has a credit.  Prefill has no prefix affinity — there is
        no warm cache to return to; the leg's KV leaves with the ship.
        ``None`` = no prefill capacity right now (the caller falls
        back to colocated decode-side prefill, never queues)."""
        with self._lock:
            best = None
            for r in self._replicas:
                if (r.role != "prefill" or r.idx in tried
                        or not r.placeable
                        or r.inflight >= self.credits):
                    continue
                if best is None or r.inflight < best.inflight:
                    best = r
            if best is None:
                return None
            best.inflight += 1
            self._gauge_inflight(best)
            return best

    def _peek_decode(self, digest: bytes) -> Optional[_Replica]:
        """The decode replica normal placement would choose for this
        prefix group — WITHOUT taking a credit (the ship needs a
        destination address at prefill time; the decode dispatch takes
        the credit itself moments later).  Pins the affinity map so the
        later :meth:`_acquire` lands on the same replica the blocks
        were shipped to; a divergence (the replica died or filled in
        between) only strands the staging for the TTL sweep — the
        decode leg then re-prefills, it never attends foreign KV."""
        with self._lock:
            n = len(self._replicas)
            mapped = (self._affinity_map.get(digest)
                      if self.affinity else None)
            if self.affinity:
                order = self._hrw_order(digest)
                if mapped is not None:
                    order = [mapped] + [i for i in order if i != mapped]
            else:
                start = next(self._rr) % n
                order = [(start + j) % n for j in range(n)]
            for idx in order:
                r = self._replicas[idx]
                if not r.placeable or r.role == "prefill":
                    continue
                if self.affinity and mapped != idx:
                    self._affinity_map[digest] = idx
                    self._jpub(k="affinity", d=digest.hex(), r=idx)
                    while len(self._affinity_map) > self._affinity_cap:
                        self._affinity_map.popitem(last=False)
                if self.affinity and digest in self._affinity_map:
                    self._affinity_map.move_to_end(digest)
                return r
            return None

    # ------------------------------------------------------------- dispatch

    def stream(self, prompt, max_new_tokens: int, *, seed: int = 0,
               priority: int = 0, deadline: Optional[float] = None,
               resume=None, rid: Optional[str] = None,
               tenant: Optional[str] = None,
               slo: Optional[str] = None, _redispatch: bool = False):
        """Token iterator: place the request, stream its tokens, and on
        replica death re-dispatch to a survivor with the emitted prefix
        — the consumer sees one uninterrupted, token-identical
        sequence.  Raises :class:`ReplicaLostError` (typed, within the
        deadline) when the serving tier cannot complete it.

        ``resume`` = tokens the CALLER already holds (a client retrying
        through the router after its own connection loss — the same
        wire contract the serve frontend speaks); they count against
        ``max_new_tokens`` and only new tokens are yielded.

        ``rid`` (caller-chosen, minted when absent) names the request
        for OP_CANCEL propagation and the HA journal's in-flight
        record; ``tenant`` debits that tenant's fair-share credit pool
        when tenant weights are configured.

        ``slo`` names the request's class (``guaranteed`` /
        ``standard`` / ``best-effort`` — docs/serving.md "Elastic
        capacity & SLO classes"): when the estimated queue wait blows
        the class deadline the request sheds AT THE DOOR with the
        typed, retryable :class:`OverloadShedError` instead of
        queueing into a miss.  A best-effort stream running on a
        BORROWED tenant credit additionally sheds mid-flight when the
        lender claws its credit back.  ``_redispatch`` is internal:
        the takeover path re-running a journaled queued record (skips
        admission — it was admitted once — and parks its tokens for
        the client to attach to)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        emitted: List[int] = ([int(t) for t in resume]
                              if resume is not None else [])
        if len(emitted) >= max_new_tokens:
            raise ValueError(
                f"resume carries {len(emitted)} tokens but "
                f"max_new_tokens is {max_new_tokens} — nothing left "
                f"to generate")
        if not self._active:
            self._bump(STANDBY_REFUSED)
            raise RouterStandbyError(
                f"router {self.self_addr or self._self_idx} is standby "
                f"(epoch owner: peer {self._active_peer}); retry the "
                f"active router")
        slo_class = normalize_slo(slo, self.slo_default)
        deadline_ts = time.monotonic() + (
            deadline if deadline is not None else self.deadline)
        rid = str(rid) if rid else f"r{self._self_idx}.{next(self._rid_seq)}"
        if not _redispatch:
            with self._parked_cv:
                parked = self._parked.get(rid)
            if parked is not None:
                # a takeover re-dispatch already runs this request:
                # attach to its parked stream instead of re-submitting
                yield from self._attach_parked(rid, parked, emitted,
                                               deadline_ts)
                return
        self._bump(REQUESTS)
        if not _redispatch:
            # deadline-aware admission: estimate the queue wait from
            # the live backlog and shed typed AT THE DOOR when the
            # class deadline cannot be met (guaranteed never sheds by
            # default — infinite deadline)
            with self._lock:
                queued = sum(1 for q in self._inflight.values()
                             if q.get("r") is None)
                busy = sum(r.inflight for r in self._replicas)
                cap = self.credits * sum(
                    1 for r in self._replicas
                    if r.placeable and r.role != "prefill")
            try:
                self._admission.admit(slo_class, busy, queued, cap)
            except OverloadShedError:
                self._bump(_SHED_COUNTER[slo_class])
                raise
        t_start = time.monotonic()
        digest = self._digest(prompt)
        dispatched = False  # a leg reached a replica at least once
        tried: Set[int] = set()
        attempt = 0  # consecutive no-progress attempts (resets on tokens)
        stalls = 0   # consecutive no-placeable-replica waits
        rec = {"rid": rid, "seed": int(seed), "prio": int(priority),
               "mnt": int(max_new_tokens), "tenant": tenant,
               "slo": slo_class,
               "r": None, "n": len(emitted), "cancelled": False,
               # dispatch stage, journaled to standbys: None (normal)
               # or "ship" (PREFILL_SHIPPING — a takeover knows the
               # request was mid-prefill-leg and owns no decode slot)
               "st": None}
        if (self._journal is not None and not emitted
                and len(prompt) <= 4096):
            # the QUEUED record's prompt, journaled so a takeover can
            # re-dispatch a request that never reached a replica
            rec["p"] = [int(t) for t in prompt]
        with self._lock:
            if rid in self._cancel_tombs:
                del self._cancel_tombs[rid]
                rec["cancelled"] = True
            self._rid_done.pop(rid, None)  # the rid is live again
            self._inflight[rid] = rec

        def _give_up(cause: str, err=None):
            self._bump(FAILED)
            e = ReplicaLostError(
                f"request could not complete on any replica within its "
                f"deadline: {cause} (attempts without progress: "
                f"{attempt}, tokens already streamed: {len(emitted)})",
                attempts=attempt, emitted=emitted)
            if err is not None:
                raise e from err
            raise e

        def _pace(cause: str, err=None):
            # backoff before the next attempt, deadline- and
            # attempt-bounded by the RetryPolicy contract
            nonlocal attempt
            attempt += 1
            if not self.retry.should_retry(attempt, deadline_ts):
                _give_up(cause, err)
            self._bump(RETRIES)
            self.retry.sleep(attempt + 1)

        journaled = False

        def _jpub_inflight():
            nonlocal journaled
            ent = {f: rec[f] for f in _JOURNAL_FIELDS}
            if rec["r"] is None and "p" in rec:
                ent["p"] = rec["p"]
            journaled = True
            self._jpub(k="inflight", **ent)

        tname = (tenant if tenant in self._tenant_pools else "default")
        lease: Optional[Lease] = None

        def _claw_check():
            # the work-conserving contract's teeth: a borrowed credit
            # flagged by clawback sheds this stream typed at its next
            # pace point, and release() sends the credit home
            if lease is not None and lease.reclaimed:
                self._bump(_SHED_COUNTER[slo_class])
                raise OverloadShedError(
                    slo_class, 0.0, 0.0,
                    reason="borrowed credit clawed back")

        try:
            if not _redispatch:
                # journal the QUEUED record before any gate: a
                # takeover between here and placement re-dispatches it
                _jpub_inflight()
            if self._tenant_pools:
                # fair-share gate: ONE credit for the request's whole
                # lifetime (held across failover re-dispatches — it
                # bounds in-flight share, not attempts).  Own pool
                # first, then a BORROWED idle credit (work-conserving
                # shares), then block on the own pool clawing our
                # outstanding loans back.  Deadline-bounded.
                lease = self._shares.acquire(
                    tname,
                    reclaimable=(slo_class == SLO_BEST_EFFORT),
                    timeout=max(0.0, deadline_ts - time.monotonic()),
                    should_abort=lambda: bool(rec["cancelled"]))
                if lease is None:
                    if rec["cancelled"]:
                        self._bump(CANCELLED)
                        return
                    _give_up(
                        f"tenant {tname!r} at its fair-share "
                        f"in-flight limit for the whole deadline "
                        f"(router.tenant_credits)")
                self._gauge_tenant(tname)
            # ---- disaggregated prefill leg (docs/serving.md) ---------
            # One-shot: run the prompt on a prefill-role replica with
            # mnt=1 and ship_to=<the decode replica placement would
            # pick>; the prefill frontend parks the finished KV and
            # ships it to the decode target before replying.  ANY
            # failure on this leg falls through to the normal loop —
            # decode-side re-prefill over the resume path is
            # the availability floor: disaggregation is never less
            # available than colocated serving.
            ship_addr: Optional[str] = None
            ship_first = False  # first decode leg after a prefill leg
            if self._disagg and not emitted and not rec["cancelled"]:
                d = self._peek_decode(digest)
                p = (self._acquire_prefill(tried)
                     if d is not None else None)
                if (p is not None and not p.verified
                        and not self._verify_replica_weights(
                            p, raising=False)):
                    self._release(p)
                    p = None
                if p is not None:
                    pleg: Optional[RemoteServeClient] = None
                    try:
                        dispatched = True
                        rec["r"] = p.idx
                        rec["st"] = "ship"  # PREFILL_SHIPPING
                        _jpub_inflight()
                        pleg = RemoteServeClient(
                            p.addr, timeout=self.stream_timeout)
                        toks, info = pleg.prefill_ship(
                            prompt, seed=seed, priority=priority,
                            ship_to=d.addr, kv_ship=rid,
                            epoch=self.epoch, rid=rid, tenant=tenant)
                        self._bump(DISAGG_PREFILLS)
                        # name the staging on the decode dispatch
                        # either way: a complete ship is adopted, a
                        # failed/partial one is aborted and released
                        # promptly instead of waiting out the TTL
                        ship_addr = d.addr
                        ship_first = True
                        if info.get("shipped"):
                            self._bump(DISAGG_SHIPPED_BLOCKS,
                                       int(info.get("blocks", 0)))
                        else:
                            self._bump(DISAGG_FALLBACKS)
                            bps_log.warning(
                                "disagg: ship %s -> %s failed (%s); "
                                "decode-side re-prefill",
                                rid, d.addr, info.get("error"))
                        for tok in toks:
                            if rec["cancelled"]:
                                self._bump(CANCELLED)
                                return
                            emitted.append(int(tok))
                            rec["n"] = len(emitted)
                            yield int(tok)
                        if len(emitted) >= max_new_tokens:
                            # mnt=1 request: the prefill leg WAS the
                            # whole request (its staging, if any, is
                            # TTL-swept at the decode replica)
                            self._bump(COMPLETED)
                            return
                    except (ServeConnectionError, OSError) as e:
                        # the prefill replica died mid-leg or mid-ship:
                        # fall through — the loop below re-prefills
                        # decode-side from scratch (no tokens were
                        # emitted, so the prefix is just the prompt)
                        self._note_leg_failure(p)
                        self._bump(FAILOVERS)
                        self._bump(DISAGG_FALLBACKS)
                        if rec["cancelled"]:
                            self._bump(CANCELLED)
                            return
                        bps_log.warning(
                            "disagg: prefill replica %d (%s) lost "
                            "mid-leg (%s); decode-side re-prefill",
                            p.idx, p.addr, e)
                    except RuntimeError as e:
                        msg = str(e)
                        if "EpochFencedError" in msg:
                            m = re.search(r"high-water (\d+)", msg)
                            self._demote(int(m.group(1)) if m
                                         else self.epoch)
                            self._bump(STANDBY_REFUSED)
                            raise RouterStandbyError(
                                f"router "
                                f"{self.self_addr or self._self_idx} "
                                f"deposed: replica {p.idx} fenced "
                                f"epoch {self.epoch}; retry the "
                                f"active router with resume") from e
                        if "ValueError" in msg:
                            # deterministic client error: recurs on
                            # every replica — propagate, don't retry
                            self._bump(FAILED)
                            raise
                        # backpressure / engine failure on the prefill
                        # tier: colocated fallback, not a request
                        # failure
                        self._bump(DISAGG_FALLBACKS)
                        if rec["cancelled"]:
                            self._bump(CANCELLED)
                            return
                    finally:
                        if pleg is not None:
                            pleg.close()
                        self._release(p)
                        rec["r"] = None
                        rec["st"] = None
            while True:
                if rec["cancelled"]:
                    self._bump(CANCELLED)
                    return
                _claw_check()
                if not self._active:
                    # deposed mid-request (epoch fence / higher-epoch
                    # journal): the new epoch's router owns the tier —
                    # the client fails over to it with resume
                    self._bump(STANDBY_REFUSED)
                    raise RouterStandbyError(
                        f"router {self.self_addr or self._self_idx} "
                        f"was deposed mid-request (epoch owner: peer "
                        f"{self._active_peer}); retry the active "
                        f"router with resume")
                r = self._acquire(digest, tried)
                if r is None:
                    # no placeable replica this round: clear the
                    # per-round exclusions and wait — states and
                    # credits change while we do.  Saturation is NOT a
                    # failed attempt: it is bounded by the request
                    # DEADLINE alone (the RetryPolicy attempt budget
                    # counts replicas actually failing, not the router
                    # waiting its turn for a credit).
                    tried.clear()
                    stalls += 1
                    delay = max(0.005, self.retry.backoff(
                        min(stalls, self.retry.max_attempts) + 1))
                    if time.monotonic() + delay > deadline_ts:
                        _give_up("no placeable replica within the "
                                 "deadline (all dead, draining, or at "
                                 "their credit limit)")
                    self._bump(RETRIES)
                    time.sleep(delay)
                    continue
                stalls = 0
                if not r.verified and not self._verify_replica_weights(
                        r, raising=False):
                    # registration could not reach this replica and it
                    # is still unverified (or the check just refused
                    # it): an unverified replica must never see traffic
                    # — a wrong-checkpoint replica receiving a resume
                    # re-dispatch in the window before its first
                    # successful ping is the exact splice the handshake
                    # exists to prevent.  Not a failed attempt: like
                    # saturation, this round simply skips it (the
                    # deadline bounds the overall wait, and a
                    # transiently-unreachable stats endpoint is retried
                    # on the next round / ping).
                    self._release(r)
                    tried.add(r.idx)
                    continue
                leg: Optional[RemoteServeClient] = None
                try:
                    leg = RemoteServeClient(r.addr,
                                            timeout=self.stream_timeout)
                    if emitted and dispatched and not ship_first:
                        # a router-internal re-dispatch (mid-stream
                        # failover) — caller-supplied resume tokens on
                        # the FIRST leg are not one, and neither is the
                        # decode leg that follows a prefill leg
                        self._bump(REDISPATCHES)
                    dispatched = True
                    rec["r"] = r.idx
                    rec["n"] = len(emitted)
                    if rec["cancelled"]:
                        # cancel() ran between the loop-top check and
                        # the placement (it saw r=None and relied on
                        # us): honor it BEFORE the SUBMIT ever leaves
                        self._bump(CANCELLED)
                        return
                    # the journaled in-flight record: id, params,
                    # replica, emitted COUNT (counts, not tokens — the
                    # client holds the tokens)
                    _jpub_inflight()
                    extra = None
                    if (ship_addr is not None and r.addr == ship_addr
                            and len(emitted) == 1):
                        # name the staged ship on the decode dispatch
                        # (consumed once: the frontend's stager.take
                        # pops the staging, adopted or aborted)
                        extra = {"kv_ship": rid}
                        ship_addr = None
                    ship_first = False
                    for tok in leg.stream(prompt, max_new_tokens,
                                          seed=seed, priority=priority,
                                          resume=emitted or None,
                                          epoch=self.epoch, rid=rid,
                                          extra=extra):
                        if rec["cancelled"]:
                            # a cancel whose replica-side forward
                            # missed this leg (raced a re-dispatch, or
                            # found r=None): tear the leg down — the
                            # finally's leg.close() disconnects, and
                            # the replica's disconnect path eager-
                            # cancels the slot
                            self._bump(CANCELLED)
                            return
                        _claw_check()
                        emitted.append(int(tok))
                        attempt = 0
                        tried.clear()
                        rec["n"] = len(emitted)
                        if rec["n"] % self.journal_every == 0:
                            _jpub_inflight()
                        yield int(tok)
                    if rec["cancelled"]:
                        # the replica-side eager cancel ended the leg
                        # with its terminal frame early
                        self._bump(CANCELLED)
                    else:
                        self._bump(COMPLETED)
                    return
                except OverloadShedError:
                    # our own clawback shed (_claw_check inside the
                    # token loop): typed, not a replica failure — the
                    # leg teardown below still runs
                    raise
                except (ServeConnectionError, OSError) as e:
                    # the replica died or stalled mid-leg (connect
                    # refused, reset mid-stream, no token within
                    # stream_timeout): feed the detector and
                    # re-dispatch to a survivor with the emitted prefix
                    self._note_leg_failure(r)
                    self._bump(FAILOVERS)
                    if rec["cancelled"]:
                        self._bump(CANCELLED)
                        return
                    if len(emitted) >= max_new_tokens:
                        # the replica died BETWEEN the final token and
                        # the terminal frame: the stream is already
                        # fully delivered — completing it is correct,
                        # and a re-dispatch would be infeasible
                        # (nothing left to generate)
                        self._bump(COMPLETED)
                        return
                    tried.add(r.idx)
                    _pace(f"replica {r.idx} ({r.addr}) lost "
                          f"mid-request: {e}", e)
                except RuntimeError as e:
                    msg = str(e)
                    if "EpochFencedError" in msg:
                        # the replica has served a NEWER epoch: a
                        # standby took over while we thought we were
                        # active.  Demote and bounce the request — the
                        # client re-issues to the new active with
                        # resume; continuing here would double-serve it
                        m = re.search(r"high-water (\d+)", msg)
                        self._demote(int(m.group(1)) if m
                                     else self.epoch)
                        self._bump(STANDBY_REFUSED)
                        raise RouterStandbyError(
                            f"router {self.self_addr or self._self_idx}"
                            f" deposed: replica {r.idx} fenced epoch "
                            f"{self.epoch}; retry the active router "
                            f"with resume") from e
                    if ("QueueFullError" in msg
                            or "AdmissionError" in msg
                            or "BlocksExhaustedError" in msg):
                        # typed replica-side backpressure: shed to the
                        # next candidate instead of queueing blind
                        self._bump(SHEDS)
                        tried.add(r.idx)
                        _pace(f"replica {r.idx} shedding load: {msg}",
                              e)
                    elif "ValueError" in msg:
                        # a deterministic client error (infeasible
                        # request) recurs on every replica —
                        # propagate, don't retry
                        self._bump(FAILED)
                        raise
                    else:
                        # replica-side engine failure: that engine is
                        # gone for this request — treat like a dead
                        # replica
                        self._note_leg_failure(r)
                        self._bump(FAILOVERS)
                        if rec["cancelled"]:
                            self._bump(CANCELLED)
                            return
                        if len(emitted) >= max_new_tokens:
                            self._bump(COMPLETED)  # fully delivered
                            return
                        tried.add(r.idx)
                        _pace(f"replica {r.idx} failed the request: "
                              f"{msg}", e)
                finally:
                    if leg is not None:
                        leg.close()
                    self._release(r)
        finally:
            with self._lock:
                self._inflight.pop(rid, None)
                self._rid_done[rid] = None
                while len(self._rid_done) > 1024:
                    self._rid_done.popitem(last=False)
            if lease is not None:
                # a borrowed credit flows back to the LENDER's pool —
                # that release IS the clawback's delivery mechanism
                self._shares.release(lease)
                self._gauge_tenant(lease.lender or tname)
            if dispatched and emitted:
                # feed the EWMA service-time estimate the admission
                # door's queue-wait math runs on
                self._admission.note_service(
                    max(0.0, time.monotonic() - t_start))
            if journaled:
                # "done" retires the journaled record whether or not a
                # replica was ever reached — a standby must not
                # re-dispatch a request that already failed typed here
                self._jpub(k="done", rid=rid)

    def generate(self, prompt, max_new_tokens: int, *, seed: int = 0,
                 priority: int = 0, deadline: Optional[float] = None,
                 resume=None, rid: Optional[str] = None,
                 tenant: Optional[str] = None,
                 slo: Optional[str] = None) -> np.ndarray:
        """Blocking dispatch -> the NEW tokens (the OP_SUBMIT analog
        of :meth:`stream`; with ``resume`` the caller already holds
        the prefix, so only the continuation comes back)."""
        return np.asarray(
            list(self.stream(prompt, max_new_tokens, seed=seed,
                             priority=priority, deadline=deadline,
                             resume=resume, rid=rid, tenant=tenant,
                             slo=slo)),
            np.int32)

    # ----------------------------------------------------------------- drain

    def drain(self, idx: int, timeout: Optional[float] = None) -> None:
        """Gracefully remove replica ``idx``: stop new placements
        immediately, let in-flight requests finish, then retire it —
        zero client-visible errors.  Its affinity groups re-home on
        their next request (rendezvous keeps everyone else's placement
        stable)."""
        r = self._replicas[idx]
        deadline_ts = (time.monotonic() + timeout
                       if timeout is not None else None)
        with self._lock:
            if r.retired:
                # idempotent: a takeover reconcile and the autoscale
                # controller may both retire the same replica — the
                # second call must be a no-op, not a second drain
                return
            r.draining = True
            self._gauge_state(r)
            for d in [d for d, i in self._affinity_map.items()
                      if i == idx]:
                del self._affinity_map[d]
            while r.inflight > 0:
                remaining = (None if deadline_ts is None
                             else deadline_ts - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"drain of replica {idx} timed out with "
                        f"{r.inflight} request(s) still in flight")
                self._cv.wait(remaining)
            r.retired = True
        self._bump(DRAINS)
        self._jpub_replica(r)
        bps_log.info("router: replica %d (%s) drained and retired",
                     idx, r.addr)

    # ---------------------------------------------------- elastic capacity

    def placeable_count(self) -> int:
        """Replicas currently accepting normal placement — the
        autoscale policy's notion of tier size (prefill-role replicas
        are not decode capacity)."""
        with self._lock:
            return sum(1 for r in self._replicas
                       if r.placeable and r.role != "prefill")

    def signal_snapshot(self) -> Dict[str, int]:
        """Load signals for the in-process autoscale sampler
        (``autoscale.signals.poll_router``): in-flight legs vs the
        placeable tier's credit capacity, plus the admission-queue
        depth (admitted but not yet placed)."""
        with self._lock:
            cap = self.credits * sum(
                1 for r in self._replicas
                if r.placeable and r.role != "prefill")
            busy = sum(r.inflight for r in self._replicas)
            queued = sum(1 for rec in self._inflight.values()
                         if rec.get("r") is None)
        return {"inflight": busy, "capacity": cap, "queued": queued}

    def replica_index(self, addr: str) -> Optional[int]:
        """Roster index of the (non-retired) replica at ``addr``, or
        None — how the takeover reconcile maps a journaled scale
        intent back onto the roster."""
        with self._lock:
            for r in self._replicas:
                if r.addr == addr and not r.retired:
                    return r.idx
        return None

    def add_replica(self, addr: str, role: str = "both") -> int:
        """Register a NEW replica with the running tier (the autoscale
        actuator's scale-up path).  The replica joins the roster and
        the heartbeat/degraded maps, then must pass the same weights-
        fingerprint handshake registration runs — a wrong-checkpoint
        spawn raises typed and never takes traffic.  The journaled
        roster entry carries the address, so HA standbys append the
        same replica (a takeover mid-scale-up owns the grown tier
        instead of orphaning the spawn).  Idempotent on address."""
        addr = str(addr).strip()
        if role not in ("prefill", "decode", "both"):
            raise ValueError(f"unknown replica role {role!r}")
        with self._lock:
            for r in self._replicas:
                if r.addr == addr and not r.retired:
                    return r.idx
            r = _Replica(len(self._replicas), addr, role)
            self._replicas.append(r)
            self._detector.grow(1)
            self._degraded.grow(1)
        self._gauge_state(r)
        self._verify_replica_weights(r, raising=True)
        self._jpub_replica(r)
        with self._lock:
            self._cv.notify_all()
        return r.idx

    def journal_scale(self, op: str, addr: Optional[str] = None,
                      idx: Optional[int] = None,
                      phase: str = "intent") -> None:
        """Journal one scale event (``k="scale"``).  Standbys fold the
        open intent into :meth:`pending_scale`, so a takeover
        mid-scale reconciles it (``AutoscaleController.
        reconcile_takeover``) instead of orphaning a spawning replica
        or double-draining a retiring one."""
        ent = {"k": "scale", "op": str(op), "addr": addr, "i": idx,
               "phase": str(phase)}
        with self._lock:
            self._pending_scale = (None if phase in ("done", "abort")
                                   else dict(ent))
        self._jpub(**ent)

    def pending_scale(self) -> Optional[dict]:
        with self._lock:
            return (dict(self._pending_scale)
                    if self._pending_scale else None)

    # ------------------------------------- takeover queued re-dispatch

    _parked_cap = 64

    def _park_redispatch(self, ent: dict) -> None:
        """Re-dispatch one journaled QUEUED-but-unstarted record on a
        background thread, buffering its tokens under the rid; the
        client's retry (same rid, SUBMIT or STREAM) attaches to the
        buffer instead of double-submitting.  Bounded by
        ``_parked_cap`` — records past it stay orphans (their clients
        re-issue with resume, the pre-existing recovery window)."""
        rid = str(ent["rid"])
        with self._parked_cv:
            if (rid in self._parked
                    or len(self._parked) >= self._parked_cap):
                return
            slot = {"toks": [], "done": False, "err": None}
            self._parked[rid] = slot
        self._bump(QUEUED_REDISPATCHES)

        def _run():
            try:
                for tok in self.stream(
                        np.asarray(ent["p"], np.int32),
                        int(ent["mnt"]),
                        seed=int(ent.get("seed") or 0),
                        priority=int(ent.get("prio") or 0),
                        tenant=ent.get("tenant"), slo=ent.get("slo"),
                        rid=rid, _redispatch=True):
                    with self._parked_cv:
                        slot["toks"].append(int(tok))
                        self._parked_cv.notify_all()
            except BaseException as e:  # delivered to the attacher
                slot["err"] = f"{type(e).__name__}: {e}"
            finally:
                with self._parked_cv:
                    slot["done"] = True
                    self._parked_cv.notify_all()

        threading.Thread(target=_run, daemon=True,
                         name=f"bps-requeue-{rid}").start()

    def _attach_parked(self, rid: str, slot: dict,
                       emitted: List[int], deadline_ts: float):
        """Yield the parked re-dispatch's tokens past the caller's
        resume offset; the slot is consumed when the underlying
        stream completes (accounting — REQUESTS/COMPLETED/journal —
        belongs to the re-dispatch run, not this view)."""
        i = len(emitted)
        while True:
            with self._parked_cv:
                while (len(slot["toks"]) <= i and not slot["done"]
                        and time.monotonic() < deadline_ts):
                    self._parked_cv.wait(min(
                        0.1, max(0.001,
                                 deadline_ts - time.monotonic())))
                toks = list(slot["toks"])
                done = bool(slot["done"])
                err = slot["err"]
            while i < len(toks):
                yield int(toks[i])
                i += 1
            if done and i >= len(toks):
                with self._parked_cv:
                    self._parked.pop(rid, None)
                if err:
                    raise ReplicaLostError(
                        f"takeover re-dispatch of {rid} failed: "
                        f"{err}", emitted=toks)
                return
            if time.monotonic() >= deadline_ts:
                raise ReplicaLostError(
                    f"takeover re-dispatch of {rid} still running at "
                    f"the caller's deadline", emitted=toks)

    # ------------------------------------------------------------ inspection

    def replica_states(self) -> List[str]:
        return [r.state.value for r in self._replicas]

    def stats(self) -> Dict[str, object]:
        # one lock hold for the WHOLE mutable-state snapshot: the
        # journal epoch, role and in-flight maps move together under
        # _lock (apply_journal / takeover), so reading them after
        # releasing it could pair a pre-takeover role with a
        # post-takeover epoch — the exact torn read the lock-discipline
        # lint (lock-unguarded-field) flagged here
        with self._lock:
            reps = [{"addr": r.addr, "state": r.state.value,
                     "inflight": r.inflight, "role": r.role}
                    for r in self._replicas]
            out: Dict[str, object] = {"replicas": reps,
                                      "affinity": self.affinity,
                                      "credits": self.credits,
                                      "disagg": self._disagg,
                                      "role": ("active" if self._active
                                               else "standby"),
                                      "epoch": self.epoch,
                                      "journal_epoch": self._journal_epoch,
                                      "journal_inflight":
                                          len(self._journal_inflight),
                                      "inflight": len(self._inflight)}
            if self._tenant_pools:
                out["tenant_credits"] = {
                    t: q.credits for t, q in self._tenant_pools.items()}
        for name in (REQUESTS, COMPLETED, FAILED, FAILOVERS,
                     REDISPATCHES, SHEDS, RETRIES, AFFINITY_HITS,
                     AFFINITY_MISSES, DRAINS, WEIGHTS_REFUSED,
                     TAKEOVERS, DEMOTIONS, STANDBY_REFUSED, CANCELS,
                     CANCELLED, JOURNAL_SENT, JOURNAL_APPLIED,
                     TAKEOVER_ORPHANS, DISAGG_PREFILLS,
                     DISAGG_SHIPPED_BLOCKS, DISAGG_FALLBACKS,
                     SHED_GUARANTEED, SHED_STANDARD, SHED_BEST_EFFORT,
                     BORROWED_CREDITS, QUEUED_REDISPATCHES):
            m = self._registry.get(name)
            out[name] = m.value if m is not None else 0
        return out


# --------------------------------------------------------------- wire tier


class _RouterHandler(socketserver.BaseRequestHandler):
    def setup(self):
        track = getattr(self.server, "_track_conn", None)
        if track is not None:
            track(self.request)

    def handle(self):  # one connection, many requests
        router: ServeRouter = self.server.router  # type: ignore
        sock = self.request
        maybe_nodelay(sock)
        try:
            while True:
                try:
                    op, name, arr, _ = _decode(sock)
                except (ConnectionError, OSError):
                    return
                try:
                    if op in (OP_SUBMIT, OP_STREAM):
                        # same request layout as the serve frontend
                        # (wire compatibility is the point) — ONE
                        # definition of the resume-split contract
                        params = json.loads(name) if name else {}
                        prompt, resumed = _split_resume(params, arr)
                        kw = dict(
                            seed=int(params.get("seed", 0)),
                            priority=int(params.get("priority", 0)),
                            resume=resumed,
                            rid=params.get("rid"),
                            tenant=params.get("tenant"),
                            slo=params.get("slo"))
                        mnt = int(params.get("max_new_tokens", 16))
                    if op == OP_SUBMIT:
                        new = router.generate(prompt, mnt, **kw)
                        # like the frontend: the reply is the FULL
                        # sequence, resume prefix included
                        full = (np.concatenate([resumed, new])
                                if resumed is not None else new)
                        reply = _encode(0, "", full)
                    elif op == OP_STREAM:
                        gen = router.stream(prompt, mnt, **kw)
                        emitted: List[int] = ([int(t) for t in resumed]
                                              if resumed is not None
                                              else [])
                        try:
                            try:
                                for tok in gen:
                                    emitted.append(tok)
                                    sock.sendall(_encode(
                                        0, "t",
                                        np.asarray([tok], np.int32)))
                                sock.sendall(_encode(
                                    0, "end",
                                    np.asarray(emitted, np.int32)))
                            except OSError:
                                # client went away: closing the
                                # generator tears the replica leg down,
                                # which triggers the replica-side eager
                                # cancel
                                return
                        finally:
                            gen.close()
                        continue
                    elif op == OP_CANCEL:
                        params = json.loads(name) if name else {}
                        ok = router.cancel(str(params.get("rid", "")))
                        reply = _encode(
                            0, "", None,
                            json.dumps({"cancelled": ok}).encode())
                    elif op == OP_JOURNAL:
                        ack = router.apply_journal(
                            json.loads(name) if name else [])
                        reply = _encode(0, "", None,
                                        json.dumps(ack).encode())
                    elif op == OP_STATS:
                        reply = _encode(
                            0, "", None,
                            json.dumps(router.stats()).encode())
                    elif op == OP_PING:
                        reply = _encode(0, "", None)
                    else:
                        reply = _encode(1, "", None,
                                        f"bad op {op}".encode())
                except Exception as e:
                    # typed errors (ReplicaLostError, replica-side
                    # rejections) ride the status=1 reply; the
                    # connection survives
                    reply = _encode(
                        1, "", None, f"{type(e).__name__}: {e}".encode())
                sock.sendall(reply)
        except Exception as e:  # pragma: no cover - teardown races
            bps_log.debug("router handler exit: %s", e)


class RouterFrontend(socketserver.ThreadingTCPServer):
    """TCP frontend over a :class:`ServeRouter` — wire-compatible with
    ``ServeFrontend``, so existing clients point at the router
    unchanged.  A STANDBY router serves the same port: it answers
    PING/STATS/JOURNAL and refuses SUBMIT/STREAM with the typed,
    client-retryable ``RouterStandbyError``."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, router: ServeRouter):
        super().__init__(addr, _RouterHandler)
        self.router = router
        # live client sockets, so kill() can die like a crashed router
        # process (sever mid-stream connections, not just stop
        # accepting) — the ServeFrontend.kill discipline one tier up
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._killing = False
        router.start()

    def _track_conn(self, sock) -> None:
        with self._conns_lock:
            if not self._killing:
                self._conns.add(sock)
                self._conns = {s for s in self._conns
                               if s.fileno() != -1}
                return
        hard_reset(sock)

    def kill(self) -> None:
        """Die like a crashed active router: hard-reset every live
        client connection FIRST (mid-stream clients see ECONNRESET
        mid-frame — what the multi-router client failover must
        absorb), stop accepting, and take the ServeRouter down with
        this process (its journal sender and detectors die too — a
        crash leaves no background threads).  Chaos/test only."""
        self._killing = True
        # journaling stops FIRST: a crashed process never flushes its
        # queued entries, and the takeover proof depends on that
        self.router.kill()
        with self._conns_lock:
            conns, self._conns = set(self._conns), set()
        for c in conns:
            hard_reset(c)
        self.shutdown()
        self.server_close()

    def server_close(self):
        self.router.close()
        super().server_close()


def serve_router(router: ServeRouter, port: int, host: str = "0.0.0.0",
                 in_thread: bool = False):
    """Run the router frontend.  ``in_thread=True`` returns
    ``(server, thread)`` for tests; otherwise blocks (launcher mode)."""
    srv = RouterFrontend((host, port), router)
    bps_log.info("byteps_tpu_torch serve router (%s, epoch %d) listening "
                 "on %s:%d over %d replica(s)",
                 "active" if router.active else "standby", router.epoch,
                 host, srv.server_address[1], len(router._replicas))
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


def router_from_env(env=None) -> int:
    """Entry point for the launcher's ``router`` role: build the router
    from ``BYTEPS_ROUTER_*`` and block on the TCP frontend.  The metrics
    scrape and the RPC trace knobs (``BYTEPS_METRICS_PORT``,
    ``BYTEPS_TRACE_RPC``, ``BYTEPS_TRACE_PATH``) are refused, never
    ignored."""
    import os

    from ..common.config import check_observability, get_config, reset_config

    if env is not None:
        os.environ.update({k: str(v) for k, v in env.items()
                           if k.startswith(("BYTEPS_", "DMLC_"))})
    reset_config()
    cfg = get_config()
    check_observability(cfg, "router")
    replicas = [a.strip() for a in cfg.router_replicas.split(",")
                if a.strip()]
    if not replicas:
        raise SystemExit(
            "byteps_tpu_torch.launcher: the router role needs "
            "BYTEPS_ROUTER_REPLICAS=host:port,host:port (the serve "
            "replicas to fan out over)")
    peers = [a.strip() for a in cfg.router_peers.split(",")
             if a.strip()]
    if peers and not cfg.router_self:
        raise SystemExit(
            "byteps_tpu_torch.launcher: BYTEPS_ROUTER_PEERS is set, so "
            "BYTEPS_ROUTER_SELF must name this router's own entry in "
            "it (host:port) — priority is the list order, and every "
            "router must know its place in it")
    tenant_weights: Dict[str, float] = {}
    if cfg.router_tenant_weights:
        for pair in cfg.router_tenant_weights.split(","):
            t, _, w = pair.partition("=")
            if not t.strip() or not w.strip():
                raise SystemExit(
                    f"byteps_tpu_torch.launcher: malformed "
                    f"BYTEPS_ROUTER_TENANT_WEIGHTS entry {pair!r} "
                    f"(want tenant=weight,tenant=weight)")
            try:
                tenant_weights[t.strip()] = float(w)
            except ValueError:
                raise SystemExit(
                    f"byteps_tpu_torch.launcher: BYTEPS_ROUTER_TENANT_WEIGHTS "
                    f"weight for {t.strip()!r} must be a number, got "
                    f"{w.strip()!r}") from None
    roles = [x.strip() for x in cfg.router_roles.split(",")
             if x.strip()]
    if roles and len(roles) != len(replicas):
        raise SystemExit(
            f"byteps_tpu_torch.launcher: BYTEPS_ROUTER_ROLES has "
            f"{len(roles)} entries for {len(replicas)} replicas — it "
            f"must mirror BYTEPS_ROUTER_REPLICAS positionally "
            f"(prefill, decode, or both)")
    router = ServeRouter(
        replicas,
        roles=roles or None,
        disagg=cfg.disagg,
        credits=cfg.router_credits,
        affinity=cfg.router_affinity,
        affinity_block=cfg.router_affinity_block,
        deadline=cfg.router_deadline_ms / 1e3,
        stream_timeout=cfg.router_stream_timeout_ms / 1e3,
        heartbeat_interval=cfg.router_heartbeat_ms / 1e3,
        miss_threshold=cfg.router_miss_threshold,
        ping_timeout=cfg.heartbeat_timeout_ms / 1e3,
        expected_weights_fp=cfg.router_weights_fp or None,
        peers=peers or None,
        self_addr=cfg.router_self,
        epoch_timeout=cfg.router_epoch_timeout_ms / 1e3,
        tenant_weights=tenant_weights or None,
        slo_default=cfg.slo_default,
        slo_deadlines={
            SLO_STANDARD: cfg.slo_standard_deadline_ms / 1e3,
            SLO_BEST_EFFORT: cfg.slo_best_effort_deadline_ms / 1e3},
        service_estimate_s=cfg.slo_service_estimate_ms / 1e3,
        slo_borrow=cfg.slo_borrow)
    controller = None
    if cfg.autoscale:
        from .autoscale import (AutoscaleController, ReplicaLauncher,
                                ScalePolicy, TierSignals, poll_router)
        controller = AutoscaleController(
            router,
            ScalePolicy(
                min_replicas=cfg.autoscale_min,
                max_replicas=cfg.autoscale_max,
                up_threshold=cfg.autoscale_up,
                down_threshold=cfg.autoscale_down,
                up_cooldown_s=cfg.autoscale_up_cooldown_ms / 1e3,
                down_cooldown_s=cfg.autoscale_down_cooldown_ms / 1e3,
                dry_run=cfg.autoscale_dry_run),
            TierSignals(poll_router(router),
                        window_s=cfg.autoscale_window_ms / 1e3),
            ReplicaLauncher(),
            interval_s=cfg.autoscale_interval_ms / 1e3).start()
    try:
        serve_router(router, cfg.router_port)
    finally:
        if controller is not None:
            controller.close()
    return 0
