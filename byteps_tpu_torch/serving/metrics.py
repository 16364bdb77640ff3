"""Serving metrics — the port of ``byteps_tpu/serving/metrics.py``
(the counters the paged engine bumps, TTFT/TPOT/queue-wait histograms,
KV block gauges), registry-backed by the port's
``observability/metrics.py``.  Counter names are the JAX package's, so
a STATS reply reads the same from either engine.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..common import logging as bps_log
from ..observability.metrics import MetricsRegistry, get_registry

SUBMITTED = "serve.requests_submitted"
ADMITTED = "serve.requests_admitted"
REJECTED = "serve.requests_rejected"
COMPLETED = "serve.requests_completed"
CANCELLED = "serve.requests_cancelled"
FAILED = "serve.requests_failed"
TOKENS = "serve.tokens_generated"
PREFILL_TOKENS = "serve.prefill_tokens"
PREFILL_CHUNKS = "serve.prefill_chunks"
KV_BLOCKS_FREE = "serve.kv_blocks_free"
KV_BLOCKS_USED = "serve.kv_blocks_used"
PREEMPTIONS = "serve.preemptions"
# ticks that ran a decode forward (the tokens-per-tick denominator; one
# paged-attention launch per layer per tick)
DECODE_TICKS = "serve.decode_ticks"
OCCUPANCY = "serve.batch_occupancy"
QUEUE_DEPTH = "serve.queue_depth"
TTFT_MS = "serve.ttft_ms"
TPOT_MS = "serve.tpot_ms"
QUEUE_WAIT_MS = "serve.queue_wait_ms"
QUEUE_WAIT_S = "serve.queue_wait_s"
TTFT_S = "serve.ttft_s"
TPOT_S = "serve.tpot_s"
PREFILL_CREDITS = "serve.prefill_credits"


class ServeMetrics:
    """Thread-safe serving counters + latency samples, registry-backed.
    ``registry=None`` builds a private registry (isolated counting);
    :func:`get_serve_metrics` binds the process-global one."""

    _HIST = {"queue_wait": QUEUE_WAIT_S, "ttft": TTFT_S, "tpot": TPOT_S}

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._registry = (registry if registry is not None
                          else MetricsRegistry())
        self._names: Dict[str, None] = {}
        self._lock = threading.Lock()

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry

    def _hist(self, label: str):
        return self._registry.histogram(self._HIST[label])

    def bump(self, counter: str, n: int = 1) -> int:
        with self._lock:
            self._names.setdefault(counter, None)
        total = self._registry.counter(counter).inc(n)
        bps_log.debug("%s -> %d", counter, total)
        return total

    def gauge(self, name: str, value: float) -> None:
        self._registry.gauge(name).set(value)

    def observe_tick(self, occupancy: float, queue_depth: int,
                     tokens_emitted: int) -> None:
        if tokens_emitted:
            self.bump(TOKENS, tokens_emitted)
        self.gauge(OCCUPANCY, occupancy)
        self.gauge(QUEUE_DEPTH, queue_depth)

    def observe_request(self, queue_wait_s: float, ttft_s: float,
                        tpot_s: Optional[float]) -> None:
        """One completed request's latency profile (``tpot_s`` None for
        single-token requests)."""
        self._hist("queue_wait").observe(queue_wait_s)
        self._hist("ttft").observe(ttft_s)
        if tpot_s is not None:
            self._hist("tpot").observe(tpot_s)
        self.gauge(QUEUE_WAIT_MS, queue_wait_s * 1e3)
        self.gauge(TTFT_MS, ttft_s * 1e3)
        if tpot_s is not None:
            self.gauge(TPOT_MS, tpot_s * 1e3)
        self.bump(COMPLETED)

    def get(self, name: str) -> int:
        m = self._registry.get(name)
        return m.value if m is not None else 0

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            names = list(self._names)
        return {n: self.get(n) for n in names}

    def summary(self) -> Dict[str, object]:
        """Counters plus latency percentiles (seconds)."""
        out: Dict[str, object] = dict(self.snapshot())
        for label in ("queue_wait", "ttft", "tpot"):
            h = self._hist(label)
            out[f"{label}_p50_s"] = h.percentile(50)
            out[f"{label}_p99_s"] = h.percentile(99)
            out[f"{label}_n"] = h.count
        return out


_metrics: Optional[ServeMetrics] = None
_metrics_lock = threading.Lock()


def get_serve_metrics() -> ServeMetrics:
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            _metrics = ServeMetrics(registry=get_registry())
        return _metrics

