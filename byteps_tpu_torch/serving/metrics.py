"""Serving metrics — the port of ``byteps_tpu/serving/metrics.py``
(the counters the paged engine bumps — requests, tokens, prefill,
prefix reuse, speculation, preemption, disaggregated KV ships —
TTFT/TPOT/queue-wait/ship histograms, KV block gauges),
registry-backed by the port's ``observability/metrics.py``.  Counter
names are the JAX package's, so a STATS reply reads the same from
either engine.
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
# prefix reuse (serving/prefix.py): lookup outcomes per admission, the
# tokens whose prefill a hit skipped, and inserts that stored something
PREFIX_HITS = "serve.prefix_hits"
PREFIX_MISSES = "serve.prefix_misses"
PREFIX_HIT_TOKENS = "serve.prefix_hit_tokens"
PREFIX_INSERTIONS = "serve.prefix_insertions"
KV_BLOCKS_FREE = "serve.kv_blocks_free"
KV_BLOCKS_USED = "serve.kv_blocks_used"
KV_BLOCKS_SHARED = "serve.kv_blocks_shared"
# prefix-store nodes evicted (each released one block reference)
BLOCK_EVICTIONS = "serve.block_evictions"
PREEMPTIONS = "serve.preemptions"
# blocks the gather fallback copied into rows this tick (n_slots x the
# high-water bucket, decode and verify passes alike)
GATHERED_BLOCKS = "serve.gathered_blocks"
# ticks that ran a decode or verify forward (the tokens-per-tick
# denominator; one paged-attention launch per layer — tp per layer on a
# tp pool — per tick)
DECODE_TICKS = "serve.decode_ticks"
# speculative decoding (serving/spec.py): tokens handed to the verifier,
# proposed tokens the model confirmed (before budget/EOS truncation),
# and the ticks that ran a verify pass in place of a plain decode
SPEC_PROPOSED = "serve.spec_proposed_tokens"
SPEC_ACCEPTED = "serve.spec_accepted_tokens"
SPEC_VERIFY_TICKS = "serve.spec_verify_ticks"
OCCUPANCY = "serve.batch_occupancy"
QUEUE_DEPTH = "serve.queue_depth"
TTFT_MS = "serve.ttft_ms"
TPOT_MS = "serve.tpot_ms"
QUEUE_WAIT_MS = "serve.queue_wait_ms"
QUEUE_WAIT_S = "serve.queue_wait_s"
TTFT_S = "serve.ttft_s"
TPOT_S = "serve.tpot_s"
PREFILL_CREDITS = "serve.prefill_credits"
# disaggregated prefill/decode (serving/disagg): KV blocks a prefill
# replica shipped over OP_KV_BLOCKS, their payload bytes (framing
# excluded, so the counter divides into block_bytes exactly), and the
# per-request ship latency (extract -> last ack, seconds)
KV_BLOCKS_SHIPPED = "serve.kv_blocks_shipped"
KV_BLOCKS_SHIPPED_BYTES = "serve.kv_blocks_shipped_bytes"
SHIP_LATENCY_S = "serve.ship_latency_s"


class ServeMetrics:
    """Thread-safe serving counters + latency samples, registry-backed.
    ``registry=None`` builds a private registry (isolated counting);
    :func:`get_serve_metrics` binds the process-global one."""

    _HIST = {"queue_wait": QUEUE_WAIT_S, "ttft": TTFT_S, "tpot": TPOT_S,
             "ship": SHIP_LATENCY_S}

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
        for label in ("queue_wait", "ttft", "tpot", "ship"):
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

