"""Wire-compression observability — the port of
``byteps_tpu/compression/stats.py``.

Every payload put on the cross-machine link bumps two monotonic
counters, per tensor and in total:

  * ``compression.wire_bytes_sent``  — bytes actually sent;
  * ``compression.wire_bytes_saved`` — raw bytes minus wire bytes (what
    compression kept off the link).

The totals live in a metrics registry (observability/metrics.py — the
process-global one for ``get_compression_stats()``), whose counters are
mirrored onto the chrome trace when ``BYTEPS_TRACE_PATH`` is set (one
value track each, plus a per-tensor instant event carrying the tensor
name).  ``log_summary()`` emits the run-end one-liner.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from ..common import logging as bps_log
from ..observability.metrics import MetricsRegistry, get_registry

WIRE_BYTES_SENT = "compression.wire_bytes_sent"
WIRE_BYTES_SAVED = "compression.wire_bytes_saved"

__all__ = ["WIRE_BYTES_SENT", "WIRE_BYTES_SAVED", "CompressionStats",
           "get_compression_stats", "reset_compression_stats"]


class CompressionStats:
    """Thread-safe per-tensor wire byte accounting with Tracer surfacing."""

    def __init__(self, tracer=None,
                 registry: Optional[MetricsRegistry] = None):
        self._lock = threading.Lock()
        self._per_tensor: Dict[str, Tuple[int, int]] = {}  # name -> (raw, wire)
        self._raw_total = 0
        self._wire_total = 0
        self._tracer = tracer
        self._registry = registry if registry is not None \
            else MetricsRegistry()
        # per-frame bumps: counter value track only, no instant spam
        # (the per-tensor instant below carries the detail)
        self._c_sent = self._registry.counter(
            WIRE_BYTES_SENT, track="compression", instants=False)
        self._c_saved = self._registry.counter(
            WIRE_BYTES_SAVED, track="compression", instants=False)

    def _get_tracer(self):
        if self._tracer is not None:
            return self._tracer
        from ..common.tracing import get_tracer

        return get_tracer()

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry

    def observe(self, name: str, raw_bytes: int, wire_bytes: int) -> None:
        with self._lock:
            r, w = self._per_tensor.get(name, (0, 0))
            self._per_tensor[name] = (r + raw_bytes, w + wire_bytes)
            self._raw_total += raw_bytes
            self._wire_total += wire_bytes
        self._c_sent.inc(wire_bytes)
        self._c_saved.inc(raw_bytes - wire_bytes)
        tracer = self._get_tracer()
        if tracer.enabled:
            tracer.instant(WIRE_BYTES_SENT, "compression", tensor=name,
                           raw=raw_bytes, wire=wire_bytes)

    # ------------------------------------------------------------ reporting

    def per_tensor(self) -> Dict[str, Tuple[int, int]]:
        with self._lock:
            return dict(self._per_tensor)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            raw, wire = self._raw_total, self._wire_total
            tensors = len(self._per_tensor)
        return {
            "raw_bytes": raw,
            "wire_bytes_sent": wire,
            "wire_bytes_saved": raw - wire,
            "compression_ratio": (raw / wire) if wire else 1.0,
            "tensors": tensors,
        }

    def log_summary(self) -> Optional[str]:
        """The run-end summary line; returns it (None when nothing was
        observed, so idle clients stay silent)."""
        s = self.summary()
        if not s["raw_bytes"]:
            return None
        line = ("wire compression: %.1f MB raw -> %.1f MB sent "
                "(%.2fx, %.1f MB saved) across %d tensors" % (
                    s["raw_bytes"] / 1e6, s["wire_bytes_sent"] / 1e6,
                    s["compression_ratio"], s["wire_bytes_saved"] / 1e6,
                    s["tensors"]))
        bps_log.info(line)
        return line


_stats: Optional[CompressionStats] = None
_stats_lock = threading.Lock()


def get_compression_stats() -> CompressionStats:
    global _stats
    with _stats_lock:
        if _stats is None:
            _stats = CompressionStats(registry=get_registry())
        return _stats


def reset_compression_stats() -> None:
    """Forget the singleton AND its counts: the ``compression.*``
    metrics live in the process-global registry, which outlives the
    singleton, so they are removed explicitly — otherwise a rebuilt
    ``get_compression_stats()`` would report pre-reset byte totals."""
    global _stats
    with _stats_lock:
        inst, _stats = _stats, None
    if inst is not None:
        inst.registry.remove_prefix("compression.")
