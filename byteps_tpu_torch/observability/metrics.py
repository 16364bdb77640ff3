"""Typed, thread-safe metrics registry — the port's subset of
``byteps_tpu/observability/metrics.py`` that ``serving/metrics.py``, the
router tier and the resilience counters need: :class:`Counter`,
:class:`Gauge`, :class:`Histogram` (fixed buckets plus a bounded
reservoir for percentiles) and a get-or-create :class:`MetricsRegistry`
keyed by name and static labels, with ``get``, ``remove``,
``remove_prefix`` and ``snapshot()``.

As in the JAX package, a counter bump or a gauge write is mirrored onto
the process's chrome-trace ``Tracer`` (common/tracing.py) when tracing
is on (``BYTEPS_TRACE_PATH``): an instant event with ``inc``'s keyword
arguments (unless ``instants=False``) and a value on the metric's
counter track (its ``track``, by default the name's namespace prefix);
``mirror=False`` keeps a metric registry-only.  The Prometheus scrape is
not ported (queue A item 10).  ``snapshot()`` keeps the JAX layout
(``{"counters", "gauges", "histograms"}`` keyed by
``name{label=value,...}``), which the STATS replies carry unchanged.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry"]


def _tracer():
    from ..common.tracing import get_tracer

    return get_tracer()


def _default_track(name: str) -> str:
    """A metric's chrome-trace row: its namespace prefix
    (``resilience.retry`` -> ``resilience``), else ``metrics``."""
    return name.split(".", 1)[0] if "." in name else "metrics"


class _Metric:
    """Identity: the name, its trace row and its static labels
    (``label_key`` is the snapshot key and the mirrored series name,
    JAX's ``name{k=v,...}``)."""

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None,
                 track: Optional[str] = None):
        self.name = name
        self.track = track or _default_track(name)
        self.labels = dict(labels or {})
        if self.labels:
            inner = ",".join(f"{k}={v}"
                             for k, v in sorted(self.labels.items()))
            self.label_key = f"{name}{{{inner}}}"
        else:
            self.label_key = name
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonic counter.  ``inc``'s keyword arguments ride the mirrored
    instant event; ``instants=False`` keeps only the value track and
    ``mirror=False`` drops the mirroring."""

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None,
                 track: Optional[str] = None, instants: bool = True,
                 mirror: bool = True):
        super().__init__(name, labels, track)
        self._value = 0
        self._instants = instants
        self._mirror = mirror

    def inc(self, n: int = 1, **args) -> int:
        with self._lock:
            self._value += n
            total = self._value
        if self._mirror:
            tracer = _tracer()
            if tracer.enabled:
                if self._instants:
                    # "name" would collide with instant()'s own first param
                    safe = {("tensor" if k == "name" else k): v
                            for k, v in args.items()}
                    tracer.instant(self.label_key, self.track, **safe)
                tracer.counter(self.label_key, total, self.track)
        return total

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge(_Metric):
    """Last-written value, mirrored onto its trace value track."""

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None,
                 track: Optional[str] = None, mirror: bool = True):
        super().__init__(name, labels, track)
        self._value = 0.0
        self._mirror = mirror

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
        if self._mirror:
            tracer = _tracer()
            if tracer.enabled:
                tracer.counter(self.label_key, value, self.track)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                    1.0, 2.5, 5.0, 10.0)


def _nearest_rank(vals: List[float], q: float) -> float:
    """Nearest-rank percentile of pre-sorted ``vals`` (the JAX
    package's rank formula, so both packages report the same p50/p99
    from the same samples)."""
    if not vals:
        return 0.0
    k = max(0, min(len(vals) - 1, int(round(q / 100.0 * (len(vals) - 1)))))
    return vals[k]


class Histogram(_Metric):
    """Cumulative-bucket histogram + ring reservoir of the most recent
    ``max_samples`` observations (percentiles come from the ring)."""

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None,
                 buckets: Optional[Tuple[float, ...]] = None,
                 max_samples: int = 4096):
        super().__init__(name, labels)
        self.buckets = tuple(sorted(buckets or _DEFAULT_BUCKETS))
        self._counts = [0] * (len(self.buckets) + 1)  # +inf bucket
        self._count = 0
        self._sum = 0.0
        self._samples: List[float] = []
        self._max_samples = max(1, int(max_samples))
        self._next = 0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._count += 1
            self._sum += value
            i = len(self.buckets)
            for j, b in enumerate(self.buckets):
                if value <= b:
                    i = j
                    break
            self._counts[i] += 1
            if len(self._samples) < self._max_samples:
                self._samples.append(value)
            else:
                self._samples[self._next] = value
                self._next = (self._next + 1) % self._max_samples

    def percentile(self, q: float) -> float:
        with self._lock:
            vals = sorted(self._samples)
        return _nearest_rank(vals, q)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def state(self) -> Dict[str, object]:
        with self._lock:
            counts = list(self._counts)
            count, total = self._count, self._sum
            vals = sorted(self._samples)
        cum, acc = [], 0
        for c in counts[:-1]:
            acc += c
            cum.append(acc)
        return {"count": count, "sum": total,
                "p50": _nearest_rank(vals, 50),
                "p90": _nearest_rank(vals, 90),
                "p99": _nearest_rank(vals, 99),
                "buckets": {str(b): c for b, c in zip(self.buckets, cum)}}


def _key(name: str, labels: Dict[str, object]):
    return name, frozenset((k, str(v)) for k, v in labels.items())


class MetricsRegistry:
    """Get-or-create metric store: a name + labels pair maps to exactly
    one metric; re-requesting it as another type raises."""

    def __init__(self):
        self._metrics: Dict[tuple, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, labels: Dict[str, object],
                       **kw):
        key = _key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, {k: str(v) for k, v in labels.items()}, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, track: Optional[str] = None,
                instants: bool = True, mirror: bool = True,
                **labels) -> Counter:
        return self._get_or_create(Counter, name, labels, track=track,
                                   instants=instants, mirror=mirror)

    def gauge(self, name: str, track: Optional[str] = None,
              mirror: bool = True, **labels) -> Gauge:
        return self._get_or_create(Gauge, name, labels, track=track,
                                   mirror=mirror)

    def histogram(self, name: str) -> Histogram:
        return self._get_or_create(Histogram, name, {})

    def get(self, name: str, **labels) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(_key(name, labels))

    def remove(self, name: str, **labels) -> bool:
        """Drop one metric; the next get-or-create of the same name and
        labels starts from zero."""
        with self._lock:
            return self._metrics.pop(_key(name, labels), None) is not None

    def remove_prefix(self, prefix: str) -> int:
        """Drop every metric whose name starts with ``prefix`` (any
        labels); returns how many were removed."""
        with self._lock:
            doomed = [k for k in self._metrics if k[0].startswith(prefix)]
            for k in doomed:
                del self._metrics[k]
        return len(doomed)

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        with self._lock:
            metrics = list(self._metrics.values())
        out: Dict[str, Dict[str, object]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        for m in metrics:
            if isinstance(m, Counter):
                out["counters"][m.label_key] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][m.label_key] = m.value
            else:
                out["histograms"][m.label_key] = m.state()
        return out


_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global registry."""
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = MetricsRegistry()
        return _registry

