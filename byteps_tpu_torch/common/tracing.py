"""Chrome-trace recorder — the port of ``byteps_tpu/common/tracing.py``.

The reference's observability (SURVEY.md §5) is a Chrome-trace timeline
of per-key push/pull begin/end events (``BYTEPS_SERVER_ENABLE_PROFILE``,
docs/timeline.md) plus TRACE-level queue logging.  Here:

  * ``Tracer`` — a process-wide Chrome-trace event recorder.  The eager
    engine (engine/dispatcher.py) records a span per (partition, stage),
    so ``chrome://tracing`` / Perfetto render the reference's per-key
    timeline.  Enable with ``BYTEPS_TRACE_PATH=/tmp/bps_trace.json``.
  * ``annotate`` — a ``torch.profiler.record_function`` region, so a
    step's stages show up named in a ``torch.profiler`` trace.

Timestamps are wall-clock anchored: a fixed ``time.time() -
perf_counter()`` epoch captured at construction maps monotonic
``perf_counter`` deltas onto the wall clock, so trace files of several
processes share one microsecond axis.

The in-memory buffer is bounded (``BYTEPS_TRACE_BUFFER`` events): at the
bound it rolls over into an incremental flush that appends to the trace
file on a background thread and leaves it valid JSON after every write.
Batches that cannot be written are dropped loudly, with a counted
``trace.events_dropped`` metric, instead of growing without bound.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import List, Optional

from . import logging as bps_log
from .config import get_config

# incremental trace file framing: every flush rewrites the terminator,
# so the file parses as {"traceEvents": [...]} between (and after) runs
_HEAD = '{"traceEvents": [\n'
_TERM = "\n]}\n"


class Tracer:
    """Chrome-trace ("trace event format") recorder, thread-safe.

    Events are complete-events ("ph": "X") with microsecond timestamps, one
    row (tid) per pipeline stage — mirroring the reference's
    push/pull-per-key rows (docs/timeline.md).
    """

    def __init__(self, path: str = "", key_filter: str = "",
                 max_events: Optional[int] = None):
        self.path = path
        self.key_filter = key_filter
        self._events: List[dict] = []
        self._lock = threading.Lock()      # guards the event buffer
        self._io_lock = threading.Lock()   # serializes file appends
        # cached once: getpid is a real syscall on every event otherwise,
        # and sandboxed kernels make syscalls ~100x a dict append
        self._pid = os.getpid()
        # wall-clock anchor for perf_counter deltas (see module doc)
        self._epoch = time.time() - time.perf_counter()
        self._max = (get_config().trace_buffer if max_events is None
                     else max_events)
        self._file_started = False     # HEAD + terminator are on disk
        self._file_has_events = False  # the on-disk array is non-empty
        self._dropped = 0
        # rollover batches are written by ONE lazy daemon thread: the
        # event that trips the buffer bound may be recorded from the
        # engine's dispatch or completion loop, and an inline ~100k-event
        # json+write there would stall every collective behind it for
        # ~1 s — exactly the straggler this layer exists to expose.  _pending
        # counts queued-but-unwritten batches; flush() waits on it so
        # callers still see a complete file, and the cap below keeps
        # memory bounded if the disk cannot keep up.
        self._wq = None                # queue.SimpleQueue, lazy
        self._pending = 0
        self._cv = threading.Condition(self._lock)

    _MAX_PENDING = 4  # queued rollover batches before loud dropping

    @property
    def enabled(self) -> bool:
        return bool(self.path)

    @property
    def dropped(self) -> int:
        """Events lost to failed rollover writes (see module doc)."""
        with self._lock:
            return self._dropped

    def _now_us(self) -> float:
        return (self._epoch + time.perf_counter()) * 1e6

    def _to_us(self, t_perf: float) -> float:
        """Map a caller-taken ``time.perf_counter()`` stamp onto this
        tracer's wall-anchored microsecond axis."""
        return (self._epoch + t_perf) * 1e6

    def _append(self, ev: dict) -> None:
        """Buffer one event; at the bound, roll the buffer over to the
        background writer so memory stays O(BYTEPS_TRACE_BUFFER) and
        the recording thread never pays the file I/O."""
        drained = None
        overflow = False
        with self._lock:
            self._events.append(ev)
            if self._max and self._max > 0 and len(self._events) >= self._max:
                drained, self._events = self._events, []
                if self._pending >= self._MAX_PENDING:
                    overflow = True  # writer behind: drop, don't grow
                else:
                    self._pending += 1
        if overflow:
            self._drop_batch(drained, "writer backlog")
        elif drained:
            self._writer_queue().put(drained)

    def _writer_queue(self):
        """The rollover queue, starting its daemon writer on first use
        (most tracers never roll over and get no thread)."""
        with self._cv:
            if self._wq is None:
                import queue

                self._wq = queue.SimpleQueue()
                threading.Thread(target=self._writer_loop,
                                 name="bps-trace-writer",
                                 daemon=True).start()
            return self._wq

    def _writer_loop(self) -> None:
        while True:
            batch = self._wq.get()
            if batch is None:  # reset_tracer's stop sentinel
                return
            try:
                self._write_batch(batch)
            finally:
                with self._cv:
                    self._pending -= 1
                    self._cv.notify_all()

    def _drain_writer(self, timeout: float = 30.0) -> None:
        """Block until every queued rollover batch is on disk — the
        ordering fence flush() needs before it appends the tail."""
        with self._cv:
            self._cv.wait_for(lambda: self._pending == 0, timeout=timeout)
            if self._pending:  # pragma: no cover - stuck-disk escape
                bps_log.warning(
                    "tracer: giving up on %d unwritten rollover "
                    "batches after %.0fs", self._pending, timeout)

    def _stop_writer(self) -> None:
        """Stop the writer thread (after a final drain) so resets don't
        leak one blocked thread per Tracer generation."""
        with self._cv:
            wq = self._wq
        if wq is not None:
            self._drain_writer()
            wq.put(None)

    @contextmanager
    def span(self, name: str, stage: str, key: Optional[int] = None, **args):
        if not self.enabled or (self.key_filter and self.key_filter not in name):
            yield
            return
        t0 = self._now_us()
        try:
            yield
        finally:
            t1 = self._now_us()
            self._append(
                {
                    "name": name,
                    "cat": stage,
                    "ph": "X",
                    "ts": t0,
                    "dur": t1 - t0,
                    "pid": self._pid,
                    "tid": stage,
                    "args": {"key": key, **args},
                }
            )

    def complete(self, name: str, stage: str, t0: float, dur: float,
                 **args) -> None:
        """Record a span from caller-held ``perf_counter`` stamps:
        ``t0`` seconds (perf_counter clock), ``dur`` seconds, for spans
        whose threads only note timestamps and never touch the tracer."""
        if not self.enabled or (self.key_filter
                                and self.key_filter not in name):
            return
        self._append(
            {
                "name": name,
                "cat": stage,
                "ph": "X",
                "ts": self._to_us(t0),
                "dur": dur * 1e6,
                "pid": self._pid,
                "tid": stage,
                "args": args,
            }
        )

    def counter(self, name: str, value: float, stage: str = "counters") -> None:
        """Chrome-trace counter event ("ph": "C") — renders as a value
        track in chrome://tracing / Perfetto.  Used by the resilience
        subsystem to put retries/failovers/heartbeat misses on the same
        timeline as the push/pull spans."""
        if not self.enabled:
            return
        self._append(
            {
                "name": name,
                "cat": stage,
                "ph": "C",
                "ts": self._now_us(),
                "pid": self._pid,
                "tid": stage,
                "args": {"value": value},
            }
        )

    def instant(self, name: str, stage: str, **args) -> None:
        if not self.enabled:
            return
        self._append(
            {
                "name": name,
                "cat": stage,
                "ph": "i",
                "s": "p",
                "ts": self._now_us(),
                "pid": self._pid,
                "tid": stage,
                "args": args,
            }
        )

    # ------------------------------------------------------------ flushing

    def _write_batch(self, events: List[dict]) -> None:
        """Append ``events`` to ``self.path``, leaving the file valid
        JSON: the first batch writes the ``{"traceEvents": [`` head +
        terminator, later batches seek back over the terminator and
        extend the array — O(new events) per flush, never a rewrite of
        history.  A failed write drops the batch with a counted
        ``trace.events_dropped`` (observability registry) instead of
        re-buffering it forever."""
        if not events or not self.path:
            return
        body = ",\n".join(json.dumps(ev) for ev in events)
        try:
            with self._io_lock:
                if not self._file_started:
                    with open(self.path, "w") as f:
                        f.write(_HEAD + body + _TERM)
                    self._file_started = True
                else:
                    sep = ",\n" if self._file_has_events else ""
                    with open(self.path, "r+b") as f:
                        f.seek(-len(_TERM), os.SEEK_END)
                        f.write((sep + body + _TERM).encode())
                self._file_has_events = True
        except OSError as e:
            self._drop_batch(events, f"write to {self.path!r} failed: {e}")

    def _drop_batch(self, events: List[dict], reason: str) -> None:
        """Loud, counted drop — the bounded-memory promise's escape
        valve (unwritable path, or a disk slower than the event rate)."""
        with self._lock:
            self._dropped += len(events)
            total = self._dropped
        bps_log.warning("tracer: dropped %d events (%s); %d dropped total",
                        len(events), reason, total)
        try:
            from ..observability.metrics import get_registry

            get_registry().counter("trace.events_dropped",
                                   instants=False).inc(len(events))
        except Exception:  # pragma: no cover - accounting best-effort
            pass

    def flush(self, path: Optional[str] = None) -> Optional[str]:
        """Write accumulated events as Chrome-trace JSON; returns the path.

        Default path: an incremental append to ``self.path`` (rollover
        batches already live there; this drains the remainder).  An
        explicit *different* ``path`` writes only the currently
        buffered events as a standalone complete file."""
        if not (path or self.path):
            return None
        with self._lock:
            events, self._events = self._events, []
        if path and path != self.path:
            with open(path, "w") as f:
                json.dump({"traceEvents": events}, f)
            return path
        # ordering fence: rollover batches queued before these events
        # must land first, or the file's array goes out of order
        self._drain_writer()
        with self._lock:
            started = self._file_started
        if events or not started:
            # an enabled tracer with zero events still writes a valid
            # empty trace (callers json.load the result unconditionally)
            if events:
                self._write_batch(events)
            else:
                with self._io_lock:
                    if not self._file_started:
                        with open(self.path, "w") as f:
                            f.write(_HEAD[:-1] + _TERM)
                        self._file_started = True
        return self.path

    def events(self) -> List[dict]:
        """The *buffered* (not yet rolled-over) events."""
        with self._lock:
            return list(self._events)


_tracer: Optional[Tracer] = None
_tracer_lock = threading.Lock()
_atexit_armed = False


def _flush_at_exit() -> None:  # pragma: no cover - exercised at interpreter exit
    with _tracer_lock:
        t = _tracer
    if t is not None and t.enabled:
        try:
            t.flush()
        except Exception:
            pass


def get_tracer() -> Tracer:
    global _tracer, _atexit_armed
    with _tracer_lock:
        if _tracer is None:
            _tracer = Tracer(path=get_config().trace_path)
            if not _atexit_armed:
                # crash-safe-ish: a normal interpreter exit flushes the
                # buffer; rollover batches are already on disk
                atexit.register(_flush_at_exit)
                _atexit_armed = True
        return _tracer


def reset_tracer() -> None:
    global _tracer
    with _tracer_lock:
        if _tracer is not None:
            if _tracer.enabled:
                _tracer.flush()
            _tracer._stop_writer()
        _tracer = None


@contextmanager
def annotate(name: str):
    """Named region in ``torch.profiler`` traces (the JAX package's
    ``jax.profiler.TraceAnnotation``)."""
    import torch

    with torch.profiler.record_function(name):
        yield
