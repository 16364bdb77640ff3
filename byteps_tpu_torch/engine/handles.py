"""Handle-based async result tracking — the port of
``byteps_tpu/engine/handles.py``, counterpart of reference
``byteps/torch/handle_manager.{h,cc}`` (mutex-guarded handle -> Status map)
and the poll/wait API of ``torch/ops.cc:107-120``.

Difference from the reference: ``WaitAndClear`` there spins with 1 ms sleeps
(ops.cc:114-120); here each handle owns a ``threading.Event`` so waiters are
woken exactly once, and the result payload rides along with the Status.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from ..common.types import Status


class HandleManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        self._done: Dict[int, Tuple[Status, Any]] = {}
        self._events: Dict[int, threading.Event] = {}

    def allocate(self) -> int:
        """Reference handle_manager.cc:22-28."""
        with self._lock:
            h = self._next
            self._next += 1
            self._events[h] = threading.Event()
            return h

    def mark_done(self, handle: int, status: Status, result: Any = None) -> None:
        """Reference handle_manager.cc:30-36 (MarkDone)."""
        with self._lock:
            ev = self._events.get(handle)
            self._done[handle] = (status, result)
        if ev is not None:
            ev.set()

    def poll(self, handle: int) -> bool:
        """Reference handle_manager.cc:38-43 (PollHandle)."""
        with self._lock:
            if handle not in self._events and handle not in self._done:
                raise ValueError(f"handle {handle} was never allocated")
            return handle in self._done

    def wait_and_clear(self, handle: int, timeout: Optional[float] = None):
        """Reference handle_manager.cc:45-54 + ops.cc:114-120; returns the
        result payload, raising if the status is an error."""
        with self._lock:
            ev = self._events.get(handle)
            if ev is None and handle not in self._done:
                raise ValueError(f"handle {handle} was never allocated")
        if ev is not None and not ev.wait(timeout):
            raise TimeoutError(f"handle {handle} not done within {timeout}s")
        with self._lock:
            status, result = self._done.pop(handle)
            self._events.pop(handle, None)
        if not status.ok():
            raise RuntimeError(f"push_pull failed: {status.type.name}: {status.reason}")
        return result

    def pending(self) -> int:
        with self._lock:
            return len(self._events) - len(self._done)
