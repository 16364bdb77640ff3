"""Priority + credit scheduled queue — the port's copy of
``ScheduledQueue`` (``byteps_tpu/common/scheduler.py``), which the eager
push_pull engine, the serving scheduler and the router's tenant credit
pools build on.

Semantics of reference ``scheduled_queue.{h,cc}``:
  * tasks kept sorted by (priority desc, key asc);
  * ``get_task`` skips tasks whose length exceeds the remaining credits
    and decrements credits on grant;
  * ``report_finish`` returns credits;
  * an unscheduled queue grants unlimited credit;
  * ``wait_task`` blocks for a grant; ``close`` wakes every waiter.

A task is any object with ``.priority``, ``.key``, ``.length`` and
``.name`` (the engine's ``TensorTaskEntry``, the serving engine's
``PrefillTask``).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from . import logging as bps_log

UNLIMITED_CREDIT = 34359738368  # 32 GB, reference scheduled_queue.cc:40-42


class ScheduledQueue:
    def __init__(self, scheduled: bool = False, credit_bytes: int = 0,
                 name: str = ""):
        self._is_scheduled = scheduled
        self._credits = (credit_bytes if scheduled and credit_bytes > 0
                         else UNLIMITED_CREDIT)
        self._queue: List = []
        # a condition, so debit_wait and wait_task sleep until a task,
        # credit()/report_finish or close()
        self._lock = threading.Condition()
        self._closed = False
        self.name = name

    def add_task(self, task) -> None:
        """Insert keeping (priority desc, key asc) order."""
        with self._lock:
            lo, hi = 0, len(self._queue)
            k = (-task.priority, task.key)
            while lo < hi:
                mid = (lo + hi) // 2
                mk = (-self._queue[mid].priority, self._queue[mid].key)
                if mk <= k:
                    lo = mid + 1
                else:
                    hi = mid
            self._queue.insert(lo, task)
            bps_log.trace("queue %s: added %s key %d prio %d (%d pending)",
                          self.name, task.name, task.key, task.priority,
                          len(self._queue))
            self._lock.notify_all()

    def get_task(self, key: Optional[int] = None):
        """Grant the best task (or the one with ``key``) within the credit
        budget, or None (reference scheduled_queue.cc:100-161)."""
        with self._lock:
            return self._get_locked(key)

    def _get_locked(self, key: Optional[int] = None):
        for i, task in enumerate(self._queue):
            if key is not None and task.key != key:
                continue
            if self._is_scheduled and task.length > self._credits:
                continue
            if self._is_scheduled:
                self._credits -= task.length
            del self._queue[i]
            bps_log.trace("queue %s: granted %s key %d (credits left %d)",
                          self.name, task.name, task.key, self._credits)
            return task
        return None

    def wait_task(self, timeout: Optional[float] = None):
        """Blocking :meth:`get_task`: a grant, or None after ``timeout``
        seconds or at once once the queue is closed."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                task = self._get_locked()
                if task is not None:
                    return task
                if self._closed:
                    return None
                left = None if deadline is None else \
                    deadline - time.monotonic()
                if left is not None and left <= 0:
                    return None
                self._lock.wait(left)

    def wait_grantable(self, timeout: float) -> bool:
        """Block until a queued task fits the credits (True), or
        ``timeout`` seconds pass or the queue closes (False); grants
        nothing."""
        def fits():
            return self._closed or any(
                not self._is_scheduled or t.length <= self._credits
                for t in self._queue)

        with self._lock:
            return self._lock.wait_for(fits, timeout) and not self._closed

    def tasks(self) -> List:
        """The queued tasks in grant order (a snapshot)."""
        with self._lock:
            return list(self._queue)

    def close(self) -> None:
        """Wake every waiter; later waits return None at once."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()

    def drain(self) -> List:
        """Remove and return every queued task, ignoring credits."""
        with self._lock:
            tasks, self._queue = list(self._queue), []
            return tasks

    def report_finish(self, task) -> None:
        """Return a granted task's credits."""
        with self._lock:
            if self._is_scheduled:
                self._credits += task.length
                self._lock.notify_all()

    def try_debit(self, n: int) -> bool:
        """Consume ``n`` credits for work granted outside the queue (a
        chunked-prefill continuation); False, debiting nothing, when the
        remaining credits cannot cover it."""
        with self._lock:
            if not self._is_scheduled:
                return True
            if n > self._credits:
                return False
            self._credits -= n
            return True

    def credit(self, n: int) -> None:
        """Return ``n`` directly-debited credits."""
        with self._lock:
            if self._is_scheduled:
                self._credits += n
                self._lock.notify_all()

    def debit_wait(self, n: int, timeout: float) -> bool:
        """:meth:`try_debit`'s blocking form: wait up to ``timeout``
        seconds for ``n`` credits and consume them (woken by
        :meth:`credit` / :meth:`report_finish`).  False on timeout."""
        deadline = time.monotonic() + timeout
        with self._lock:
            if not self._is_scheduled:
                return True
            while n > self._credits:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._lock.wait(left)
            self._credits -= n
            return True

    def remove(self, task) -> bool:
        """Remove a still-pending task without granting it; False when
        it is no longer queued."""
        with self._lock:
            for i, queued in enumerate(self._queue):
                if queued is task:
                    del self._queue[i]
                    return True
            return False

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def credits(self) -> int:
        with self._lock:
            return self._credits
