"""Credit-scheduled prefill admission over a bounded queue — the port
of ``byteps_tpu/serving/scheduler.py`` (pure host-side Python, carried
over unchanged onto the port's own ``common/scheduler.py``).

BytePS's core scheduling insight (``common/scheduler.py:ScheduledQueue``,
reference scheduled_queue.cc) is that a partitioned work queue under a
credit budget keeps the pipe full without letting large transfers starve
small latency-critical ones.  Serving has the same shape: *prefill* is
the large bursty op (a whole prompt's forward), *decode* is the small
latency-critical one (one token per active request per tick).  This
module reuses ``ScheduledQueue`` verbatim — credits denominated in
**padded prefill tokens** instead of bytes — so each engine tick admits
at most a credit budget's worth of prefill work before the next decode
pass runs.  A burst of long prompts therefore cannot stall the TPOT of
requests already decoding: the surplus waits in the queue, served in
(priority desc, submit order asc) order — exactly the reference's
(priority, key) order — with one inherited ``ScheduledQueue`` nuance:
*within a tick*, a task larger than the credits remaining is skipped
and a shorter later task may be granted past it (the reference's
keep-the-pipe-full scan, scheduled_queue.cc:100-136).  The overtake is
bounded to that tick — credits return at tick end, and the skipped
task's earlier key puts it first in the next scan.

Admission control is a bounded queue: past ``max_queue`` pending
requests, ``submit`` raises the *typed* ``QueueFullError`` carrying the
depth and bound, so frontends can surface backpressure (HTTP 429-style)
instead of buffering unboundedly.
"""

from __future__ import annotations

import itertools
import threading
from typing import List, Optional

from ..common.scheduler import ScheduledQueue


class AdmissionError(RuntimeError):
    """Base class for typed admission failures."""


class QueueFullError(AdmissionError):
    """Bounded admission queue is full — retry later or shed load."""

    def __init__(self, depth: int, bound: int):
        self.depth = depth
        self.bound = bound
        super().__init__(
            f"serve admission queue full ({depth}/{bound} pending); "
            f"retry later or raise BYTEPS_SERVE_MAX_QUEUE")


class PrefillTask:
    """One queued prefill, duck-typing ``TensorTaskEntry`` for
    ``ScheduledQueue`` (it reads only .priority/.key/.length/.name):
    ``length`` is the request's *padded* prompt length — the unit the
    credit budget is denominated in."""

    def __init__(self, request, key: int, padded_len: int):
        self.request = request
        self.priority = request.priority
        self.key = key                    # monotonic => FIFO within prio
        self.length = padded_len
        self.name = f"prefill:req{request.id}"


class ServeScheduler:
    """Bounded, credit-scheduled prefill queue for the serving engine.

    ``credit_budget`` bounds the padded prefill tokens grantable between
    ``finish`` calls (the engine returns every grant's credits at the
    END of its tick, so the budget is per-tick).  A task longer than the
    whole budget has its *accounted* length clamped to the budget at
    submit — it then consumes the entire tick's credit by itself instead
    of starving forever behind shorter prompts that slip past it.
    """

    def __init__(self, max_queue: int = 64, credit_budget: int = 0):
        self.max_queue = max_queue
        self.credit_budget = credit_budget
        self._q = ScheduledQueue(
            scheduled=credit_budget > 0, credit_bytes=credit_budget,
            name="serve.prefill")
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._depth = 0

    # ------------------------------------------------------------- submit

    def submit(self, request, padded_len: int) -> PrefillTask:
        """Enqueue a request for prefill; raises ``QueueFullError`` when
        the bounded queue is at capacity."""
        if self.credit_budget > 0:
            padded_len = min(padded_len, self.credit_budget)
        with self._lock:
            if self._depth >= self.max_queue:
                raise QueueFullError(self._depth, self.max_queue)
            self._depth += 1
            task = PrefillTask(request, next(self._seq), padded_len)
        self._q.add_task(task)
        return task

    # -------------------------------------------------------------- grant

    def resubmit(self, task: PrefillTask) -> None:
        """Re-queue a **preempted** request's original task (paged
        engine, KV block pressure — serving/engine.py ``_preempt``).
        The task keeps its original monotonic key, so within its
        priority it re-enters AHEAD of everything submitted after it —
        a preempted request resumes in its original admission order
        instead of going to the back.  Deliberately bypasses the
        ``max_queue`` bound: preemption must never be lossy, and the
        request was already accounted for when first submitted."""
        with self._lock:
            self._depth += 1
        self._q.add_task(task)

    def admit(self, max_grants: int) -> List[PrefillTask]:
        """Grant up to ``max_grants`` prefills within the credit budget
        (one engine tick's admissions).  Cancelled requests are granted
        too — retiring them (emitting the stream sentinel, metrics) is
        the engine's job, not the queue's.  The caller MUST call
        ``finish`` on every returned task once it is processed (the
        engine does so at end of tick), or credits leak."""
        granted: List[PrefillTask] = []
        while len(granted) < max_grants:
            task = self._q.get_task()
            if task is None:
                break
            with self._lock:
                self._depth -= 1
            granted.append(task)
        return granted

    def finish(self, task: PrefillTask) -> None:
        """Return a granted task's credits (end of the engine tick)."""
        self._q.report_finish(task)

    def take_credits(self, n: int) -> bool:
        """Debit ``n`` credits for prefill work granted outside the
        queue — a chunked-prefill *continuation* chunk of an
        already-admitted request shares this pool with queued
        admissions, so one budget bounds the total prefill work
        between consecutive decode passes.  Pair every success with
        :meth:`return_credits` at end of tick."""
        return self._q.try_debit(n)

    def return_credits(self, n: int) -> None:
        """Return directly-debited continuation credits."""
        self._q.credit(n)

    def remove(self, task: PrefillTask) -> bool:
        """Eagerly drop a still-queued task (cancellation before any
        grant): frees its queue-depth immediately instead of letting
        the dead request sit in the admission queue and consume a
        grant.  False when the task was already granted — the engine
        then retires it at grant time as before."""
        if not self._q.remove(task):
            return False
        with self._lock:
            self._depth -= 1
        return True

    def drain_pending(self) -> List[PrefillTask]:
        """Pop EVERY queued task regardless of credits — the engine's
        failure path must reach requests a credit-bounded ``admit``
        would skip (no credits were consumed, none are returned)."""
        tasks = self._q.drain()
        with self._lock:
            self._depth -= len(tasks)
        return tasks

    # ---------------------------------------------------------- inspection

    @property
    def depth(self) -> int:
        with self._lock:
            return self._depth

    @property
    def credits(self) -> int:
        return self._q.credits

    def pending(self) -> int:
        return self._q.pending()
