"""Retry policy: bounded exponential backoff with jitter and a deadline
— the port's copy of ``byteps_tpu/resilience/policy.py``.

The policy is pure decision logic — it owns no sockets and no threads.
The serving router drives it (``serving/router.py``): each failed
placement or transient leg failure asks the policy whether (and how
long) to wait before the next attempt.  So does the parameter-server
client (``engine/ps_server.py:RemoteStore._rpc``), with the policy
``from_config`` builds from the ``BYTEPS_RETRY_*`` knobs.  Mutating-op
idempotence is not handled here: the client version-guards retried
pushes, since only it can ask the server for ``OP_VERSION``.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How many times to retry a failed op, and how to pace attempts.

    ``max_attempts`` counts total tries (1 = the seed's fail-fast
    behavior).  Sleep before attempt k (k >= 2) is
    ``backoff_base * backoff_mult**(k-2)``, multiplied by a uniform
    jitter factor in ``[1 - jitter, 1 + jitter]``, capped at
    ``backoff_cap``.  ``deadline`` bounds the whole op (first attempt to
    final failure) in seconds; 0 disables the bound.
    """

    max_attempts: int = 3
    backoff_base: float = 0.05
    backoff_mult: float = 2.0
    backoff_cap: float = 2.0
    jitter: float = 0.1
    deadline: float = 15.0

    @staticmethod
    def from_config(cfg=None) -> "RetryPolicy":
        """The ``BYTEPS_RETRY_*`` knobs as a policy (JAX's mapping:
        milliseconds to seconds, at least one attempt)."""
        if cfg is None:
            from ..common.config import get_config

            cfg = get_config()
        return RetryPolicy(
            max_attempts=max(1, cfg.retry_max_attempts),
            backoff_base=cfg.retry_backoff_ms / 1e3,
            backoff_mult=cfg.retry_backoff_mult,
            jitter=cfg.retry_jitter,
            deadline=cfg.retry_deadline_ms / 1e3,
        )

    def backoff(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        """Sleep (seconds) before attempt ``attempt`` (1-based; attempt 1
        never sleeps)."""
        if attempt <= 1:
            return 0.0
        delay = self.backoff_base * self.backoff_mult ** (attempt - 2)
        delay = min(delay, self.backoff_cap)
        if self.jitter:
            r = rng if rng is not None else random
            delay *= 1.0 + self.jitter * (2.0 * r.random() - 1.0)
        return max(0.0, delay)

    def start(self) -> float:
        """Deadline timestamp for an op starting now (monotonic clock);
        ``inf`` when unbounded."""
        return (time.monotonic() + self.deadline) if self.deadline > 0 else float("inf")

    def should_retry(self, attempt: int, deadline_ts: float) -> bool:
        """May attempt ``attempt + 1`` proceed?  False once attempts are
        exhausted or the next backoff would land past the deadline."""
        if attempt >= self.max_attempts:
            return False
        return time.monotonic() + self.backoff(attempt + 1) <= deadline_ts

    def sleep(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        """Sleep the backoff before attempt ``attempt``; returns the
        slept duration (for logging/tests)."""
        d = self.backoff(attempt, rng)
        if d > 0:
            time.sleep(d)
        return d
