"""Readiness barrier — the port of ``byteps_tpu/common/ready_table.py``,
counterpart of reference ``ready_table.{h,cc}``.

A ``key -> count`` map with an expected count per key; a key becomes
ready when its count reaches the expectation (reference
ready_table.cc:17-41).  The eager engine (engine/dispatcher.py) keeps one
as its partition-completion barrier, keyed by handle: a push_pull's
result is assembled only once every partition's collective has landed.
"""

from __future__ import annotations

import threading
from typing import Dict


class ReadyTable:
    def __init__(self, expected: int = 1, name: str = ""):
        self._expected_default = expected
        self._expected: Dict[int, int] = {}
        self._count: Dict[int, int] = {}
        self._lock = threading.Lock()
        self.name = name

    def set_expected(self, key: int, expected: int) -> None:
        with self._lock:
            self._expected[key] = expected

    def add_ready_count(self, key: int, n: int = 1) -> int:
        """Reference ready_table.cc:29-35."""
        with self._lock:
            self._count[key] = self._count.get(key, 0) + n
            return self._count[key]

    def add_and_check(self, key: int, n: int = 1) -> bool:
        """Atomically add and report whether this addition *completed* the
        key (count crossed the expectation exactly now) — true for exactly
        one caller even under concurrent completions."""
        with self._lock:
            expected = self._expected.get(key, self._expected_default)
            before = self._count.get(key, 0)
            self._count[key] = before + n
            return before < expected <= before + n

    def is_key_ready(self, key: int) -> bool:
        """Reference ready_table.cc:17-27."""
        with self._lock:
            expected = self._expected.get(key, self._expected_default)
            return self._count.get(key, 0) >= expected

    def clear_ready_count(self, key: int) -> None:
        """Reference ready_table.cc:37-41."""
        with self._lock:
            self._count.pop(key, None)

    def clear_key(self, key: int) -> None:
        """Drop both count and per-key expectation (end of a key's life)."""
        with self._lock:
            self._count.pop(key, None)
            self._expected.pop(key, None)
