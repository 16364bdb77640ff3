"""Key -> shard placement — the port's copy of ``ServerSharder`` from
``byteps_tpu/common/context.py``, the one piece of that module the
router tier needs (``resilience/router.py``'s ``DegradedModeRouter``
remaps dead replicas through :meth:`ServerSharder.remap`).

The rest of the JAX module — the declared-name registry, the tensor
context types and the ``declared_key << 16 | partition`` keyspace — is
the parameter-server runtime's and is ported with it, later.
"""

from __future__ import annotations

import threading
from typing import Dict, List

from . import logging as bps_log


class ServerSharder:
    """key -> shard placement with load accounting.

    Bit-compatible with reference global.cc:305-334: default placement is
    ``(((key>>16) + key % 65536) * 9973) % num_shards``; under hash mode it
    uses Python's hash as the stand-in for ``std::hash``.  Tracks accumulated
    bytes per shard exactly as the reference logs for load-balance debugging.
    """

    def __init__(self, num_shards: int, use_hash: bool = False):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.num_shards = num_shards
        self.use_hash = use_hash
        self._bytes: List[int] = [0] * num_shards
        self._cache: Dict[int, int] = {}
        self._lock = threading.Lock()

    def place(self, key: int, nbytes: int = 0) -> int:
        with self._lock:
            shard = self._cache.get(key)
            if shard is None:
                if self.use_hash:
                    shard = hash(key) % self.num_shards
                else:
                    shard = (((key >> 16) + key % 65536) * 9973) % self.num_shards
                self._cache[key] = shard
            self._bytes[shard] += nbytes
            if nbytes:
                bps_log.debug(
                    "key %d -> shard %d (accumulated %d bytes)",
                    key, shard, self._bytes[shard],
                )
            return shard

    def load(self) -> List[int]:
        with self._lock:
            return list(self._bytes)

    @staticmethod
    def remap(shard: int, exclude, num_shards: int) -> int:
        """Deterministic degraded-mode remap: the first alive shard
        scanning forward from ``shard`` (wrapping).  Every worker
        computes the same fallback with no coordination — the same
        property the placement formula itself has — so two clients
        re-route a dead shard's keys identically.  Raises when every
        shard is excluded."""
        for step in range(num_shards):
            candidate = (shard + step) % num_shards
            if candidate not in exclude:
                return candidate
        raise RuntimeError("all PS shards are marked down")
