"""Named-tensor registry and PS key encoding — the port of
``byteps_tpu/common/context.py``.

Counterpart of the reference's per-tensor bookkeeping:
  * declared-name -> monotonically assigned ``declared_key`` registry
    (``BytePSGlobal::IsTensorDeclared``/``GetContextFromName``,
    reference global.cc:290-303);
  * keyspace layout ``declared_key << 16 | partition_index`` giving 2^16
    tensors x 2^16 partitions (reference operations.cc:214-230);
  * key -> server sharding (:class:`ServerSharder`, reference
    global.cc:305-334), which the router tier's ``DegradedModeRouter``
    remaps dead replicas through.
"""

from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import logging as bps_log
from .types import DataType

MAX_PARTITIONS = 1 << 16


@dataclass
class TensorContext:
    """Per-declared-tensor state — counterpart of ``BPSContext``
    (reference common.h:138-154)."""

    name: str
    declared_key: int
    dtype: Optional[DataType] = None
    shape: tuple = ()
    nbytes: int = 0
    initialized: bool = False
    key_list: List[int] = field(default_factory=list)
    priority: int = 0
    version: int = 0


class TensorRegistry:
    """Thread-safe name -> TensorContext map with monotonic key
    assignment.  ``declare`` is idempotent per name (reference
    IsTensorDeclared, global.cc:290-303): the first call assigns the next
    declared_key, later calls return the existing context."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_name: Dict[str, TensorContext] = {}
        self._next_key = 0

    def declare(self, name: str) -> TensorContext:
        with self._lock:
            ctx = self._by_name.get(name)
            if ctx is None:
                if self._next_key >= MAX_PARTITIONS:
                    raise RuntimeError(
                        f"too many declared tensors (max {MAX_PARTITIONS})")
                ctx = TensorContext(name=name, declared_key=self._next_key)
                self._by_name[name] = ctx
                self._next_key += 1
                bps_log.trace("declared tensor %s key %d", name,
                              ctx.declared_key)
            return ctx

    def get(self, name: str) -> TensorContext:
        with self._lock:
            try:
                return self._by_name[name]
            except KeyError as e:
                raise KeyError(f"tensor {name!r} was never declared") from e

    def contains(self, name: str) -> bool:
        with self._lock:
            return name in self._by_name

    def names(self) -> List[str]:
        with self._lock:
            return list(self._by_name)

    def reset(self) -> None:
        with self._lock:
            self._by_name.clear()
            self._next_key = 0


def name_key(name: str) -> int:
    """Order-independent key: ``crc32(name) & 0xFFFF`` in the
    declared_key slot of the keyspace, for placement that must not depend
    on each worker's declaration order."""
    return (zlib.crc32(name.encode()) & 0xFFFF) << 16


def partition_key(declared_key: int, partition_index: int) -> int:
    """Keyspace layout of reference operations.cc:214-230."""
    if not 0 <= partition_index < MAX_PARTITIONS:
        raise ValueError(f"partition_index {partition_index} out of range")
    return (declared_key << 16) | partition_index


def split_key(key: int) -> tuple:
    return key >> 16, key & (MAX_PARTITIONS - 1)


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
