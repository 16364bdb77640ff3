"""Prefix reuse — the port of ``byteps_tpu/serving/prefix.py``: the dense
engine's row-copy :class:`PrefixCache` and the paged engine's radix
:class:`PagedPrefixCache`.

For a causal model the K/V of a shared token prefix is position for
position the same in every request, so it can be moved instead of
recomputed, and the move is bit-exact by construction.

  * **Digests.**  ``h_j = blake2b(h_{j-1} || block_j)`` seeded with a
    salt (the engine's weights fingerprint and row or pool geometry), so
    the ``j``-block digest commits to every earlier token and to the key
    space; a match compares the stored tokens before it is returned, so
    a collision is a miss, never wrong K/V.  The usable match is capped
    at ``len(prompt) - 1``: one position must remain to prefill for the
    first token's logits.
  * **Dense entries are full cache rows** (:class:`PrefixCache`): the
    request's slot row with positions ``>= length`` zeroed, indexed
    under every block boundary it covers (a request sharing only the
    first block of a longer entry still hits), at the store's own
    ``block``.  A hit copies the whole row into the admitted slot; rows
    past the match are zeros the request overwrites before the mask
    admits them.  ``refs`` pins an entry across the copy; LRU eviction
    keeps the summed bytes under ``max_bytes``, re-pointing a boundary an
    evicted entry first registered at a surviving entry that covers it.
    A store may back several engines: the salt keeps different weights
    and row geometries apart.
  * **Paged entries are block chains** (:class:`PagedPrefixCache`): one
    radix node per block boundary owning one reference on its block; a
    hit adopts the stored blocks into the admitted slot's table
    (refcount bumps, no device copy), and an insert that walks onto an
    indexed boundary reuses that node's block.  Only unpinned nodes
    without children are evicted, so boundary ``j`` indexed implies
    ``j - 1`` indexed.  Under block pressure the engine calls
    :meth:`PagedPrefixCache.evict_for` before it preempts a live
    request.  The store is bound to one allocator (block ids mean
    nothing in another pool), so it is private to its engine.  Under an
    int8 pool the stored bytes are the quantized ones, which a
    re-prefill reproduces exactly.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["PrefixCache", "PagedPrefixCache", "PrefixEntry",
           "weights_fingerprint"]


def weights_fingerprint(model: torch.nn.Module) -> bytes:
    """Order-stable digest of a model's state (parameters and buffers,
    int8 weights' scales included): names, shapes, dtypes, and a cheap
    value sample per tensor (the first and last 8 elements and the fp32
    sum) — the JAX ``weights_fingerprint`` over torch tensors.  Engines
    salt their prefix keys with it and report it in STATS."""
    h = hashlib.blake2b(digest_size=16)
    for name, t in sorted(model.state_dict().items()):
        flat = t.detach().reshape(-1)
        h.update(name.encode())
        h.update(f"{tuple(t.shape)}{t.dtype}".encode())
        for part in (flat[:8], flat[-8:]):
            h.update(part.cpu().view(torch.uint8).numpy().tobytes())
        h.update(np.float32(flat.sum(dtype=torch.float32).item()).tobytes())
    return h.digest()


class PrefixEntry:
    """One stored prefix: a full cache-row buffer (dense) or the block-id
    chain root..self (paged), the tokens it holds (verified on match),
    its block-aligned ``length`` and ``nbytes``, its LRU stamp and the
    salt it was inserted under.  ``refs`` pins it against eviction while
    the engine copies or attaches it."""

    __slots__ = ("buffer", "tokens", "length", "nbytes", "refs", "keys",
                 "stamp", "salt")

    def __init__(self, buffer, tokens: np.ndarray, length: int,
                 nbytes: int, stamp: int, salt: bytes = b""):
        self.buffer = buffer
        self.tokens = tokens          # [length] int32, verified on match
        self.length = length
        self.nbytes = nbytes
        self.refs = 0
        # (digest, boundary_length) index keys referencing this entry
        self.keys: List[Tuple[bytes, int]] = []
        self.stamp = stamp            # LRU clock (monotonic per touch)
        self.salt = salt              # the inserter's key space


def _tree_bytes(rows) -> int:
    return sum(t.numel() * t.element_size() for layer in rows
               for t in layer.values())


class PrefixCache:
    """The dense engine's block-aligned row-copy store (see the module
    docstring).  ``block`` is the match granularity in tokens,
    ``max_bytes`` the budget over the summed row bytes (0 = unbounded).
    Thread-safe; the engine also serializes every call under its tick
    lock."""

    def __init__(self, block: int = 16, max_bytes: int = 256 << 20):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        if max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
        self.block = block
        self.max_bytes = max_bytes
        self._index: Dict[bytes, Tuple[PrefixEntry, int]] = {}
        self._entries: List[PrefixEntry] = []
        self._clock = itertools.count(1)
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0

    # ------------------------------------------------------------- hashing

    def _digests(self, tokens: np.ndarray, nblocks: int,
                 salt: bytes = b"") -> List[bytes]:
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
        out: List[bytes] = []
        h = salt
        B = self.block
        for j in range(nblocks):
            h = hashlib.blake2b(h + toks[j * B:(j + 1) * B].tobytes(),
                                digest_size=16).digest()
            out.append(h)
        return out

    def digests_for(self, prompt, salt: bytes = b"") -> List[bytes]:
        """Every rolling block digest of ``prompt`` (``len // block`` of
        them), computed once and passed as ``digests=`` to the lookups
        of one admission."""
        toks = np.asarray(prompt, np.int32).reshape(-1)
        return self._digests(toks, int(toks.shape[0]) // self.block,
                             salt)

    def _digs(self, toks: np.ndarray, n: int, salt: bytes,
              digests: Optional[List[bytes]]) -> List[bytes]:
        if digests is not None and len(digests) >= n:
            return digests[:n]
        return self._digests(toks, n, salt)

    # -------------------------------------------------------------- lookup

    def match(self, prompt, salt: bytes = b"",
              digests: Optional[List[bytes]] = None,
              ) -> Optional[Tuple[PrefixEntry, int]]:
        """Longest stored block-aligned prefix of ``prompt`` usable for
        serving: ``(entry, length)`` with ``length <= len(prompt) - 1``,
        or None.  Only entries inserted under ``salt`` can match.
        Touches the entry's LRU stamp."""
        toks = np.asarray(prompt, np.int32).reshape(-1)
        max_blocks = (int(toks.shape[0]) - 1) // self.block
        if max_blocks < 1:
            with self._lock:
                self.misses += 1
            return None
        digs = self._digs(toks, max_blocks, salt, digests)
        with self._lock:
            for j in range(max_blocks, 0, -1):
                found = self._index.get(digs[j - 1])
                if found is None:
                    continue
                entry, blen = found
                if not np.array_equal(entry.tokens[:blen], toks[:blen]):
                    continue  # digest collision -> a miss
                entry.stamp = next(self._clock)
                self.hits += 1
                return entry, blen
            self.misses += 1
            return None

    def insertable_len(self, prompt, salt: bytes = b"",
                       digests: Optional[List[bytes]] = None) -> int:
        """Block-aligned length an insert of ``prompt`` would cover, or
        0 when nothing new would land (shorter than a block, or its last
        full boundary is already indexed)."""
        toks = np.asarray(prompt, np.int32).reshape(-1)
        nblocks = int(toks.shape[0]) // self.block
        if nblocks < 1:
            return 0
        digs = self._digs(toks, nblocks, salt, digests)
        with self._lock:
            if digs[-1] in self._index:
                return 0
        return nblocks * self.block

    # -------------------------------------------------------------- insert

    def insert(self, tokens, buffer, salt: bytes = b"",
               digests: Optional[List[bytes]] = None) -> bool:
        """Store ``buffer`` (a full cache row, per layer a dict of ``[1,
        S, ...]`` tensors, rows ``>= len(tokens)`` zeroed) under every
        block boundary of ``tokens`` (block-aligned), in ``salt``'s key
        space.  Returns False when nothing was stored (already indexed,
        or larger than the whole budget)."""
        toks = np.asarray(tokens, np.int32).reshape(-1).copy()
        length = int(toks.shape[0])
        if length < self.block or length % self.block:
            raise ValueError(
                f"insert length {length} is not a positive multiple of "
                f"block {self.block}")
        nblocks = length // self.block
        digs = self._digs(toks, nblocks, salt, digests)
        nbytes = _tree_bytes(buffer)
        with self._lock:
            if digs[-1] in self._index:
                return False  # a concurrent insert won the race
            if self.max_bytes and nbytes > self.max_bytes:
                return False  # one entry cannot fit the budget
            entry = PrefixEntry(buffer, toks, length, nbytes,
                                next(self._clock), salt)
            for j in range(1, nblocks + 1):
                if digs[j - 1] not in self._index:
                    self._index[digs[j - 1]] = (entry, j * self.block)
                    entry.keys.append((digs[j - 1], j * self.block))
            self._entries.append(entry)
            self.insertions += 1
            self._evict_to_budget_locked()
            return True

    # ------------------------------------------------------------ eviction

    def acquire(self, entry: PrefixEntry) -> None:
        """Pin ``entry`` against eviction (bracket a copy or attach)."""
        with self._lock:
            entry.refs += 1

    def release(self, entry: PrefixEntry) -> None:
        with self._lock:
            if entry.refs < 1:
                raise ValueError("release() without matching acquire()")
            entry.refs -= 1

    def _evict_entry_locked(self, victim: PrefixEntry) -> None:
        self._entries.remove(victim)
        for digest, blen in victim.keys:
            self._index.pop(digest, None)
            # a boundary the victim registered first may be covered by a
            # later entry sharing its blocks: re-point the key there
            for heir in self._entries:
                if (heir.salt == victim.salt and heir.length >= blen
                        and np.array_equal(heir.tokens[:blen],
                                           victim.tokens[:blen])):
                    self._index[digest] = (heir, blen)
                    heir.keys.append((digest, blen))
                    break
        self.evictions += 1

    def _evict_to_budget_locked(self) -> None:
        if not self.max_bytes:
            return
        while self.total_bytes > self.max_bytes:
            victims = [e for e in self._entries if e.refs == 0]
            if not victims:
                return  # everything pinned; retry on the next insert
            self._evict_entry_locked(min(victims, key=lambda e: e.stamp))

    # ---------------------------------------------------------- inspection

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries)

    @property
    def entry_count(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "insertions": self.insertions,
                    "evictions": self.evictions,
                    "entries": self.entry_count, "bytes": self.total_bytes}


class PagedPrefixCache(PrefixCache):
    """Radix prefix store over a paged pool's :class:`BlockAllocator`
    (see the module docstring).  ``block`` is the pool's block size in
    tokens, ``block_bytes`` one block's bytes across every layer (what a
    node charges), ``max_bytes`` the store's budget (0 = unbounded),
    ``on_evict(n)`` a callback per released node."""

    def __init__(self, allocator, block: int, block_bytes: int,
                 max_bytes: int = 0, on_evict=None):
        super().__init__(block=block, max_bytes=max_bytes)
        self.allocator = allocator
        self.block_bytes = block_bytes
        self._on_evict = on_evict
        # radix bookkeeping, keyed by each node's boundary digest
        self._node_parent: Dict[bytes, Optional[bytes]] = {}
        self._node_children: Dict[bytes, int] = {}

    # -------------------------------------------------------------- insert

    def insert(self, tokens, buffer, salt: bytes = b"",
               digests: Optional[List[bytes]] = None) -> bool:
        raise TypeError(
            "PagedPrefixCache stores block references, not row buffers;"
            " use insert_blocks()")

    def insert_blocks(self, tokens, block_ids, salt: bytes = b"",
                      digests: Optional[List[bytes]] = None) -> bool:
        """Register ``tokens``' block-aligned prefix as a chain of
        per-boundary nodes over ``block_ids``.  Indexed boundaries are
        reused (their canonical block wins, no new reference); each new
        boundary becomes a node owning one store reference on its block.
        Returns False when nothing new was stored (fully indexed, or not
        one new node fits the budget)."""
        toks = np.asarray(tokens, np.int32).reshape(-1).copy()
        length = int(toks.shape[0])
        nblocks = len(block_ids)
        if length != nblocks * self.block or nblocks < 1:
            raise ValueError(
                f"insert length {length} does not cover {nblocks} "
                f"block(s) of {self.block} tokens")
        digs = self._digs(toks, nblocks, salt, digests)
        with self._lock:
            floor = next(self._clock)  # nodes created below are newer
            chain: List[int] = []
            created = False
            parent: Optional[bytes] = None
            for j in range(1, nblocks + 1):
                blen = j * self.block
                found = self._index.get(digs[j - 1])
                if found is not None:
                    node, node_blen = found
                    if (node_blen != blen or not np.array_equal(
                            node.tokens[:blen], toks[:blen])):
                        break  # a collision: stop rather than corrupt
                    chain.append(node.buffer[-1])
                    node.stamp = next(self._clock)
                    parent = digs[j - 1]
                    continue
                if self.max_bytes and (self.total_bytes + self.block_bytes
                                       > self.max_bytes):
                    # partial insert: fund the next node from LRU leaves
                    # older than this call's own additions, or stop
                    self._evict_to_budget_locked(
                        headroom=self.block_bytes, stamp_before=floor)
                    if (self.total_bytes + self.block_bytes
                            > self.max_bytes):
                        break
                bid = int(block_ids[j - 1])
                self.allocator.incref(bid)
                chain.append(bid)
                node = PrefixEntry(tuple(chain), toks[:blen], blen,
                                   self.block_bytes, next(self._clock),
                                   salt)
                node.keys.append((digs[j - 1], blen))
                self._index[digs[j - 1]] = (node, blen)
                self._entries.append(node)
                self._node_parent[digs[j - 1]] = parent
                self._node_children[digs[j - 1]] = 0
                if parent is not None:
                    self._node_children[parent] += 1
                parent = digs[j - 1]
                created = True
            if created:
                self.insertions += 1
            return created

    # ------------------------------------------------------------ eviction

    def _evict_entry_locked(self, victim: PrefixEntry) -> None:
        digest, _ = victim.keys[0]
        if self._node_children.get(digest, 0):
            raise RuntimeError("evicting a prefix node that has children")
        self._entries.remove(victim)
        self._index.pop(digest, None)
        parent = self._node_parent.pop(digest, None)
        self._node_children.pop(digest, None)
        if parent is not None:
            self._node_children[parent] -= 1
        self.evictions += 1
        # one node owns exactly one reference: its own (deepest) block
        self.allocator.decref(victim.buffer[-1])
        if self._on_evict is not None:
            self._on_evict(1)

    def _leaves(self, stamp_before: Optional[int] = None
                ) -> List[PrefixEntry]:
        out = []
        for e in self._entries:
            if e.refs or self._node_children.get(e.keys[0][0], 0):
                continue
            if stamp_before is not None and e.stamp >= stamp_before:
                continue
            out.append(e)
        return out

    def _evict_to_budget_locked(self, headroom: int = 0,
                                stamp_before: Optional[int] = None) -> None:
        if not self.max_bytes:
            return
        while self.total_bytes + headroom > self.max_bytes:
            victims = self._leaves(stamp_before)
            if not victims:
                return  # everything pinned or interior; retry later
            self._evict_entry_locked(min(victims, key=lambda e: e.stamp))

    def evict_for(self, n_blocks: int) -> bool:
        """Block-pressure eviction: drop LRU unpinned leaves until the
        allocator has gained ``n_blocks`` free blocks or nothing is left
        to evict.  True when at least one node went (the caller retries
        its allocation).  A node's block frees only when no live slot
        shares it."""
        with self._lock:
            before = self.allocator.free_count
            progressed = False
            while self.allocator.free_count - before < n_blocks:
                victims = self._leaves()
                if not victims:
                    break
                self._evict_entry_locked(min(victims,
                                             key=lambda e: e.stamp))
                progressed = True
            return progressed

    # ---------------------------------------------------------- inspection

    @property
    def entry_count(self) -> int:
        """Distinct stored prefixes = chain leaves (a store holding one
        4-block prefix counts 1)."""
        with self._lock:
            return sum(1 for e in self._entries
                       if not self._node_children.get(e.keys[0][0], 0))

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {**super().stats(), "nodes": len(self._entries)}
