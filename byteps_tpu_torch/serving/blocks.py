"""Paged KV cache: block-granular slot memory — the port of
``byteps_tpu/serving/blocks.py`` in its flat layout.

  * one flat pool per layer ``{"k","v"} [n_blocks, block, KV * D]`` in
    the model dtype — the layout the paged-attention kernel reads, one
    block being one contiguous ``[block, KV*D]`` chunk; or, with
    ``kv_dtype="int8"``, s8 values plus fp32 per-(position, head) scale
    pools ``{"k_scale","v_scale"} [n_blocks, block, KV]``; and with
    ``tp > 1`` a leading shard axis (``[tp, n_blocks, block,
    (KV/tp)*D]``: shard ``s`` holds KV heads ``[s*KV/tp, (s+1)*KV/tp)``);
  * a :class:`BlockAllocator` — lowest-index free list (deterministic)
    plus per-block refcounts, which prefix sharing raises above 1;
  * a per-slot :class:`BlockTable` mapping logical block ``pos // block``
    to a physical block id, granted lazily as the cursor crosses block
    boundaries, adopting shared prefix blocks at its head (``share``)
    and forking a shared entry copy-on-write before a write (``cow``).
    A block id names the same token span on every shard.

**The null block.**  Physical block 0 is allocated at pool construction
and never freed: the scatter target of every masked slot's garbage
decode write and the table entry past a slot's allocated prefix.  Its
content is never attended (the kernel reads only blocks holding a
readable key).
"""

from __future__ import annotations

import heapq
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.transformer import TransformerConfig
from ..ops.paged_attention import KV_DTYPES
from .scheduler import AdmissionError
from .slots import SlotPool

__all__ = ["BlocksExhaustedError", "BlockAllocator", "BlockTable",
           "init_paged_cache", "PagedSlotPool"]


class BlocksExhaustedError(AdmissionError):
    """KV block pool exhausted — typed backpressure.  The engine reacts
    by preempting the newest in-flight request back to QUEUED; a request
    that cannot fit the pool even alone fails with this error."""

    def __init__(self, needed: int, free: int):
        self.needed = needed
        self.free = free
        super().__init__(
            f"KV block pool exhausted: need {needed} block(s), {free} "
            f"free; raise BYTEPS_SERVE_KV_MB or lower concurrency")


class BlockAllocator:
    """Free-list + refcount bookkeeping over ``n_blocks`` physical
    blocks of ``block`` tokens.  Lowest-free-id allocation keeps the
    engine's output deterministic."""

    def __init__(self, n_blocks: int, block: int):
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.n_blocks = n_blocks
        self.block = block
        self._free: List[int] = list(range(n_blocks))
        heapq.heapify(self._free)
        self._refs: List[int] = [0] * n_blocks
        self._lock = threading.Lock()

    def alloc(self, n: int = 1) -> List[int]:
        """Claim ``n`` blocks (refs start at 1).  Atomic: on
        :class:`BlocksExhaustedError` nothing was allocated."""
        if n < 0:
            raise ValueError(f"alloc count must be >= 0, got {n}")
        with self._lock:
            if n > len(self._free):
                raise BlocksExhaustedError(n, len(self._free))
            out = [heapq.heappop(self._free) for _ in range(n)]
            for bid in out:
                self._refs[bid] = 1
            return out

    def incref(self, bid: int) -> int:
        """Add a reference to an allocated block (sharing)."""
        with self._lock:
            if self._refs[bid] < 1:
                raise ValueError(f"incref on free block {bid}")
            self._refs[bid] += 1
            return self._refs[bid]

    def decref(self, bid: int) -> int:
        """Drop a reference; at zero the block returns to the free
        list.  Returns the remaining count."""
        with self._lock:
            if self._refs[bid] < 1:
                raise ValueError(f"decref on free block {bid}")
            self._refs[bid] -= 1
            if self._refs[bid] == 0:
                heapq.heappush(self._free, bid)
            return self._refs[bid]

    def refs(self, bid: int) -> int:
        with self._lock:
            return self._refs[bid]

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_count(self) -> int:
        return self.n_blocks - self.free_count

    def shared_count(self) -> int:
        """Blocks referenced by more than one holder (prefix sharing)."""
        with self._lock:
            return sum(1 for r in self._refs if r >= 2)


class BlockTable:
    """One slot's logical->physical block mapping: entry ``i`` backs
    positions ``[i * block, (i + 1) * block)``."""

    __slots__ = ("blocks", "max_blocks")

    def __init__(self, max_blocks: int):
        self.blocks: List[int] = []
        self.max_blocks = max_blocks

    def ensure(self, alloc: BlockAllocator, n_logical: int) -> List[int]:
        """Grow the table to cover ``n_logical`` blocks; returns the
        fresh ids.  Atomic: on exhaustion the table is unchanged."""
        if n_logical > self.max_blocks:
            raise ValueError(
                f"table overflow: need {n_logical} logical blocks, "
                f"max {self.max_blocks}")
        missing = n_logical - len(self.blocks)
        if missing <= 0:
            return []
        fresh = alloc.alloc(missing)
        self.blocks.extend(fresh)
        return fresh

    def share(self, alloc: BlockAllocator, ids: Sequence[int]) -> None:
        """Adopt ``ids`` as this table's head (a prefix-cache hit): each
        gains a reference.  Only valid on an empty table — shared
        prefixes are attached at admission, before any write."""
        if self.blocks:
            raise ValueError("share() on a non-empty block table")
        for bid in ids:
            alloc.incref(bid)
        self.blocks.extend(ids)

    def cow(self, alloc: BlockAllocator,
            idx: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write fork of entry ``idx`` when it is shared: a
        private clone is allocated and swapped in, and the shared
        reference dropped.  Returns ``(old_id, new_id)`` for the
        caller's device-side copy, or None when the entry was private.
        On exhaustion the table is unchanged (the alloc comes first)."""
        bid = self.blocks[idx]
        if alloc.refs(bid) <= 1:
            return None
        new = alloc.alloc(1)[0]
        self.blocks[idx] = new
        alloc.decref(bid)
        return bid, new

    def release(self, alloc: BlockAllocator) -> None:
        """Drop every reference this table holds (slot free /
        preemption).  Shared blocks survive under their other refs."""
        for bid in self.blocks:
            alloc.decref(bid)
        self.blocks.clear()


def _check_tp(cfg: TransformerConfig, tp: int) -> None:
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if cfg.kv_heads % tp:
        raise ValueError(
            f"tensor-parallel paged pool requires tp ({tp}) to divide "
            f"kv_heads ({cfg.kv_heads}): a KV head is the unit of exact "
            f"attention partitioning")


def init_paged_cache(cfg: TransformerConfig, n_blocks: int, block: int,
                     kv_dtype: str = "", tp: int = 1,
                     device=None) -> List[dict]:
    """Zeroed flat paged pools, per layer ``{"k","v"} [n_blocks, block,
    kv_heads * d_head]`` in the model dtype (the JAX ``layout="flat"``
    pool — the paged-attention kernel's layout).

    ``kv_dtype="int8"`` stores s8 values plus fp32 per-(position, head)
    scales ``{"k_scale","v_scale"} [n_blocks, block, kv_heads]``
    (``_quantize_kv``).  ``tp > 1`` adds a leading shard axis over pools
    ``(kv_heads / tp) * d_head`` wide — shard ``s`` holds KV heads ``[s
    * KV/tp, (s+1) * KV/tp)`` in the same head-major order, so the
    shards' minor axes concatenated are the unsharded block."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got "
                         f"{kv_dtype!r}")
    _check_tp(cfg, tp)
    KVs = cfg.kv_heads // tp
    lead = (tp,) if tp > 1 else ()
    shape = lead + (n_blocks, block, KVs * cfg.d_head)

    def layer():
        if not kv_dtype:
            return {n: torch.zeros(shape, dtype=cfg.dtype, device=device)
                    for n in ("k", "v")}
        out = {n: torch.zeros(shape, dtype=torch.int8, device=device)
               for n in ("k", "v")}
        for n in ("k_scale", "v_scale"):
            out[n] = torch.zeros(lead + (n_blocks, block, KVs),
                                 dtype=torch.float32, device=device)
        return out

    return [layer() for _ in range(cfg.num_layers)]


class PagedSlotPool(SlotPool):
    """Slot pool whose KV storage is a shared pool of fixed-size blocks.

    Sizing: ``n_blocks`` explicit, or derived from ``kv_bytes``
    (``BYTEPS_SERVE_KV_MB``), or the dense-equivalent default
    ``n_slots * max_seq / block`` plus the null block.  ``kv_dtype`` and
    ``tp`` shape the pools (:func:`init_paged_cache`); the allocator,
    tables and refcounts are the same at any tp, and ``block_bytes`` is
    the total across shards."""

    def __init__(self, cfg: TransformerConfig, n_slots: int, max_seq: int,
                 *, block: int = 16, n_blocks: Optional[int] = None,
                 kv_bytes: int = 0, kv_dtype: str = "", tp: int = 1,
                 device=None):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        if max_seq % block:
            raise ValueError(
                f"max_seq {max_seq} must be a multiple of the KV block "
                f"size {block}")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype supports '' (the model dtype) or 'int8' (s8 "
                f"blocks + per-(position, head) f32 scales), got "
                f"{kv_dtype!r}")
        _check_tp(cfg, tp)
        self.block = block
        self.kv_dtype = kv_dtype
        self.tp = tp
        self.max_blocks = max_seq // block
        KV, D = cfg.kv_heads, cfg.d_head
        # bytes of ONE physical block across every layer's k+v pools
        # (int8: 1 byte a value plus the 4-byte scale per (position, head))
        if kv_dtype == "int8":
            self.block_bytes = cfg.num_layers * 2 * block * (KV * D + 4 * KV)
        else:
            itemsize = torch.empty((), dtype=cfg.dtype).element_size()
            self.block_bytes = cfg.num_layers * 2 * block * KV * D * itemsize
        if n_blocks is None:
            n_blocks = (kv_bytes // self.block_bytes if kv_bytes > 0
                        else n_slots * self.max_blocks + 1)
        if n_blocks < self.max_blocks + 1:
            raise ValueError(
                f"paged KV pool too small: {n_blocks} blocks "
                f"({n_blocks * self.block_bytes} bytes) cannot hold one "
                f"max_seq={max_seq} request ({self.max_blocks} blocks) "
                f"plus the null block; raise BYTEPS_SERVE_KV_MB or "
                f"lower max_seq")
        self._n_blocks = n_blocks
        super().__init__(cfg, n_slots, max_seq, device=device)
        self.alloc = BlockAllocator(n_blocks, block)
        self.null_block = self.alloc.alloc(1)[0]
        self.tables: List[BlockTable] = [
            BlockTable(self.max_blocks) for _ in range(n_slots)]
        self._tables_dirty = True
        self._tables_dev: Optional[torch.Tensor] = None

    def _init_caches(self):
        return init_paged_cache(self.cfg, self._n_blocks, self.block,
                                kv_dtype=self.kv_dtype, tp=self.tp,
                                device=self.device)

    def reset_locked(self, slot: int) -> None:
        super().reset_locked(slot)
        self.tables[slot].release(self.alloc)
        self._tables_dirty = True

    def ensure_blocks(self, slot: int, upto_pos: int) -> List[int]:
        """Lazily grant blocks so ``slot`` can write ``[0, upto_pos)``;
        raises :class:`BlocksExhaustedError` (table unchanged) when the
        pool cannot cover it."""
        need = -(-upto_pos // self.block)
        fresh = self.tables[slot].ensure(self.alloc, need)
        if fresh:
            self._tables_dirty = True
        return fresh

    def share_prefix(self, slot: int, ids: Sequence[int]) -> None:
        """Attach a prefix-cache hit's blocks at the head of ``slot``'s
        table — refcount bumps only, no device-side copy."""
        self.tables[slot].share(self.alloc, ids)
        self._tables_dirty = True

    def adopt_blocks(self, slot: int, ids: Sequence[int]) -> None:
        """Attach ``ids`` to an empty ``slot`` table as an ownership
        transfer: unlike :meth:`share_prefix` no refcount is bumped — the
        caller's references become the table's, and ``reset_locked``
        releases them like any granted block."""
        t = self.tables[slot]
        if t.blocks:
            raise ValueError(f"adopt_blocks: slot {slot} table is not "
                             f"empty ({len(t.blocks)} block(s))")
        if len(ids) > t.max_blocks:
            raise ValueError(f"adopt_blocks: {len(ids)} blocks exceed the "
                             f"slot's max_blocks={t.max_blocks}")
        t.blocks.extend(int(b) for b in ids)
        self._tables_dirty = True

    def make_writable(self, slot: int, lo_pos: int, hi_pos: int,
                      copy_cb) -> int:
        """Copy-on-write fork of every shared block backing positions
        ``[lo_pos, hi_pos)`` before a write lands there; ``copy_cb(old,
        new)`` copies the block on the device.  Returns the number of
        forks (0 in the common case: writes land past a shared prefix)."""
        t = self.tables[slot]
        forks = 0
        last = min((hi_pos - 1) // self.block + 1, len(t.blocks))
        for idx in range(lo_pos // self.block, last):
            pair = t.cow(self.alloc, idx)
            if pair is not None:
                copy_cb(*pair)
                forks += 1
                self._tables_dirty = True
        return forks

    def copy_block(self, src: int, dst: int) -> None:
        """Copy physical block ``src`` into ``dst`` in every pool (values
        and int8 scales, on every shard) — the device side of a fork."""
        for layer in self.caches:
            for c in layer.values():
                if self.tp > 1:
                    c[:, dst] = c[:, src]
                else:
                    c[dst] = c[src]

    def write_target(self, slot: int) -> Tuple[int, int]:
        """(physical block id, in-block offset) of the slot's next K/V
        write."""
        pos = self.pos[slot]
        return self.tables[slot].blocks[pos // self.block], \
            pos % self.block

    def _table_array(self, slots) -> np.ndarray:
        arr = np.full((len(slots), self.max_blocks), self.null_block,
                      np.int32)
        for i, s in enumerate(slots):
            t = self.tables[s].blocks
            if t:
                arr[i, :len(t)] = t
        return arr

    def tables_device(self) -> torch.Tensor:
        """``[n_slots, max_blocks]`` int32 device tensor of every slot's
        table, unallocated entries on the null block; rebuilt only when
        some table changed."""
        if self._tables_dirty or self._tables_dev is None:
            self._tables_dev = torch.from_numpy(
                self._table_array(range(self.n_slots))).to(self.device)
            self._tables_dirty = False
        return self._tables_dev

    def table_row(self, slot: int) -> torch.Tensor:
        """One slot's ``[max_blocks]`` int32 table (chunk-prefill arg)."""
        return torch.from_numpy(self._table_array([slot])[0]).to(
            self.device)

    def block_stats(self) -> dict:
        """Live pool accounting; ``used`` includes the null block."""
        return {"block": self.block, "n_blocks": self.alloc.n_blocks,
                "block_bytes": self.block_bytes,
                "free": self.alloc.free_count,
                "used": self.alloc.used_count,
                "shared": self.alloc.shared_count()}
