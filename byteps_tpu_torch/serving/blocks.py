"""Paged KV cache: block-granular slot memory — the port of
``byteps_tpu/serving/blocks.py`` (flat fp layout, tp=1).

  * one flat pool per layer ``{"k","v"} [n_blocks, block, KV * D]`` in
    the model dtype — the layout the paged-attention kernel reads, one
    block being one contiguous ``[block, KV*D]`` chunk;
  * a :class:`BlockAllocator` — lowest-index free list (deterministic)
    plus per-block refcounts;
  * a per-slot :class:`BlockTable` mapping logical block ``pos // block``
    to a physical block id, granted lazily as the cursor crosses block
    boundaries.

**The null block.**  Physical block 0 is allocated at pool construction
and never freed: the scatter target of every masked slot's garbage
decode write and the table entry past a slot's allocated prefix.  Its
content is never attended (the kernel reads only blocks holding a
readable key).

Prefix sharing (refcounts above 1, copy-on-write forks), int8 pools and
tensor-parallel pools are later slices.
"""

from __future__ import annotations

import heapq
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.transformer import TransformerConfig
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

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_count(self) -> int:
        return self.n_blocks - self.free_count


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

    def release(self, alloc: BlockAllocator) -> None:
        """Drop every reference this table holds (slot free /
        preemption)."""
        for bid in self.blocks:
            alloc.decref(bid)
        self.blocks.clear()


def init_paged_cache(cfg: TransformerConfig, n_blocks: int, block: int,
                     device=None) -> List[dict]:
    """Zeroed flat paged pools, per layer ``{"k","v"} [n_blocks, block,
    kv_heads * d_head]`` in the model dtype (the JAX ``layout="flat"``
    pool — the paged-attention kernel's layout)."""
    shape = (n_blocks, block, cfg.kv_heads * cfg.d_head)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.num_layers)]


class PagedSlotPool(SlotPool):
    """Slot pool whose KV storage is a shared pool of fixed-size blocks.

    Sizing: ``n_blocks`` explicit, or derived from ``kv_bytes``
    (``BYTEPS_SERVE_KV_MB``), or the dense-equivalent default
    ``n_slots * max_seq / block`` plus the null block."""

    def __init__(self, cfg: TransformerConfig, n_slots: int, max_seq: int,
                 *, block: int = 16, n_blocks: Optional[int] = None,
                 kv_bytes: int = 0, device=None):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        if max_seq % block:
            raise ValueError(
                f"max_seq {max_seq} must be a multiple of the KV block "
                f"size {block}")
        self.block = block
        self.max_blocks = max_seq // block
        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        # bytes of ONE physical block across every layer's k+v pools
        self.block_bytes = (cfg.num_layers * 2 * block * cfg.kv_heads
                            * cfg.d_head * itemsize)
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
                "used": self.alloc.used_count}
