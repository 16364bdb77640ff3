"""Fixed-capacity slot pool — the port of ``byteps_tpu/serving/slots.py``.

The serving engine treats the decode batch dimension as a pool of
*slots*: admitting a request claims the lowest free slot and seeds its
write cursor; freeing returns the index.  Freed rows are not zeroed:
the causal mask admits only positions at or below the request's own
cursor, each of which the request has written before the mask reaches
it, and masked scores contribute exactly zero probability mass.

This base class owns the host-side bookkeeping and the dense engine's
row cache (``init_cache``: one ``[n_slots, max_seq, ...]`` tensor a layer
for K and for V, the batch axis being the slot); the paged pool
(``blocks.py``) overrides the storage.
"""

from __future__ import annotations

import heapq
import threading
from typing import List, Optional

from ..models.transformer import TransformerConfig, init_cache


class SlotPool:
    """``n_slots`` cache rows plus per-slot cursor bookkeeping.  The
    cache tensors (``self.caches``) live on ``device`` and are written
    in place by the model.

    ``kv_quant`` stores int8 values with fp32 per-(position, head)
    scales; ``layout`` is ``"grouped"`` (``[n_slots, max_seq, KV, D]``,
    the default, as in JAX: the dense decode tick attends it with plain
    torch, which is also what JAX's engine runs by default) or ``"flat"``
    (``[n_slots, max_seq, KV*D]``, the layout the decode-attention kernel
    reads)."""

    def __init__(self, cfg: TransformerConfig, n_slots: int, max_seq: int,
                 *, kv_quant: bool = False, layout: str = "grouped",
                 device=None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if max_seq < 2:
            raise ValueError(f"max_seq must be >= 2, got {max_seq}")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.kv_quant = kv_quant
        self.layout = layout
        self.device = device
        self.caches = self._init_caches()
        self._lock = threading.Lock()
        self._free: List[int] = list(range(n_slots))
        heapq.heapify(self._free)
        # per-slot cursor: absolute position of the next K/V write
        self.pos: List[int] = [0] * n_slots
        self.request_ids: List[Optional[int]] = [None] * n_slots

    def _init_caches(self):
        return init_cache(self.cfg, self.n_slots, self.max_seq,
                          quantized=self.kv_quant, layout=self.layout,
                          device=self.device)

    # ------------------------------------------------------------ lifecycle

    def assign(self, request_id: int, prompt_len: int) -> Optional[int]:
        """Claim the lowest free slot for ``request_id``; None when full.
        ``prompt_len`` seeds the slot's cursor (prefill writes [0, T))."""
        if prompt_len < 1 or prompt_len >= self.max_seq:
            raise ValueError(
                f"prompt_len {prompt_len} not in [1, max_seq={self.max_seq})")
        with self._lock:
            if not self._free:
                return None
            slot = heapq.heappop(self._free)
            self.request_ids[slot] = request_id
            self.pos[slot] = prompt_len
            return slot

    def free(self, slot: int) -> None:
        """Return a slot to the pool (its cache row left as-is)."""
        with self._lock:
            if self.request_ids[slot] is None:
                raise ValueError(f"slot {slot} is not assigned")
            self.reset_locked(slot)
            heapq.heappush(self._free, slot)

    def reset_locked(self, slot: int) -> None:
        self.request_ids[slot] = None
        self.pos[slot] = 0

    def advance(self, slot: int, n: int = 1) -> int:
        """Move a slot's write cursor after a decode step.  Raises past
        ``max_seq``: the engine failed to retire the request at its
        budget."""
        with self._lock:
            new = self.pos[slot] + n
            if new > self.max_seq:
                raise RuntimeError(
                    f"slot {slot} cursor {new} overran max_seq "
                    f"{self.max_seq}")
            self.pos[slot] = new
            return new

    # ---------------------------------------------------------- inspection

    def active_slots(self) -> List[int]:
        with self._lock:
            return [i for i in range(self.n_slots)
                    if self.request_ids[i] is not None]

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def active_count(self) -> int:
        return self.n_slots - self.free_count

    def occupancy(self) -> float:
        return self.active_count / self.n_slots
