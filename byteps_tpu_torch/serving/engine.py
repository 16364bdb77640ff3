"""Continuous-batching engine — the port of ``byteps_tpu/serving/engine.py``
over a dense slot pool (``paged=False``, the default, as in JAX: the
serve role's default engine) or a paged KV pool in its fused-kernel mode.

Per tick, in a fixed order: retire cancellations, continue in-flight
chunked prefills, admit queued requests within the prefill credit
budget, run ONE decode pass over every active slot, return credits.

The dense engine (``SlotPool``: one cache row a slot, grouped or flat,
fp or ``kv_quant`` int8):

  * **whole-prompt prefill** (``chunk == 0``) — the prompt right-padded
    to a power-of-two bucket runs ``Transformer.decode`` at ``pos = 0``
    on the slot's row (the JAX ``_prefill_forward``: the flash forward at
    buckets passing the gcd gate when ``attn_impl="flash"``), and the
    first token is read at the true last position;
  * **chunked prefill** (``chunk > 0``) — ``Transformer.prefill_chunk``
    at position offsets, in power-of-two buckets, debiting the same
    credit pool as admissions; the request sits in ``PREFILLING`` until
    its final chunk samples the first token;
  * **decode** — one ``Transformer.decode`` call over all ``n_slots``
    rows at a ``[n_slots]`` position vector on the device (the JAX
    engine's ``vmap`` over slots): on a flat cache one decode-kernel
    launch a layer reads every slot's position itself; on the grouped
    cache plain torch attends with a per-row mask.  The width never
    changes, so a slot's arithmetic does not depend on the others.
    Masked (free) slots sit at pos 0; a ``PREFILLING`` slot's garbage
    write is aimed at its post-prefill cursor, which its own first
    decode overwrites before the mask admits it, so a chunk it already
    wrote is never touched.
  * **prefix reuse** (``prefix_cache``, :class:`PrefixCache`) — at
    admission the longest stored prefix of the sequence, matched at the
    store's own ``prefix_block``, has its full stored row copied into
    the slot, and prefill resumes at the match (chunked, or split into
    buckets that fit the row); after prefill the row is extracted with
    positions past the block-aligned length zeroed and inserted, unless
    one row exceeds the store's budget.
  * **speculative decoding** (``spec_k > 0``, grouped rows) — every tick
    is one ``Transformer.verify_tokens`` call at ``tq = k + 1`` over every
    row at the position vector, sharing the paged engine's
    accept/truncate tail (below); a span running past a row's end is
    clamped there by the model.

The paged engine (``paged=True``):

  * **chunked prefill** — every prompt runs through
    ``Transformer.prefill_chunk_paged`` in power-of-two buckets (the
    whole prompt as one chunk when ``chunk == 0``): gather the slot's
    rows through its block table, run the dense chunk forward, scatter
    the chunk's K/V into the pool.  Requests sit in ``PREFILLING`` until
    their final chunk samples the first token.
  * **decode** — one ``Transformer.decode_paged_fused`` call serves the
    whole pool: every layer scatters the fresh K/V at each slot's
    ``(block, offset)`` write target and the hand-written
    paged-attention kernel reads blocks in place through the tables.
    Masked slots (free or PREFILLING) sit at pos 0 and write the null
    block.
  * **the gather fallback** (``paged_kernel="off"``) — decode and verify
    gather every slot's blocks through the tables, up to the high-water
    bucket (:meth:`_gather_hw`), into one row set, run the dense decode
    on it (``Transformer.decode_paged`` / ``verify_tokens_paged``) and
    scatter only the written positions back to their ``(block, offset)``
    targets (masked slots to the null block; a tp pool per shard).  An
    fp pool at tp = 1 is grouped, an int8 or tp pool flat; an int8
    pool's rows decode on CUDA through the decode-attention kernel at
    the slots' position vector, one launch a layer.
  * **block pressure** — blocks are granted lazily at boundary
    crossings; on exhaustion the prefix store gives up its least
    recently used unpinned blocks first, then the newest other request
    is preempted back to QUEUED (its blocks return to the pool) and
    later re-prefills prompt + emitted tokens, resuming from its parked
    next-input token.
  * **int8 / tp pools** (``kv_dtype="int8"``, ``tp > 1``) — the pool
    holds s8 values with fp32 scale rows, quantized as they are written
    (so a re-prefill writes the same bytes), and/or one sub-pool per
    KV-head slice; the kernel reads either (``ops/paged_attention.py``).
  * **prefix reuse** (``prefix_cache``, ``serving/prefix.py``) — at
    admission the longest stored block-aligned prefix of the sequence
    is adopted into the slot's table (refcount bumps, no copy) and
    prefill resumes at its boundary; after prefill the sequence's full
    blocks are inserted.  A chunk whose start is shifted left over a
    shared block forks it first (copy-on-write, ``_cow_copy``).
  * **speculative decoding** (``spec_k > 0``, ``serving/spec.py``) —
    every tick is a verify pass: the kernel at ``tq = k + 1`` over every
    slot (a span that runs past its row's end too: the rows there are
    discarded), inputs its next token and the proposals its own history made
    (none is fine), each slot emitting the model's tokens up to the
    first rejected proposal (at least one, so it never emits fewer than
    a plain tick), truncated at its budget and at EOS
    (``_verify_tick``).  Blocks are granted for the span first; a
    proposal the grant cannot cover is clipped.  The JAX engine verifies
    only on ticks where some slot proposes, at the depth bucket of the
    longest proposal; here the width is fixed because the card's GEMM
    and reduction kernels depend on the row count, so a slot's
    arithmetic would otherwise depend on what the other slots propose,
    and streams could differ from run to run with the batch's makeup.

Greedy streams are token-identical to the JAX engine (and to
``generate()``).  Sampled streams use the port's own noise chain,
``inference.token_generator(seed, k)`` — a pure function of the
request's seed and the index of the token being drawn — so a stream
repeats exactly across runs, batch compositions, preemptions and
speculation (the draw for token ``k`` is the same whether a verify or a
plain tick emits it), but does not reproduce ``jax.random``'s draws
(the JAX engine replays its ``PRNGKey`` split chain instead,
``_resume_key_chain``).

PyTorch runs eagerly, so there are no compiled programs to count:
:meth:`step_counts` reports the decode and verify ticks, prefill chunks,
proposed and accepted tokens, prefix hits, row copies and extracts,
copy-on-write forks, the gather buckets used, and the launch counts of
the paged- and decode-attention kernels.

The replica side of the router tier (JAX ``engine.py:115-130``,
``:1134-1232``, ``:1316-1490``, ``:1668-1700``):

  * **router epochs** — a dispatch stamped with ``epoch`` is admitted
    inside :meth:`epoch_fence`, which refuses an epoch below the highest
    one seen with the typed :class:`EpochFencedError` (a deposed router
    must never place work the new epoch re-dispatched);
  * **disaggregated prefill/decode** — a prefill replica's ``keep_kv``
    request parks its finished blocks (refs taken before the slot frees,
    capped at ``BYTEPS_DISAGG_PARKED_CAP``) for the frontend to ship
    (:meth:`extract_kv_payloads`: one gather and one device-to-host copy
    a ship); a decode replica writes a received ship into staged pool
    blocks (:meth:`write_kv_payloads`: one host-to-device copy and one
    indexed copy a cache tensor), both on a stream of their own, and a
    resume submit carrying ``kv_blocks`` adopts them in place of the
    prefill.  A tp pool ships the unsharded head-major rows, so a ship
    does not depend on either side's tp.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import enum
import hashlib
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..common import logging as bps_log
from ..common.device import resolve_device
from ..inference import sample_logits, token_generator
from ..models.transformer import Transformer, scatter_paged_rows
from ..ops import decode_attention as _da
from ..ops import paged_attention as _pa
from . import metrics as sm
from .blocks import BlocksExhaustedError, PagedSlotPool
from .metrics import ServeMetrics, get_serve_metrics
from .prefix import PagedPrefixCache, PrefixCache, weights_fingerprint
from .scheduler import ServeScheduler
from .slots import SlotPool
from .spec import NgramProposer

__all__ = ["EpochFencedError", "Request", "RequestState", "ServingEngine",
           "resolve_device"]


class EpochFencedError(RuntimeError):
    """A dispatch carried a router epoch LOWER than one this engine has
    already served: the sender is a deposed active router that does not
    yet know a standby took over.  The refusal is the split-brain guard
    — accepting the stale dispatch could double-serve a request the new
    epoch's router already re-dispatched.  Typed so the stale router can
    recognize the fence and demote itself instead of treating this
    replica as dead."""

    def __init__(self, epoch: int, high_water: int):
        self.epoch = epoch
        self.high_water = high_water
        super().__init__(
            f"dispatch fenced: epoch {epoch} < this engine's epoch "
            f"high-water {high_water} — a newer router epoch has taken "
            f"over this tier; the sending router must demote")


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"  # slot assigned, chunked prefill in flight
    ACTIVE = "active"
    DONE = "done"
    CANCELLED = "cancelled"
    FAILED = "failed"  # engine tick raised; see Request.error


_END = object()  # stream sentinel


@dataclasses.dataclass
class Request:
    """One in-flight generation request.  Stream tokens with ``for tok
    in req:`` or block for the whole sequence with ``result()``."""

    id: int
    prompt: np.ndarray          # [T] int32
    max_new_tokens: int
    seed: int = 0
    priority: int = 0
    state: RequestState = RequestState.QUEUED
    cancelled: bool = False
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    prefill_pos: int = 0  # sequence tokens already in the slot's blocks
    _pf_paid: bool = dataclasses.field(default=False, repr=False)
    # the sequence the current prefill covers: the prompt, or after a
    # preemption the prompt plus the emitted tokens minus the last one
    _seq: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    # next decode input parked across a preemption (or a resume submit)
    _resume_tok: Optional[int] = dataclasses.field(default=None, repr=False)
    # blocks that must be free before a preempted request re-admits
    _hold_blocks: int = dataclasses.field(default=0, repr=False)
    # tokens pre-seeded by a resume submit (another engine emitted them)
    _resumed_n: int = dataclasses.field(default=0, repr=False)
    # rolling prefix-block digests of _seq, computed once at admission
    _prefix_digs: Optional[list] = dataclasses.field(default=None,
                                                     repr=False)
    # the proposer's context (prompt + emitted tokens) and its fill
    _spec_ctx: Optional[np.ndarray] = dataclasses.field(default=None,
                                                        repr=False)
    _spec_n: int = dataclasses.field(default=0, repr=False)
    # disaggregated serving: park the finished request's blocks for a
    # ship (prefill replica), or staged block ids to adopt at admission
    # in place of the prefill (decode replica)
    _keep_kv: bool = dataclasses.field(default=False, repr=False)
    _kv_blocks: Optional[List[int]] = dataclasses.field(default=None,
                                                        repr=False)
    _task: Optional[object] = dataclasses.field(default=None, repr=False)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_last: float = 0.0
    error: Optional[BaseException] = None
    _out: "queue.Queue" = dataclasses.field(default_factory=queue.Queue)
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event)

    def __iter__(self):
        while True:
            item = self._out.get()
            if item is _END:
                if self.error is not None:
                    raise RuntimeError(
                        f"serving engine failed while request {self.id} "
                        f"was in flight: {self.error!r}") from self.error
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the request finishes; returns the emitted tokens.
        Raises if the engine failed while it was in flight."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.id} not done within {timeout}s")
        if self.error is not None:
            raise RuntimeError(
                f"serving engine failed while request {self.id} was in "
                f"flight: {self.error!r}") from self.error
        return np.asarray(self.tokens, np.int32)

    @property
    def done(self) -> bool:
        return self._done.is_set()


# prompt padding token and the smallest prefill bucket (the JAX engine's
# defaults, so chunk buckets — and with them the numerics — agree)
_PAD_ID = 0
_MIN_PREFILL_BUCKET = 8


def _bytes_as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A ``uint8`` tensor's bytes reinterpreted as ``dtype`` (its last
    dimension scaled): a view where the offset and strides allow one,
    else a view of a contiguous copy."""
    try:
        return t.view(dtype)
    except RuntimeError:
        return t.contiguous().view(dtype)


def _next_bucket(n: int, lo: int, hi: int) -> int:
    """Smallest power-of-two >= n, floored at lo, clamped to hi."""
    b = lo
    while b < n:
        b *= 2
    return min(b, hi)


class ServingEngine:
    """Continuous batching over a dense :class:`SlotPool` (``paged=False``,
    the default) or a :class:`PagedSlotPool` (``paged=True``, with the
    kernel) on ``device`` (``cuda`` unless the caller passes another —
    see :func:`resolve_device`).  The arguments and defaults are the JAX
    engine's, and so are its refusals.

    Dense: ``kv_quant`` (an int8 cache) and ``cache_layout`` (``"grouped"``
    or ``"flat"``, the decode kernel's) shape the rows; ``chunk`` turns on
    chunked prefill; ``prefix_cache`` (True, or a :class:`PrefixCache`
    to share across engines) the row-copy store, of at most
    ``prefix_bytes``, matching at ``prefix_block`` tokens (16 unless
    set).

    Paged: ``kv_dtype`` ("" or "int8") and ``tp`` shape the pool;
    ``paged_kernel`` ("auto" or "on": the kernel; "off": the gather
    fallback); ``prefix_cache`` turns on the radix prefix store, of at
    most ``prefix_bytes``, matching at the pool's ``block`` (another
    ``prefix_block`` is refused).

    Both: ``spec_k > 0`` turns on speculation with up to ``spec_k``
    proposed tokens (rounded down to a power of two) from a trailing
    n-gram of up to ``spec_ngram`` tokens (floored at 2).  ``tp = 0``
    takes ``BYTEPS_TP``.

    Sampling parameters are fixed per engine; per-request variation
    rides the ``seed``.  Drive it with :meth:`step` (deterministic,
    single-threaded) or :meth:`start`'s background tick thread."""

    def __init__(self, model: Transformer, *, n_slots: int = 8,
                 max_seq: Optional[int] = None, temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 eos_id: Optional[int] = None, kv_quant: bool = False,
                 cache_layout: str = "grouped", max_queue: int = 64,
                 prefill_credits: Optional[int] = None, chunk: int = 0,
                 prefix_cache: bool = False,
                 prefix_block: Optional[int] = None,
                 prefix_bytes: int = 256 << 20, paged: bool = False,
                 block: int = 16, kv_mb: int = 0,
                 kv_blocks: Optional[int] = None, kv_dtype: str = "",
                 paged_kernel="auto", tp: int = 0, spec_k: int = 0,
                 spec_ngram: int = 3,
                 metrics: Optional[ServeMetrics] = None, device=None):
        cfg = model.cfg
        self.max_seq = max_seq if max_seq is not None else cfg.max_seq_len
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self.pad_id = _PAD_ID
        self.greedy = temperature == 0
        self.min_prefill_bucket = _MIN_PREFILL_BUCKET
        # chunk size on the prefill bucket grid; 0 = whole prompt
        self.chunk = (_next_bucket(chunk, self.min_prefill_bucket,
                                   self.max_seq) if chunk and chunk > 0
                      else 0)
        self.paged = bool(paged)
        self.device = resolve_device(device)
        self._check_options(cfg, kv_quant, cache_layout, prefix_cache,
                            kv_dtype, paged_kernel, spec_k)
        if not tp:
            from ..common.config import get_config
            tp = max(1, int(get_config().serve_tp))
        if tp > 1 and not self.paged:
            raise ValueError(
                f"tp ({tp}) > 1 requires paged=True: tensor-parallel "
                f"serving shards the paged block pool per KV-head slice; "
                f"dense slot caches shard through init_cache's mesh path "
                f"instead")
        if tp < 1 or cfg.num_heads % tp:
            raise ValueError(f"tp ({tp}) must be >= 1 and divide num_heads "
                             f"({cfg.num_heads}) so query head slices "
                             f"align with KV head slices")
        if self.paged and prefix_block is not None and prefix_block != block:
            raise NotImplementedError(
                f"prefix_block {prefix_block} != block {block}: a paged "
                f"engine's store matches at the pool's block")
        if self.device.type == "cuda":
            if self.paged_kernel:
                _pa.check_kernel_config(cfg.dtype, cfg.d_head, block,
                                        kv_dtype)
            elif cache_layout == "flat" or kv_dtype:
                _da.check_kernel_config(cfg.dtype, cfg.d_head)
        self.model = model.to(self.device).eval()
        if self.paged:
            # the kernel reads flat pools; the gather's fp pool at tp = 1
            # is grouped (int8 and tp pools are flat whatever it says)
            self.pool = PagedSlotPool(
                cfg, n_slots, self.max_seq, block=block, n_blocks=kv_blocks,
                kv_bytes=kv_mb << 20, kv_dtype=kv_dtype, tp=tp,
                layout="flat" if self.paged_kernel or tp > 1 else "grouped",
                device=self.device)
        else:
            self.pool = SlotPool(cfg, n_slots, self.max_seq,
                                 kv_quant=kv_quant, layout=cache_layout,
                                 device=self.device)
        self.kv_dtype = kv_dtype
        self.tp = tp
        # a resume re-prefills the emitted tokens: bit-exact only where
        # prefill reproduces the K/V the original decode wrote (JAX's rule)
        if kv_quant:
            self._resume_unsafe = (
                "kv_quant: resume prefill attends pre-quantization K/V "
                "where the original decode attended the quantized values")
        elif cfg.attn_impl == "flash" and self.max_seq >= 128:
            self._resume_unsafe = (
                "attn_impl='flash': resume prefill can take the flash "
                "kernel while the original run's emitted-token K/V came "
                "from dense decode — accumulation orders differ")
        else:
            self._resume_unsafe = ""
        # speculation depth rounds DOWN to a power of two (the JAX
        # engine's verify buckets); single-token n-grams are noise
        if spec_k and spec_k > 0:
            k = 1
            while k * 2 <= spec_k:
                k *= 2
            self.spec: Optional[NgramProposer] = NgramProposer(
                k, max(2, spec_ngram))
        else:
            self.spec = None
        # credit budget in padded prefill tokens per tick: one max-length
        # prefill (or one chunk) unless set
        budget = (prefill_credits if prefill_credits and prefill_credits > 0
                  else (self.chunk or self.max_seq))
        if self.chunk:
            budget = max(budget, self.chunk)
        self.scheduler = ServeScheduler(max_queue=max_queue,
                                        credit_budget=budget)
        self.metrics = metrics if metrics is not None else get_serve_metrics()
        # a paged store references this pool's blocks, so it is private;
        # a dense one holds copied rows and may back several engines.
        # Keys are salted with the weights and the per-slot row (or pool)
        # geometry, so another model or row shape is a miss, as in JAX
        self._weights_fp: Optional[str] = None
        self._prefix_salt = b""
        self.prefix: Optional[PrefixCache] = None
        if self.paged and prefix_cache:
            if isinstance(prefix_cache, PrefixCache):
                raise ValueError(
                    "a paged engine's prefix store references its own "
                    "KV block pool (entries are block ids, not copied "
                    "buffers) and cannot be shared across engines; "
                    "pass prefix_cache=True")
            self.prefix = PagedPrefixCache(
                self.pool.alloc, block=self.pool.block,
                block_bytes=self.pool.block_bytes, max_bytes=prefix_bytes,
                on_evict=lambda n: self.metrics.bump(sm.BLOCK_EVICTIONS, n))
        elif isinstance(prefix_cache, PagedPrefixCache):
            raise ValueError(
                "a PagedPrefixCache references a paged engine's block "
                "pool and cannot back a dense engine; pass "
                "prefix_cache=True (or a plain PrefixCache)")
        elif isinstance(prefix_cache, PrefixCache):
            self.prefix = prefix_cache
        elif prefix_cache:
            self.prefix = PrefixCache(block=prefix_block or 16,
                                      max_bytes=prefix_bytes)
        # a dense entry is one full row, so its size is the geometry's;
        # when even one cannot fit the budget the extract is skipped
        self._prefix_row_bytes = 0
        if self.prefix is not None:
            geom = hashlib.blake2b(digest_size=16)
            for layer in self.pool.caches:
                for name, t in sorted(layer.items()):
                    geom.update(f"{name}{tuple(t.shape[1:])}"
                                f"{t.dtype}".encode())
                    if not self.paged:
                        self._prefix_row_bytes += (
                            t[0].numel() * t.element_size())
            wfp = weights_fingerprint(self.model)
            self._weights_fp = wfp.hex()
            self._prefix_salt = wfp + geom.digest()
        self._lock = threading.RLock()
        self._req_seq = 0
        self._slot_req: List[Optional[Request]] = [None] * n_slots
        self._prefilling: Dict[int, Request] = {}
        self._tick_chunk_debt = 0
        self._tick_prefill = 0
        # next decode input per slot (host-side: the tick reads the
        # sampled tokens back anyway to stream them)
        self._tok = np.zeros((n_slots,), np.int64)
        self._outstanding = 0
        self._drain_cv = threading.Condition(self._lock)
        self._wake = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop_flag = False
        self._engine_error: Optional[BaseException] = None
        self.decode_ticks = 0       # decode and verify ticks
        self.verify_ticks = 0
        self.prefill_chunks = 0     # prefill forwards (whole prompts too)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.prefix_hits = 0
        self.prefix_copies = 0      # dense rows copied in at a hit
        self.prefix_extracts = 0    # dense rows extracted for an insert
        self.cow_copies = 0
        self.gather_buckets: set = set()  # high-water buckets gathered
        # router epochs: the highest dispatch epoch seen (the fence)
        self._epoch_lock = threading.Lock()
        self._epoch_hw = 0
        # parked KV of finished keep_kv requests, req.id -> {"ids": [block
        # ids, incref'd], "pos": T}, oldest evicted past the cap
        from ..common.config import get_config

        self._parked_kv: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()
        self._parked_cap = max(1, get_config().disagg_parked_cap)
        self._parked_lock = threading.Lock()
        # the ship's copies run on a stream of their own (see the seam)
        self._ship_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def _check_options(self, cfg, kv_quant, cache_layout, prefix_cache,
                       kv_dtype, paged_kernel, spec_k) -> None:
        """The JAX engine's refusals, with its messages, in its order;
        sets ``paged_kernel`` (the kernel, or the gather fallback)."""
        if kv_dtype not in ("", "int8"):
            raise ValueError(
                f"kv_dtype must be '' or 'int8', got {kv_dtype!r}")
        if kv_dtype and kv_quant:
            raise ValueError(
                "kv_quant and kv_dtype are mutually exclusive: kv_quant "
                "quantizes the DENSE cache (whole-prompt prefill "
                "attends pre-quantization values — incompatible with "
                "paging/chunking/resume), kv_dtype quantizes the PAGED "
                "block pool with write-time determinism.  Pick one: "
                "kv_quant=True for dense engines, kv_dtype='int8' for "
                "paged engines.")
        if kv_dtype and not self.paged:
            raise ValueError(
                "kv_dtype='int8' quantizes the paged block pool and "
                "requires paged=True; dense engines quantize with "
                "kv_quant=True instead")
        pk = paged_kernel
        if isinstance(pk, bool):
            pk = "on" if pk else "off"
        if pk not in ("auto", "on", "off"):
            raise ValueError(
                f"paged_kernel must be 'auto'|'on'|'off', got "
                f"{paged_kernel!r}")
        # "auto" is the kernel on every device: its plain version serves
        # CPU tensors, as JAX's interpret mode would
        self.paged_kernel = self.paged and pk != "off"
        if self.paged and not self.paged_kernel and cache_layout == "flat":
            raise ValueError(
                "cache_layout='flat' on a paged engine requires the "
                "fused paged-attention kernel (paged_kernel='on'): the "
                "gather fallback would route flat rows through the "
                "dense decode kernel under vmap")
        if kv_quant and (self.chunk or prefix_cache or self.paged):
            raise ValueError(
                "chunked prefill / prefix cache / paged KV cache "
                "require a dense KV cache: a chunk at a traced "
                "position attends int8 K/V where whole-prompt prefill "
                "attends the pre-quantization values, breaking the "
                "bit-exact parity contract.  Run kv_quant engines with "
                "chunk=0, prefix_cache=False, paged=False — or, to "
                "quantize a PAGED engine, use kv_dtype='int8' "
                "(BYTEPS_SERVE_KV_DTYPE), whose quantize-at-write "
                "discipline is consistent at traced positions and "
                "composes with chunking, prefix reuse, and resume.")
        if (self.chunk or prefix_cache or self.paged) and (
                cfg.attn_impl == "flash" and self.max_seq >= 128):
            raise ValueError(
                "chunked prefill / prefix cache / paged KV cache "
                "require the dense prefill path: this config's "
                "whole-prompt prefill can take the flash kernel while "
                "chunks always take dense cached attention, and the "
                "two differ in accumulation order — token streams "
                "could silently diverge from generate().  Serve "
                "attn_impl='flash' models with chunk=0, "
                "prefix_cache=False, paged=False.")
        if spec_k and spec_k > 0:
            if kv_quant:
                raise ValueError(
                    "speculative decoding requires a dense fp KV cache "
                    "(kv_quant=False): the verify pass must be bit-"
                    "exact against single-token decode, which the "
                    "quantized cache paths do not guarantee across "
                    "query widths")
            if cache_layout != "grouped":
                raise ValueError(
                    f"speculative decoding requires cache_layout="
                    f"'grouped' (got {cache_layout!r}): a flat-layout "
                    f"pool decodes tq=1 through the fused decode kernel "
                    f"while the tq>1 verify always runs dense cached "
                    f"attention — the two differ in accumulation order, "
                    f"so accepted tokens could silently diverge from the "
                    f"non-speculative stream")
            if (kv_dtype and not self.paged_kernel
                    and self.device.type == "cuda"):
                # the gather's int8 rows decode tq = 1 through the decode
                # kernel on CUDA while the verify runs dense q8 attention
                raise ValueError(
                    "speculative decoding on an int8 paged pool "
                    "(kv_dtype='int8') requires the fused paged kernel "
                    "on a CUDA device (paged_kernel='on'/'auto'): the "
                    "gather fallback decodes tq=1 through the fused "
                    "dense kernel while the tq>1 verify runs dense q8 "
                    "attention, which differ in accumulation order")
        if not self.paged and cache_layout not in ("grouped", "flat"):
            raise ValueError(f"cache_layout must be 'grouped' or 'flat', "
                             f"got {cache_layout!r}")

    # ------------------------------------------------------------- submit

    @contextlib.contextmanager
    def epoch_fence(self, epoch: int):
        """Check-and-record a router dispatch's epoch atomically with the
        admission or cancel inside the ``with`` block: an epoch LOWER
        than the high-water already seen raises the typed
        :class:`EpochFencedError`; an equal one passes (the active router
        stamps every dispatch with its epoch).  The lock is held across
        the body, so a deposed router's dispatch cannot pass the check,
        lose the race to the takeover epoch's first dispatch, and still
        act afterwards."""
        epoch = int(epoch)
        with self._epoch_lock:
            if epoch < self._epoch_hw:
                raise EpochFencedError(epoch, self._epoch_hw)
            self._epoch_hw = epoch
            yield

    def fence_epoch(self, epoch: int) -> None:
        """Point-in-time epoch check (paths that admit or cancel work use
        the :meth:`epoch_fence` form)."""
        with self.epoch_fence(epoch):
            pass

    @property
    def epoch_high_water(self) -> int:
        with self._epoch_lock:
            return self._epoch_hw

    def submit(self, prompt, max_new_tokens: int, *, seed: int = 0,
               priority: int = 0, resume_tokens=None,
               epoch: Optional[int] = None, keep_kv: bool = False,
               kv_blocks=None) -> Request:
        """Enqueue a generation request.  Raises ``ValueError`` on an
        infeasible request and ``QueueFullError`` when the bounded
        admission queue is full.  ``resume_tokens`` continues a request
        another engine already emitted ``k`` tokens for: prompt +
        emitted tokens are re-prefilled and decoding resumes from the
        last one (only new tokens are streamed).

        ``epoch`` (router dispatches) runs the admission inside
        :meth:`epoch_fence`.  ``keep_kv`` (a disagg prefill replica)
        parks the finished request's blocks for a ship; ``kv_blocks`` (a
        decode replica) carries staged, written block ids whose adoption
        replaces the prefill.  The engine owns ``kv_blocks`` once this
        returns (adopted, or released on every other path); on a raise
        they stay the caller's."""
        if epoch is not None:
            with self.epoch_fence(epoch):
                return self._submit(prompt, max_new_tokens, seed, priority,
                                    resume_tokens, keep_kv, kv_blocks)
        return self._submit(prompt, max_new_tokens, seed, priority,
                            resume_tokens, keep_kv, kv_blocks)

    def _submit(self, prompt, max_new_tokens: int, seed: int, priority: int,
                resume_tokens, keep_kv: bool, kv_blocks) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        T = int(prompt.shape[0])
        if T < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if T + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({T}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds engine max_seq {self.max_seq}")
        vocab = self.model.cfg.vocab_size
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        resumed = ([int(t) for t in resume_tokens]
                   if resume_tokens is not None else [])
        if (resumed and self.eos_id is not None
                and resumed[-1] == self.eos_id):
            # the stream already ended at EOS where it was emitted:
            # answer a finished request (no slot, no prefill — so even an
            # engine that refuses resume answers it), and release staged
            # blocks nothing will adopt
            with self._lock:
                self._req_seq += 1
                req = Request(id=self._req_seq, prompt=prompt,
                              max_new_tokens=max_new_tokens, seed=seed,
                              priority=priority, t_submit=time.monotonic())
                req.tokens = resumed
                req.state = RequestState.DONE
                req._out.put(_END)
                req._done.set()
                if self.paged:
                    self.release_kv_ids(kv_blocks)
            self.metrics.bump(sm.SUBMITTED)
            self.metrics.bump(sm.COMPLETED)  # 0 tokens generated here
            return req
        if resumed and self._resume_unsafe:
            raise ValueError(
                f"this engine cannot resume a partially-emitted request "
                f"bit-exactly ({self._resume_unsafe}); serve resumable "
                f"replicas with a dense, non-flash-prefill config")
        if resumed and max_new_tokens <= len(resumed):
            raise ValueError(
                f"resume carries {len(resumed)} tokens but "
                f"max_new_tokens is {max_new_tokens} — nothing left to "
                f"generate")
        bucket = _next_bucket(T + max(0, len(resumed) - 1),
                              self.min_prefill_bucket, self.max_seq)
        if self.chunk:
            bucket = min(bucket, self.chunk)
        with self._lock:
            if self._engine_error is not None:
                raise RuntimeError(
                    f"serving engine is dead (tick failed with "
                    f"{self._engine_error!r}); restart it") \
                    from self._engine_error
            self._req_seq += 1
            req = Request(id=self._req_seq, prompt=prompt,
                          max_new_tokens=max_new_tokens, seed=seed,
                          priority=priority, t_submit=time.monotonic())
            if resumed:
                req.tokens = resumed
                req._resumed_n = len(resumed)
                req._resume_tok = resumed[-1]
            req._keep_kv = bool(keep_kv and self.paged)
            if kv_blocks is not None and self.paged:
                req._kv_blocks = [int(b) for b in kv_blocks]
            self._outstanding += 1
            try:
                req._task = self.scheduler.submit(req, bucket)
            except Exception:
                # the caller keeps the staged blocks of a refused submit
                req._kv_blocks = None
                self._outstanding -= 1
                self._drain_cv.notify_all()
                self.metrics.bump(sm.REJECTED)
                raise
        self.metrics.bump(sm.SUBMITTED)
        with self._wake:
            self._wake.notify_all()
        return req

    def cancel(self, req: Request) -> None:
        """Cancel a request: a queued one leaves the queue now; an
        in-flight one frees its slot and blocks now (serialized with
        :meth:`step` on the engine lock)."""
        req.cancelled = True
        with self._lock:
            if (req.state is RequestState.QUEUED and req._task is not None
                    and self.scheduler.remove(req._task)):
                self._finish(req, RequestState.CANCELLED)
            elif (req.state in (RequestState.PREFILLING,
                                RequestState.ACTIVE)
                    and req.slot is not None
                    and self._engine_error is None):
                self._finish(req, RequestState.CANCELLED)
        with self._wake:
            self._wake.notify_all()

    # --------------------------------------------------------------- tick

    def step(self) -> Dict[str, int]:
        """One engine tick: cancellations -> prefill continuations ->
        credit-bounded admissions -> one decode pass -> credits back."""
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> Dict[str, int]:
        emitted = 0
        admitted = 0
        granted: List = []
        self._tick_chunk_debt = 0
        self._tick_prefill = 0
        try:
            for slot in self.pool.active_slots():
                req = self._slot_req[slot]
                if req is not None and req.cancelled:
                    self._finish(req, RequestState.CANCELLED)
            for slot in sorted(self._prefilling):
                req = self._prefilling.get(slot)
                if req is not None:
                    emitted += self._advance_prefill(req)
            free = self.pool.free_count
            if free:
                granted = self.scheduler.admit(free)
                for task in granted:
                    req = task.request
                    if req.cancelled:
                        self._finish(req, RequestState.CANCELLED)
                    elif (self.paged and req._hold_blocks
                          and self.pool.alloc.free_count < req._hold_blocks
                          and self.pool.active_count > 0):
                        # a preempted request waits until its worst-case
                        # need fits; everything granted after it goes
                        # back too (FCFS head-of-line)
                        idx = granted.index(task)
                        for later in granted[idx:]:
                            self.scheduler.resubmit(later)
                        break
                    else:
                        req._hold_blocks = 0
                        admitted += 1
                        emitted += self._admit(req)
            active = [s for s in self.pool.active_slots()
                      if s not in self._prefilling]
            if active:
                emitted += self._decode_tick(active)
        except Exception as e:
            for task in granted:
                req = task.request
                if req.state is RequestState.QUEUED:
                    self.scheduler.remove(task)
                    req.error = e
                    self._finish(req, RequestState.FAILED)
            raise
        finally:
            for task in granted:
                self.scheduler.finish(task)
            if self._tick_chunk_debt:
                self.scheduler.return_credits(self._tick_chunk_debt)
                self._tick_chunk_debt = 0
        if granted or emitted or self.pool.active_count \
                or self.scheduler.depth:
            self.metrics.observe_tick(self.pool.occupancy(),
                                      self.scheduler.depth, emitted)
            self.metrics.gauge(sm.PREFILL_CREDITS, self.scheduler.credits)
            if self.paged:
                bs = self.pool.block_stats()
                self.metrics.gauge(sm.KV_BLOCKS_FREE, bs["free"])
                self.metrics.gauge(sm.KV_BLOCKS_USED, bs["used"])
                self.metrics.gauge(sm.KV_BLOCKS_SHARED, bs["shared"])
        return {"admitted": admitted, "emitted": emitted,
                "active": self.pool.active_count,
                "queued": self.scheduler.depth,
                "prefill_tokens": self._tick_prefill}

    def _admit(self, req: Request) -> int:
        k = len(req.tokens)
        seq = (req.prompt if k == 0 else
               np.concatenate([req.prompt,
                               np.asarray(req.tokens[:-1], np.int32)]))
        req._seq = seq
        slot = self.pool.assign(req.id, int(seq.shape[0]))
        if slot is None:
            raise RuntimeError("admit() granted beyond free slots")
        req.slot = slot
        if not req.t_admit:
            req.t_admit = time.monotonic()
            self.metrics.bump(sm.ADMITTED)
        self._slot_req[slot] = req
        if req._kv_blocks is not None:
            # disagg adoption: a shipped prefill's staged blocks replace
            # the prefill (ownership moves to the table; the cursor is at
            # T from assign) and the resume token is the next decode
            # input.  Any other shape re-prefills — never a wrong answer
            ids, req._kv_blocks = req._kv_blocks, None
            T = int(seq.shape[0])
            want = -(-T // self.pool.block)
            if (req._resume_tok is not None and len(ids) == want
                    and len(ids) <= self.pool.tables[slot].max_blocks
                    and not self.pool.tables[slot].blocks):
                self.pool.adopt_blocks(slot, ids)
                req.state = RequestState.ACTIVE
                self._tok[slot] = req._resume_tok
                req._resume_tok = None
                return 0
            bps_log.warning(
                "disagg: refusing adoption of %d staged block(s) for "
                "request %d (want %d for T=%d) — re-prefilling",
                len(ids), req.id, want, T)
            self.release_kv_ids(ids)
        p0 = 0
        if self.prefix is not None:
            req._prefix_digs = self.prefix.digests_for(
                seq, salt=self._prefix_salt)
            m = self.prefix.match(seq, salt=self._prefix_salt,
                                  digests=req._prefix_digs)
            if m is not None:
                # a hit shares the stored blocks (paged: refcounts, no
                # copy) or copies the stored row (dense), and prefill
                # resumes at the boundary: the bytes are the K/V the
                # prefill would recompute
                entry, p0 = m
                self.prefix.acquire(entry)
                try:
                    if self.paged:
                        self.pool.share_prefix(
                            slot, entry.buffer[:p0 // self.pool.block])
                    else:
                        self._prefix_copy(entry.buffer, slot)
                finally:
                    self.prefix.release(entry)
                self.prefix_hits += 1
                self.metrics.bump(sm.PREFIX_HITS)
                self.metrics.bump(sm.PREFIX_HIT_TOKENS, p0)
            else:
                self.metrics.bump(sm.PREFIX_MISSES)
        if p0 == 0 and not self.paged and not self.chunk:
            return self._prefill_whole(req)
        req.state = RequestState.PREFILLING
        req.prefill_pos = p0
        req._pf_paid = True
        self._prefilling[slot] = req
        return self._advance_prefill(req)

    def _prefix_copy(self, buffer: List[dict], slot: int) -> None:
        """Overwrite a dense slot's whole row with a stored one (JAX
        ``_prefix_copy_fn``); the rows past the match are the entry's
        zeros, rewritten before the mask admits them."""
        for layer, stored in zip(self.pool.caches, buffer):
            for n, c in layer.items():
                c[slot].copy_(stored[n][0])
        self.prefix_copies += 1

    def _prefix_extract(self, slot: int, length: int) -> List[dict]:
        """A copy of a dense slot's row with positions ``>= length``
        zeroed (JAX ``_prefix_extract_fn``)."""
        out = []
        for layer in self.pool.caches:
            row = {}
            for n, c in layer.items():
                r = c[slot:slot + 1].clone()
                r[:, length:] = 0
                row[n] = r
            out.append(row)
        self.prefix_extracts += 1
        return out

    def _slot_row(self, slot: int) -> List[dict]:
        """A dense slot's ``[1, max_seq, ...]`` row of every layer's
        caches: views, so the model's in-place writes land in the pool."""
        return [{n: c[slot:slot + 1] for n, c in layer.items()}
                for layer in self.pool.caches]

    def _prefill_whole(self, req: Request) -> int:
        """Dense whole-prompt prefill (JAX ``_prefill_forward``): the
        sequence right-padded to its power-of-two bucket runs at ``pos =
        0`` on the slot's row — the flash forward where the bucket passes
        the gcd gate of an ``attn_impl="flash"`` model — and the first
        token is read at the true last position.  The pad rows' K/V lies
        past the cursor, rewritten before the mask can admit it."""
        seq = req._seq
        T = int(seq.shape[0])
        slot = req.slot
        bucket = _next_bucket(T, self.min_prefill_bucket, self.max_seq)
        toks = np.full((1, bucket), self.pad_id, np.int64)
        toks[0, :T] = seq
        logits, _ = self.model.decode(torch.from_numpy(toks).to(self.device),
                                      self._slot_row(slot), 0,
                                      last_idx=T - 1)
        self.prefill_chunks += 1
        self.metrics.bump(sm.PREFILL_TOKENS, bucket)
        self._tick_prefill += bucket
        return self._prefill_done(req, logits)

    def _prefill_done(self, req: Request, logits: torch.Tensor) -> int:
        """A request's prefill is complete: ACTIVE, and its first token
        sampled from ``logits [1, 1, vocab]`` and emitted (1) — or, when
        it resumes, its parked next-input token restored (0)."""
        slot = req.slot
        self._prefilling.pop(slot, None)
        req.state = RequestState.ACTIVE
        self._maybe_insert_prefix(req)
        if req._resume_tok is not None:
            # resuming: every emitted token's K/V is rebuilt; the parked
            # next-input token continues the stream
            self._tok[slot] = req._resume_tok
            req._resume_tok = None
            return 0
        tok0 = self._select(logits[:, -1], req)
        self._tok[slot] = tok0
        self._emit(req, tok0)
        return 1

    def _select(self, logits_last: torch.Tensor, req: Request,
                k: Optional[int] = None) -> int:
        """Pick token ``k`` (default: the next) of ``req`` from ``[1,
        vocab]`` logits: argmax, or a draw from ``token_generator(seed,
        k)``."""
        if self.greedy:
            return int(torch.argmax(logits_last[0]).item())
        g = token_generator(req.seed, len(req.tokens) if k is None else k)
        return int(sample_logits(logits_last, g, self.temperature,
                                 self.top_k, self.top_p)[0].item())

    def _advance_prefill(self, req: Request) -> int:
        """Run as many prefill chunks for ``req`` as the tick's credits
        allow.  Returns 1 when the final chunk emitted the first token,
        else 0 (still PREFILLING, resumed, preempted or failed)."""
        seq = req._seq if req._seq is not None else req.prompt
        T = int(seq.shape[0])
        slot = req.slot
        S = self.max_seq
        while True:
            p0 = req.prefill_pos
            csize = (min(T - p0, self.chunk) if self.chunk else T - p0)
            bucket = _next_bucket(csize, self.min_prefill_bucket,
                                  self.chunk or self.max_seq)
            if p0 and p0 + bucket > S and p0 + self.min_prefill_bucket <= S:
                fit = self.min_prefill_bucket
                while fit * 2 <= S - p0:
                    fit *= 2
                bucket = fit
                csize = min(csize, bucket)
            need = (min(bucket, self.scheduler.credit_budget)
                    if self.scheduler.credit_budget > 0 else bucket)
            if req._pf_paid:
                req._pf_paid = False
            elif self.scheduler.take_credits(need):
                self._tick_chunk_debt += need
            else:
                return 0  # budget spent; next tick continues
            # a padded final bucket must not write past the row: shift
            # the chunk left and re-feed tokens already written (their
            # K/V recomputes to the same values)
            start = min(p0, S - bucket)
            # lazy grant for the chunk's REAL tokens; padding lands on
            # the null block through the table's null entries.  Then fork
            # any shared block the span touches (only a shifted-left
            # re-feed reaches one), so shared blocks are never written
            if self.paged and not self._with_block_pressure(
                    req, lambda: self.pool.ensure_blocks(
                        slot, min(start + bucket, T))):
                return 0
            if self.paged and not self._with_block_pressure(
                    req, lambda: self.pool.make_writable(
                        slot, start, start + bucket, self._cow_copy)):
                return 0
            toks = np.full((1, bucket), self.pad_id, np.int64)
            end = min(start + bucket, T)
            toks[0, :end - start] = seq[start:end]
            final = p0 + csize >= T
            last_idx = (T - 1 - start) if final else (bucket - 1)
            toks = torch.from_numpy(toks).to(self.device)
            if self.paged:
                logits = self.model.prefill_chunk_paged(
                    toks, self.pool.caches, self.pool.table_row(slot), start,
                    last_idx, tp=self.tp)
            else:
                logits = self.model.prefill_chunk(
                    toks, self._slot_row(slot), start, last_idx)
            req.prefill_pos = p0 + csize
            self.prefill_chunks += 1
            self.metrics.bump(sm.PREFILL_TOKENS, bucket)
            self.metrics.bump(sm.PREFILL_CHUNKS)
            self._tick_prefill += bucket
            if final:
                return self._prefill_done(req, logits)

    def _maybe_insert_prefix(self, req: Request) -> None:
        """After a completed prefill, store the sequence's block-aligned
        prefix: a paged engine registers the slot's own blocks (refcount
        bumps, no copy), a dense one inserts the zero-masked row extract
        (skipped when one row exceeds the budget).  Skipped when its last
        full boundary is already stored."""
        if self.prefix is None:
            return
        seq = req._seq if req._seq is not None else req.prompt
        ins = self.prefix.insertable_len(seq, salt=self._prefix_salt,
                                         digests=req._prefix_digs)
        if ins <= 0:
            return
        if self.paged:
            ids = self.pool.tables[req.slot].blocks[:ins // self.pool.block]
            if (len(ids) == ins // self.pool.block
                    and self.prefix.insert_blocks(
                        seq[:ins], ids, salt=self._prefix_salt,
                        digests=req._prefix_digs)):
                self.metrics.bump(sm.PREFIX_INSERTIONS)
            return
        if (self.prefix.max_bytes
                and self._prefix_row_bytes > self.prefix.max_bytes):
            return
        if self.prefix.insert(seq[:ins], self._prefix_extract(req.slot, ins),
                              salt=self._prefix_salt,
                              digests=req._prefix_digs):
            self.metrics.bump(sm.PREFIX_INSERTIONS)

    def _cow_copy(self, src: int, dst: int) -> None:
        """Device side of a copy-on-write fork
        (``PagedSlotPool.make_writable``)."""
        self.pool.copy_block(src, dst)
        self.cow_copies += 1

    def _with_block_pressure(self, req: Request, fn) -> bool:
        """Run ``fn()`` (a block grant for ``req``); on exhaustion evict
        unpinned prefix-store blocks (cheapest: they can be recomputed),
        else preempt the NEWEST other in-flight request and retry; if
        ``req`` is itself the newest it yields (back to QUEUED); alone
        and still short it fails with the typed error.  False = ``req``
        lost its slot this tick."""
        while True:
            try:
                fn()
                return True
            except BlocksExhaustedError as e:
                if self.prefix is not None and self.prefix.evict_for(
                        max(1, e.needed - e.free)):
                    continue
                others = [self._slot_req[s]
                          for s in self.pool.active_slots()
                          if self._slot_req[s] is not None
                          and self._slot_req[s] is not req]
                newer = [r for r in others if r.id > req.id]
                if newer:
                    self._preempt(max(newer, key=lambda r: r.id))
                    continue
                if others:
                    self._preempt(req)
                    return False
                req.error = e
                self._finish(req, RequestState.FAILED)
                return False

    def _preempt(self, victim: Request) -> None:
        """Back to QUEUED under block pressure: the slot and blocks
        return now; on re-admission the request re-prefills prompt +
        emitted tokens and resumes from its parked next-input token.
        Re-queued through its ORIGINAL task, ahead of later arrivals."""
        slot = victim.slot
        if victim.state is RequestState.ACTIVE and victim.tokens:
            victim._resume_tok = int(self._tok[slot])
        self._prefilling.pop(slot, None)
        self._slot_req[slot] = None
        self.pool.free(slot)
        victim.slot = None
        victim.prefill_pos = 0
        victim._pf_paid = False
        victim._seq = None
        victim._hold_blocks = -(-(int(victim.prompt.shape[0])
                                  + victim.max_new_tokens)
                                // self.pool.block)
        victim.state = RequestState.QUEUED
        self.scheduler.resubmit(victim._task)
        self.metrics.bump(sm.PREEMPTIONS)

    def _decode_tick(self, active: List[int]) -> int:
        n = self.pool.n_slots
        if self.paged:
            for slot in list(active):
                req = self._slot_req[slot]
                if req is None:
                    continue  # a victim of an earlier preemption
                self._with_block_pressure(
                    req, lambda s=slot: self.pool.ensure_blocks(
                        s, self.pool.pos[s] + 1))
            active = [s for s in active
                      if self._slot_req[s] is not None
                      and s not in self._prefilling]
            if not active:
                return 0
        if self.spec is not None:
            return self._verify_tick(active, self._collect_proposals(active))
        self.decode_ticks += 1
        self.metrics.bump(sm.DECODE_TICKS)
        pos = np.zeros((n,), np.int32)
        dev = self.device
        tok = torch.from_numpy(self._tok[:, None]).to(dev)
        if not self.paged:
            # one pass over every row at its fixed width: active slots at
            # their cursors, free slots at 0, PREFILLING slots at their
            # post-prefill cursor (JAX ``_decode_tick``)
            for slot in [*active, *self._prefilling]:
                pos[slot] = self.pool.pos[slot]
            logits, _ = self.model.decode(
                tok, self.pool.caches, torch.from_numpy(pos).to(dev),
                last_only=True)
            return self._emit_tick(active, logits[:, -1])
        wblk = np.full((n, 1), self.pool.null_block, np.int32)
        woff = np.zeros((n, 1), np.int32)
        for slot in active:
            pos[slot] = self.pool.pos[slot]
            wblk[slot, 0], woff[slot, 0] = self.pool.write_target(slot)
        if self.paged_kernel:
            logits = self.model.decode_paged_fused(
                tok, self.pool.caches, self.pool.tables_device(),
                torch.from_numpy(pos).to(dev),
                torch.from_numpy(wblk).to(dev),
                torch.from_numpy(woff).to(dev), last_only=True)
        else:
            logits = self._gather_step(tok, pos, wblk, woff)
        return self._emit_tick(active, logits[:, -1])

    def _gather_hw(self, tq: int) -> int:
        """The gather's block high-water bucket (JAX ``_gather_hw``): the
        smallest power-of-two block count, capped at ``max_blocks``,
        covering every assigned non-PREFILLING slot's ``[0, pos + tq)``
        (masked slots sit at pos 0 and write the null block)."""
        need = tq
        for slot in self.pool.active_slots():
            if slot not in self._prefilling:
                need = max(need, self.pool.pos[slot] + tq)
        return _next_bucket(-(-need // self.pool.block), 1,
                            self.pool.max_blocks)

    def _gather_step(self, toks, pos: np.ndarray, wblk: np.ndarray,
                     woff: np.ndarray) -> torch.Tensor:
        """One gather-fallback pass at ``tq = toks.shape[1]``: every slot's
        rows up to the high-water bucket, the dense decode on them at the
        position vector (``Transformer.decode_paged``), then only the
        written positions scattered back to ``(wblk, woff) [n, tq]``.
        Returns the logits ``[n, tq, vocab]``."""
        tq = toks.shape[1]
        hw = self._gather_hw(tq)
        self.gather_buckets.add(hw)
        self.metrics.bump(sm.GATHERED_BLOCKS, self.pool.n_slots * hw)
        dev = self.device
        posd = torch.from_numpy(pos).to(dev)
        logits, rows = self.model.decode_paged(
            toks, self.pool.caches, self.pool.tables_device(), posd,
            hw_blocks=hw, tp=self.tp)
        positions = posd.long()[:, None] + torch.arange(tq, device=dev)
        scatter_paged_rows(self.pool.caches, rows, positions,
                           torch.from_numpy(wblk).to(dev),
                           torch.from_numpy(woff).to(dev), self.tp)
        return logits

    def _emit_tick(self, active: List[int], logits: torch.Tensor) -> int:
        """Pick every active slot's next token from ``logits [n_slots,
        vocab]``, advance its cursor and emit it."""
        n = self.pool.n_slots
        if self.greedy:
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        else:
            nxt = np.zeros((n,), np.int64)
            for slot in active:
                nxt[slot] = self._select(logits[slot:slot + 1],
                                         self._slot_req[slot])
        emitted = 0
        for slot in active:
            req = self._slot_req[slot]
            self._tok[slot] = int(nxt[slot])
            self.pool.advance(slot)
            self._emit(req, int(nxt[slot]))
            emitted += 1
        return emitted

    def _collect_proposals(self, active: List[int]) -> Dict[int, List[int]]:
        """Per active slot, up to ``k`` proposed continuations from the
        request's own prompt + emitted history, capped at its remaining
        row space and token budget minus one (tokens past either could
        never be emitted); slots with none are left out."""
        props: Dict[int, List[int]] = {}
        S = self.max_seq
        for slot in active:
            req = self._slot_req[slot]
            if req is None or not req.tokens:
                continue
            cap = min(S - self.pool.pos[slot] - 1,
                      req.max_new_tokens - len(req.tokens) - 1)
            if cap < 1:
                continue
            P = int(req.prompt.shape[0])
            if req._spec_ctx is None:
                req._spec_ctx = np.empty(P + req.max_new_tokens, np.int32)
                req._spec_ctx[:P] = req.prompt
                req._spec_n = P
            k = len(req.tokens)
            have = req._spec_n - P
            if k > have:
                req._spec_ctx[P + have:P + k] = req.tokens[have:]
                req._spec_n = P + k
            p = self.spec.propose(req._spec_ctx[:req._spec_n], cap)
            if p:
                props[slot] = p
        return props

    def _verify_tick(self, active: List[int],
                     props: Dict[int, List[int]]) -> int:
        """One speculative tick: every slot rides one pass at ``tq = k +
        1``, inputs ``[next token, proposals...]`` at ``[pos, pos + tq)``
        (the kernel, the gather, or on dense rows
        ``Transformer.verify_tokens`` at the position vector).  Slot ``s``
        emits the model's tokens ``t_0..t_{m-1}`` with ``m = 1 + `` the
        leading run of proposals equal to the model's own tokens,
        truncated at its budget and at the first EOS; ``t_{m-1}`` is its
        next input and its cursor moves ``m`` (JAX ``_verify_accept``).
        Rejected positions' K/V lies past the cursor, never attended
        before it is rewritten.  The width never changes, so a slot's
        arithmetic does not depend on the other slots: near the row's
        end a span's positions past the row (paged: past the granted
        blocks, which write the null block) are discarded, as proposals
        are capped to the row."""
        n = self.pool.n_slots
        S = self.max_seq
        d = self.spec.k
        tq = d + 1
        toks = np.full((n, tq), self.pad_id, np.int64)
        toks[:, 0] = self._tok
        plen = np.zeros((n,), np.int64)
        pos = np.zeros((n,), np.int32)
        if self.paged:
            blk = self.pool.block
            wblk = np.full((n, tq), self.pool.null_block, np.int32)
            woff = np.zeros((n, tq), np.int32)
        else:
            # PREFILLING rows' masked span aims at their cursor, as on a
            # plain tick
            for slot in self._prefilling:
                pos[slot] = self.pool.pos[slot]
        for slot in active:
            p0 = self.pool.pos[slot]
            pos[slot] = p0
            p = props.get(slot, [])[:d]
            toks[slot, 1:1 + len(p)] = p
            plen[slot] = len(p)
            if not self.paged:
                continue
            # best-effort span grant: speculation never evicts or
            # preempts to hold guess-width; a proposal the grant cannot
            # cover is clipped before the verify, so acceptance never
            # moves a cursor onto an unwritten position
            try:
                self.pool.ensure_blocks(slot, min(p0 + 1 + len(p), S))
            except BlocksExhaustedError:
                pass
            table = self.pool.tables[slot].blocks
            cov = len(table) * blk - p0
            plen[slot] = min(len(p), cov - 1)
            for j in range(min(tq, cov)):
                wblk[slot, j] = table[(p0 + j) // blk]
                woff[slot, j] = (p0 + j) % blk
        self.decode_ticks += 1
        self.verify_ticks += 1
        self.metrics.bump(sm.DECODE_TICKS)
        self.metrics.bump(sm.SPEC_VERIFY_TICKS)
        dev = self.device
        tokd = torch.from_numpy(toks).to(dev)
        if not self.paged:
            logits, _ = self.model.verify_tokens(
                tokd, self.pool.caches, torch.from_numpy(pos).to(dev))
        elif self.paged_kernel:
            logits = self.model.decode_paged_fused(
                tokd, self.pool.caches, self.pool.tables_device(),
                torch.from_numpy(pos).to(dev),
                torch.from_numpy(wblk).to(dev),
                torch.from_numpy(woff).to(dev))
        else:
            logits = self._gather_step(tokd, pos, wblk, woff)
        tmat = (torch.argmax(logits, dim=-1).cpu().numpy() if self.greedy
                else None)                                # [n, tq]
        emitted = accepted = 0
        for slot in active:
            req = self._slot_req[slot]
            k0 = len(req.tokens)
            # the model's token at each position that could be emitted:
            # argmax, or the draw of token k0 + i from its own generator
            # (the draw a plain tick would make for that token)
            cand = [int(tmat[slot, i]) if self.greedy else self._select(
                logits[slot, i:i + 1], req, k0 + i)
                for i in range(int(plen[slot]) + 1)]
            lead = 0
            while lead < plen[slot] and toks[slot, 1 + lead] == cand[lead]:
                lead += 1
            m = min(1 + lead, max(req.max_new_tokens - k0, 1))
            if self.eos_id is not None and self.eos_id in cand[:m]:
                m = cand.index(self.eos_id) + 1
            accepted += lead
            self._tok[slot] = cand[m - 1]
            self.pool.advance(slot, m)
            for t in cand[:m]:
                self._emit(req, t)
                emitted += 1
        self.spec_proposed += int(plen.sum())
        self.spec_accepted += accepted
        self.metrics.bump(sm.SPEC_PROPOSED, int(plen.sum()))
        if accepted:
            self.metrics.bump(sm.SPEC_ACCEPTED, accepted)
        return emitted

    def _emit(self, req: Request, tok: int) -> None:
        now = time.monotonic()
        if not req.t_first:
            req.t_first = now
        req.t_last = now
        req.tokens.append(tok)
        req._out.put(tok)
        if (len(req.tokens) >= req.max_new_tokens
                or (self.eos_id is not None and tok == self.eos_id)):
            self._finish(req, RequestState.DONE)

    def _finish(self, req: Request, state: RequestState) -> None:
        req.state = state
        if req.slot is not None:
            if req._keep_kv and state is RequestState.DONE:
                # disagg prefill replica: park the blocks (refs taken
                # before the free below drops the table's own)
                self._park_kv_locked(req)
            self._prefilling.pop(req.slot, None)
            self._slot_req[req.slot] = None
            self.pool.free(req.slot)
            req.slot = None
        if req._kv_blocks is not None:
            # staged blocks never adopted (cancel or failure before
            # admission): released, never leaked
            self.release_kv_ids(req._kv_blocks)
            req._kv_blocks = None
        req._out.put(_END)
        req._done.set()
        if state is RequestState.DONE:
            # only THIS engine's emissions (a resume pre-seeds tokens)
            n = len(req.tokens) - req._resumed_n
            tpot = ((req.t_last - req.t_first) / (n - 1) if n > 1 else None)
            self.metrics.observe_request(
                queue_wait_s=req.t_admit - req.t_submit,
                ttft_s=req.t_first - req.t_submit, tpot_s=tpot)
        elif state is RequestState.FAILED:
            self.metrics.bump(sm.FAILED)
        else:
            self.metrics.bump(sm.CANCELLED)
        with self._drain_cv:
            self._outstanding -= 1
            self._drain_cv.notify_all()

    # ---------------------------------------------------------- lifecycle

    def _idle(self) -> bool:
        return self.pool.active_count == 0 and self.scheduler.depth == 0

    def start(self) -> "ServingEngine":
        """Run the tick loop on a background thread (frontend mode)."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stop_flag = False
            self._thread = threading.Thread(
                target=self._run, name="byteps-torch-serve-engine",
                daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop_flag:
            try:
                self.step()
            except Exception as e:
                # a dead tick thread must not look like a hung one: fail
                # every request loudly and refuse new submissions
                bps_log.warning("serving engine tick failed: %r", e)
                self._fail_all(e)
                return
            with self._wake:
                if self._idle() and not self._stop_flag:
                    self._wake.wait(timeout=0.05)

    def _fail_all(self, exc: BaseException) -> None:
        with self._lock:
            self._engine_error = exc
            for slot in self.pool.active_slots():
                req = self._slot_req[slot]
                if req is not None:
                    req.error = exc
                    self._finish(req, RequestState.FAILED)
            for task in self.scheduler.drain_pending():
                task.request.error = exc
                self._finish(task.request, RequestState.FAILED)

    def stop(self, timeout: float = 10.0) -> None:
        self._stop_flag = True
        with self._wake:
            self._wake.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            if t.is_alive():
                bps_log.warning(
                    "serving engine tick thread still running after "
                    "%.1fs; engine not restartable until it exits",
                    timeout)
            else:
                self._thread = None

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted request has finished; without a
        background thread, drives :meth:`step` inline."""
        deadline = None if timeout is None else time.monotonic() + timeout
        if self._thread is None:
            while True:
                with self._lock:
                    if self._outstanding == 0:
                        return
                self.step()
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError("drain timed out")
        else:
            with self._drain_cv:
                while self._outstanding > 0:
                    if (deadline is not None
                            and time.monotonic() >= deadline):
                        raise TimeoutError("drain timed out")
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    self._drain_cv.wait(remaining)

    # ------------------------------------------- disagg KV ship seam
    #
    # The prefill side reads parked blocks out of the pool
    # (extract_kv_payloads), the decode side writes received blocks in
    # (write_kv_payloads).  JAX runs both under the engine lock because
    # its tick donates the pool's buffers; here the pools are updated in
    # place and never replaced, and the tick thread holds the engine lock
    # for a whole tick, so the seam takes no engine lock (under load a
    # call would wait for ticks): the allocator and the parked map have
    # locks of their own, and the copies run on the engine's ship stream,
    # ending in its synchronize.  On the host every block they touch is
    # the ship's alone — parked blocks hold the entry's refs; staged ones
    # sit in no table until an admission adopts them, and that
    # admission's decode passes are issued after the copy has landed.  On
    # the device they are not: a block freed by a cancel or a preemption
    # (and then staged) may still have a prefill chunk's K/V write queued
    # on the tick's stream, so the ship stream first waits for the work
    # queued there.  The wait is the device's; the host does not wait.

    def _ship_copies(self):
        if self._ship_stream is None:
            return contextlib.nullcontext()
        self._ship_stream.wait_stream(torch.cuda.default_stream(self.device))
        return torch.cuda.stream(self._ship_stream)

    def take_parked_kv(self, req_id: int) -> Optional[dict]:
        """Claim (and remove) the parked KV entry a finished ``keep_kv``
        request left behind; the caller owns its block refs and must
        :meth:`release_kv_ids` them."""
        with self._parked_lock:
            return self._parked_kv.pop(req_id, None)

    def release_kv_ids(self, ids) -> None:
        """Drop one reference a block id (parked entries, refused
        adoptions, aborted stagings)."""
        for b in ids or ():
            self.pool.alloc.decref(int(b))

    def stage_alloc(self, n: int) -> List[int]:
        """Allocate ``n`` pool blocks for an incoming ship; raises
        ``BlocksExhaustedError`` when the pool cannot cover it (the
        sender aborts, the router re-prefills)."""
        return self.pool.alloc.alloc(n)

    def kv_block_schema(self) -> List[list]:
        """One block's wire schema: per layer, ``(name, shape, dtype)``
        for each cache tensor in sorted-name order (the payload order),
        ``shape`` the unsharded row — a tp pool's shards side by side,
        head-major — so the schema is the same at any tp, and a grouped
        ``[block, KV, D]`` row is the bytes of a flat ``[block, KV*D]``
        one."""
        out = []
        for layer in self.pool.caches:
            out.append([(n, ((layer[n].shape[2], self.tp * layer[n].shape[3])
                             if self.tp > 1 else tuple(layer[n].shape[1:])),
                         layer[n].dtype) for n in sorted(layer)])
        return out

    def _split_rows(self, rows: torch.Tensor
                    ) -> List[Dict[str, torch.Tensor]]:
        """``[n, block_bytes]`` uint8 payload rows as :meth:`kv_block_schema`
        tensors: one dict a layer, each value ``[n, *row]`` (views where
        the byte offsets allow)."""
        n = rows.shape[0]
        out, off = [], 0
        for layer in self.kv_block_schema():
            d = {}
            for name, shape, dt in layer:
                nb = int(np.prod(shape)) * dt.itemsize
                d[name] = _bytes_as(rows[:, off:off + nb], dt).reshape(
                    n, *shape)
                off += nb
            out.append(d)
        return out

    def extract_kv_payloads(self, ids) -> torch.Tensor:
        """The ship payload of the blocks ``ids``: a ``[len(ids),
        block_bytes]`` uint8 host tensor (pinned, on CUDA), row ``i``
        block ``ids[i]``'s bytes in :meth:`kv_block_schema` order.  One
        gather a cache tensor and ONE device-to-host copy for the whole
        ship, on the ship stream."""
        n = len(ids)
        with self._ship_copies():
            idx = torch.tensor([int(b) for b in ids], dtype=torch.long,
                               device=self.device)
            parts = []
            for layer in self.pool.caches:
                for name in sorted(layer):
                    c = layer[name]
                    g = (c.index_select(0, idx) if self.tp == 1 else
                         c.index_select(1, idx).permute(1, 2, 0, 3))
                    parts.append(g.reshape(n, -1).view(torch.uint8))
            dev = torch.cat(parts, dim=1)
            if self._ship_stream is None:
                return dev
            host = torch.empty(dev.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(dev, non_blocking=True)
            self._ship_stream.synchronize()
        return host

    def write_kv_payloads(self, ids, rows) -> None:
        """Write received blocks into the pool at physical ids ``ids``:
        ``rows`` holds their payloads back to back (bytes-like, or a
        ``[len(ids), block_bytes]`` uint8 tensor), as
        :meth:`extract_kv_payloads` gives them — one host-to-device copy,
        split on the device, one indexed copy a cache tensor (a tp pool's
        rows back into its shards).  On the ship stream, ending in its
        synchronize while ``rows`` is still referenced, so every copy
        has landed when this returns."""
        n = len(ids)
        if not isinstance(rows, torch.Tensor):
            if memoryview(rows).readonly:
                rows = bytearray(rows)
            rows = torch.frombuffer(rows, dtype=torch.uint8)
        with self._ship_copies():
            idx = torch.tensor([int(b) for b in ids], dtype=torch.long,
                               device=self.device)
            raw = rows.reshape(n, -1).to(self.device, non_blocking=True)
            blk = self._split_rows(raw)
            for cache, src in zip(self.pool.caches, blk):
                for name, c in cache.items():
                    if self.tp == 1:
                        c.index_copy_(0, idx, src[name].reshape(
                            n, *c.shape[1:]))
                    else:                       # [tp, n_blocks, block, X]
                        c.index_copy_(1, idx, src[name].reshape(
                            n, c.shape[2], self.tp, -1).permute(2, 0, 1, 3))
            if self._ship_stream is not None:
                self._ship_stream.synchronize()

    def _park_kv_locked(self, req: Request) -> None:
        """Park a finished ``keep_kv`` request's blocks (incref BEFORE the
        slot free drops the table's refs) for the frontend's ship; the
        oldest entry past the cap is evicted and released."""
        ids = list(self.pool.tables[req.slot].blocks)
        if not ids:
            return
        for b in ids:
            self.pool.alloc.incref(b)
        seq = req._seq if req._seq is not None else req.prompt
        with self._parked_lock:
            self._parked_kv[req.id] = {"ids": ids, "pos": int(len(seq))}
            evicted = []
            while len(self._parked_kv) > self._parked_cap:
                evicted.append(self._parked_kv.popitem(last=False)[1])
        for old in evicted:
            self.release_kv_ids(old["ids"])

    # --------------------------------------------------------- inspection

    @property
    def weights_fp(self) -> str:
        """Hex fingerprint of the weights (``prefix.weights_fingerprint``,
        the digest the prefix keys are salted with), computed once."""
        if self._weights_fp is None:
            self._weights_fp = weights_fingerprint(self.model).hex()
        return self._weights_fp

    def step_counts(self) -> Dict[str, int]:
        """What ran in this engine: decode ticks (verify ticks included)
        and verify ticks, prefill forwards (chunks, and whole prompts on a
        dense engine), proposed and accepted tokens, prefix hits, dense
        row copies and extracts, copy-on-write forks, and the distinct
        high-water buckets the gather fallback used (JAX's
        ``compile_counts()["decode_buckets"]``, one program a bucket
        there); and the process-wide launch counts of the paged-attention
        kernel (a paged CUDA engine: one a layer a tick, at any tp) and
        the decode-attention kernel (a flat dense CUDA engine, or the
        gather over an int8 pool: one a layer a tick, for every slot)."""
        return {"decode_ticks": self.decode_ticks,
                "verify_ticks": self.verify_ticks,
                "prefill_chunks": self.prefill_chunks,
                "spec_proposed": self.spec_proposed,
                "spec_accepted": self.spec_accepted,
                "prefix_hits": self.prefix_hits,
                "prefix_copies": self.prefix_copies,
                "prefix_extracts": self.prefix_extracts,
                "cow_copies": self.cow_copies,
                "gather_buckets": len(self.gather_buckets),
                "paged_attention_launches": _pa.launches,
                "decode_attention_launches": _da.launches}
