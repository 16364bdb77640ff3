"""Continuous-batching engine over a paged KV pool — the port of
``byteps_tpu/serving/engine.py`` in its paged, fused-kernel mode.

Per tick, in a fixed order: retire cancellations, continue in-flight
chunked prefills, admit queued requests within the prefill credit
budget, run ONE decode pass over every active slot, return credits.

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
proposed and accepted tokens, prefix hits and copy-on-write forks run,
and the paged-attention kernel's launch count.

Not ported yet: the dense slot pool, the gather fallback, disaggregated
KV shipping and router epochs (ROADMAP queue A).
"""

from __future__ import annotations

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
from ..models.transformer import Transformer
from ..ops import paged_attention as _pa
from . import metrics as sm
from .blocks import BlocksExhaustedError, PagedSlotPool
from .metrics import ServeMetrics, get_serve_metrics
from .prefix import PagedPrefixCache, weights_fingerprint
from .scheduler import ServeScheduler
from .spec import NgramProposer

__all__ = ["Request", "RequestState", "ServingEngine", "resolve_device"]


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


def _next_bucket(n: int, lo: int, hi: int) -> int:
    """Smallest power-of-two >= n, floored at lo, clamped to hi."""
    b = lo
    while b < n:
        b *= 2
    return min(b, hi)


class ServingEngine:
    """Continuous batching over a :class:`PagedSlotPool` on ``device``
    (``cuda`` unless the caller passes another — see
    :func:`resolve_device`).  Paged with the kernel only: the JAX
    engine's ``paged`` / ``paged_kernel`` choices have one value here.

    ``kv_dtype`` ("" or "int8") and ``tp`` shape the pool;
    ``prefix_cache`` turns on the radix prefix store, of at most
    ``prefix_bytes``, matching at the pool's ``block`` (a ``prefix_block``
    other than ``block`` selects the dense store's own granularity, which
    is not ported, and is refused); ``spec_k > 0`` turns on speculation with up to
    ``spec_k`` proposed tokens (rounded down to a power of two) from a
    trailing n-gram of up to ``spec_ngram`` tokens (floored at 2).
    Sampling parameters are fixed per engine; per-request variation
    rides the ``seed``.  Drive it with :meth:`step` (deterministic,
    single-threaded) or :meth:`start`'s background tick thread."""

    def __init__(self, model: Transformer, *, n_slots: int = 8,
                 max_seq: Optional[int] = None, temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 eos_id: Optional[int] = None, max_queue: int = 64,
                 prefill_credits: Optional[int] = None, chunk: int = 0,
                 block: int = 16, kv_mb: int = 0,
                 kv_blocks: Optional[int] = None, kv_dtype: str = "",
                 tp: int = 1, prefix_cache: bool = False,
                 prefix_block: Optional[int] = None,
                 prefix_bytes: int = 256 << 20, spec_k: int = 0,
                 spec_ngram: int = 3,
                 metrics: Optional[ServeMetrics] = None, device=None):
        self.device = resolve_device(device)
        cfg = model.cfg
        if tp < 1 or cfg.num_heads % tp:
            raise ValueError(f"tp ({tp}) must be >= 1 and divide num_heads "
                             f"({cfg.num_heads}) so query head slices "
                             f"align with KV head slices")
        if prefix_block is not None and prefix_block != block:
            raise NotImplementedError(
                f"prefix_block {prefix_block} != block {block}: a paged "
                f"store matches at the pool's block; the dense store that "
                f"takes its own granularity is not ported")
        if self.device.type == "cuda":
            _pa.check_kernel_config(cfg.dtype, cfg.d_head, block, kv_dtype)
        self.model = model.to(self.device).eval()
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
        self.pool = PagedSlotPool(cfg, n_slots, self.max_seq, block=block,
                                  n_blocks=kv_blocks, kv_bytes=kv_mb << 20,
                                  kv_dtype=kv_dtype, tp=tp,
                                  device=self.device)
        self.kv_dtype = kv_dtype
        self.tp = tp
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
        # the prefix store references this pool's blocks, so it is
        # private; its keys are salted with the weights and the pool's
        # geometry, as in JAX
        self._weights_fp: Optional[str] = None
        self._prefix_salt = b""
        self.prefix: Optional[PagedPrefixCache] = None
        if prefix_cache:
            self.prefix = PagedPrefixCache(
                self.pool.alloc, block=self.pool.block,
                block_bytes=self.pool.block_bytes, max_bytes=prefix_bytes,
                on_evict=lambda n: self.metrics.bump(sm.BLOCK_EVICTIONS, n))
            geom = hashlib.blake2b(digest_size=16)
            for layer in self.pool.caches[:1]:
                for name, t in sorted(layer.items()):
                    geom.update(f"{name}{tuple(t.shape)}{t.dtype}".encode())
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
        self.prefill_chunks = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.prefix_hits = 0
        self.cow_copies = 0

    # ------------------------------------------------------------- submit

    def submit(self, prompt, max_new_tokens: int, *, seed: int = 0,
               priority: int = 0, resume_tokens=None) -> Request:
        """Enqueue a generation request.  Raises ``ValueError`` on an
        infeasible request and ``QueueFullError`` when the bounded
        admission queue is full.  ``resume_tokens`` continues a request
        another engine already emitted ``k`` tokens for: prompt +
        emitted tokens are re-prefilled and decoding resumes from the
        last one (only new tokens are streamed)."""
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
            self._outstanding += 1
            try:
                req._task = self.scheduler.submit(req, bucket)
            except Exception:
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
                    elif (req._hold_blocks
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
        p0 = 0
        if self.prefix is not None:
            req._prefix_digs = self.prefix.digests_for(
                seq, salt=self._prefix_salt)
            m = self.prefix.match(seq, salt=self._prefix_salt,
                                  digests=req._prefix_digs)
            if m is not None:
                # a hit shares the stored blocks (no copy) and prefill
                # resumes at the boundary: the shared bytes are the K/V
                # the prefill would recompute
                entry, p0 = m
                self.prefix.acquire(entry)
                try:
                    self.pool.share_prefix(
                        slot, entry.buffer[:p0 // self.pool.block])
                finally:
                    self.prefix.release(entry)
                self.prefix_hits += 1
                self.metrics.bump(sm.PREFIX_HITS)
                self.metrics.bump(sm.PREFIX_HIT_TOKENS, p0)
            else:
                self.metrics.bump(sm.PREFIX_MISSES)
        req.state = RequestState.PREFILLING
        req.prefill_pos = p0
        req._pf_paid = True
        self._prefilling[slot] = req
        return self._advance_prefill(req)

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
            if not self._with_block_pressure(
                    req, lambda: self.pool.ensure_blocks(
                        slot, min(start + bucket, T))):
                return 0
            if not self._with_block_pressure(
                    req, lambda: self.pool.make_writable(
                        slot, start, start + bucket, self._cow_copy)):
                return 0
            toks = np.full((1, bucket), self.pad_id, np.int64)
            end = min(start + bucket, T)
            toks[0, :end - start] = seq[start:end]
            final = p0 + csize >= T
            last_idx = (T - 1 - start) if final else (bucket - 1)
            logits = self.model.prefill_chunk_paged(
                torch.from_numpy(toks).to(self.device), self.pool.caches,
                self.pool.table_row(slot), start, last_idx)
            req.prefill_pos = p0 + csize
            self.prefill_chunks += 1
            self.metrics.bump(sm.PREFILL_TOKENS, bucket)
            self.metrics.bump(sm.PREFILL_CHUNKS)
            self._tick_prefill += bucket
            if final:
                del self._prefilling[slot]
                req.state = RequestState.ACTIVE
                self._maybe_insert_prefix(req)
                if req._resume_tok is not None:
                    # resuming: every emitted token's K/V is rebuilt;
                    # the parked next-input token continues the stream
                    self._tok[slot] = req._resume_tok
                    req._resume_tok = None
                    return 0
                tok0 = self._select(logits[:, -1], req)
                self._tok[slot] = tok0
                self._emit(req, tok0)
                return 1

    def _maybe_insert_prefix(self, req: Request) -> None:
        """After a completed prefill, register the sequence's full
        blocks in the prefix store (refcount bumps, no copy); skipped
        when its last full boundary is already stored."""
        if self.prefix is None:
            return
        seq = req._seq if req._seq is not None else req.prompt
        ins = self.prefix.insertable_len(seq, salt=self._prefix_salt,
                                         digests=req._prefix_digs)
        if ins <= 0:
            return
        ids = self.pool.tables[req.slot].blocks[:ins // self.pool.block]
        if (len(ids) == ins // self.pool.block
                and self.prefix.insert_blocks(
                    seq[:ins], ids, salt=self._prefix_salt,
                    digests=req._prefix_digs)):
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
        wblk = np.full((n, 1), self.pool.null_block, np.int32)
        woff = np.zeros((n, 1), np.int32)
        for slot in active:
            pos[slot] = self.pool.pos[slot]
            wblk[slot, 0], woff[slot, 0] = self.pool.write_target(slot)
        dev = self.device
        logits = self.model.decode_paged_fused(
            torch.from_numpy(self._tok[:, None]).to(dev), self.pool.caches,
            self.pool.tables_device(), torch.from_numpy(pos).to(dev),
            torch.from_numpy(wblk).to(dev), torch.from_numpy(woff).to(dev),
            last_only=True)[:, -1]                       # [n, vocab]
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
        """One speculative tick: every slot rides one kernel pass at
        ``tq = k + 1``, inputs ``[next token, proposals...]`` at ``[pos,
        pos + tq)``.  Slot ``s`` emits the model's tokens ``t_0..t_{m-1}``
        with ``m = 1 + `` the leading run of proposals equal to the
        model's own tokens, truncated at its budget and at the first
        EOS; ``t_{m-1}`` is its next input and its cursor moves ``m``.
        Rejected positions' K/V lies past the cursor, never attended
        before it is rewritten.  The width never changes, so a slot's
        arithmetic does not depend on the other slots: near the row's
        end a span's positions past the granted blocks write the null
        block, and their rows (which the kernel serves from the row's
        own blocks) are discarded, as proposals are capped to the row."""
        n = self.pool.n_slots
        S = self.max_seq
        blk = self.pool.block
        d = self.spec.k
        tq = d + 1
        toks = np.full((n, tq), self.pad_id, np.int64)
        toks[:, 0] = self._tok
        plen = np.zeros((n,), np.int64)
        pos = np.zeros((n,), np.int32)
        wblk = np.full((n, tq), self.pool.null_block, np.int32)
        woff = np.zeros((n, tq), np.int32)
        for slot in active:
            p0 = self.pool.pos[slot]
            pos[slot] = p0
            p = props.get(slot, [])[:d]
            toks[slot, 1:1 + len(p)] = p
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
        logits = self.model.decode_paged_fused(
            torch.from_numpy(toks).to(dev), self.pool.caches,
            self.pool.tables_device(), torch.from_numpy(pos).to(dev),
            torch.from_numpy(wblk).to(dev), torch.from_numpy(woff).to(dev))
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
            self._prefilling.pop(req.slot, None)
            self._slot_req[req.slot] = None
            self.pool.free(req.slot)
            req.slot = None
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
        and verify ticks, prefill chunks, proposed and accepted tokens,
        prefix hits and copy-on-write forks; and the paged-attention
        kernel's process-wide launch count (per tick one per layer, tp
        per layer on a tp pool, on a CUDA engine)."""
        return {"decode_ticks": self.decode_ticks,
                "verify_ticks": self.verify_ticks,
                "prefill_chunks": self.prefill_chunks,
                "spec_proposed": self.spec_proposed,
                "spec_accepted": self.spec_accepted,
                "prefix_hits": self.prefix_hits,
                "cow_copies": self.cow_copies,
                "paged_attention_launches": _pa.launches}
