"""The eager push_pull engine — the port of
``byteps_tpu/engine/dispatcher.py``.

Counterpart of the reference's background machinery (SURVEY.md §1): the
``Run*LoopOnce`` threads draining ``BytePSScheduledQueue``s
(core_loops.cc).  One dispatcher thread grants tasks and launches their
collectives (``async_op=True``: a launch returns at once), one completion
thread waits on them.  What survives from the reference design:

  * tensors are partitioned into <= ``BYTEPS_PARTITION_BYTES`` chunks,
    each an independently scheduled :class:`TensorTaskEntry`
    (operations.cc:95-132);
  * the dispatcher grants tasks in (priority desc, key asc) order under a
    byte-credit budget (scheduled_queue.cc:78-136), so
    ``BYTEPS_SCHEDULING_CREDIT`` bounds the bytes in flight;
  * a granted partition is one ``all_reduce`` on the engine's own process
    group; the completion thread waits on its work handle, averages,
    returns the credit and, through the :class:`ReadyTable`, finishes
    the tensor when its last partition lands (FinishOrProceed,
    core_loops.cc:27-82).

**Issue order across ranks.**  NCCL and gloo match collectives by the
order each rank issues them, and ranks enqueue when their own backward
gets there, in their own order.  The JAX engine schedules inside one
process and never meets this; the port agrees on an order first, as the
reference's coordinate stages (``QueueType.COORDINATE_*``) and Horovod's
coordinator do.  Every dispatcher cycle, each rank all-gathers (on a
gloo control group) its queued partitions — identified by tensor name
and partition index — its free credits and whether it is shutting down.
Every rank then computes the same grant list from the same gathered
data: the partitions queued on *all* ranks, in rank 0's (priority desc,
key asc) order, within the smallest rank's credits.  Each rank launches
exactly that list, so two ranks that enqueue the same tensors in
different orders or at different times still issue identical sequences.
A rank with nothing grantable waits at most ``CYCLE_S`` before it joins
the next gather, so the gathers pace themselves to the slowest rank.
With one worker the gather is skipped: its own offer is the whole list,
and the same grant and launch code runs.
"""

from __future__ import annotations

import collections
import queue as queue_mod
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..common import logging as bps_log
from ..common.config import get_config
from ..common.context import TensorRegistry, partition_key
from ..common.partition import partition_offsets
from ..common.ready_table import ReadyTable
from ..common.scheduler import ScheduledQueue
from ..common.tracing import get_tracer
from ..common.types import QueueType, Status, TensorTaskEntry
from .handles import HandleManager

__all__ = ["Engine", "get_engine", "start_engine", "stop_engine"]

CYCLE_S = 0.005  # a rank's longest wait before the next agreement cycle


class _PushPullRequest:
    """One user-level push_pull spanning >= 1 partitions: the flat work
    buffer the partitions reduce in place, and how to hand it back."""

    def __init__(self, handle: int, name: str, buf: torch.Tensor,
                 target: Optional[torch.Tensor], shape, dtype):
        self.handle = handle
        self.name = name
        self.buf = buf
        self.target = target      # the caller's tensor, for inplace=True
        self.shape = shape
        self.dtype = dtype
        self.lock = threading.Lock()
        self.failed = False

    def mark_failed(self) -> bool:
        """Record the first failure; True for exactly one caller."""
        with self.lock:
            if self.failed:
                return False
            self.failed = True
            return True

    def result(self) -> torch.Tensor:
        if self.target is None:
            return self.buf.view(self.shape).to(self.dtype)
        if self.buf.data_ptr() != self.target.data_ptr():
            self.target.copy_(self.buf.view(self.shape))
        return self.target


def agree(offers: List[tuple]) -> List[tuple]:
    """The grant list every rank computes from the gathered offers.

    ``offers[r]`` is rank r's ``(stopping, credits, tasks)`` with
    ``tasks`` its queued ``(ident, priority, key, length)`` in grant
    order.  A partition is granted once it is queued on every rank (an
    ident queued twice on every rank may be granted twice), in rank 0's
    order, skipping one whose length exceeds the credits left — the
    ScheduledQueue rule applied to the smallest rank's credits."""
    common = None
    for _, _, tasks in offers:
        c = collections.Counter(t[0] for t in tasks)
        common = c if common is None else common & c
    lengths: Dict[tuple, int] = {}
    for _, _, tasks in offers:
        for ident, _, _, length in tasks:
            lengths[ident] = max(lengths.get(ident, 0), length)
    credits = min(o[1] for o in offers)
    out = []
    for ident, _, _, _ in offers[0][2]:
        if common[ident] <= 0 or lengths[ident] > credits:
            continue
        credits -= lengths[ident]
        common[ident] -= 1
        out.append(ident)
    return out


class Engine:
    """One per process: the registry, the scheduled queue, the dispatcher
    and completion threads.  ``group`` is the engine's own process group
    (the data collectives); ``control_group`` a gloo group over the same
    ranks for the order agreement (needed when the world has more than
    one rank)."""

    def __init__(self, group=None, control_group=None, device=None):
        cfg = get_config()
        self.group = group
        self.control_group = control_group
        self.world = dist.get_world_size(group)
        if self.world > 1 and control_group is None:
            raise ValueError("a world of more than one rank needs a "
                             "control group for the issue order")
        self.device = torch.device(device) if device is not None else None
        self.registry = TensorRegistry()
        self.handles = HandleManager()
        self.queue = ScheduledQueue(scheduled=True,
                                    credit_bytes=cfg.effective_credit,
                                    name="push_pull")
        self.ready = ReadyTable(name="push_pull_parts")
        # what the dispatcher did: agreement gathers and the ms spent in
        # them (the wait for the slowest rank included), collectives
        # launched, and the last grants in order (name, key, priority)
        self.counts = {"cycles": 0, "collectives": 0, "gather_ms": 0.0}
        self.grants: collections.deque = collections.deque(maxlen=1 << 16)
        self._completion_q: "queue_mod.Queue" = queue_mod.Queue()
        self._stop = threading.Event()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="bps-dispatcher", daemon=True)
        self._completer = threading.Thread(
            target=self._completion_loop, name="bps-completer", daemon=True)
        self._dispatcher.start()
        self._completer.start()

    # ------------------------------------------------------------------ API

    def declare(self, name: str) -> int:
        return self.registry.declare(name).declared_key

    def push_pull_async(self, tensor: torch.Tensor, name: str,
                        average: bool = True, priority: int = 0,
                        version: int = 0,
                        wire_dtype: Optional[torch.dtype] = None,
                        inplace: bool = False) -> int:
        """Enqueue the allreduce of this worker's ``tensor`` across the
        engine's group; returns a handle for poll/synchronize.

        The result is a new tensor, or with ``inplace=True`` the caller's
        ``tensor`` itself (contiguous), written when the handle completes.
        ``wire_dtype`` (default ``BYTEPS_WIRE_DTYPE``) casts the payload
        for the collective and the average, as the JAX engine does; with
        one worker there is no wire and the cast is skipped, as there.
        ``priority`` 0 means ``-declared_key`` (reference
        tensorflow/ops.cc:158)."""
        cfg = get_config()
        ctx = self.registry.declare(name)
        if priority == 0:
            priority = -ctx.declared_key
        if wire_dtype is None:
            wire_dtype = cfg.wire_torch_dtype
        if self.world == 1 or wire_dtype == tensor.dtype:
            wire_dtype = None
        if inplace and not tensor.is_contiguous():
            raise ValueError("inplace push_pull needs a contiguous tensor")
        flat = tensor.reshape(-1)
        if wire_dtype is not None:
            buf = flat.to(wire_dtype)
        else:
            buf = flat if inplace else flat.clone()
        itemsize = flat.element_size()
        parts = partition_offsets(flat.numel() * itemsize,
                                  cfg.effective_partition_bytes)
        handle = self.handles.allocate()
        req = _PushPullRequest(handle, name, buf,
                               tensor if inplace else None, tensor.shape,
                               tensor.dtype)
        self.ready.set_expected(handle, len(parts))
        counter = [len(parts)]
        for i, (off_b, len_b) in enumerate(parts):
            off_e, len_e = off_b // itemsize, len_b // itemsize
            task = TensorTaskEntry(
                name=f"{name}_{i}" if len(parts) > 1 else name,
                key=partition_key(ctx.declared_key, i),
                priority=priority, version=version, offset=off_b,
                length=max(1, len_b), total_partitions=len(parts),
                partition_index=i,
                queue_list=[QueueType.REDUCE, QueueType.PUSH,
                            QueueType.PULL, QueueType.BROADCAST],
                payload=buf[off_e:off_e + len_e], counter_ref=counter)
            task.request = req  # type: ignore[attr-defined]
            task.ident = (name, i)  # type: ignore[attr-defined]
            task.average = average  # type: ignore[attr-defined]
            self.queue.add_task(task)
        return handle

    def poll(self, handle: int) -> bool:
        return self.handles.poll(handle)

    def synchronize(self, handle: int, timeout: Optional[float] = 600.0):
        return self.handles.wait_and_clear(handle, timeout)

    def shutdown(self, timeout: float = 60.0) -> None:
        """Stop both threads.  With more than one rank the dispatcher
        leaves only at a cycle where every rank is stopping (a rank that
        left early would strand the others in the gather), so this
        returns once the other ranks call it too, or after ``timeout``.
        Tasks still queued then fail their handles."""
        self._stop.set()
        self.queue.close()
        self._dispatcher.join(timeout)
        if self._dispatcher.is_alive():
            bps_log.warning("push_pull engine: the dispatcher did not stop "
                            "within %.0fs (another rank never shut down)",
                            timeout)
        self._completion_q.put(None)
        self._completer.join(timeout)

    # -------------------------------------------------------------- threads

    def _dispatch_loop(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        tracer = get_tracer()
        try:
            self._agreed_loop(tracer)
        except Exception as e:  # the loop is the boundary: report, fail
            bps_log.error("push_pull dispatcher stopped: %r", e)
        for task in self.queue.drain():
            self._fail(task, Status.Aborted(
                f"engine shut down before {task.name} was granted"))

    def _agreed_loop(self, tracer) -> None:
        """Every cycle: gather the offers, launch the agreed list (module
        docstring, "Issue order across ranks")."""
        while True:
            self.queue.wait_grantable(CYCLE_S)
            mine = self.queue.tasks()
            offer = (self._stop.is_set(), self.queue.credits,
                     [(t.ident, t.priority, t.key, t.length) for t in mine])
            offers: List[tuple] = [offer]
            if self.world > 1:
                offers = [None] * self.world
                t0 = time.perf_counter()
                dist.all_gather_object(offers, offer,
                                       group=self.control_group)
                self.counts["cycles"] += 1
                self.counts["gather_ms"] += (time.perf_counter() - t0) * 1e3
            by_ident: Dict[tuple, List[TensorTaskEntry]] = {}
            for t in mine:
                by_ident.setdefault(t.ident, []).append(t)
            for ident in agree(offers):
                task = by_ident[ident].pop(0)
                if self.queue.get_task(key=task.key) is not task:
                    raise RuntimeError(f"agreed task {task.name} could not "
                                       f"be granted locally")
                self._launch(task, tracer)
            if all(o[0] for o in offers):
                return

    def _launch(self, task: TensorTaskEntry, tracer) -> None:
        try:
            with tracer.span(task.name, "dispatch", key=task.key,
                             bytes=task.length):
                work = dist.all_reduce(task.payload, group=self.group,
                                       async_op=True)
        except Exception as e:
            bps_log.error("dispatch failed for %s: %s", task.name, e)
            self.queue.report_finish(task)
            self._fail(task, Status.UnknownError(str(e)))
            return
        self.counts["collectives"] += 1
        self.grants.append((task.name, task.key, task.priority))
        self._completion_q.put((task, work))

    def _fail(self, task: TensorTaskEntry, status: Status) -> None:
        req: _PushPullRequest = task.request  # type: ignore[attr-defined]
        if req.mark_failed():
            self.handles.mark_done(req.handle, status)
        # the failed partition still counts toward the barrier, so the key
        # is cleared exactly when the last sibling lands
        if self.ready.add_and_check(req.handle):
            self.ready.clear_key(req.handle)

    def _completion_loop(self) -> None:
        """Wait on launched collectives, average, return credits, finish
        tensors (FinishOrProceed, core_loops.cc:27-82)."""
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        tracer = get_tracer()
        while True:
            item = self._completion_q.get()
            if item is None:
                return
            task, work = item
            req: _PushPullRequest = task.request  # type: ignore[attr-defined]
            try:
                with tracer.span(task.name, "push_pull", key=task.key,
                                 bytes=task.length):
                    work.wait()
                    part = task.payload
                    if task.average and part.is_floating_point():
                        part.div_(self.world)
                    elif task.average:
                        part.copy_(torch.div(part, self.world,
                                             rounding_mode="trunc"))
                    if part.is_cuda:
                        torch.cuda.current_stream(part.device).synchronize()
                status = Status.OK()
            except Exception as e:
                status = Status.UnknownError(str(e))
            self.queue.report_finish(task)
            sample = get_config().debug_sample_tensor
            if sample and sample in task.name and status.ok():
                # reference BYTEPS_DEBUG_SAMPLE_TENSOR (core_loops.cc:33-63)
                flat = task.payload.reshape(-1)
                bps_log.info("sample %s key=%d first=%s last=%s", task.name,
                             task.key, flat[0].item(), flat[-1].item())
            if not status.ok() and req.mark_failed():
                self.handles.mark_done(req.handle, status)
            if not self.ready.add_and_check(req.handle):
                continue
            self.ready.clear_key(req.handle)
            with req.lock:
                if req.failed:
                    continue  # marked by the first failure
            try:
                out = req.result()
            except Exception as e:
                self.handles.mark_done(req.handle,
                                       Status.UnknownError(str(e)))
                continue
            self.handles.mark_done(req.handle, Status.OK(), out)


_engine: Optional[Engine] = None
_engine_lock = threading.Lock()


def get_engine() -> Optional[Engine]:
    return _engine


def start_engine(group=None, control_group=None, device=None) -> Engine:
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = Engine(group, control_group, device)
        return _engine


def stop_engine() -> None:
    global _engine
    with _engine_lock:
        if _engine is not None:
            _engine.shutdown()
            _engine = None
