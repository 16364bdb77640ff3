"""Cross-iteration communication/compute overlap — the port of
``byteps_tpu/training/overlap.py``, the ByteScheduler analog.

The reference's ByteScheduler (bytescheduler/torch/optimizer.py) removes
the barrier between iterations, so iteration N+1's forward runs while
iteration N's buckets are still reducing.  The JAX package renders it as
program structure: ``make_delayed_grad_step`` builds a step whose
collectives consume the **previous** iteration's local gradients,
carried in the state, so nothing in the reduce depends on this step's
batch.  The exact staleness, at step N:

    g_N        = grad(loss)(params_N, batch_N)
    r_{N-1}    = push_pull(pending = g_{N-1})   (averaged; at one worker
                                                 unreduced, as in JAX)
    params_N+1 = optimizer step of params_N with r_{N-1}
    pending'   = g_N

The first step reduces the zero ``pending`` of ``init_state``, and
``flush(state)`` applies the last pending gradients after the loop (the
analog of ByteScheduler's final synchronize, optimizer.py:75-97).

The torch rendering runs the overlap eagerly: pending's buckets are
enqueued on the eager engine (engine/dispatcher.py) **before** step N's
forward, so they reduce while forward and backward run; the step waits
for them, hands them to the optimizer as ``p.grad``, and keeps this
step's ``p.grad`` as the new pending (the gradients are set to None
before each backward, so backward N+1 writes fresh tensors while
pending reduces).  With ``BYTEPS_TRACE_PATH`` set, each step's forward
and backward is an ``overlap`` span on the trace (closed once the device
has finished the backward), beside the engine's ``push_pull`` spans.

Compression: the JAX step honours a Compressor class's ``wire_dtype``
(the fp16 / bf16 casts) and silently drops every other spec, strings
included (``getattr(compression, "wire_dtype", None)``,
``byteps_tpu/training/overlap.py:77``).  The port takes the casts and
refuses the rest: a spec is refused, never ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from .. import api
from ..common.config import get_config
from ..common.tracing import get_tracer
from ..ops.compression import Compression, Compressor
from .optimizer import BucketReducer
from .step import TrainState, create_train_state

__all__ = ["OverlapState", "DelayedStep", "make_delayed_grad_step"]


@dataclasses.dataclass
class OverlapState(TrainState):
    """A ``TrainState`` plus ``pending``: the previous iteration's local
    (unreduced) gradients, one tensor a parameter."""

    pending: Optional[List[torch.Tensor]] = None

    def state_dict(self) -> dict:
        return {**super().state_dict(), "pending": list(self.pending)}

    def load_state_dict(self, sd: dict) -> None:
        super().load_state_dict(sd)
        for p, s in zip(self.pending, sd["pending"]):
            p.copy_(s)


def _wire_dtype(compression):
    """The cast a compression spec puts on the wire, or None; what the
    JAX step would silently drop is refused."""
    if compression is None or compression is Compression.none \
            or compression == "none":
        return None
    if isinstance(compression, type) and issubclass(compression, Compressor) \
            and compression.wire_dtype is not None:
        return compression.wire_dtype
    raise ValueError(
        f"overlap=True takes a cast Compressor class (Compression.bf16, "
        f"Compression.fp16) or none, not compression={compression!r}: the "
        f"JAX delayed-gradient step applies only a class's wire dtype and "
        f"drops every other spec without a word (scheme names included), "
        f"so the port refuses them")


class DelayedStep:
    """Callable delayed-gradient step; ``flush`` applies the final pending
    gradients (ByteScheduler's end-of-training synchronize)."""

    def __init__(self, fn: Callable, flush_fn: Callable,
                 optimizer: torch.optim.Optimizer):
        self._fn = fn
        self._flush = flush_fn
        self.optimizer = optimizer

    def __call__(self, state: OverlapState, batch):
        return self._fn(state, batch)

    def flush(self, state: OverlapState) -> OverlapState:
        return self._flush(state)

    def init_state(self, model: nn.Module, model_state=None) -> OverlapState:
        st = create_train_state(model, self.optimizer, model_state)
        return OverlapState(st.model, st.optimizer, st.model_state, 0,
                            [torch.zeros_like(p)
                             for g in self.optimizer.param_groups
                             for p in g["params"] if p.requires_grad])


_instances = [0]


def make_delayed_grad_step(loss_fn: Callable,
                           optimizer: torch.optim.Optimizer,
                           world_size: Optional[int] = None,
                           compression: Any = None,
                           partition_bytes: Optional[int] = None
                           ) -> DelayedStep:
    """The delayed-gradient data-parallel step over ``api.size()``
    workers: ``step(state, batch) -> (state, {"loss": loss})`` with
    ``make_data_parallel_step``'s conventions (``loss_fn(model,
    model_state, batch) -> (loss, new_model_state)`` on this worker's
    batch; the loss and floating model state averaged across workers),
    but each update applies the previous step's averaged gradients (the
    module docstring).  ``compression`` is ``None`` or a cast Compressor
    class; ``partition_bytes`` (default ``BYTEPS_PARTITION_BYTES``)
    sizes the buckets."""
    world = api.size()
    if world_size is not None and world_size != world:
        raise ValueError(f"world size {world_size} but api.size() is "
                         f"{world}: the workers are the processes of "
                         f"api.init()")
    wire = _wire_dtype(compression)
    params = [p for g in optimizer.param_groups for p in g["params"]
              if p.requires_grad]
    reducer = None
    if world > 1:
        _instances[0] += 1
        reducer = BucketReducer(
            [f"param_{i}" for i in range(len(params))], params,
            partition_bytes or get_config().effective_partition_bytes,
            True, wire, f"DelayedStep{_instances[0]}")
    group = api.mesh().group(None)

    def mean(t: torch.Tensor) -> torch.Tensor:
        t = t.detach().clone()
        dist.all_reduce(t, group=group)
        return t / world

    def update(state: OverlapState) -> None:
        """Wait for pending's reduce and step the optimizer with it."""
        if reducer is not None:
            reducer.synchronize(state.pending)
        for p, r in zip(params, state.pending):
            p.grad = r
        state.optimizer.step()

    def step(state: OverlapState, batch):
        if reducer is not None:   # before the forward: overlaps it
            reducer.enqueue_all(state.pending.__getitem__)
        state.optimizer.zero_grad(set_to_none=True)
        tracer = get_tracer()
        with tracer.span("forward_backward", "overlap", step=state.step):
            loss, new_mstate = loss_fn(state.model, state.model_state, batch)
            loss.backward()
            if tracer.enabled and loss.is_cuda:
                torch.cuda.synchronize(loss.device)   # the span's end
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        update(state)
        loss = loss.detach()
        if world > 1:
            loss = mean(loss)
            new_mstate = {k: mean(v) if torch.is_tensor(v)
                          and v.is_floating_point() else v
                          for k, v in new_mstate.items()}
        return (OverlapState(state.model, state.optimizer, new_mstate,
                             state.step + 1, grads), {"loss": loss})

    def flush(state: OverlapState) -> OverlapState:
        if reducer is not None:
            reducer.enqueue_all(state.pending.__getitem__)
        update(state)
        state.optimizer.zero_grad(set_to_none=True)
        return OverlapState(state.model, state.optimizer, state.model_state,
                            state.step, [torch.zeros_like(p)
                                         for p in params])

    return DelayedStep(step, flush, optimizer)
