"""High-level training loop — the port of ``byteps_tpu/training/
trainer.py``: owns the step function, the broadcast-at-start and the
train loop, so user code is model + data.  Each worker (process) runs
one ``Trainer`` over its own share of the batches; rank 0's parameters
are broadcast at start, the gradients are averaged across the workers
every step (``make_data_parallel_step``) and the logged loss is the mean
over the workers.

Example::

    trainer = Trainer(lm_loss_fn(model),
                      torch.optim.AdamW(model.parameters(), lr=1e-4,
                                        weight_decay=1e-4))
    state = trainer.fit(model, {}, batches, steps=1000)

``evaluate(eval_fn, batches)`` averages metrics over batches and
workers without gradients.  ``checkpoint_dir`` keeps rolling checkpoints
(``checkpoint_every`` steps, the last ``checkpoint_keep``;
training/checkpoint.py) and ``init_state`` resumes from the newest, as
the JAX ``Trainer`` does; ``callbacks`` run after each step and may
return a replacement state; ``overlap=True`` trains with the
delayed-gradient step (training/overlap.py), flushed at the end of each
``fit``.  ``device`` defaults to ``cuda`` (no GPU: pass
``device="cpu"``); the model's parameters must already be there, and
batches are moved there.  To share one card between workers, call
``api.init(device, backend="gloo")`` before building the Trainer.

Async-PS mode (``async_mode=True`` or ``BYTEPS_ENABLE_ASYNC=1``; the
reference's torch/__init__.py:174-189): each worker steps on its own
batches, and every ``async_interval`` steps exchanges weight deltas with
the parameter-server tier (``async_store``, default the process store of
``engine/async_ps.get_async_store``).  The exchange is pipelined: the
train thread hands the exchange thread clones of the parameters and
keeps stepping; at the next interval it adopts the finished exchange
with the catch-up rule ``params += pulled - submitted`` (the term is
already on the device, copied there by the exchange thread), and the
last exchange is drained at the end of ``fit``.  The train thread waits
on the host only in ``take_delta``.  ``close()`` stops the exchange
thread.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from .. import api
from ..common import logging as bps_log
from ..common.config import get_config
from .checkpoint import CheckpointManager
from .step import TrainState, make_data_parallel_step

__all__ = ["Trainer"]

# eval steps in flight before a host read (the JAX trainer's window)
_INFLIGHT_WINDOW = 4


class Trainer:
    def __init__(self, loss_fn: Callable,
                 optimizer: torch.optim.Optimizer, compression=None,
                 backward_passes_per_step: int = 1,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1000, checkpoint_keep: int = 3,
                 log_every: int = 100, callbacks: Sequence[Callable] = (),
                 async_mode: Optional[bool] = None, async_store=None,
                 async_interval: int = 1, worker_id: Optional[int] = None,
                 overlap: bool = False, device=None):
        api.init(device)
        self.device = api.device()
        # ByteScheduler mode: cross-iteration overlap through the
        # delayed-gradient step; fit() flushes the final pending gradients
        self.overlap = bool(overlap)
        # async-PS mode: explicit argument beats BYTEPS_ENABLE_ASYNC
        self.async_mode = bool(get_config().enable_async
                               if async_mode is None else async_mode)
        if self.overlap:
            if self.async_mode:
                raise ValueError("overlap=True is a synchronous schedule; "
                                 "it cannot combine with async_mode")
            if backward_passes_per_step != 1:
                raise ValueError("overlap=True does not compose with "
                                 "backward_passes_per_step > 1")
            from .overlap import make_delayed_grad_step

            self.step_fn = make_delayed_grad_step(
                loss_fn, optimizer, compression=compression)
        else:
            self.step_fn = make_data_parallel_step(
                loss_fn, optimizer, compression=compression,
                backward_passes_per_step=backward_passes_per_step)
        self.ckpt = (CheckpointManager(checkpoint_dir, checkpoint_every,
                                       checkpoint_keep)
                     if checkpoint_dir else None)
        self.log_every = log_every
        self.callbacks = list(callbacks)
        self.state: Optional[TrainState] = None
        self.metrics: dict = {}  # the last step's {"loss": tensor}
        self.async_interval = max(1, int(async_interval))
        self.worker_id = (get_config().worker_id if worker_id is None
                          else worker_id)
        self._async_worker = None
        self.async_store = None
        if self.async_mode:
            from ..engine.async_ps import get_async_store

            self.async_store = (async_store if async_store is not None
                                else get_async_store())

    def init_state(self, model: nn.Module, model_state=None,
                   root_rank: int = 0, resume: bool = True) -> TrainState:
        """Broadcast-consistent init: ``root_rank``'s parameters (and
        model state) on every worker, in place — or, with a checkpoint
        directory holding a checkpoint and ``resume``, the newest
        checkpoint's state (model, optimizer, model state, step and any
        error-feedback residuals or pending gradients), loaded on rank 0
        and broadcast."""
        wrong = {p.device for p in model.parameters()
                 if p.device != self.device}
        if wrong:
            raise ValueError(f"model parameters on {wrong}, trainer on "
                             f"{self.device}: move the model first")
        state = None
        if self.ckpt is not None and resume:
            state = self.step_fn.init_state(model, model_state)
            restored, step = self.ckpt.restore_latest(template=state)
            if restored is not None:
                bps_log.info("resuming from checkpoint step %d", step)
            state = restored
        if state is None:
            model = api.broadcast_parameters(model, root_rank)
            if model_state:
                model_state = api.broadcast_parameters(model_state,
                                                       root_rank)
            state = self.step_fn.init_state(model, model_state)
        if self.async_mode and self._async_worker is None:
            from ..engine.async_ps import AsyncWorker

            # registers every parameter: the first-push-wins initial push
            # (reference InitTensor, operations.cc:262-284)
            self._async_worker = AsyncWorker(self.async_store, state.model,
                                             worker_id=self.worker_id)
        return state

    def fit(self, model: nn.Module, model_state, batches: Iterable,
            steps: Optional[int] = None) -> TrainState:
        """Run the step over ``batches`` (dicts of arrays or tensors), at
        most ``steps`` of them; a later call continues from the state.
        After each step the state is checkpointed when due, then the
        callbacks run; with ``overlap`` the last pending gradients are
        applied at the end."""
        state = self.state or self.init_state(model, model_state)
        state.model.train()
        t0 = time.time()
        seen = 0
        for i, batch in enumerate(batches):
            if steps is not None and i >= steps:
                break
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in batch.items()}
            state, self.metrics = self.step_fn(state, batch)
            seen += 1
            if self.ckpt is not None:
                self.ckpt.maybe_save(state, state.step)
            for cb in self.callbacks:
                maybe = cb(state)
                if maybe is not None:
                    state = maybe
            if self._async_worker is not None and \
                    seen % self.async_interval == 0:
                # adopt the previous interval's exchange, then submit this
                # one on clones the next steps do not write
                state = self._adopt_exchange(state)
                with torch.no_grad():
                    self._async_worker.begin_push_pull(
                        [p.detach().clone()
                         for p in state.model.parameters()])
            if self.log_every and seen % self.log_every == 0:
                bps_log.info("step %d loss %.4f (%.2f steps/s)", state.step,
                             float(self.metrics["loss"]),
                             seen / max(time.time() - t0, 1e-9))
        if self._async_worker is not None:
            # drain the last exchange, so the state reflects the store
            state = self._adopt_exchange(state)
        if self.overlap:
            state = self.step_fn.flush(state)
        self.state = state
        return state

    def close(self) -> None:
        """Stop the async-PS exchange thread (it pins a host snapshot of
        the parameters).  Idempotent."""
        if self._async_worker is not None:
            self._async_worker.close()
            self._async_worker = None

    def _adopt_exchange(self, state: TrainState) -> TrainState:
        """Fold a finished exchange into the current parameters, in
        place: ``params += pulled - submitted`` (the catch-up rule of
        ``AsyncWorker.take_result``).  No-op when none is in flight."""
        if not self._async_worker.exchange_in_flight():
            return state
        deltas = self._async_worker.take_delta()
        with torch.no_grad():
            for p, d in zip(state.model.parameters(), deltas):
                if not isinstance(d, torch.Tensor):
                    d = torch.from_numpy(d)
                p.add_(d.to(p.device, p.dtype))
        return state

    def evaluate(self, eval_fn: Callable,
                 batches: Iterable) -> Dict[str, float]:
        """Average ``eval_fn(state, batch) -> {metric: scalar}`` over
        ``batches`` (moved to the trainer's device), under
        ``torch.no_grad()`` with the model in eval mode; with one worker
        the average across workers is the identity.  Host reads lag
        :data:`_INFLIGHT_WINDOW` batches behind, so the device is not
        synchronized batch by batch (the JAX ``Trainer.evaluate``).
        Needs a state: call :meth:`fit` first, or set ``self.state`` from
        :meth:`init_state`."""
        if self.state is None:
            raise ValueError("no train state: call fit() or set "
                             "trainer.state = trainer.init_state(model)")
        model = self.state.model
        was_training = model.training
        sums: Dict[str, float] = {}
        n = 0
        inflight: list = []

        def drain(out):
            nonlocal n
            for k, v in out.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1

        model.eval()
        try:
            with torch.no_grad():
                for batch in batches:
                    batch = {k: torch.as_tensor(v).to(self.device)
                             for k, v in batch.items()}
                    inflight.append(eval_fn(self.state, batch))
                    if len(inflight) > _INFLIGHT_WINDOW:
                        drain(inflight.pop(0))
                for out in inflight:
                    drain(out)
        finally:
            model.train(was_training)
        means = {k: v / max(n, 1) for k, v in sums.items()}
        if api.size() > 1 and means:
            keys = sorted(means)
            t = torch.tensor([means[k] for k in keys], dtype=torch.float64,
                             device=self.device)
            dist.all_reduce(t, group=api.mesh().group(None))
            means = dict(zip(keys, (t / api.size()).tolist()))
        return means
