"""Training callbacks and schedules — the port of
``byteps_tpu/training/callbacks.py``, the Keras-callback surface of the
reference (_keras/callbacks.py:21-171) for a torch training loop:

  * ``BroadcastGlobalVariablesCallback`` -> ``broadcast_parameters`` and
    ``broadcast_optimizer_state`` at the first step (consistent init /
    checkpoint resume);
  * ``MetricAverageCallback``            -> ``average_metrics`` (metric
    values averaged across workers);
  * ``LearningRateScheduleCallback`` and ``LearningRateWarmupCallback``
    -> ``warmup_schedule`` / ``multiplier_schedule`` / ``scaled_lr``,
    plain functions from step to learning rate, and
    ``MomentumCorrectedSGD`` (the JAX package's ``momentum_corrected_sgd``
    as a ``torch.optim.Optimizer``), the reference's momentum correction
    when the rate changes mid-run (_keras/callbacks.py:116-171).

A schedule goes to ``torch.optim.lr_scheduler.LambdaLR``, which scales
each group's initial ``lr`` by it: build the optimizer with ``lr=1.0``::

    opt = torch.optim.SGD(model.parameters(), lr=1.0, momentum=0.9)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, warmup_schedule(0.1, api.size(), 500))
    # ... opt.step(); sched.step() each step

The schedules compute in float32 as the JAX ones do (their ``jnp``
arithmetic), so they give the JAX package's values bit for bit.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from .. import api

__all__ = ["scaled_lr", "warmup_schedule", "multiplier_schedule",
           "MomentumCorrectedSGD", "average_metrics",
           "BroadcastGlobalVariablesCallback"]

Schedule = Callable[[int], float]


def scaled_lr(base_lr: float, world_size: int) -> float:
    """Linear LR scaling with worker count (reference docstring advice in
    _keras/callbacks.py:84-96)."""
    return base_lr * world_size


def warmup_schedule(base_lr: float, world_size: int, warmup_steps: int,
                    after: Optional[Schedule] = None) -> Schedule:
    """LR warmup from ``base_lr`` to ``base_lr * world_size`` over
    ``warmup_steps`` (reference LearningRateWarmupCallback semantics:
    gradual ramp to the scaled rate), then hand off to ``after`` (default:
    constant scaled rate), which is called with the steps since."""
    peak = scaled_lr(base_lr, world_size)
    rise = np.float32(peak - base_lr)

    def schedule(step) -> float:
        s = np.float32(step)
        frac = np.clip(s / np.float32(max(warmup_steps, 1)),
                       np.float32(0.0), np.float32(1.0))
        warm = np.float32(base_lr) + rise * frac
        if after is None or s < warmup_steps:
            return float(warm)
        return float(after(float(s - np.float32(warmup_steps))))

    return schedule


def multiplier_schedule(base_lr: float,
                        multipliers: Dict[int, float]) -> Schedule:
    """Staircase schedule from {start_step: multiplier} — the reference's
    ``LearningRateScheduleCallback`` with ``staircase=True``
    (_keras/callbacks.py:98-140)."""
    boundaries = sorted(multipliers)

    def schedule(step) -> float:
        mult = np.float32(1.0)
        for b in boundaries:
            if int(step) >= b:
                mult = np.float32(multipliers[b])
        return float(np.float32(base_lr) * mult)

    return schedule


class MomentumCorrectedSGD(torch.optim.Optimizer):
    """SGD whose momentum buffer is rescaled when the LR changes — the
    reference's ``momentum_correction`` (_keras/callbacks.py:143-171): on
    an LR change from lr0 to lr1 the velocity is multiplied by lr1/lr0 so
    the effective update magnitude tracks the new rate immediately.

    Each step: ``lr = schedule(step)``; ``trace = trace * momentum *
    (lr / prev_lr) + g``; ``p -= lr * trace``, in the JAX
    transformation's float32 order.  A parameter without a gradient
    counts as a zero gradient (its velocity still carries it), as every
    leaf of an optax update does.  The step and the previous rate ride
    each param group, so ``state_dict()`` carries them."""

    def __init__(self, params, schedule: Schedule, momentum: float = 0.9):
        super().__init__(params, {"momentum": momentum})
        self.schedule = schedule
        for group in self.param_groups:
            group.setdefault("step", 0)
            group.setdefault("prev_lr", float(np.float32(schedule(0))))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr = np.float32(self.schedule(group["step"]))
            correction = lr / max(np.float32(group["prev_lr"]),
                                  np.float32(1e-30))
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                st = self.state[p]
                if "trace" not in st:
                    st["trace"] = torch.zeros_like(p)
                trace = st["trace"]
                trace.mul_(group["momentum"]).mul_(float(correction)).add_(g)
                p.add_(trace * float(-lr))
            group["step"] += 1
            group["prev_lr"] = float(lr)
        return loss


def average_metrics(
        metrics: Dict[str, Union[float, torch.Tensor]]) -> Dict[str, float]:
    """Average scalar metrics across workers — the reference's
    ``MetricAverageCallback`` (_keras/callbacks.py:36-70).  Each worker
    computed its metrics from its own data shard; they are summed in
    float32 across the workers and divided by the world, as the JAX
    package sums its processes' metrics.  With one worker the identity
    (as float32 values)."""
    world = api.size() if api._state.initialized else 1
    keys = sorted(metrics)
    local = torch.tensor([float(metrics[k]) for k in keys],
                         dtype=torch.float32)
    if world == 1:
        return {k: float(v) for k, v in zip(keys, local)}
    local = local.to(api.device())
    dist.all_reduce(local, group=api.mesh().group(None))
    return {k: float(v) / world for k, v in zip(keys, local.tolist())}


class BroadcastGlobalVariablesCallback:
    """Callable hook: at the first step, broadcast the parameters, the
    optimizer state and floating model state from the root so every
    worker holds the same (reference keras/callbacks.py:28-31 — also the
    checkpoint-resume path).  Returns the state, updated in place."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank
        self._done = False

    def __call__(self, state):
        if self._done:
            return state
        self._done = True
        api.broadcast_parameters(state.model, root_rank=self.root_rank)
        api.broadcast_optimizer_state(state.optimizer,
                                      root_rank=self.root_rank)
        tensors = {k: v for k, v in state.model_state.items()
                   if torch.is_tensor(v)}
        if tensors:
            api.broadcast_parameters(tensors, root_rank=self.root_rank)
        return state
