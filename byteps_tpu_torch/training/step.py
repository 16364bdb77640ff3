"""Train-step factories — the port of ``byteps_tpu/training/step.py``.

``make_data_parallel_step(loss_fn, optimizer)`` returns a step that runs
the loss forward on this worker's batch, ``backward()`` and
``optimizer.step()``.  With more than one worker (or
``backward_passes_per_step > 1``) the optimizer is wrapped in the
:class:`~byteps_tpu_torch.training.optimizer.DistributedOptimizer`, so
the gradients are averaged across workers, bucketed, while backward
runs; the reported loss is the mean over the workers and floating
model state is averaged, as the JAX step's ``psum / n`` does.  With one
worker and one pass a step, the JAX factory's short-circuit
(``step.py:142-152``): no DistributedOptimizer, but a compression spec
still acts as it would on a wire (JAX ``step.py:52-95``) — a cast rounds
each gradient through its dtype, and a biased scheme named by string
runs error feedback on each gradient locally (the optimizer wrapped by
``with_error_feedback``) — so a compressed run at two workers and its
one-worker rerun see the same numerics.

Checkpoints do not move between world sizes (JAX ``step.py:134-136``):
the optimizer's ``state_dict()`` carries the error-feedback residuals,
and only rank 0's are saved (training/checkpoint.py), so a resume at
another world restarts the other ranks' carry from rank 0's.

PyTorch idiom where JAX was functional: parameters live in the module
and the optimizer (a ``torch.optim`` optimizer built by the caller over
the module's parameters) updates them in place, so ``TrainState`` holds
the module and the optimizer where the JAX state holds the parameter
and optimizer-state trees.  ``loss_fn(model, model_state, batch) ->
(loss, new_model_state)`` mirrors the JAX ``loss_fn(params,
model_state, batch)``.

Mind the optimizer defaults when matching a JAX run: ``optax.adamw``
decays weights by 1e-4 by default and ``torch.optim.AdamW`` by 1e-2;
pass the value explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .. import api
from ..ops.compression import Compression
from .optimizer import DistributedOptimizer, with_error_feedback

__all__ = ["TrainState", "TrainStep", "create_train_state",
           "make_data_parallel_step", "lm_loss_fn"]


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer (its state), mutable
    model collections, and the step counter.  ``state_dict()`` is what a
    checkpoint holds (tensors and plain containers only);
    ``load_state_dict()`` puts it back in place."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    model_state: Dict[str, Any]
    step: int = 0

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "model_state": dict(self.model_state), "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        dev = next(self.model.parameters()).device
        self.model_state = {k: v.to(dev) if torch.is_tensor(v) else v
                            for k, v in sd["model_state"].items()}
        self.step = int(sd["step"])


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       model_state=None) -> TrainState:
    """A state at step 0.  Every tensor the optimizer updates must be a
    parameter of ``model``."""
    own = {id(p) for p in model.parameters()}
    for group in optimizer.param_groups:
        for p in group["params"]:
            if id(p) not in own:
                raise ValueError("the optimizer updates a tensor that is "
                                 "not a parameter of the model")
    return TrainState(model, optimizer,
                      model_state if model_state is not None else {}, 0)


class TrainStep:
    """The step function plus the optimizer whose state it updates; use
    ``init_state`` to build a matching :class:`TrainState`."""

    def __init__(self, fn: Callable, optimizer: torch.optim.Optimizer):
        self._fn = fn
        self.optimizer = optimizer

    def __call__(self, state: TrainState, batch):
        return self._fn(state, batch)

    def init_state(self, model: nn.Module, model_state=None) -> TrainState:
        return create_train_state(model, self.optimizer, model_state)


def make_data_parallel_step(loss_fn: Callable,
                            optimizer: torch.optim.Optimizer,
                            world_size: Optional[int] = None,
                            compression: Any = None,
                            partition_bytes: Optional[int] = None,
                            backward_passes_per_step: int = 1) -> TrainStep:
    """A train step ``step(state, batch) -> (state, {"loss": loss})`` over
    ``api.size()`` workers (``world_size``, when given, must equal it).
    ``batch`` is this worker's share; the returned loss is the detached
    mean over the workers, and reading it synchronizes with the device.
    ``compression`` is a Compressor class or a registry scheme name (a
    cast, or a biased scheme run with error feedback);
    ``partition_bytes`` (default ``BYTEPS_PARTITION_BYTES``) sizes the
    gradient buckets."""
    world = api.size()
    if world_size is not None and world_size != world:
        raise ValueError(f"world size {world_size} but api.size() is "
                         f"{world}: the workers are the processes of "
                         f"api.init()")
    distributed = world > 1 or backward_passes_per_step > 1
    roundtrip = None
    if distributed:
        optimizer = DistributedOptimizer(
            optimizer, compression=compression,
            backward_passes_per_step=backward_passes_per_step,
            partition_bytes=partition_bytes)
    else:
        roundtrip, ef = _world1_compression(compression)
        if ef is not None:
            optimizer = with_error_feedback(optimizer, ef)
    group = api.mesh().group(None)

    def mean(t: torch.Tensor) -> torch.Tensor:
        t = t.detach().clone()
        dist.all_reduce(t, group=group)
        return t / world

    def step(state: TrainState, batch):
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss, new_mstate = loss_fn(state.model, state.model_state, batch)
        loss.backward()
        if roundtrip is not None:
            for p in state.model.parameters():
                if p.grad is not None:
                    p.grad = roundtrip.decompress(*roundtrip.compress(p.grad))
        opt.step()
        loss = loss.detach()
        if world > 1:
            loss = mean(loss)
            new_mstate = {k: mean(v) if torch.is_tensor(v)
                          and v.is_floating_point() else v
                          for k, v in new_mstate.items()}
        return (TrainState(state.model, opt, new_mstate, state.step + 1),
                {"loss": loss})

    return TrainStep(step, optimizer)


def make_zero_step(loss_fn, zero, model_state=None, reduce_grads=None):
    """The ZeRO step over the PS tier's span keys (JAX ``training/
    step.py:217`` with ``training/zero.py``) — not ported yet: it comes
    with ``zero.py`` (queue A item 10).  Refused by name."""
    raise NotImplementedError(
        "make_zero_step: the ZeRO step comes with the port of "
        "training/zero.py (queue A item 10); use make_data_parallel_step")


def _world1_compression(compression) -> tuple:
    """The one-worker rendering of a compression spec (JAX
    ``_world1_compression_tx``): ``(roundtrip, error_feedback)``.  A
    scheme name runs error feedback if the scheme is biased, else its
    cast; a Compressor class (a cast, or the stateless roundtrip of a
    registry class) is applied to each gradient as ``compress`` then
    ``decompress``; none gives ``(None, None)``."""
    if isinstance(compression, str):
        from ..compression import error_feedback_compress, get_scheme

        scheme = get_scheme(compression)
        if scheme.biased:
            return None, error_feedback_compress(scheme)
    comp = Compression.resolve(compression)
    return (None if comp is Compression.none else comp), None


def lm_loss_fn(model: nn.Module, fused_head: bool = False,
               block_n: Optional[int] = None, block_v: Optional[int] = None,
               early_exit: Optional[tuple] = None) -> Callable:
    """Next-token cross-entropy loss for a causal LM whose batch is
    ``{"tokens": [B, T]}`` (plus optional HF ``"labels"`` with ``-100``
    on ignored positions); fits :func:`make_data_parallel_step`.

    Targets are the tokens (or labels) rolled left by one with ``-100``
    at the wrap position; the loss is the mean over *valid* targets
    only (``0 <= t < vocab``), in both heads.

    * The plain head: fp32 logits from the model's head, then
      cross-entropy in fp32 — the JAX
      ``optax.softmax_cross_entropy_with_integer_labels`` branch.  The
      last position's logits, whose target is always ignored, are not
      computed (the JAX branch computes and drops them).
    * ``fused_head=True``: the JAX ``_fused_ce`` — ``hidden`` over all
      ``B*T`` rows and the head weight in the model dtype
      (``Transformer.head_weight``) go to ``fused_linear_cross_entropy``
      (``ops/fused_cross_entropy.py``, the fused LM-head kernels), so the ``[B, T, vocab]`` logits never
      exist; the wrap position rides the kernels' ignore-index rule.
      ``block_n``/``block_v`` pass through and do not change the result.

    ``early_exit=(layers, weight)`` adds the LayerSkip auxiliary loss
    ``weight * CE`` of the model's first ``layers`` blocks read out by
    its own final norm and head — the truncation
    :func:`~byteps_tpu_torch.inference.truncated_draft` builds, sharing
    the model's parameters — with the same head.  ``model`` is the
    module the closure is for; the step passes the state's module,
    normally the same object."""
    from ..inference import truncated_draft
    from ..ops.fused_cross_entropy import fused_linear_cross_entropy

    del model

    def fused_ce(m: nn.Module, tokens, targets):
        h = m.hidden(tokens)                           # [B, T, d] cfg.dtype
        flat_t = targets.reshape(-1)
        per_row = fused_linear_cross_entropy(
            h.reshape(-1, h.shape[-1]), m.head_weight().t(), flat_t,
            block_n, block_v)
        V = m.cfg.vocab_size
        valid = (flat_t >= 0) & (flat_t < V)
        return per_row.sum() / valid.sum().clamp(min=1)

    def plain_ce(m: nn.Module, tokens, targets):
        t = targets[:, :-1]
        logits = m.logits(m.hidden(tokens)[:, :-1])   # [B, T-1, V] fp32
        V = logits.shape[-1]
        valid = (t >= 0) & (t < V)
        per_tok = F.cross_entropy(
            logits.reshape(-1, V), torch.where(valid, t, 0).reshape(-1).long(),
            reduction="none").view_as(t)
        per_tok = torch.where(valid, per_tok, 0.0)
        return per_tok.sum() / valid.sum().clamp(min=1)

    ce = fused_ce if fused_head else plain_ce

    def loss_fn(m: nn.Module, model_state, batch):
        tokens = batch["tokens"]
        src = batch["labels"] if "labels" in batch else tokens
        targets = torch.roll(src, -1, dims=1)
        targets[:, -1] = -100  # ignore the wrap position
        loss = ce(m, tokens, targets)
        if early_exit is not None:
            layers, weight = early_exit
            loss = loss + weight * ce(truncated_draft(m, layers), tokens,
                                      targets)
        return loss, model_state

    return loss_fn
