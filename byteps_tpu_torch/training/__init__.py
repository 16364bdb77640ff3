"""Training — the port of ``byteps_tpu/training``: the LM loss (plain or
fused head, optional early-exit term), the train step at any world
(``make_data_parallel_step``), the ``DistributedOptimizer`` that
averages gradients across workers while backward runs (with error
feedback under a biased compression scheme), the delayed-gradient
overlap step (``make_delayed_grad_step``), checkpoints
(``CheckpointManager``), callbacks and schedules, and the ``Trainer``
loop with ``fit`` and ``evaluate``."""

from .callbacks import (BroadcastGlobalVariablesCallback,
                        MomentumCorrectedSGD, average_metrics,
                        multiplier_schedule, scaled_lr, warmup_schedule)
from .checkpoint import (CheckpointManager, restore_checkpoint,
                         save_checkpoint)
from .optimizer import (DistributedOptimizer, push_pull_gradients,
                        resolve_compression)
from .overlap import DelayedStep, OverlapState, make_delayed_grad_step
from .step import (TrainState, TrainStep, create_train_state, lm_loss_fn,
                   make_data_parallel_step, make_zero_step)
from .trainer import Trainer

__all__ = ["BroadcastGlobalVariablesCallback", "CheckpointManager",
           "DelayedStep", "DistributedOptimizer", "MomentumCorrectedSGD",
           "OverlapState", "TrainState", "TrainStep", "Trainer",
           "average_metrics", "create_train_state", "lm_loss_fn",
           "make_data_parallel_step", "make_delayed_grad_step",
           "make_zero_step",
           "multiplier_schedule",
           "push_pull_gradients", "resolve_compression",
           "restore_checkpoint", "save_checkpoint", "scaled_lr",
           "warmup_schedule"]
