"""Training — the port of ``byteps_tpu/training``: the LM loss (plain or
fused head, optional early-exit term), the train step at any world
(``make_data_parallel_step``), the ``DistributedOptimizer`` that
averages gradients across workers while backward runs, and the
``Trainer`` loop with ``fit`` and ``evaluate``."""

from .optimizer import DistributedOptimizer, push_pull_gradients
from .step import (TrainState, TrainStep, create_train_state, lm_loss_fn,
                   make_data_parallel_step)
from .trainer import Trainer

__all__ = ["DistributedOptimizer", "TrainState", "TrainStep", "Trainer",
           "create_train_state", "lm_loss_fn", "make_data_parallel_step",
           "push_pull_gradients"]
