"""Training — the port of ``byteps_tpu/training`` for one worker: the LM
loss (plain or fused head, optional early-exit term), the train step
and the ``Trainer`` loop with ``fit`` and ``evaluate``."""

from .step import (TrainState, TrainStep, create_train_state, lm_loss_fn,
                   make_data_parallel_step)
from .trainer import Trainer

__all__ = ["TrainState", "TrainStep", "Trainer", "create_train_state",
           "lm_loss_fn", "make_data_parallel_step"]
