"""Training layer: step builders and the fault-tolerant driver loop."""
from .steps import (TrainState, dp_residuals_init, gather_train_state,
                    init_train_state, make_dp_train_step, make_loss_fn,
                    make_train_step, shard_train_state)
from .loop import StragglerWatchdog, TrainLoop

__all__ = ["TrainState", "dp_residuals_init", "gather_train_state",
           "init_train_state", "make_dp_train_step", "make_loss_fn",
           "make_train_step", "shard_train_state",
           "StragglerWatchdog", "TrainLoop"]
