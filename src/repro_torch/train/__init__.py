"""Training layer: step builders and the fault-tolerant driver loop."""
from .steps import (TrainState, dp_residuals_init, init_train_state,
                    make_dp_train_step, make_loss_fn, make_train_step)
from .loop import StragglerWatchdog, TrainLoop

__all__ = ["TrainState", "dp_residuals_init", "init_train_state",
           "make_dp_train_step", "make_loss_fn", "make_train_step",
           "StragglerWatchdog", "TrainLoop"]
