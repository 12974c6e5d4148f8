"""The training step (counterpart of `repro.train`)."""
from .loop import (TrainConfig, init_train_state, loss_and_grads,
                   make_train_step)

__all__ = ["TrainConfig", "init_train_state", "loss_and_grads",
           "make_train_step"]
