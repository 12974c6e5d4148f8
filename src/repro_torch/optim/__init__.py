"""Optimizers: AdamW, factored Adafactor, cosine schedule, int8 grad
compression (counterpart of `repro.optim`)."""
from . import grad_compress
from .adamw import (AdamWState, AdafactorState, OptimizerConfig, adamw_init,
                    adamw_update, adafactor_init, adafactor_update, cosine_lr,
                    make_optimizer, optimizer_bytes_per_param)

__all__ = ["grad_compress", "AdamWState", "AdafactorState",
           "OptimizerConfig", "adamw_init", "adamw_update",
           "adafactor_init", "adafactor_update", "cosine_lr",
           "make_optimizer", "optimizer_bytes_per_param"]
