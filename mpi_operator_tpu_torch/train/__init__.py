"""The port's training path (see lm_trainer.py)."""
from .lm_trainer import (  # noqa: F401
    AdamWState, LMTrainer, LMTrainerConfig, LMTrainState, adamw_update,
    fused_lm_loss, lm_loss, make_lr_schedule,
)
from .resilience import guard_nonfinite_update  # noqa: F401

__all__ = ["AdamWState", "LMTrainState", "LMTrainer", "LMTrainerConfig",
           "adamw_update", "fused_lm_loss", "guard_nonfinite_update",
           "lm_loss", "make_lr_schedule"]
