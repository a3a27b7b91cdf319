"""The port's training path (see lm_trainer.py), its checkpoints
(checkpoint.py) and its preemption runtime (resilience.py)."""
from .checkpoint import (  # noqa: F401
    latest_checkpoint, maybe_resume, maybe_save, periodic_saver,
    restore_checkpoint, save_checkpoint, wait_for_checkpoints,
)
from .lm_trainer import (  # noqa: F401
    AdamWState, LMTrainer, LMTrainerConfig, LMTrainState, adamw_update,
    fused_lm_loss, lm_loss, make_lr_schedule,
)
from .resilience import (  # noqa: F401
    DivergenceError, Preempted, ResilienceConfig, ResilienceContext,
    guard_nonfinite_update,
)

__all__ = ["AdamWState", "DivergenceError", "LMTrainState", "LMTrainer",
           "LMTrainerConfig", "Preempted", "ResilienceConfig",
           "ResilienceContext", "adamw_update", "fused_lm_loss",
           "guard_nonfinite_update", "latest_checkpoint", "lm_loss",
           "make_lr_schedule", "maybe_resume", "maybe_save",
           "periodic_saver", "restore_checkpoint", "save_checkpoint",
           "wait_for_checkpoints"]
