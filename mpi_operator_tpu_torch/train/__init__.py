"""The port's training paths (lm_trainer.py for the LMs, trainer.py for
the image models), their checkpoints (checkpoint.py) and the preemption
runtime (resilience.py)."""
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
from .trainer import (  # noqa: F401
    Trainer, TrainerConfig, TrainState, cross_entropy_loss, make_sgd,
)

__all__ = ["AdamWState", "DivergenceError", "LMTrainState", "LMTrainer",
           "LMTrainerConfig", "Preempted", "ResilienceConfig",
           "ResilienceContext", "TrainState", "Trainer", "TrainerConfig",
           "adamw_update", "cross_entropy_loss", "fused_lm_loss",
           "guard_nonfinite_update", "latest_checkpoint", "lm_loss",
           "make_lr_schedule", "make_sgd", "maybe_resume", "maybe_save",
           "periodic_saver", "restore_checkpoint", "save_checkpoint",
           "wait_for_checkpoints"]
