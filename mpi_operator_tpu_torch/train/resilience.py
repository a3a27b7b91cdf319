"""The in-step divergence guard of the training loop.

The counterpart of `mpi_operator_tpu/train/resilience.py::
guard_nonfinite_update`, the only part of that module on the flat
training path: a step whose loss or global gradient norm (of the
unclipped gradients) is not finite applies no update. Parameters and
optimizer state keep their old values, the trainer's step counter still
advances, and `nonfinite_streak` counts the skipped steps in a row. It
runs on the device with no host sync: each buffer is selected in place
with `torch.where`.

Not here yet (later slices): the preemption drain, the watchdog, the
stop-bit collective, checkpoint rollback.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import torch


def guard_nonfinite_update(updates: Iterable[Tuple[torch.Tensor,
                                                   torch.Tensor]],
                           loss: torch.Tensor, grad_norm: torch.Tensor,
                           streak: torch.Tensor) -> torch.Tensor:
    """For each (old, new) pair: old <- new in place when `loss` and
    `grad_norm` are finite, else old keeps its value. Returns the new
    streak: 0 after a finite step, `streak` + 1 after a skipped one."""
    ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
    for old, new in updates:
        torch.where(ok, new, old, out=old)
    return torch.where(ok, torch.zeros_like(streak), streak + 1)


__all__ = ["guard_nonfinite_update"]
