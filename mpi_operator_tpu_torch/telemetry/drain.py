"""The drain budget and the stop-check cadence it implies.

`suggest_stop_check_every` is read by two processes: the training
worker, which derives its stop-bit cadence from the last run's measured
drain latency (train/resilience.py, TPU_STOP_CHECK_EVERY=auto), and the
postmortem CLI, which prints the cadence that would have landed a slow
drain inside the budget (postmortem.py). The postmortem runs where the
operator runs, in an image without torch, so the function lives here,
in a module that imports neither torch nor jax; train/resilience.py
re-exports it with the budget's names.
"""
from __future__ import annotations

import os
from typing import Optional

#: env var holding the drain-latency budget (seconds) the auto cadence
#: targets
ENV_DRAIN_TARGET = "TPU_DRAIN_TARGET_SECONDS"
#: default drain budget: well inside a preemption notice, leaving the
#: emergency checkpoint write the rest of the grace window
DRAIN_TARGET_SECONDS = 5.0


def suggest_stop_check_every(drain_seconds: float, cadence: int,
                             target: Optional[float] = None,
                             lo: int = 1, hi: int = 256) -> Optional[int]:
    """The cadence that would have landed a measured drain inside the
    target budget, assuming drain latency scales roughly linearly with
    the cadence. Returns None when the inputs can't support one."""
    if target is None:
        raw = os.environ.get(ENV_DRAIN_TARGET, "")
        try:
            target = float(raw) if raw else DRAIN_TARGET_SECONDS
        except ValueError:
            target = DRAIN_TARGET_SECONDS
    if drain_seconds <= 0 or cadence <= 0 or target <= 0:
        return None
    return max(lo, min(hi, int(round(cadence * target / drain_seconds))
                       or lo))


__all__ = ["ENV_DRAIN_TARGET", "DRAIN_TARGET_SECONDS",
           "suggest_stop_check_every"]
