"""First-window benchmark profiling (torch.profiler).

The counterpart of `mpi_operator_tpu/utils/profiling.py`: per-op host
and device timelines for the first measurement window of a benchmark
loop, written as a chrome trace (`trace_<pid>_<n>.json`) into
`profile_dir`, with CUDA activity recorded when the run is on the card.
A tiny stateful helper so the trainer and the serving benchmark share
the reference's start/stop discipline:

  - the stop (which exports the trace — real I/O) happens AFTER the
    window's closing timestamp is taken, so trace writing is never
    charged to reported throughput;
  - callers wrap their loop in try/finally with `stop_if_active()` so an
    exception mid-window can't leave a profiler session running (a
    leaked session makes the next profiler start raise).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch

from .device import DeviceLike


class WindowProfiler:
    def __init__(self, profile_dir: Optional[str],
                 log: Callable[[str], None] = print,
                 device: DeviceLike = "cpu"):
        self._dir = profile_dir
        self._log = log
        self._cuda = torch.device(device).type == "cuda"
        self._prof: Optional[torch.profiler.profile] = None
        #: the chrome trace the last window wrote (None before one)
        self.trace_path: Optional[str] = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        if self._dir and self._prof is None:
            from torch.profiler import ProfilerActivity
            activities = [ProfilerActivity.CPU]
            if self._cuda:
                activities.append(ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
            self._prof = prof

    def stop_if_active(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self._dir, exist_ok=True)
        path = os.path.join(self._dir, f"trace_{os.getpid()}_"
                                       f"{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        self.trace_path = path
        self._log(f"profiler trace written to {path}")


__all__ = ["WindowProfiler"]
