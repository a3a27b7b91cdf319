"""Host-side span annotations that land in profiler and Nsight traces.

The counterpart of `mpi_operator_tpu/telemetry/spans.py`: `span(name)`
names a host region ("serve.prefill", "serve.decode_step", ...) twice:
with `torch.profiler.record_function`, so a `torch.profiler` trace
shows it next to the CUDA kernels it launched, and, on a CUDA build of
torch, with an NVTX range of the same name, so an Nsight Systems
timeline shows it too. A CPU-only build has no NVTX and takes the
profiler annotation alone. Outside an active profile both cost a few
microseconds, so call sites keep their spans unconditionally.
"""
from __future__ import annotations

import torch

#: NVTX ranges need a CUDA build of torch (a CPU build raises on them)
_NVTX = torch.version.cuda is not None


class span:
    """Context manager marking a named host region in profiler traces
    and, on a CUDA build, as an NVTX range."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = torch.profiler.record_function(name)

    def __enter__(self):
        if _NVTX:
            torch.cuda.nvtx.range_push(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        if _NVTX:
            torch.cuda.nvtx.range_pop()
        return False


__all__ = ["span"]
