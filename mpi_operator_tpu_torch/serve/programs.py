"""The serving engine's compiled programs: its decode steps and prefill
chunks as CUDA graphs.

The counterpart of the reference engine's jitted functions
(`mpi_operator_tpu/serve/engine.py`, `jax.jit` of `step`/`step_paged`
with the sampling mode static, and of `prefill`/`prefill_paged`, one
trace per chunk bucket). The engine keys its programs as the reference
keys its executables: the decode step by (paged, mode) for the three
`sample_slots` modes, prefill by (paged, bucket). `compile_counts()`
counts the programs built, so the reference's no-recompile contract
(`step <= 3`, `prefill <= len(chunk_buckets)`) holds the port as well.

A `Program` is a function `fn(inputs)` over static device buffers. Its
inputs live in ONE int32 device buffer (float inputs are stored by
their bits, each input 16-byte aligned), so one host-to-device copy
from pinned memory (`Staging`) fills them all; `fn` writes its results
into buffers allocated outside the graph pool and returns nothing. On
the card, with capture on:

- the first call runs `fn` eagerly on the capture side stream: the
  call's real work, and the warm-up that makes the libraries allocate
  their per-stream state before the capture. Then `fn` is captured,
  which executes nothing; every later call replays the graph. There is
  no other warm-up run: it would write the KV cache again, advance the
  sampling generator and overwrite the token chain;
- a sampled mode's graph is registered with the engine's generator
  (`CUDAGraph.register_generator_state`): a replay draws what an eager
  call would draw from the generator's state, and advances it as much;
  the capture leaves it where it was;
- `ops.attention.launch_counts` keep counting kernel launches: the
  capture's own counts are taken back, and each replay adds the
  launches the graph holds;
- the graph keeps alive the decode workspace it captured
  (`ops.attention.current_workspace`);
- a capture or replay that fails raises; nothing falls back to eager.

With capture off (the CPU, or `EngineConfig.cuda_graphs=False` on the
card: the port's `jax.disable_jit`) the same `fn` runs eagerly over the
same buffers on every call.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import attention as ops

#: an input of a program: (name, shape, numpy dtype: int32 or float32)
Input = Tuple[str, Tuple[int, ...], type]


class Program:
    """One of the engine's programs; see the module docstring. `key`
    names it, `layout` lists its inputs, which `fn` receives as a dict
    of device tensors (int32 or float32 views of `buffer`)."""

    def __init__(self, key: Hashable, fn: Callable[[Dict], None],
                 layout: Sequence[Input], device: torch.device,
                 capture: bool, pool=None,
                 stream: Optional["torch.cuda.Stream"] = None,
                 generator: Optional[torch.Generator] = None):
        self.key = key
        self.fn = fn
        self.device = device
        self.capture = capture
        self.pool = pool
        self.stream = stream
        self.generator = generator
        self.fields: List[Tuple[str, int, int, type]] = []
        off = 0
        for name, shape, dtype in layout:
            if np.dtype(dtype).itemsize != 4:
                raise TypeError(f"{name}: program inputs are 4-byte "
                                f"values, got {np.dtype(dtype)}")
            off = -(-off // 4) * 4     # 16-byte aligned, as K4/K5 load
            n = int(np.prod(shape))
            self.fields.append((name, off, n, dtype))
            off += n
        self.size = off
        self.buffer = torch.zeros(off, dtype=torch.int32, device=device)
        self.inputs: Dict[str, torch.Tensor] = {}
        for (name, o, n, dtype), (_, shape, _) in zip(self.fields, layout):
            view = self.buffer[o:o + n]
            if np.dtype(dtype) == np.float32:
                view = view.view(torch.float32)
            self.inputs[name] = view.view(shape)
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.launches: Dict[str, int] = {}     # kernel launches a replay
        self.workspace = None                  # what the graph captured

    def pack(self, host: np.ndarray, values: Dict[str, np.ndarray]) -> None:
        """Write `values` (one array per input) into the int32 host
        array `host` in this program's layout."""
        for name, off, n, dtype in self.fields:
            a = np.ascontiguousarray(values[name], dtype=dtype).reshape(-1)
            if a.size != n:
                raise ValueError(f"{self.key}: input {name} has {a.size} "
                                 f"values, the program takes {n}")
            host[off:off + n] = a.view(np.int32)

    @torch.inference_mode()
    def __call__(self) -> None:
        if not self.capture:
            self.fn(self.inputs)
        elif self.graph is None:
            self._run_and_capture()
        else:
            self.graph.replay()
            for name, n in self.launches.items():
                ops.launch_counts[name] += n

    def _run_and_capture(self) -> None:
        main = torch.cuda.current_stream(self.device)
        side = self.stream
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.fn(self.inputs)                 # the call's real work
            before = dict(ops.launch_counts)
            graph = torch.cuda.CUDAGraph()
            if self.generator is not None:
                graph.register_generator_state(self.generator)
            try:
                with torch.cuda.graph(graph, pool=self.pool, stream=side):
                    self.fn(self.inputs)
            finally:
                captured = {k: ops.launch_counts[k] - before[k]
                            for k in before}
                ops.launch_counts.update(before)  # the capture ran nothing
        main.wait_stream(side)
        self.launches = {k: n for k, n in captured.items() if n}
        self.workspace = ops.current_workspace(self.device)
        self.graph = graph


class Staging:
    """Pinned host staging for program inputs: two int32 buffers used in
    turn, each reused only after the event behind its last copy, so the
    host can fill step N+1's inputs while step N's copy is still queued.
    `upload` packs one program's inputs and makes ONE host-to-device
    copy into its buffer, ordered on the stream before the program runs
    (a page table in it can never change under a step in flight). The
    buffers grow to the largest program's inputs at its first upload."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host: List[torch.Tensor] = []
        self.events = ([torch.cuda.Event(), torch.cuda.Event()]
                       if device.type == "cuda" else None)
        self.pin = device.type == "cuda"
        self.turn = 0

    def _wait(self, i: int) -> None:
        if self.events is not None:
            self.events[i].synchronize()     # returns at once if unrecorded

    def upload(self, program: Program, values: Dict[str, np.ndarray]) -> None:
        if not self.host or program.size > self.host[0].numel():
            self._wait(0)
            self._wait(1)
            self.host = [torch.zeros(program.size, dtype=torch.int32,
                                     pin_memory=self.pin) for _ in range(2)]
        i = self.turn
        self.turn ^= 1
        self._wait(i)
        host = self.host[i][:program.size]
        program.pack(host.numpy(), values)
        program.buffer.copy_(host, non_blocking=True)
        if self.events is not None:
            # the copy's stream: the program's card, not the current one
            self.events[i].record(torch.cuda.current_stream(self.device))


__all__ = ["Input", "Program", "Staging"]
