"""Build and load the port's hand-written CUDA kernels.

Each source is one `csrc/<name>.cu` file with plain C entry points
(`decode_attention.cu` holds K4's and K5's, `flash_attention.cu` K1's,
K2's and K3's). At first use it is compiled
by `nvcc` for Hopper (`sm_90a`) into a shared library under `ops/_build/`
(listed in `.gitignore`) and loaded with `ctypes`. Nothing here
includes PyTorch's headers, so a build takes seconds, not the minutes a
`torch.utils.cpp_extension` build takes. `build` starts one nvcc per
source, all together, and then waits for them.

A library's file name carries a hash of its source and flags, so an
edited kernel is rebuilt and a stale build is never loaded. Builds
write to a temporary name and are renamed into place, so two processes
building at once cannot load half a file.

Nothing is built at import time: the CPU tests import every module, and
the CPU path never needs `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: what ptxas reported for each kernel built in this process (registers,
#: shared memory, spills) — chip_smoke.py prints it
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    """`nvcc` from $CUDA_HOME, /usr/local/cuda, or the PATH; raises
    when none is installed (a CUDA tensor without a compiler cannot
    launch the kernel, and there is no fallback)."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from source at first use")
    return found


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no kernel source {src}")
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str) -> Optional[Tuple[subprocess.Popen, Path, Path]]:
    """Start the nvcc build of `name` unless its library is already on
    disk; returns (running process, temporary output, final path), or
    None."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build(names: Iterable[str]) -> None:
    """Build every named kernel, all nvcc processes started together
    (one per source) and then awaited."""
    names = list(names)
    with _lock:
        started = [(n, _start(n)) for n in names]
        for n, p in started:
            _finish(n, p)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


__all__ = ["build", "load", "find_nvcc", "build_logs", "CSRC", "BUILD_DIR"]
