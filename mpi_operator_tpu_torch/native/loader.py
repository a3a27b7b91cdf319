"""ctypes binding for the native npy-shard loader (npy_loader.cc, the
port's copy of the reference's host C++).

The shared library is built on first use with the machine's g++ into
`_build/` beside the source (ignored by git) and bound with ctypes. It
is host code: shard IO, the fused normalize and cast, and a prefetch
thread, all outside the GIL; it is no TPU kernel and has no CUDA. If no
compiler is available, `native_available()` is False and
data/imagefolder.py keeps its pure-Python feeder. Batches come back as
torch CPU tensors (pinned when asked), ready for a non-blocking copy to
the card.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "npy_loader.cc")
_BUILD = os.path.join(_HERE, "_build")
_SO = os.path.join(_BUILD, "libnpyloader.so")
_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    """Compile the .so if stale/missing; returns an error string or None."""
    try:
        if (os.path.exists(_SO)
                and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
            return None
        os.makedirs(_BUILD, exist_ok=True)
        proc = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-pthread", _SRC, "-o",
             _SO + ".tmp"],
            capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            return f"g++ failed: {proc.stderr[-500:]}"
        os.replace(_SO + ".tmp", _SO)
        return None
    except FileNotFoundError:
        return "g++ not found"
    except Exception as e:  # noqa: BLE001
        return f"build error: {e!r}"


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        _build_error = _build()
        if _build_error is not None:
            return None
        lib = ctypes.CDLL(_SO)
        lib.nsl_open.restype = ctypes.c_void_p
        lib.nsl_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_char_p, ctypes.c_int]
        lib.nsl_next.restype = ctypes.c_int
        lib.nsl_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int]
        lib.nsl_close.restype = None
        lib.nsl_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class NativeShardLoader:
    """Iterator of (images, labels) CPU tensor batches produced by the C++
    loader: normalization + dtype conversion + shard IO run in a native
    prefetch thread, outside the GIL.

    images: [B, H, W, C] in `dtype` (torch.float32 or torch.bfloat16,
    already (x-mean)/std normalized); labels: [B] int32. `pin` puts each
    batch in pinned memory.
    """

    def __init__(self, shards: Sequence[Tuple[str, str]], batch_size: int,
                 image_shape: Tuple[int, int, int],
                 dtype: torch.dtype = torch.float32,
                 mean: Sequence[float] = (127.5, 127.5, 127.5),
                 std: Sequence[float] = (127.5, 127.5, 127.5),
                 seed: int = 0, pin: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        if dtype not in (torch.float32, torch.bfloat16):
            # the Python feeder casts to whatever dtype was asked; the
            # native path only emits f32/bf16 — reject rather than let the
            # two paths silently produce different input dtypes
            raise ValueError(
                f"native loader emits float32 or bfloat16, not {dtype!r}")
        self._lib = lib
        H, W, C = image_shape
        self.batch_size = batch_size
        self.image_shape = image_shape
        self.dtype = dtype
        self.pin = pin
        img_paths = (ctypes.c_char_p * len(shards))(
            *[s[0].encode() for s in shards])
        lbl_paths = (ctypes.c_char_p * len(shards))(
            *[s[1].encode() for s in shards])
        mean_c = (ctypes.c_float * 3)(*[float(m) for m in mean])
        std_c = (ctypes.c_float * 3)(*[float(s) for s in std])
        err = ctypes.create_string_buffer(512)
        self._handle = lib.nsl_open(
            img_paths, lbl_paths, len(shards), batch_size, H, W, C,
            1 if dtype == torch.bfloat16 else 0, seed & 0xFFFFFFFF, mean_c,
            std_c, err, 512)
        if not self._handle:
            raise RuntimeError(f"native loader: {err.value.decode()}")

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        # a fresh batch each call, so the caller may hold batches across
        # iterations (and a pinned one until its copy to the card lands)
        img = torch.empty((self.batch_size, *self.image_shape),
                          dtype=self.dtype, pin_memory=self.pin)
        lbl = torch.empty((self.batch_size,), dtype=torch.int32,
                          pin_memory=self.pin)
        err = ctypes.create_string_buffer(512)
        rc = self._lib.nsl_next(
            self._handle, ctypes.c_void_p(img.data_ptr()),
            ctypes.cast(ctypes.c_void_p(lbl.data_ptr()),
                        ctypes.POINTER(ctypes.c_int32)),
            err, 512)
        if rc != 0:
            raise RuntimeError(f"native loader: {err.value.decode()}")
        return img, lbl

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.nsl_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


__all__ = ["NativeShardLoader", "native_available"]
