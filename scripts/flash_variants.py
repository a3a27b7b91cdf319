#!/usr/bin/env python3
"""Time K1 and K3 of the PyTorch/CUDA port against copies of their source
with one change each, in one process on one card.

    python3 scripts/flash_variants.py        # from the repo root, on an H100

Each variant is `mpi_operator_tpu_torch/ops/csrc/flash_attention.cu` with
one text edit (a ring depth, or one phase of K1 taken out to see what it
costs), built with the port's own nvcc flags into
`mpi_operator_tpu_torch/ops/_build/variants/` and called through its C
entry points. At the training shape (B=16, S=512, H=16, D=64, causal,
bf16) every library runs K1 and K3 in turns, committed source first and
last (committed, variants..., variants reversed, committed), each launch
timed with CUDA events after the 50 MB L2 is flushed; the median of 30
launches is printed beside the relative error against the plain
versions (an ablation's error is large by design). A variant whose edit
no longer matches the source raises.
"""
import ctypes
import math
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# name: (text in the source, its replacement)
VARIANTS = {
    "k1_ring1": ("constexpr int kFwdStages = 2;", "constexpr int kFwdStages = 1;"),
    "k1_ring3": ("constexpr int kFwdStages = 2;", "constexpr int kFwdStages = 3;"),
    "k3_ring1": ("constexpr int kDkvStages = 3;", "constexpr int kDkvStages = 1;"),
    "k3_ring2": ("constexpr int kDkvStages = 3;", "constexpr int kDkvStages = 2;"),
    # K1 without its exponentials (p = the exponent), its p.v products,
    # or its output stores
    "k1_no_exp": ("const float e = ex2(fmaf(s[n][j], c2, -mb[j >> 1]));",
                  "const float e = fmaf(s[n][j], c2, -mb[j >> 1]);"),
    "k1_no_pv": ("    wgmma_rs(o, pa[kk], mnmajor(vt, BK, kk), 1);",
                 "    if (a.B < 0) wgmma_rs(o, pa[kk], mnmajor(vt, BK, kk), 1);"),
    "k1_no_store": ("          if (n8 * 8 < a.D)\n"
                    "            *reinterpret_cast<uint32_t*>(orow",
                    "          if (n8 * 8 < a.D && a.B < 0)\n"
                    "            *reinterpret_cast<uint32_t*>(orow"),
}


def build(ops_build, src_text, name, out_dir):
    src = out_dir / f"{name}.cu"
    src.write_text(src_text)
    lib = out_dir / f"lib{name}.so"
    return subprocess.Popen(
        [ops_build.find_nvcc(), *ops_build.NVCC_FLAGS, "-o", str(lib),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True), lib


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from mpi_operator_tpu_torch.ops import _build
    from mpi_operator_tpu_torch.ops import attention as ops
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    source = (_build.CSRC / "flash_attention.cu").read_text()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = {"committed": source}
    for name, (old, new) in VARIANTS.items():
        if source.count(old) != 1:
            raise RuntimeError(f"variant {name}: its edit matches the source "
                               f"{source.count(old)} times, not once")
        texts[name] = source.replace(old, new)
    started = {n: build(_build, t, n, out_dir) for n, t in texts.items()}
    libs = {}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, (proc, path) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(path))
        lib.flash_fwd_launch.argtypes = [P] * 6 + [I] * 5 + [F, P]
        lib.flash_dkv_launch.argtypes = [P] * 9 + [I] * 5 + [F, P]
        libs[name] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S, H, D = 16, 512, 16, 64
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen, device=dev)
                   .bfloat16() for _ in range(4))
    ref_out, ref_lse = ops.flash_fwd_ref(q, k, v, True)
    delta = ops.flash_delta(ref_out, do)
    ref_dk, ref_dv = ops.flash_dkv_ref(q, k, v, do, ref_lse, delta, True)
    out, lse = torch.empty_like(q), torch.empty_like(ref_lse)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream().cuda_stream
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(D)

    def fwd(lib):
        rc = lib.flash_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  0, out.data_ptr(), lse.data_ptr(), B, S, H,
                                  D, 1, scale, stream)
        if rc:
            raise RuntimeError(f"flash_fwd_launch returned {rc}")

    def dkv(lib):
        rc = lib.flash_dkv_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  do.data_ptr(), ref_lse.data_ptr(),
                                  delta.data_ptr(), 0, dk.data_ptr(),
                                  dv.data_ptr(), B, S, H, D, 1, scale, stream)
        if rc:
            raise RuntimeError(f"flash_dkv_launch returned {rc}")

    def time_ms(fn, iters=30):
        for _ in range(3):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for e0, e1 in ev:
            flush.zero_()
            e0.record()
            fn()
            e1.record()
        torch.cuda.synchronize()
        ts = sorted(e0.elapsed_time(e1) for e0, e1 in ev)
        return ts[len(ts) // 2]

    def rel(got, want):
        got, want = got.float(), want.float()
        return float((got - want).norm() / want.norm())

    names = list(libs)
    for name in names + names[::-1]:
        lib = libs[name]
        fwd(lib)
        dkv(lib)
        torch.cuda.synchronize()
        errs = (rel(out, ref_out), rel(dk, ref_dk), rel(dv, ref_dv))
        print(f"{name:12s} K1 {time_ms(lambda: fwd(lib)):.4f} ms  K3 "
              f"{time_ms(lambda: dkv(lib)):.4f} ms  relative error out "
              f"{errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
