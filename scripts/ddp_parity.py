#!/usr/bin/env python3
"""Data-parallel parity across the cards of one machine: the port's DDP
parity worker (tests/torch_ddp_worker.py) as N ranks, forked by
`mpi_operator_tpu_torch.bootstrap.launch` (TPU_SLOTS_PER_WORKER=N) and
joined through the bootstrap, against one process at the global batch.

    python3 scripts/ddp_parity.py 2 4        # on a machine with 4 cards
    python3 scripts/ddp_parity.py --cpu 4    # 4 gloo ranks on the CPU

With N cards or more the bootstrap picks NCCL (rank r on cuda:r); on the
CPU it picks gloo. On the card: ResNet-50 (s2d, 64 px, f32, TF32 off)
and ViT-B/16's width at 2 layers (bf16, K1-K3), 3 SGD steps on a global
batch of 16, as chip_smoke.py's [train-ddp]; on the CPU the tests' small
models for one step. Prints, per gang and model, the relative error of
the update (params after minus before), of the momentum and of the BN
statistics against the single process, and the backend the gang used.
Exits 1 if a gang fails.
"""
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import torch  # noqa: E402

import torch_ddp_worker as worker  # noqa: E402


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    cpu = "--cpu" in sys.argv
    worlds = [int(a) for a in sys.argv[1:] if a.isdigit()] or [2, 4]
    size, px, steps = ("test", 32, 1) if cpu else ("chip", 64, 3)
    dev = torch.device("cpu") if cpu else torch.device("cuda", 0)
    if not cpu:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        from mpi_operator_tpu_torch.ops import _build
        _build.build(["flash_attention"])
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout, flush=True)
    want = worker.train(0, 1, dev, steps, px, size)
    ok = True
    for world in worlds:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "rank0.pt")
            env = dict(os.environ, TPU_SLOTS_PER_WORKER=str(world),
                       PYTHONPATH=ROOT)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m",
                 "mpi_operator_tpu_torch.bootstrap.launch", "--",
                 sys.executable, os.path.join(ROOT, "tests",
                                              "torch_ddp_worker.py"),
                 str(world), str(free_port()), out, "--device",
                 "cpu" if cpu else "cuda", "--size", size,
                 "--image-size", str(px), "--steps", str(steps)],
                cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=600)
            secs = time.perf_counter() - t0
            if proc.returncode:
                print(f"world {world}: rc {proc.returncode}\n"
                      f"{proc.stderr[-4000:]}")
                ok = False
                continue
            saved = torch.load(out)
            for name, (s0, p, mom, st) in saved["results"].items():
                w0, wp, wm, ws = want[name]
                upd = float(((p - s0) - (wp - w0)).norm()
                            / (wp - w0).norm())
                mrel = float((mom - wm).norm() / wm.norm())
                srel = (float((st - ws).norm() / ws.norm())
                        if ws.numel() else 0.0)
                print(f"world {world} over {saved['backend']} "
                      f"({secs:.1f} s) {name}: update {upd:.3e} momentum "
                      f"{mrel:.3e} statistics {srel:.3e}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
