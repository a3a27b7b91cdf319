#!/usr/bin/env python3
"""Data-parallel parity across the cards of one machine: the port's
parity workers as N ranks, forked by `mpi_operator_tpu_torch.bootstrap.
launch` and joined through the bootstrap, against one process at the
global batch.

    python3 scripts/ddp_parity.py 2 4              # a machine with 4 cards
    python3 scripts/ddp_parity.py 2 4 --scaling    # and the speed legs
    python3 scripts/ddp_parity.py --cpu 4          # gloo ranks on the CPU

With N cards or more the bootstrap picks NCCL (rank r on cuda:r); on the
CPU it picks gloo. For each gang size N:

- images (tests/torch_ddp_worker.py): on the card ResNet-50 (s2d, 64
  px, f32, TF32 off) and ViT-B/16's width at 2 layers (bf16, K1-K3), 3
  SGD steps on a global batch of 16, as chip_smoke.py's [train-ddp];
  the relative error of the update (params after minus before), of the
  momentum and of the BN statistics;
- LMs (tests/torch_lm_gang_worker.py): gpt2-medium's, bert-large's and
  gpt2-small's 8-expert widths at 2 layers (f32, dense attention, MoE
  under accum_steps 2), 3 AdamW steps on a global batch of 8 x 256, as
  chip_smoke.py's [train-lm-ddp]; the relative error of the update,
  mu and nu;
- at N = 4, 2 slices x 2 ranks (TPU_NUM_SLICES 2, one launch.py a
  slice, each slice its own two cards): gpt2 in bf16 through K1-K3 and
  ResNet-50 over the dcn x dp mesh.

`--mp` runs the model-parallel mode instead (tests/torch_mp_worker.py
as one gang over the largest N, one card a rank over NCCL): gpt2-medium
at full width, 16 x 512 a card, bf16, K1-K3, through LMTrainer.benchmark
at tp = 1, 2, 4 (dp filling the rest) and fsdp = 2, 4: tokens/s a card,
step p50, each card's bytes of masters + mu + nu and peak memory; and
each tp leg again with its tp all-reduces turned into the identity
(timing only), whose throughput gives the exposed all-reduce's share of
a step, 1 - tokens/s(on) / tokens/s(off) (the windows' wall time; the
step p50 comes from the telemetry histogram's buckets). `--mp --cpu 4` rehearses it with gloo
ranks at the test size.

On the CPU the tests' small models run instead. `--scaling` (cards
only) adds examples/allreduce_bench.py over all N cards at 1, 16 and
64 MB (the curve), then at 1354 MB (gpt2-medium's flat f32 gradient
buffer), and the LM CLI
training gpt2-medium at full width (16 x 512 a card, bf16, flash) on 1
card and on each N, one process a card: tokens/s, tokens/s a card and
step p50. Every line carries the card's name and power limit. Exits 1
if a gang fails.
"""
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import torch  # noqa: E402

import torch_ddp_worker as worker  # noqa: E402
import torch_lm_gang_worker as lm_worker  # noqa: E402
import torch_mp_worker as mp_worker  # noqa: E402


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def image_gang(world, cpu, size, px, steps, want, label):
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
            return False
        saved = torch.load(out)
    for name, (s0, p, mom, st) in saved["results"].items():
        w0, wp, wm, ws = want[name]
        upd = float(((p - s0) - (wp - w0)).norm() / (wp - w0).norm())
        mrel = float((mom - wm).norm() / wm.norm())
        srel = (float((st - ws).norm() / ws.norm()) if ws.numel() else 0.0)
        print(f"world {world} over {saved['backend']} ({secs:.1f} s) "
              f"{name}: update {upd:.3e} momentum {mrel:.3e} statistics "
              f"{srel:.3e} ({label})", flush=True)
    return True


def lm_gang(world, cpu, size, want, label, slices=1, only=None):
    only = only or list(lm_worker.MODELS)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            got, secs = lm_worker.gang(
                world, os.path.join(tmp, "r"), "--size", size, "--only",
                ",".join(only), slices=slices,
                device="cpu" if cpu else "cuda")
        except RuntimeError as exc:
            print(f"LM world {world} ({slices} slice(s)): {exc}")
            return False
    for r, res in enumerate(got):
        for name in only:
            if name == "resnet":
                (s0, p, mom, st), (w0, wp, wm, ws) = res[name], want[name]
                err = {"update": float(((p - s0) - (wp - w0)).norm()
                                       / (wp - w0).norm()),
                       "momentum": float((mom - wm).norm() / wm.norm()),
                       "statistics": float((st - ws).norm() / ws.norm())}
            else:
                err = lm_worker.compare(res[name], want[name])
            print(f"world {world} ({slices} slice(s), mesh "
                  f"dcn {res['mesh']['dcn']} x dp {res['mesh']['dp']}) over "
                  f"{res['backend']} ({secs:.1f} s) rank {r} {name}: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
                  + f" ({label})", flush=True)
    return True


def cli_env(world):
    env = dict(os.environ, TPU_COORDINATOR_ADDRESS=f"127.0.0.1:"
               f"{free_port()}", TPU_NUM_PROCESSES=str(world),
               TPU_STATUS_PORT=str(free_port()), PYTHONPATH=ROOT)
    for k in ("TPU_WORKER_ID", "TPU_LOCAL_RANK", "TPU_LAUNCHER",
              "TPU_SLOTS_PER_WORKER", "TPU_NUM_SLICES"):
        env.pop(k, None)
    return env


def cli_gang(world, cmd, launcher=True):
    """`cmd` as `world` processes, rank r on cuda:r (TPU_WORKER_ID and
    TPU_LOCAL_RANK r), and a launcher; rank 0's output."""
    env = cli_env(world)
    roles = [{"TPU_WORKER_ID": str(r), "TPU_LOCAL_RANK": str(r)}
             for r in range(world)] if world > 1 else [{}]
    if launcher and world > 1:
        roles.append({"TPU_LAUNCHER": "1"})
    procs = [subprocess.Popen(cmd, cwd=ROOT, env={**env, **role},
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for role in roles]
    outs = [p.communicate(timeout=1200)[0] for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError(f"{cmd[2]} over {world}: "
                           f"{[p.returncode for p in procs]}\n"
                           f"{outs[0][-3000:]}")
    return outs[0]


def scaling(worlds, label):
    """allreduce_bench over the largest gang, then gpt2-medium through
    the LM CLI on 1 card and on each gang size."""
    n = max(worlds)
    for payloads in (["1", "16", "64"], ["1354"]):
        out = cli_gang(n, [sys.executable, "-m", "mpi_operator_tpu_torch."
                           "examples.allreduce_bench", "--payload-mb",
                           *payloads], launcher=False)
        print(f"allreduce_bench over {n} cards ({label}): "
              f"{out.strip().splitlines()[-1]}", flush=True)
    for world in [1] + list(worlds):
        out = cli_gang(world, [
            sys.executable, "-m", "mpi_operator_tpu_torch.examples."
            "lm_benchmark", "--size", "medium", "--batch-per-device", "16",
            "--seq-len", "512", "--num-steps", "30", "--warmup-steps", "3",
            "--attention", "flash"])
        head = json.loads([line for line in out.splitlines()
                           if '"metric"' in line][-1])
        p50 = re.search(r"step time: p50 ([0-9.]+) ms", out)
        print(f"gpt2-medium 16 x 512 a card on {world} card(s) ({label}): "
              f"tokens/s {head['value']:.0f}, a card "
              f"{head['value'] / world:.0f}, step p50 "
              f"{p50.group(1) if p50 else 'n/a'} ms, final loss "
              f"{head['final_loss']}", flush=True)


def model_parallel(world, cpu, label):
    """The --mp mode over `world` ranks (see the module docstring)."""
    prefix = "cards-test/" if cpu else "cards/"
    names = [n.replace("cards/", prefix)
             for n in mp_worker.card_legs(world)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        try:
            got = mp_worker.gang(world, os.path.join(tmp, "r"), names,
                                 device="cpu" if cpu else "cuda",
                                 timeout=1800)
        except RuntimeError as exc:
            print(f"model-parallel gang of {world}: {exc}")
            return False
    print(f"model-parallel gang of {world} over {got[0]['backend']}: "
          f"{time.perf_counter() - t0:.1f} s ({label})", flush=True)
    for name in names:
        ranks = [r[name] for r in got if name in r]
        r = ranks[0]
        peak = max(q["peak_bytes"] or 0 for q in ranks)
        mesh = {k: v for k, v in r["mesh"].items() if v > 1}
        line = (f"{name} mesh {mesh}: tokens/s {r['tokens_per_sec']:.1f}, "
                f"a card {r['tokens_per_sec'] / world:.1f}, step p50 "
                f"{r['step_time_p50_ms']:.1f} ms, masters + mu + nu a card "
                f"{max(q['masters_bytes'] for q in ranks) / 1e9:.3f} GB, "
                f"peak {peak / 1e9:.2f} GB, K1 launches a rank "
                f"{r['launches']['flash_fwd']}")
        off = name + "-off"
        if off in names:
            o = [q[off] for q in got if off in q][0]
            line += (f"; without its tp all-reduces {o['tokens_per_sec']:.1f}"
                     f" tokens/s, step p50 {o['step_time_p50_ms']:.1f} ms: "
                     f"exposed share of the step "
                     f"{1 - r['tokens_per_sec'] / o['tokens_per_sec']:.3f}")
        if not name.endswith("-off"):
            print(line + f" ({label})", flush=True)
    return True


def main() -> int:
    cpu = "--cpu" in sys.argv
    worlds = [int(a) for a in sys.argv[1:] if a.isdigit()] or [2, 4]
    size, px, steps = ("test", 32, 1) if cpu else ("chip", 64, 3)
    dev = torch.device("cpu") if cpu else torch.device("cuda", 0)
    label = "cpu"
    if not cpu:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        from mpi_operator_tpu_torch.ops import _build
        _build.build(["flash_attention"])
        label = card()
        print(label, flush=True)
    if "--mp" in sys.argv:
        if not cpu:
            torch.cuda.empty_cache()
        return 0 if model_parallel(max(worlds), cpu, label) else 1
    want = worker.train(0, 1, dev, steps, px, size)
    lm_steps = 3
    lm_size = "test" if cpu else "chip"
    lm_want = lm_worker.run(0, 1, dev, lm_steps, lm_size)
    ok = True
    for world in worlds:
        ok &= image_gang(world, cpu, size, px, steps, want, label)
        ok &= lm_gang(world, cpu, lm_size, lm_want, label)
        if world == 4:
            slice_size = "test" if cpu else "chip-bf16"
            slice_want = lm_worker.run(0, 1, dev, lm_steps, slice_size,
                                       only=["gpt2", "resnet"])
            ok &= lm_gang(4, cpu, slice_size, slice_want, label, slices=2,
                          only=["gpt2", "resnet"])
    if "--scaling" in sys.argv and not cpu:
        scaling(worlds, label)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
