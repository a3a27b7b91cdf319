"""Elastic gang-resize benchmark: 4 -> 2 -> 4 ranks without a cold
restart. The counterpart of `mpi_operator_tpu/examples/elastic_benchmark.py`.

Plays the controller's side of a user-driven ``spec.resize`` end to end,
out of process; a "device" is a rank (a process of the gang):

  phase 1   4 ranks, batch 2 a rank — SIGTERM mid-run (drain ->
            emergency checkpoint -> exit 215, the retryable band)
  resize    the orchestrator records ``gang_resize`` in the controller
            event log (what TPUJobController.note_resize(gang=True) does
            when spec.resize lands)
  phase 2   2 ranks, batch 4 a rank — the checkpoint is restored through
            the resharding reader (TPU_RESHARD_RESTORE=1,
            train/checkpoint.py restore_resharded), then SIGTERM'd again
  resize    back to the original size
  phase 3   4 ranks, batch 2 a rank — resharding restore again, runs to
            --stop-at-step and exits 0

Each phase is the port's LM CLI (examples/lm_benchmark.py) as a gang of
processes under the controller's env contract (the coordinator at
127.0.0.1, TPU_NUM_PROCESSES, one TPU_WORKER_ID a worker process and a
TPU_LAUNCHER=1 process mirroring rank 0's exit, TPU_SLOTS_PER_WORKER =
the gang's ranks, so ranks that share a card join over gloo), gpt2 at
the test size. (The controller's slots>1 pods fork their ranks
through bootstrap/launch.py, which reads the worker ordinal from the
StatefulSet pod name; a local gang has none, so each rank is one
process with its TPU_WORKER_ID.) The ranks run on the card (the
default: bf16 over f32 masters, attention through the flash kernels
K1-K3) and without one it raises; `device="cpu"` runs them on the CPU
in f32, as the reference's phases run on CPU hosts.

The global batch is constant (4 x 2 = 2 x 4 = 8) and the token stream is
step-keyed, so every phase trains on exactly the batches the
uninterrupted run would at each global step: the final loss must match a
straight-through oracle run modulo the reduction order across ranks
(rel_tol 1e-3, abs_tol 1e-4). The merged timeline (controller + worker
events) feeds the same resize_ledger / goodput_ledger the live
controller renders: the ``resize_seconds`` drain / restore / recompile
split and the goodput across both resizes.

    python -m mpi_operator_tpu_torch.examples.elastic_benchmark \\
        --out-dir /tmp/elastic [--no-oracle] [--device cpu]

Prints one JSON line; exit 0 iff every gate held.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

#: (ranks, batch a rank) per phase — the product (the global batch) is
#: invariant, which is what makes the loss curves comparable at all
PHASE_SHAPES: Tuple[Tuple[int, int], ...] = ((4, 2), (2, 4), (4, 2))

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: the env a phase's processes must not inherit
_GANG_ENV = ("TPU_WORKER_ID", "TPU_LOCAL_RANK", "TPU_FAULT_INJECT",
             "TPU_NUM_SLICES", "TPU_SLICE_ID", "TPU_NUM_PROCESSES",
             "TPU_COORDINATOR_ADDRESS", "TPU_LAUNCHER", "TPU_STATUS_PORT",
             "TPU_SLOTS_PER_WORKER", "TPU_RESHARD_RESTORE")


def require_device(device: str) -> None:
    """Raise unless `device` is "cpu" or "cuda" with a card present. On
    the card, build the flash kernels here once, so that the phases'
    ranks load them instead of each running nvcc inside a phase."""
    import torch
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the phases run on the card "
                               "unless device='cpu' (--device cpu)")
        from ..ops import _build
        _build.build(["flash_attention"])


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _phase_env(devices: int, port: Optional[int], fault: Optional[str],
               reshard: bool) -> Dict[str, str]:
    env = {k: v for k, v in os.environ.items() if k not in _GANG_ENV}
    path = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env.update(PYTHONPATH=os.pathsep.join([_ROOT] + path),
               OMP_NUM_THREADS="1",
               TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port or free_port()}",
               TPU_NUM_PROCESSES=str(devices),
               TPU_SLOTS_PER_WORKER=str(devices),
               TPU_STATUS_PORT=str(free_port()))
    if fault:
        env["TPU_FAULT_INJECT"] = fault
    if reshard:
        env["TPU_RESHARD_RESTORE"] = "1"
    return env


def _run_phase(train_dir: str, devices: int, batch_per_device: int,
               port: Optional[int], stop_at_step: int, seq_len: int,
               log_path: str, fault: Optional[str] = None,
               reshard: bool = True, device: str = "cuda",
               timeout: float = 900.0) -> Tuple[int, float]:
    """One phase: the LM CLI as a gang of `devices` worker processes and
    the launcher (which mirrors rank 0's exit through its status channel,
    so rank 0 exits as soon as the launcher has read it); returns (the
    gang's exit code: the first non-zero one, as mpirun's, else 0; wall
    seconds). Rank 0's output goes to `log_path`, rank r's to
    `<log_path>.<r>`, the launcher's to `<log_path>.launcher`."""
    cmd = [sys.executable, "-m",
           "mpi_operator_tpu_torch.examples.lm_benchmark",
           "--workload", "gpt2", "--size", "test",
           "--batch-per-device", str(batch_per_device),
           "--seq-len", str(seq_len),
           "--warmup-steps", "1", "--num-steps", "50",
           "--stop-at-step", str(stop_at_step), "--stop-check-every", "1",
           "--train-dir", train_dir]
    # the card: the CLI's defaults (bf16, flash); the CPU: f32, dense
    cmd += ["--dtype", "float32", "--device", "cpu"] if device == "cpu" \
        else ["--dtype", "bfloat16", "--attention", "flash"]
    env = _phase_env(devices, port, fault, reshard)
    t0 = time.time()
    roles = [{"TPU_WORKER_ID": str(r)} for r in range(devices)] + [
        {"TPU_LAUNCHER": "1"}]
    files = [open(log_path if r == 0 else f"{log_path}.{r}", "w",
                  encoding="utf-8") for r in range(devices)] + [
        open(f"{log_path}.launcher", "w", encoding="utf-8")]
    procs = []
    try:
        for role, f in zip(roles, files):
            procs.append(subprocess.Popen(
                cmd, cwd=_ROOT, env={**env, **role}, stdout=f,
                stderr=subprocess.STDOUT))
        deadline = time.time() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    rc = next((p.returncode for p in procs if p.returncode), 0)
    return rc, round(time.time() - t0, 3)


def _headline(log_path: str) -> Dict:
    """Last parseable {"metric": ...} JSON line of a phase log."""
    out: Dict = {}
    try:
        with open(log_path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line.startswith("{"):
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and "metric" in rec:
                    out = rec
    except OSError:
        pass
    return out


def run_elastic_benchmark(out_dir: Optional[str] = None,
                          stop_at_step: int = 14,
                          resize_at: Tuple[int, int] = (5, 10),
                          port: Optional[int] = None, seq_len: int = 16,
                          oracle: bool = True, device: str = "cuda",
                          log=print) -> Dict:
    """The benchmark (module docstring); `port` None picks free ports.
    Returns the result dict (`ok` says whether every gate held)."""
    require_device(device)
    from ..telemetry import EventLog, read_events, events as tev
    from ..telemetry.collector import (goodput_ledger, ledger_lines,
                                       merge_timeline, resize_ledger,
                                       resize_lines)

    tmp = None
    if out_dir is None:
        tmp = out_dir = tempfile.mkdtemp(prefix="elastic_bench_")
    os.makedirs(out_dir, exist_ok=True)
    train_dir = os.path.join(out_dir, "ckpt")
    controller_log = os.path.join(out_dir, "controller.jsonl")
    job = "elastic"

    result: Dict = {"metric": "gpt2_elastic_resize_seconds",
                    "unit": "seconds", "phases": [], "ok": True,
                    "device": device}

    def fail(reason: str) -> None:
        result["ok"] = False
        result.setdefault("failures", []).append(reason)
        log(f"elastic: FAIL {reason}")

    try:
        with EventLog(controller_log) as clog:
            clog.emit(tev.JOB_CREATED, job=job, tpus=PHASE_SHAPES[0][0] * 2,
                      workers=PHASE_SHAPES[0][0])
            plan = [
                # (shape, fault step, expected rc)
                (PHASE_SHAPES[0], resize_at[0], 215),
                (PHASE_SHAPES[1], resize_at[1], 215),
                (PHASE_SHAPES[2], None, 0),
            ]
            for idx, ((devices, bpd), fault_step, want_rc) in enumerate(plan):
                fault = (f"sigterm-at-step:{fault_step}"
                         if fault_step is not None else None)
                log_path = os.path.join(out_dir, f"phase{idx}.log")
                log(f"elastic: phase {idx} — {devices} rank(s) x batch {bpd}"
                    + (f", SIGTERM at step {fault_step}" if fault else
                       f", run to step {stop_at_step}"))
                rc, wall = _run_phase(train_dir, devices, bpd, port,
                                      stop_at_step, seq_len, log_path,
                                      fault=fault, reshard=idx > 0,
                                      device=device)
                result["phases"].append({"devices": devices,
                                         "batch_per_device": bpd,
                                         "rc": rc, "wall_seconds": wall})
                if rc != want_rc:
                    fail(f"phase {idx} exited {rc} (want {want_rc})")
                    break
                if fault_step is not None:
                    # the controller's side of the resize: the next
                    # phase's world size, stamped between the drain and
                    # the resharded restore
                    nxt = plan[idx + 1][0]
                    clog.emit(tev.GANG_RESIZE, job=job, workers=nxt[0],
                              tpus=nxt[0] * 2)
            else:
                clog.emit(tev.JOB_SUCCEEDED, job=job, step=stop_at_step)

        headline = _headline(os.path.join(out_dir, "phase2.log"))
        result["final_loss"] = headline.get("final_loss")

        worker_log = os.path.join(train_dir, "events.jsonl")
        sources = [(None, read_events(controller_log))]
        if os.path.exists(worker_log):
            sources.append(("worker-0", read_events(worker_log)))
        timeline_path = os.path.join(out_dir, "timeline.jsonl")
        merged = merge_timeline(sources, out_path=timeline_path)
        result["timeline"] = timeline_path
        ledger = goodput_ledger(merged)
        result["goodput"] = round(ledger["goodput"], 4)
        result["useful_steps"] = ledger["useful_steps"]
        result["lost_steps"] = ledger["lost_steps"]
        resizes = resize_ledger(merged)
        result["resizes"] = resizes
        totals = [r["total_seconds"] for r in resizes
                  if "total_seconds" in r]
        result["resize_seconds"] = totals
        result["value"] = max(totals) if totals else None
        result["resharded_restores"] = sum(
            1 for r in merged if r.get("event") == tev.CHECKPOINT_RESTORE
            and r.get("resharded"))
        metrics_path = os.path.join(out_dir, "federated.prom")
        with open(metrics_path, "w", encoding="utf-8") as fh:
            fh.write("\n".join(ledger_lines(job, ledger)
                               + resize_lines(job, resizes)) + "\n")
        result["metrics"] = metrics_path

        if result["ok"]:
            if len(totals) != 2:
                fail(f"expected 2 completed resizes in the timeline, "
                     f"got {len(totals)} ({resizes})")
            for need in ("drain_seconds", "restore_seconds",
                         "recompile_seconds"):
                if any(need not in r for r in resizes):
                    fail(f"a resize entry is missing its {need} phase")
                    break
            if result["resharded_restores"] < 2:
                fail("fewer than 2 resharded restores in the timeline — "
                     "the resize resumed through the cold path")
            if ledger["goodput"] <= 0:
                fail("zero federated goodput across the resizes")

        if oracle and result["ok"]:
            # the straight-through control: same seed, same step-keyed
            # stream, same topology as phases 1/3, never interrupted
            log(f"elastic: oracle — {PHASE_SHAPES[0][0]} rank(s) "
                f"straight to step {stop_at_step}")
            oracle_dir = os.path.join(out_dir, "oracle_ckpt")
            olog = os.path.join(out_dir, "oracle.log")
            rc, _wall = _run_phase(oracle_dir, PHASE_SHAPES[0][0],
                                   PHASE_SHAPES[0][1], port, stop_at_step,
                                   seq_len, olog, fault=None,
                                   reshard=False, device=device)
            if rc != 0:
                fail(f"oracle run exited {rc}")
            oracle_loss = _headline(olog).get("final_loss")
            result["oracle_final_loss"] = oracle_loss
            final_loss = result.get("final_loss")
            if final_loss is None or oracle_loss is None:
                fail("missing final_loss for the parity check")
            else:
                # identical tokens at every global step; only the 2-rank
                # phase's reduction order differs from the oracle's
                identical = math.isclose(final_loss, oracle_loss,
                                         rel_tol=1e-3, abs_tol=1e-4)
                result["elastic_token_identical"] = identical
                if not identical:
                    fail(f"resumed loss {final_loss} != oracle "
                         f"{oracle_loss}")
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
            result.pop("timeline", None)
            result.pop("metrics", None)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_operator_tpu_torch.examples.elastic_benchmark",
        description="out-of-process elastic gang-resize benchmark: 4 -> 2 "
                    "-> 4 ranks with the resharding restore, the "
                    "resize_seconds split, goodput continuity, and oracle "
                    "loss parity")
    parser.add_argument("--out-dir", default=None,
                        help="keep artifacts (timeline.jsonl, "
                             "federated.prom, phase logs) here; default "
                             "is a temp dir removed on exit")
    parser.add_argument("--stop-at-step", type=int, default=14)
    parser.add_argument("--resize-at", default="5,10",
                        help="global steps the two SIGTERMs land on")
    parser.add_argument("--seq-len", type=int, default=16)
    parser.add_argument("--port", type=int, default=None,
                        help="coordinator port of the phases (default: a "
                             "free one a phase)")
    parser.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                        help="where the phases' ranks run (default: the "
                             "card)")
    parser.add_argument("--no-oracle", action="store_true",
                        help="skip the straight-through control run")
    args = parser.parse_args(argv)
    resize_at = tuple(int(x) for x in args.resize_at.split(","))
    if len(resize_at) != 2 or not (0 < resize_at[0] < resize_at[1]
                                   < args.stop_at_step):
        raise SystemExit(f"--resize-at must be two ascending steps below "
                         f"--stop-at-step, got {args.resize_at!r}")
    result = run_elastic_benchmark(
        out_dir=args.out_dir, stop_at_step=args.stop_at_step,
        resize_at=resize_at, port=args.port, seq_len=args.seq_len,
        oracle=not args.no_oracle, device=args.device,
        log=lambda s: print(s, file=sys.stderr))
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())


__all__ = ["PHASE_SHAPES", "main", "run_elastic_benchmark"]
