"""Fleet-scheduler benchmark: preempt-to-admit, grow-back, loss parity.
The counterpart of `mpi_operator_tpu/examples/sched_benchmark.py`.

Plays both sides of a two-job fleet on a pool of 4 "devices", out of
process, with the port's REAL policy object (controller/scheduler.py
FleetScheduler) making every decision — the phases below only actuate
what plan() returns, they never hardcode the shrink. A device is a rank:
each phase is the port's LM CLI as a gang of processes
(examples/elastic_benchmark.py `_run_phase`), on the card by default
(raising without one) or with `device="cpu"` on the CPU.

  pool      4 devices, one slice pool
  lo        priority 0, elastic, wants 4 devices (batch 2/device)
  hi        priority 1, wants 2 devices — arrives while lo holds the
            whole pool and queues (sched_queue)

  plan #1   FleetScheduler preempts lo 4 -> 2 for hi (sched_preempt)
  phase 0   lo at 4 devices — SIGTERM mid-run (drain -> emergency
            checkpoint -> exit 215): the shrink's drain
  phase 1   lo at 2 devices, batch 4/device (global batch invariant),
            resharded restore; hi admitted (sched_admit) and runs SOLO
            at 2 devices to completion — 2 + 2 fills the pool exactly
  plan #2   hi done frees its chips; FleetScheduler grows lo back
            (sched_grow_back), phase 1's SIGTERM is that drain
  phase 2   lo at 4 devices again, resharded restore, runs to
            --stop-at-step and exits 0

Gates: lo's final loss must be token-identical to a straight-through
4-device oracle (same seed, step-keyed stream — the scheduler cost the
job time, never data); hi's must match its own solo oracle; the merged
timeline must carry the sched_* decision records; and the postmortem
must render a "scheduler actions:" section pairing the preempt's
predicted cost against the measured resize total.

    python -m mpi_operator_tpu_torch.examples.sched_benchmark \
        --out-dir /tmp/sched [--no-oracle] [--device cpu]

Prints one JSON line; exit 0 iff every gate held.
"""
from __future__ import annotations

import argparse
import io
import json
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from .elastic_benchmark import _headline, _run_phase, require_device
from ..controller.scheduler import FleetScheduler, SchedJob

#: one slice pool, in device units — lo fills it, hi needs half
POOL_DEVICES = 4
LO_SHAPES: Tuple[Tuple[int, int], ...] = ((4, 2), (2, 4), (4, 2))
HI_SHAPE: Tuple[int, int] = (2, 2)


def run_sched_benchmark(out_dir: Optional[str] = None,
                        stop_at_step: int = 14,
                        resize_at: Tuple[int, int] = (5, 10),
                        hi_steps: int = 6,
                        port: Optional[int] = None, seq_len: int = 16,
                        oracle: bool = True, device: str = "cuda",
                        log=print) -> Dict:
    """The benchmark (module docstring); `port` None picks free ports
    (else port .. port + 3). Returns the result dict (`ok` says whether
    every gate held)."""
    require_device(device)
    from .. import postmortem
    from ..telemetry import EventLog, read_events, events as tev
    from ..telemetry.collector import merge_timeline, resize_ledger

    tmp = None
    if out_dir is None:
        tmp = out_dir = tempfile.mkdtemp(prefix="sched_bench_")
    os.makedirs(out_dir, exist_ok=True)
    lo_dir = os.path.join(out_dir, "lo_ckpt")
    hi_dir = os.path.join(out_dir, "hi_ckpt")
    controller_log = os.path.join(out_dir, "controller.jsonl")

    result: Dict = {"metric": "fleet_sched_preempt_admit",
                    "unit": "bool", "phases": [], "ok": True,
                    "device": device}

    def at(offset: int) -> Optional[int]:
        return None if port is None else port + offset

    def fail(reason: str) -> None:
        result["ok"] = False
        result.setdefault("failures", []).append(reason)
        log(f"sched: FAIL {reason}")

    def lo_phase(idx: int, fault_step: Optional[int],
                 want_rc: int) -> bool:
        devices, bpd = LO_SHAPES[idx]
        fault = (f"sigterm-at-step:{fault_step}"
                 if fault_step is not None else None)
        log_path = os.path.join(out_dir, f"lo_phase{idx}.log")
        log(f"sched: lo phase {idx} — {devices} device(s) x batch {bpd}"
            + (f", SIGTERM at step {fault_step}" if fault else
               f", run to step {stop_at_step}"))
        rc, wall = _run_phase(lo_dir, devices, bpd, at(0), stop_at_step,
                              seq_len, log_path, fault=fault,
                              reshard=idx > 0, device=device)
        result["phases"].append({"job": "lo", "devices": devices,
                                 "rc": rc, "wall_seconds": wall})
        if rc != want_rc:
            fail(f"lo phase {idx} exited {rc} (want {want_rc})")
            return False
        return True

    # the REAL policy object decides; the phases below just actuate
    sched = FleetScheduler(pool_chips=POOL_DEVICES,
                           cooldown_floor_seconds=0.0)

    try:
        with EventLog(controller_log) as clog:
            clog.emit(tev.JOB_CREATED, job="lo", workers=LO_SHAPES[0][0])
            clog.emit(tev.JOB_CREATED, job="hi", workers=HI_SHAPE[0])

            now = time.time()
            lo_job = SchedJob(name="default/lo", priority=0, created=now - 60,
                              chips=LO_SHAPES[0][0],
                              held_chips=LO_SHAPES[0][0], elastic=True,
                              shrink_ladder=(LO_SHAPES[1][0],))
            hi_job = SchedJob(name="default/hi", priority=1, created=now - 1,
                              chips=HI_SHAPE[0], pending=True,
                              queued_since=now - 1)
            clog.emit(tev.SCHED_QUEUE, job="hi", priority=1,
                      reason=f"waiting for {HI_SHAPE[0]} free device(s)")
            plan1 = sched.plan(now, [lo_job, hi_job])
            d = plan1.action
            if d is None or d.action != "preempt" \
                    or d.to_chips != LO_SHAPES[1][0]:
                fail(f"plan #1 did not preempt lo to {LO_SHAPES[1][0]} "
                     f"devices (got {d})")
                raise RuntimeError("policy gate failed")
            clog.emit(tev.SCHED_PREEMPT, job="lo", victim=d.victim,
                      beneficiary=d.beneficiary, from_tpus=d.from_chips,
                      to_tpus=d.to_chips,
                      predicted_cost_seconds=d.predicted_cost_seconds)
            result["plan1"] = {"action": d.action, "victim": d.victim,
                              "beneficiary": d.beneficiary,
                              "to_chips": d.to_chips}

            # phase 0: the preempt's drain (SIGTERM -> emergency ckpt)
            if not lo_phase(0, resize_at[0], 215):
                raise RuntimeError("phase gate failed")
            clog.emit(tev.GANG_RESIZE, job="lo", workers=LO_SHAPES[1][0])
            clog.emit(tev.SCHED_ADMIT, job="hi", via="preempt",
                      waited_seconds=round(time.time() - hi_job.queued_since,
                                           3))

            # phase 1: lo shrunk to 2 devices while hi runs solo at 2 —
            # 2 + 2 fills the pool; phase 1's SIGTERM is the grow-back
            # drain plan #2 will justify below
            if not lo_phase(1, resize_at[1], 215):
                raise RuntimeError("phase gate failed")
            hi_log = os.path.join(out_dir, "hi.log")
            log(f"sched: hi — {HI_SHAPE[0]} device(s) solo to step "
                f"{hi_steps}")
            rc, wall = _run_phase(hi_dir, HI_SHAPE[0], HI_SHAPE[1],
                                  at(1), hi_steps, seq_len, hi_log,
                                  fault=None, reshard=False, device=device)
            result["phases"].append({"job": "hi", "devices": HI_SHAPE[0],
                                     "rc": rc, "wall_seconds": wall})
            if rc != 0:
                fail(f"hi exited {rc} (want 0)")
                raise RuntimeError("phase gate failed")
            clog.emit(tev.JOB_SUCCEEDED, job="hi", step=hi_steps)

            # hi's chips are free again: plan #2 must grow lo back
            now = time.time()
            lo_job.held_chips = LO_SHAPES[1][0]
            lo_job.sched_tpus = LO_SHAPES[1][0]
            lo_job.sched_scaled_at = now - 60
            hi_job.pending = False
            hi_job.done = True
            plan2 = sched.plan(now, [lo_job, hi_job])
            d = plan2.action
            if d is None or d.action != "grow_back":
                fail(f"plan #2 did not grow lo back (got {d})")
                raise RuntimeError("policy gate failed")
            clog.emit(tev.SCHED_GROW_BACK, job="lo",
                      from_tpus=d.from_chips, to_tpus=d.to_chips)
            result["plan2"] = {"action": d.action,
                              "to_chips": d.to_chips}
            clog.emit(tev.GANG_RESIZE, job="lo", workers=LO_SHAPES[2][0])

            if not lo_phase(2, None, 0):
                raise RuntimeError("phase gate failed")
            clog.emit(tev.JOB_SUCCEEDED, job="lo", step=stop_at_step)
    except RuntimeError:
        pass  # a gate already called fail(); fall through to report
    else:
        result["final_loss"] = _headline(
            os.path.join(out_dir, "lo_phase2.log")).get("final_loss")
        result["hi_final_loss"] = _headline(
            os.path.join(out_dir, "hi.log")).get("final_loss")

        worker_log = os.path.join(lo_dir, "events.jsonl")
        sources = [(None, read_events(controller_log))]
        if os.path.exists(worker_log):
            sources.append(("lo-worker-0", read_events(worker_log)))
        timeline_path = os.path.join(out_dir, "timeline.jsonl")
        merged = merge_timeline(sources, out_path=timeline_path)
        result["timeline"] = timeline_path
        resizes = resize_ledger(merged)
        totals = [r["total_seconds"] for r in resizes
                  if "total_seconds" in r]
        result["resize_seconds"] = totals
        if len(totals) != 2:
            fail(f"expected 2 completed resizes (shrink + grow-back), "
                 f"got {len(totals)}")
        result["resharded_restores"] = sum(
            1 for r in merged if r.get("event") == tev.CHECKPOINT_RESTORE
            and r.get("resharded"))
        if result["resharded_restores"] < 2:
            fail("fewer than 2 resharded restores — a resize resumed "
                 "through the cold path")

        # the postmortem must tell the scheduler's story from the one
        # file the run leaves behind
        summary = postmortem.summarize(merged)
        actions = summary.get("scheduler_actions") or []
        result["scheduler_actions"] = [a["event"] for a in actions]
        for need in (tev.SCHED_QUEUE, tev.SCHED_PREEMPT, tev.SCHED_ADMIT,
                     tev.SCHED_GROW_BACK):
            if not any(a["event"] == need for a in actions):
                fail(f"postmortem scheduler_actions missing {need}")
        preempts = [a for a in actions if a["event"] == tev.SCHED_PREEMPT]
        if preempts and "measured_cost_seconds" not in preempts[0]:
            fail("preempt action not paired with a measured resize cost")
        rendered = io.StringIO()
        postmortem.render(summary, rendered)
        text = rendered.getvalue()
        pm_path = os.path.join(out_dir, "postmortem.txt")
        with open(pm_path, "w", encoding="utf-8") as fh:
            fh.write(text)
        result["postmortem"] = pm_path
        if "scheduler actions:" not in text:
            fail("postmortem render has no 'scheduler actions:' section")

        if oracle and result["ok"]:
            # straight-through controls: the scheduler may cost a job
            # TIME, never data — both losses must match solo runs
            log(f"sched: lo oracle — {LO_SHAPES[0][0]} device(s) straight "
                f"to step {stop_at_step}")
            lo_olog = os.path.join(out_dir, "lo_oracle.log")
            rc, _w = _run_phase(os.path.join(out_dir, "lo_oracle_ckpt"),
                                LO_SHAPES[0][0], LO_SHAPES[0][1], at(2),
                                stop_at_step, seq_len, lo_olog,
                                fault=None, reshard=False, device=device)
            if rc != 0:
                fail(f"lo oracle exited {rc}")
            log(f"sched: hi oracle — {HI_SHAPE[0]} device(s) straight "
                f"to step {hi_steps}")
            hi_olog = os.path.join(out_dir, "hi_oracle.log")
            rc, _w = _run_phase(os.path.join(out_dir, "hi_oracle_ckpt"),
                                HI_SHAPE[0], HI_SHAPE[1], at(3),
                                hi_steps, seq_len, hi_olog,
                                fault=None, reshard=False, device=device)
            if rc != 0:
                fail(f"hi oracle exited {rc}")
            for job, got, olog in (
                    ("lo", result.get("final_loss"), lo_olog),
                    ("hi", result.get("hi_final_loss"), hi_olog)):
                want = _headline(olog).get("final_loss")
                result[f"{job}_oracle_final_loss"] = want
                if got is None or want is None:
                    fail(f"missing {job} final_loss for the parity check")
                    continue
                identical = math.isclose(got, want, rel_tol=1e-3,
                                         abs_tol=1e-4)
                result[f"{job}_token_identical"] = identical
                if not identical:
                    fail(f"{job} resumed loss {got} != solo oracle {want}")
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
            result.pop("timeline", None)
            result.pop("postmortem", None)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_operator_tpu_torch.examples.sched_benchmark",
        description="out-of-process fleet-scheduler smoke: priority "
                    "preempt-to-admit, grow-back after completion, solo "
                    "oracle loss parity for both jobs, postmortem "
                    "scheduler-actions render")
    parser.add_argument("--out-dir", default=None,
                        help="keep artifacts (timeline.jsonl, "
                             "postmortem.txt, phase logs) here; default "
                             "is a temp dir removed on exit")
    parser.add_argument("--stop-at-step", type=int, default=14)
    parser.add_argument("--resize-at", default="5,10",
                        help="global steps the shrink/grow SIGTERMs land on")
    parser.add_argument("--hi-steps", type=int, default=6,
                        help="steps the high-priority job runs")
    parser.add_argument("--seq-len", type=int, default=16)
    parser.add_argument("--port", type=int, default=None,
                        help="base coordinator port (uses port..port+3; "
                             "default: free ones)")
    parser.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                        help="where the phases' ranks run (default: the "
                             "card)")
    parser.add_argument("--no-oracle", action="store_true",
                        help="skip the straight-through control runs")
    args = parser.parse_args(argv)
    resize_at = tuple(int(x) for x in args.resize_at.split(","))
    if len(resize_at) != 2 or not (0 < resize_at[0] < resize_at[1]
                                   < args.stop_at_step):
        raise SystemExit(f"--resize-at must be two ascending steps below "
                         f"--stop-at-step, got {args.resize_at!r}")
    result = run_sched_benchmark(
        out_dir=args.out_dir, stop_at_step=args.stop_at_step,
        resize_at=resize_at, hi_steps=args.hi_steps, port=args.port,
        seq_len=args.seq_len, oracle=not args.no_oracle,
        device=args.device, log=lambda s: print(s, file=sys.stderr))
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())


__all__ = ["run_sched_benchmark", "POOL_DEVICES", "LO_SHAPES",
           "HI_SHAPE", "main"]
