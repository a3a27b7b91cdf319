"""LM training benchmark on one card: the flat single-device path of the
reference's `mpi_operator_tpu/examples/lm_benchmark.py::
run_lm_benchmark`, and its CLI.

`run_lm_benchmark(workload="gpt2", size="medium", batch_per_device=16,
seq_len=512)` builds the model with max_len = max(seq_len, 32), an
LMTrainer over it and the step-keyed synthetic TokenStream (or, with
`data_dir`, the `<stem>_tokens.npy` shards through NpyTokenDataset),
runs `trainer.benchmark` and, with `eval_steps`, `evaluate` on the
batches that follow. It runs on the CUDA card unless `device="cpu"`.

Preemption contract (the reference's): with `train_dir` the run resumes
from the newest intact checkpoint there, writes one every `ckpt_every`
steps (async), drains on SIGTERM/SIGUSR1 with a blocking emergency
checkpoint and `Preempted` (the CLI exits 215, retryable), and writes
its events to `<train_dir>/events.jsonl` unless `event_log`/`events`
say otherwise. The synthetic stream is step-keyed, so a run killed at
step N and resumed trains on exactly the batches the uninterrupted run
would have, and `stop_at_step` makes it finish at the same global step.

    python -m mpi_operator_tpu_torch.examples.lm_benchmark --size medium \\
        --batch-per-device 16 --train-dir /ckpt --ckpt-every 100

The arguments of the parts not ported yet (tp/pp/sp/ep meshes, MoE,
remat, BERT, a resharding restore, more than one process) raise; none
is ignored.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Dict, Optional, Tuple

import torch

from ..data.synthetic import TokenStream
from ..models.transformer import lm_config
from ..train.lm_trainer import LMTrainer, LMTrainerConfig, LMTrainState
from ..utils.device import DeviceLike, resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _worker_telemetry(metrics_port, event_log, train_dir, events, log):
    """The run's WorkerTelemetry: a /metrics server when `metrics_port`
    is given (0 = ephemeral), an event log at `event_log` or, when a
    train dir exists, `<train_dir>/events.jsonl`. `events` borrows an
    already-open log (ownership stays with the caller). Returns
    (telemetry, owns_events)."""
    from ..telemetry import EventLog, WorkerTelemetry

    owns = events is None
    if events is None:
        path = event_log or (os.path.join(train_dir, "events.jsonl")
                             if train_dir else None)
        events = EventLog(path) if path else None
    if events is not None and os.environ.get("TPU_PACK_GROUP"):
        # packed jobs share one worker process (and one event file):
        # stamp the pack group into every record
        events = events.bind(pack_group=os.environ["TPU_PACK_GROUP"])
    wtel = WorkerTelemetry(events=events)
    if metrics_port is not None:
        log(f"worker /metrics listening on port "
            f"{wtel.serve(port=metrics_port).port}")
    return wtel, owns and events is not None


def run_lm_benchmark(
    workload: str = "gpt2",
    size: Optional[str] = None,
    batch_per_device: int = 8,
    seq_len: int = 512,
    num_steps: int = 50,
    warmup_steps: int = 5,
    eval_steps: int = 0,
    dtype_name: str = "bfloat16",
    tp: int = 1,
    pp: int = 1,
    sp: int = 1,
    ep: int = 1,
    num_slices: int = 1,
    attention: str = "auto",
    remat: bool = False,
    moe_experts: int = 0,
    num_layers: Optional[int] = None,
    fused_xent: bool = False,
    accum_steps: int = 1,
    data_dir: Optional[str] = None,
    train_dir: Optional[str] = None,
    ckpt_every: int = 0,
    ckpt_keep: int = 0,
    step_deadline: float = 0.0,
    divergence_k: int = 3,
    stop_check_every: Optional[int] = None,
    stop_at_step: Optional[int] = None,
    lr_schedule: str = "linear",
    decay_steps: int = 10_000,
    lr: Optional[float] = None,
    lr_warmup_steps: Optional[int] = None,
    profile_dir: Optional[str] = None,
    metrics_port: Optional[int] = None,
    event_log: Optional[str] = None,
    events=None,
    device: DeviceLike = None,
    log: Callable[[str], None] = print,
) -> Tuple[LMTrainState, Dict[str, object]]:
    """GPT-2 / llama token-stream benchmark on one device. Parameters
    from seed 0 and the synthetic stream's batches from seed 1,
    step-keyed, as the reference's PRNGKey(0) and PRNGKey(1). Returns
    (state, metrics); raises Preempted after a drain (the emergency
    checkpoint committed) and DivergenceError when a rollback cannot
    help."""
    from ..train.checkpoint import (last_restore_info, maybe_resume,
                                    maybe_save, periodic_saver,
                                    wait_for_checkpoints)
    from ..train.resilience import ResilienceConfig, ResilienceContext

    if workload not in ("gpt2", "llama"):
        raise ValueError(f"workload={workload!r}: the port trains the "
                         f"causal LMs gpt2 and llama (bert is not ported)")
    unported = {"tp": tp > 1, "pp": pp > 1, "sp": sp > 1, "ep": ep > 1,
                "num_slices": num_slices > 1, "remat": remat,
                "moe_experts": bool(moe_experts)}
    for name, asked in unported.items():
        if asked:
            raise ValueError(f"{name}: not in the port yet (the flat "
                             f"single-device path only; ROADMAP.md Queue 1)")
    if dtype_name not in _DTYPES:
        raise ValueError(f"dtype_name={dtype_name!r}; expected one of "
                         f"{sorted(_DTYPES)}")
    dev = resolve_device(device)
    overrides = dict(dtype=_DTYPES[dtype_name], attention=attention,
                     max_len=max(seq_len, 32))
    if num_layers:
        overrides["num_layers"] = num_layers
    cfg = lm_config(f"{workload}-{size}" if size else workload, **overrides)
    opt_overrides = {}
    if lr is not None:
        opt_overrides["learning_rate"] = lr
    if lr_warmup_steps is not None:
        opt_overrides["warmup_steps"] = lr_warmup_steps
    tcfg = LMTrainerConfig(global_batch_size=batch_per_device,
                           seq_len=seq_len, fused_xent=fused_xent,
                           accum_steps=accum_steps, lr_schedule=lr_schedule,
                           decay_steps=decay_steps, **opt_overrides)
    trainer = LMTrainer(cfg, tcfg, device=dev)
    state = trainer.init_state(0)

    wtel, owns_events = _worker_telemetry(metrics_port, event_log,
                                          train_dir, events, log)
    resilience = ResilienceContext(
        ResilienceConfig.from_env(train_dir=train_dir,
                                  divergence_k=divergence_k,
                                  step_deadline=step_deadline,
                                  stop_check_every=stop_check_every),
        log=log, events=wtel.events, telemetry=wtel.train)
    # entering fires the corrupt-latest-checkpoint fault (if injected)
    # BEFORE the resume below, so the fallback path is what gets tested
    resilience.__enter__()
    try:
        state = maybe_resume(train_dir, state, log)
        resumed_step = state.step
        info = last_restore_info() if resumed_step else {}
        resilience.record_restore(resumed_step, path=info.get("path"),
                                  seconds=info.get("seconds"),
                                  leaves=info.get("leaves"),
                                  resharded=info.get("resharded"))
        if stop_at_step is not None:
            # finish at the same GLOBAL step the uninterrupted run would
            # have: warmup batches advance the step counter too
            remaining = stop_at_step - resumed_step - max(1, warmup_steps)
            if remaining < 1:
                log(f"stop_at_step={stop_at_step} already reached at "
                    f"resumed step {resumed_step}; running 1 step")
            num_steps = max(1, remaining)
        if data_dir:
            from ..data.tokenstream import NpyTokenDataset
            stream = NpyTokenDataset(data_dir, batch_per_device, seq_len,
                                     device=dev, vocab_size=cfg.vocab_size)
        else:
            stream = TokenStream(batch_per_device, seq_len, cfg.vocab_size,
                                 seed=1, start=resumed_step, device=dev)
        try:
            state, metrics = trainer.benchmark(
                state, stream, num_steps=num_steps,
                warmup_steps=warmup_steps, log=log,
                profile_dir=profile_dir,
                step_hook=periodic_saver(train_dir, ckpt_every, log,
                                         keep_last=ckpt_keep,
                                         resilience=resilience),
                resilience=resilience, telemetry=wtel.train)
            if eval_steps:
                # evaluation continues the stream past the trained batches
                ev = trainer.evaluate(state, stream, num_batches=eval_steps)
                metrics.update(ev)
                log(f"val_loss: {ev['val_loss']:.3f}  perplexity: "
                    f"{ev['perplexity']:.1f}  ({eval_steps} batches)")
        finally:
            if data_dir:
                stream.close()
        # non-blocking final save: the write overlaps the teardown; the
        # join below makes it durable before return
        maybe_save(train_dir, state, log, block=False)
        if wtel.events is not None:
            # the terminal frontier marker the goodput ledger reads
            from ..telemetry import events as tev
            wtel.events.emit(tev.RUN_COMPLETE, step=state.step)
    finally:
        resilience.__exit__(None, None, None)
        wtel.close(close_events=owns_events)
    wait_for_checkpoints()
    return state, metrics


def main(argv=None) -> int:
    """The single-process CLI, with the reference's flags for what is
    ported (the mesh, MoE, remat and BERT flags are not accepted). Exits
    0 after a complete run, 215 after a preemption drain (the emergency
    checkpoint committed), 1 on a divergence no rollback could fix; a
    watchdog stall exits 216 and an injected hard death 217 from inside
    the run."""
    parser = argparse.ArgumentParser(prog="lm-benchmark")
    parser.add_argument("--workload", default="gpt2",
                        choices=["gpt2", "llama"])
    parser.add_argument("--size", default=None,
                        help="gpt2: test|small|medium|large|xl; llama: "
                             "test|1b|7b")
    parser.add_argument("--batch-per-device", type=int, default=None)
    parser.add_argument("--seq-len", type=int, default=512)
    parser.add_argument("--num-steps", type=int, default=50)
    parser.add_argument("--warmup-steps", type=int, default=5)
    parser.add_argument("--eval-steps", type=int, default=0)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--num-layers", type=int, default=0)
    parser.add_argument("--accum-steps", type=int, default=1)
    parser.add_argument("--fused-xent", action="store_true")
    parser.add_argument("--attention", default="auto",
                        choices=["auto", "dense", "flash"])
    parser.add_argument("--data-dir", default=None,
                        help="<stem>_tokens.npy packed token shards "
                             "(data/tokenstream.py); omit for synthetic "
                             "data")
    parser.add_argument("--train-dir", default=None)
    parser.add_argument("--ckpt-every", type=int, default=0,
                        help="async checkpoint every N steps into "
                             "--train-dir (0 = final only)")
    parser.add_argument("--ckpt-keep", type=int, default=0,
                        help="retain only the newest N step_ checkpoints "
                             "(0 = keep everything)")
    parser.add_argument("--step-deadline", type=float, default=0.0,
                        help="watchdog: seconds a step may take before the "
                             "process dumps all stacks and exits 216 (0 = "
                             "off; env TPU_STEP_DEADLINE)")
    parser.add_argument("--divergence-k", type=int, default=3,
                        help="consecutive non-finite steps before rolling "
                             "back to the newest checkpoint")
    parser.add_argument("--stop-check-every", type=int, default=None,
                        help="gang stop-bit cadence in steps (more than "
                             "one process only; env TPU_STOP_CHECK_EVERY)")
    parser.add_argument("--stop-at-step", type=int, default=None,
                        help="finish at this GLOBAL step instead of "
                             "running --num-steps past the resume point")
    parser.add_argument("--lr-schedule", default="linear",
                        choices=["linear", "cosine"])
    parser.add_argument("--decay-steps", type=int, default=10_000)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--lr-warmup-steps", type=int, default=None)
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler chrome trace of the "
                             "first measurement window here")
    parser.add_argument("--metrics-port", type=int,
                        default=(int(os.environ["TPU_METRICS_PORT"])
                                 if os.environ.get("TPU_METRICS_PORT")
                                 else None),
                        help="serve worker /metrics on this port (0 = a "
                             "free port; default $TPU_METRICS_PORT)")
    parser.add_argument("--event-log", default=None,
                        help="fsync'd JSONL event log path; defaults to "
                             "<train-dir>/events.jsonl")
    parser.add_argument("--device", default=None,
                        help="'cpu' to run on the CPU (default: the card)")
    args = parser.parse_args(argv)

    procs = int(os.environ.get("TPU_NUM_PROCESSES", "1") or "1")
    if procs > 1:
        raise RuntimeError(
            f"TPU_NUM_PROCESSES={procs}: the port's trainer is single-"
            f"process (the bootstrap is ROADMAP.md Queue 1, step 7); "
            f"refusing to train alone")

    from ..telemetry import EventLog
    from ..train.resilience import DivergenceError, Preempted

    ev_path = args.event_log or (
        os.path.join(args.train_dir, "events.jsonl")
        if args.train_dir else None)
    events = EventLog(ev_path) if ev_path else None
    try:
        _state, metrics = run_lm_benchmark(
            workload=args.workload, size=args.size,
            batch_per_device=args.batch_per_device or 8,
            seq_len=args.seq_len, num_steps=args.num_steps,
            warmup_steps=args.warmup_steps, eval_steps=args.eval_steps,
            dtype_name=args.dtype, num_layers=args.num_layers or None,
            accum_steps=args.accum_steps, fused_xent=args.fused_xent,
            attention=args.attention, data_dir=args.data_dir,
            train_dir=args.train_dir, ckpt_every=args.ckpt_every,
            ckpt_keep=args.ckpt_keep, step_deadline=args.step_deadline,
            divergence_k=args.divergence_k,
            stop_check_every=args.stop_check_every,
            stop_at_step=args.stop_at_step, lr_schedule=args.lr_schedule,
            decay_steps=args.decay_steps, lr=args.lr,
            lr_warmup_steps=args.lr_warmup_steps,
            profile_dir=args.profile_dir, metrics_port=args.metrics_port,
            events=events, device=args.device)
        print(json.dumps({
            "metric": f"{args.workload}_tokens_per_sec",
            "value": round(metrics["tokens_per_sec"], 0),
            "unit": "tokens/sec",
            "final_loss": round(float(metrics["final_loss"]), 6)}))
        return 0
    except Preempted as p:
        # the emergency checkpoint is committed (the loop saves before
        # raising): exit in the retryable band so the gang restarts
        print(f"preempted: drained at step {p.step}, exiting "
              f"{p.exit_code} (retryable)")
        return p.exit_code
    except DivergenceError as exc:
        print(f"diverged: {exc}", file=sys.stderr)
        return 1
    finally:
        # the event log closes (flush + fsync) before the process exits,
        # so a preemption exit never leaves its drain record buffered
        if events is not None:
            events.close()


__all__ = ["main", "run_lm_benchmark"]


if __name__ == "__main__":
    sys.exit(main())
