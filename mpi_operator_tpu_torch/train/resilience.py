"""Preemption-tolerant training runtime.

The counterpart of `mpi_operator_tpu/train/resilience.py`. The control
plane restarts a gang whose workers exit in the 128-255 band, so this
module gives the data plane something worth restarting:

  * PreemptionListener — SIGTERM/SIGUSR1 set a local flag (preemptions
    deliver SIGTERM with a grace window; SIGUSR1 is the manual drain
    channel). The flag is only a local fact.
  * gang_should_stop — folds the local flags into one replicated stop
    bit (an all_reduce MAX under torch.distributed), so every rank exits
    at the SAME step boundary.
  * guard_nonfinite_update — in-step divergence defense: a step whose
    loss or global grad-norm is non-finite applies NO update and an
    on-device skip streak increments; K consecutive skips escalate to a
    rollback from the last checkpoint (ResilienceContext.rollback).
  * Watchdog — a per-step deadline thread: a hung step dumps every
    thread's stack and aborts with WATCHDOG_STALL_EXIT.
  * FaultInjector — TPU_FAULT_INJECT=... test knobs (die-at-step,
    sigterm-at-step, corrupt-latest-checkpoint, delay-coordinator,
    nan-replica) so the tests can prove kill -> restart -> resume
    without real preemptions.

ResilienceContext bundles all of it behind the single `on_step` call the
benchmark loop makes per step. The environment variable names are the
controller's contract with the worker and keep the reference's names.
"""
from __future__ import annotations

import faulthandler
import os
import re
import signal
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

# the drain budget and the cadence it implies live in a module without
# torch, which the postmortem CLI imports in the operator's image
from ..telemetry.drain import (  # noqa: F401
    DRAIN_TARGET_SECONDS, ENV_DRAIN_TARGET, suggest_stop_check_every,
)

#: env var holding the fault-injection spec (see FaultInjector)
ENV_FAULT_INJECT = "TPU_FAULT_INJECT"
#: env var default for ResilienceConfig.step_deadline (seconds)
ENV_STEP_DEADLINE = "TPU_STEP_DEADLINE"
#: stop-bit cadence: an integer, or "auto" to derive it from the last
#: run's measured drain latency in <train-dir>/events.jsonl
ENV_STOP_CHECK_EVERY = "TPU_STOP_CHECK_EVERY"

# Exit codes in the controller's 128-255 "retryable" band: its ExitCode
# restart policy relaunches the gang on any of these.
PREEMPTED_EXIT = 215        # gang drained after SIGTERM/SIGUSR1
WATCHDOG_STALL_EXIT = 216   # a step blew its deadline (hung step)
FAULT_DIE_EXIT = 217        # injected hard death (die-at-step:N)


def is_retryable_exit(code: Optional[int]) -> bool:
    """The controller's ExitCode-policy predicate: None (signal-killed
    pod) and 128-255 retry; 1-127 is a workload bug."""
    return code is None or code >= 128


class Preempted(RuntimeError):
    """The gang agreed to stop; the emergency checkpoint is written.
    Entry points catch this and exit with `exit_code` (retryable band)."""

    def __init__(self, step: int, exit_code: int = PREEMPTED_EXIT):
        super().__init__(f"preempted at step {step}")
        self.step = step
        self.exit_code = exit_code


class DivergenceError(RuntimeError):
    """K consecutive non-finite steps and no checkpoint to roll back to
    (or the rollback budget is spent) — a workload failure, NOT
    retryable: restarting would replay the same divergence."""


# ---------------------------------------------------------------------------
# Preemption listener + the gang stop bit
# ---------------------------------------------------------------------------

class PreemptionListener:
    """Installs SIGTERM/SIGUSR1 handlers that set a flag; `requested`
    reads it. Previous handlers are chained (called after ours) and
    restored on uninstall. Signal handlers only install from the main
    thread — construct this there."""

    SIGNALS = (signal.SIGTERM, signal.SIGUSR1)

    def __init__(self, log: Callable[[str], None] = print):
        self._requested = False
        self._log = log
        self._prev: dict = {}

    @property
    def requested(self) -> bool:
        return self._requested

    def _handler(self, signum, frame):
        if not self._requested:
            self._log(f"preemption notice ({signal.Signals(signum).name}): "
                      f"draining at the next step boundary")
        self._requested = True
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def install(self) -> "PreemptionListener":
        for sig in self.SIGNALS:
            self._prev[sig] = signal.getsignal(sig)
            signal.signal(sig, self._handler)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):  # non-main thread / weird prev
                pass
        self._prev.clear()


def drain_latency_from_events(events_path: str
                              ) -> Tuple[Optional[float], Optional[int]]:
    """(worst drain latency, its recorded cadence) from an events.jsonl:
    each preemption_drain pairs with the next emergency_checkpoint, and
    the drain record carries the stop_check_every it ran under. (None,
    None) when no complete drain exists."""
    from ..telemetry import events as ev

    worst: Optional[float] = None
    cadence: Optional[int] = None
    open_ts: Optional[float] = None
    open_cadence: Optional[int] = None
    try:
        records = ev.read_events(events_path)
    except OSError:
        return None, None
    for rec in records:
        kind = rec.get("event")
        if kind == ev.PREEMPTION_DRAIN:
            open_ts = rec.get("ts")
            open_cadence = rec.get("stop_check_every")
        elif kind == ev.EMERGENCY_CHECKPOINT and open_ts is not None:
            latency = float(rec.get("ts", open_ts)) - float(open_ts)
            if worst is None or latency > worst:
                worst, cadence = latency, open_cadence
            open_ts = None
    return worst, (int(cadence) if cadence else None)


def auto_stop_check_every(train_dir: Optional[str],
                          default: int = 8,
                          log: Callable[[str], None] = print) -> int:
    """TPU_STOP_CHECK_EVERY=auto: derive the cadence from the LAST run's
    drain latency in <train_dir>/events.jsonl. Falls back to `default`
    when no drain has been measured yet."""
    if not train_dir:
        return default
    path = os.path.join(os.path.abspath(train_dir), "events.jsonl")
    if not os.path.exists(path):
        return default
    worst, cadence = drain_latency_from_events(path)
    if worst is None:
        return default
    suggested = suggest_stop_check_every(worst, cadence or default)
    if suggested is None:
        return default
    log(f"stop-check cadence auto-tuned to {suggested} (last drain "
        f"{worst:.2f}s at cadence {cadence or default})")
    return suggested


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def gang_should_stop(local: bool) -> bool:
    """Replicated stop decision: True iff ANY rank requested a stop.

    With torch.distributed initialized over more than one rank this is a
    collective (every rank MUST call it at the same step —
    ResilienceContext.on_step guarantees that with a fixed cadence): an
    all_reduce MAX of an int32 flag, on the card under NCCL and on the
    CPU otherwise. A single process returns the local flag with no
    device work."""
    if _world_size() == 1:
        return bool(local)
    device = "cpu"
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    flag = torch.tensor([1 if local else 0], dtype=torch.int32,
                        device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(int(flag.item()))


# ---------------------------------------------------------------------------
# Divergence guard (in-step side)
# ---------------------------------------------------------------------------

def guard_nonfinite_update(updates: Iterable[Tuple[torch.Tensor,
                                                   torch.Tensor]],
                           loss: torch.Tensor, grad_norm: torch.Tensor,
                           streak: torch.Tensor) -> torch.Tensor:
    """For each (old, new) pair: old <- new in place when `loss` and
    `grad_norm` are finite, else old keeps its value. Returns the new
    streak: 0 after a finite step, `streak` + 1 after a skipped one. Runs
    on the device with no host sync; the trainer's step counter still
    advances (a skipped step is a no-op update, not a rewind)."""
    ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
    for old, new in updates:
        torch.where(ok, new, old, out=old)
    return torch.where(ok, torch.zeros_like(streak), streak + 1)


# ---------------------------------------------------------------------------
# Watchdog
# ---------------------------------------------------------------------------

class Watchdog:
    """Per-step deadline: `pet()` after every step; a daemon thread that
    sees `deadline` seconds without a pet dumps EVERY thread's stack
    (faulthandler) and aborts the process with WATCHDOG_STALL_EXIT —
    "the job hung" becomes "this rank stalled here, restart me".
    `abort` is injectable for tests."""

    def __init__(self, deadline: float,
                 exit_code: int = WATCHDOG_STALL_EXIT,
                 log: Callable[[str], None] = print,
                 abort: Optional[Callable[[int], None]] = None,
                 poll: Optional[float] = None):
        self.deadline = float(deadline)
        self.exit_code = exit_code
        self._log = log
        self._abort = abort if abort is not None else self._default_abort
        self._poll = poll if poll is not None else min(
            max(self.deadline / 4.0, 0.05), 5.0)
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _default_abort(code: int) -> None:
        # os._exit, not sys.exit: the main thread is stuck and will never
        # run exception handlers
        os._exit(code)

    def pet(self) -> None:
        self._last = time.monotonic()

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._last = time.monotonic()
            self._thread = threading.Thread(
                target=self._run, name="step-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            stalled = time.monotonic() - self._last
            if stalled > self.deadline:
                self._log(f"watchdog: step exceeded {self.deadline:.1f}s "
                          f"deadline ({stalled:.1f}s since last step); "
                          f"dumping stacks, aborting with exit code "
                          f"{self.exit_code}")
                try:
                    faulthandler.dump_traceback(file=sys.stderr,
                                                all_threads=True)
                except (OSError, ValueError, RuntimeError):  # best-effort
                    pass
                self._abort(self.exit_code)
                return


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------

def corrupt_latest_checkpoint(directory: str) -> Optional[str]:
    """Scribble garbage over every file of the NEWEST committed step_N —
    the directory still looks committed but restore raises, exercising
    the read-side fallback to the previous step. Returns the corrupted
    path, or None when nothing to corrupt."""
    from .checkpoint import checkpoint_steps, wait_for_checkpoints

    wait_for_checkpoints()
    directory = os.path.abspath(directory)
    steps = checkpoint_steps(directory)
    if not steps:
        return None
    path = os.path.join(directory, f"step_{max(steps)}")
    for root, _dirs, files in os.walk(path):
        for name in files:
            with open(os.path.join(root, name), "wb") as fh:
                fh.write(b"\x00corrupted-by-fault-injection\x00")
    return path


class FaultInjector:
    """Parsed TPU_FAULT_INJECT spec — ';'/',' separated directives:

      die-at-step:N             os._exit(FAULT_DIE_EXIT) after step N
                                (hard death: no emergency checkpoint)
      sigterm-at-step:N         SIGTERM to self after step N (the
                                graceful preemption drill)
      corrupt-latest-checkpoint scribble the newest step_N before resume
      delay-coordinator:K       first K distributed-init attempts fail
                                (the bootstrap's, bootstrap/bootstrap.py)
      nan-replica:K@N           poison fused-trainer replica K at step N
                                (parsed for HFTA, ROADMAP step 10e)

    Unknown directives raise at parse time — a typo'd fault spec that
    silently injects nothing would green a test that proved nothing."""

    def __init__(self, spec: str = ""):
        #: telemetry.EventLog — when set (ResilienceContext wires its
        #: own), step faults leave a durable `fault_injected` record
        #: BEFORE the kill: a hard death writes no checkpoint, so this
        #: record is the only evidence of how far the run got
        self.events = None
        self.die_at_step: Optional[int] = None
        self.sigterm_at_step: Optional[int] = None
        self.corrupt_latest = False
        self.delay_coordinator = 0
        self.nan_replica: Optional[int] = None
        self.nan_replica_step: Optional[int] = None
        self._injected_init_failures = 0
        for raw in re.split(r"[;,]", spec or ""):
            part = raw.strip()
            if not part:
                continue
            name, _, arg = part.partition(":")
            if name == "die-at-step":
                self.die_at_step = int(arg)
            elif name == "sigterm-at-step":
                self.sigterm_at_step = int(arg)
            elif name == "corrupt-latest-checkpoint":
                self.corrupt_latest = True
            elif name == "delay-coordinator":
                self.delay_coordinator = int(arg)
            elif name == "nan-replica":
                replica, _, at = arg.partition("@")
                self.nan_replica = int(replica)
                self.nan_replica_step = int(at)
            else:
                raise ValueError(
                    f"unknown {ENV_FAULT_INJECT} directive {part!r}; known: "
                    f"die-at-step:N, sigterm-at-step:N, "
                    f"corrupt-latest-checkpoint, delay-coordinator:K, "
                    f"nan-replica:K@N")

    @classmethod
    def from_env(cls, env=None) -> Optional["FaultInjector"]:
        env = os.environ if env is None else env
        spec = env.get(ENV_FAULT_INJECT, "")
        return cls(spec) if spec else None

    def check_step(self, step: int) -> bool:
        """Fire any step-indexed fault; returns True when a graceful stop
        was injected THIS call (the caller treats it like a delivered
        preemption signal, deterministically)."""
        if self.die_at_step is not None and step >= self.die_at_step:
            self._emit_fault("die", step)
            os._exit(FAULT_DIE_EXIT)
        if self.sigterm_at_step is not None and step >= self.sigterm_at_step:
            self.sigterm_at_step = None        # one shot
            self._emit_fault("sigterm", step)
            os.kill(os.getpid(), signal.SIGTERM)
            return True
        return False

    def _emit_fault(self, fault: str, step: int) -> None:
        """The drill leaves evidence: one fsync'd record before the kill."""
        if self.events is not None:
            from ..telemetry import events as ev
            self.events.emit(ev.FAULT_INJECTED, fault=fault, step=int(step))

    def check_nan_replica(self, step: int) -> Optional[int]:
        """One-shot nan-replica:K@N probe — the replica index to poison
        once `step` has reached the trigger, else None."""
        if (self.nan_replica_step is not None
                and step >= self.nan_replica_step):
            self.nan_replica_step = None       # one shot
            return self.nan_replica
        return None

    def maybe_corrupt_checkpoint(self, train_dir: Optional[str],
                                 log: Callable[[str], None] = print
                                 ) -> Optional[str]:
        if not (self.corrupt_latest and train_dir):
            return None
        self.corrupt_latest = False            # one shot
        path = corrupt_latest_checkpoint(train_dir)
        if path:
            log(f"fault-inject: corrupted {path}")
        return path

    def fail_init_attempt(self) -> bool:
        """delay-coordinator budget: consume and report one injected
        distributed-init failure."""
        if self._injected_init_failures < self.delay_coordinator:
            self._injected_init_failures += 1
            return True
        return False


# ---------------------------------------------------------------------------
# The per-loop bundle
# ---------------------------------------------------------------------------

@dataclass
class ResilienceConfig:
    train_dir: Optional[str] = None
    #: consecutive non-finite steps before rollback-from-checkpoint
    divergence_k: int = 3
    #: rollbacks allowed before giving up as a genuine divergence
    max_rollbacks: int = 2
    #: seconds a single step may take; 0 disables the watchdog
    step_deadline: float = 0.0
    #: gang stop-bit cadence (multi-process all_reduce every N steps;
    #: single-process checks the local flag every step regardless)
    stop_check_every: int = 8

    @classmethod
    def from_env(cls, env=None, **overrides) -> "ResilienceConfig":
        env = os.environ if env is None else env
        # a None override means "caller didn't specify": env/default apply
        overrides = {k: v for k, v in overrides.items() if v is not None}
        if "step_deadline" not in overrides and env.get(ENV_STEP_DEADLINE):
            overrides["step_deadline"] = float(env[ENV_STEP_DEADLINE])
        if ("stop_check_every" not in overrides
                and env.get(ENV_STOP_CHECK_EVERY)):
            raw = str(env[ENV_STOP_CHECK_EVERY]).strip()
            if raw.lower() == "auto":
                overrides["stop_check_every"] = auto_stop_check_every(
                    overrides.get("train_dir"))
            else:
                overrides["stop_check_every"] = int(raw)
        return cls(**overrides)


class ResilienceContext:
    """One per training run; use as a context manager around the loop.

    Per step the loop calls `on_step(step)` — fault hooks fire, the
    watchdog is petted, and the gang stop bit is evaluated; True means
    "drain now": the loop writes the emergency checkpoint
    (`emergency_save`) and raises Preempted. At window fetches the loop
    reads the on-device skip streak and calls `rollback` when it
    reaches divergence_k.
    """

    def __init__(self, config: Optional[ResilienceConfig] = None,
                 log: Callable[[str], None] = print,
                 listener: Optional[PreemptionListener] = None,
                 faults: Optional[FaultInjector] = None,
                 watchdog: Optional[Watchdog] = None,
                 events=None, telemetry=None):
        self.config = config or ResilienceConfig()
        self.log = log
        self.listener = (listener if listener is not None
                         else PreemptionListener(log))
        self.faults = faults if faults is not None else FaultInjector.from_env()
        if watchdog is None and self.config.step_deadline > 0:
            watchdog = Watchdog(self.config.step_deadline, log=log)
        self.watchdog = watchdog
        #: telemetry.EventLog — every emit is fsync'd before it returns,
        #: which is what lets emergency_save promise the drain is on disk
        #: before exit(215)
        self.events = events
        #: telemetry.TrainTelemetry — rollback accounting feeds goodput
        self.telemetry = telemetry
        if self.faults is not None and self.faults.events is None:
            self.faults.events = events
        self._pending_stop = False
        self._rollbacks = 0
        # record_restore arms these; the next on_step emits
        # FIRST_RESUME_STEP (restore done -> first step completed)
        self._resume_ts: Optional[float] = None
        self._resume_step = 0

    def __enter__(self) -> "ResilienceContext":
        self.listener.install()
        # the watchdog arms on the FIRST on_step call, not here: the
        # deadline budgets a steady-state step, not set-up
        if self.faults is not None:
            self.faults.maybe_corrupt_checkpoint(self.config.train_dir,
                                                 self.log)
        return self

    def __exit__(self, *exc) -> None:
        # flush the event log BEFORE any teardown that could hang: on the
        # Preempted unwind the entry point exits 215 next
        if self.events is not None:
            self.events.flush()
        if self.watchdog is not None:
            self.watchdog.stop()
        self.listener.uninstall()

    # -- the hot-path call ---------------------------------------------------

    def on_step(self, step: int) -> bool:
        if self._resume_ts is not None and step > self._resume_step:
            seconds = round(time.time() - self._resume_ts, 3)
            self._resume_ts = None
            if self.events is not None:
                from ..telemetry import events as ev
                self.events.emit(ev.FIRST_RESUME_STEP, step=int(step),
                                 seconds=seconds)
            if self.telemetry is not None:
                self.telemetry.resume_step_seconds.set(seconds)
        local = False
        if self.faults is not None:
            local = self.faults.check_step(step)
        if self.watchdog is not None:
            self.watchdog.start()       # idempotent; arms on first step
            self.watchdog.pet()
        local = local or self.listener.requested
        if _world_size() == 1:
            return local
        # multi-process: the all_reduce is a collective, so it must run
        # at the SAME steps on every rank — fixed cadence, local flag
        # carried to the next boundary
        self._pending_stop = self._pending_stop or local
        if step % max(1, self.config.stop_check_every) != 0:
            return False
        stop = gang_should_stop(self._pending_stop)
        self._pending_stop = False
        return stop

    # -- drain / rollback ----------------------------------------------------

    def emergency_save(self, state) -> None:
        """The final SYNCHRONOUS checkpoint before a preemption exit —
        blocks until committed. `preemption_drain` is fsync'd to the
        event log BEFORE the save starts (a write that dies mid-flight
        still leaves evidence of why the process exited);
        `emergency_checkpoint` lands after the commit."""
        from .checkpoint import maybe_save

        step = int(state.step)
        if self.events is not None:
            from ..telemetry import events as ev
            self.events.emit(ev.PREEMPTION_DRAIN, step=step,
                             stop_check_every=self.config.stop_check_every)
        maybe_save(self.config.train_dir, state, self.log)
        if self.events is not None:
            self.events.emit(ev.EMERGENCY_CHECKPOINT, step=step,
                             train_dir=self.config.train_dir)
        if self.telemetry is not None:
            self.telemetry.last_checkpoint_step.set(step)
            self.telemetry.step.set(step)

    # -- restart-aware goodput bookkeeping -----------------------------------

    def record_restore(self, step: int, path: Optional[str] = None,
                       seconds: Optional[float] = None,
                       leaves: Optional[int] = None,
                       resharded: Optional[bool] = None) -> None:
        """Report the step this incarnation restored from (0 = a fresh
        start, no event). The controller charges (last observed step −
        restore step) to the lost column of the job goodput ledger, so
        the restore step must be durable in the event log."""
        step = int(step)
        if step > 0 and self.events is not None:
            from ..telemetry import events as ev
            fields = {"step": step}
            if path:
                fields["path"] = path
            if seconds is not None:
                fields["seconds"] = round(float(seconds), 3)
            if leaves is not None:
                fields["leaves"] = int(leaves)
            if resharded is not None:
                fields["resharded"] = bool(resharded)
            self.events.emit(ev.CHECKPOINT_RESTORE, **fields)
        if step > 0:
            self._resume_ts = time.time()
            self._resume_step = step
        if self.telemetry is not None:
            self.telemetry.restore_step.set(step)
            if seconds is not None:
                self.telemetry.restore_seconds.set(round(float(seconds), 3))
            if step > 0:
                self.telemetry.last_checkpoint_step.set(step)
                self.telemetry.step.set(step)

    def record_checkpoint(self, step: int) -> None:
        """Report a durable periodic checkpoint (periodic_saver hook)."""
        step = int(step)
        if self.events is not None:
            from ..telemetry import events as ev
            self.events.emit(ev.CHECKPOINT_SAVED, step=step,
                             train_dir=self.config.train_dir)
        if self.telemetry is not None:
            self.telemetry.last_checkpoint_step.set(step)

    def rollback(self, state):
        """Restore the newest intact checkpoint into `state` (in place)
        after divergence_k consecutive non-finite steps, and zero the
        on-device streak. Raises DivergenceError when nothing restorable
        remains or the rollback budget is spent — a workload bug (exit
        code 1, NOT retryable)."""
        from .checkpoint import restore_with_fallback

        self._rollbacks += 1
        if self._rollbacks > self.config.max_rollbacks:
            raise DivergenceError(
                f"diverged again after {self.config.max_rollbacks} "
                f"rollback(s) — giving up (lower the LR or inspect the "
                f"data around step {int(state.step)})")
        if not self.config.train_dir:
            raise DivergenceError(
                f"{self.config.divergence_k} consecutive non-finite steps "
                f"and no --train-dir to roll back from")
        from_step = int(state.step)
        restored, path = restore_with_fallback(self.config.train_dir, state,
                                               self.log)
        if path is None:
            raise DivergenceError(
                f"{self.config.divergence_k} consecutive non-finite steps "
                f"and no restorable checkpoint under "
                f"{self.config.train_dir!r}")
        to_step = int(restored.step)
        self.log(f"divergence rollback #{self._rollbacks}: restored {path} "
                 f"(step {to_step})")
        if self.events is not None:
            from ..telemetry import events as ev
            self.events.emit(ev.DIVERGENCE_ROLLBACK, from_step=from_step,
                             to_step=to_step, rollback=self._rollbacks,
                             path=path)
        if self.telemetry is not None:
            self.telemetry.record_rollback(max(0, from_step - to_step))
        streak = getattr(restored, "nonfinite_streak", None)
        if streak is not None:
            streak.zero_()
        return restored


__all__ = [
    "PREEMPTED_EXIT", "WATCHDOG_STALL_EXIT", "FAULT_DIE_EXIT",
    "ENV_FAULT_INJECT", "ENV_STEP_DEADLINE", "ENV_STOP_CHECK_EVERY",
    "ENV_DRAIN_TARGET", "DRAIN_TARGET_SECONDS",
    "is_retryable_exit", "suggest_stop_check_every",
    "drain_latency_from_events", "auto_stop_check_every",
    "Preempted", "DivergenceError", "PreemptionListener", "gang_should_stop",
    "guard_nonfinite_update", "Watchdog", "FaultInjector",
    "corrupt_latest_checkpoint", "ResilienceConfig", "ResilienceContext",
]
