"""Structured event log: fsync'd JSONL for discrete data-plane events.

The PyTorch port's own copy of mpi_operator_tpu/telemetry/events.py:
the port imports nothing of the JAX package, not even its
framework-free modules. Its logic and names are the reference's,
held to it by tests/test_torch_telemetry.py.

Metrics answer "how fast"; events answer "what happened". Preemption
drains, emergency checkpoints, divergence rollbacks, init retries, and
slot admissions are rare, discrete, and individually precious — exactly
the records a post-mortem needs after the process is already dead.

The record discipline is bench.py's mid-kill-survivable one: each event
is a single JSON line written, flushed, AND os.fsync'd before emit()
returns. A SIGKILL between two emits loses nothing; a SIGKILL in the
middle of a write can at worst truncate the LAST line. `read_events`
skips any undecodable line (counting them in DECODE_ERRORS) so a torn
tail — or a concurrent writer caught mid-record — never aborts a live
postmortem read.

Records: {"ts": <unix seconds>, "event": <kind>, ...fields}. One file
per process; the controller-side collector (telemetry/collector.py)
merges per-host files into a job timeline. Long-running sinks can cap
growth with TPU_EVENTS_MAX_BYTES (size-based rotation to .1, .2, ...;
off by default), and packed trainers stamp replica/pack_group into
every record via bind().
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

logger = logging.getLogger("mpi_operator_tpu_torch.telemetry.events")

# Event kinds. Constants, not an enum: the log is a plain-text contract
# read by shell greps (scripts/tier1.sh --resilience) and jq alike.
#
# Worker-side kinds (emitted under <train-dir>/events.jsonl):
PREEMPTION_DRAIN = "preemption_drain"
EMERGENCY_CHECKPOINT = "emergency_checkpoint"
DIVERGENCE_ROLLBACK = "divergence_rollback"
INIT_RETRY = "init_retry"
SLOT_ADMIT = "slot_admit"
SLOT_RETIRE = "slot_retire"
CHECKPOINT_RESTORE = "checkpoint_restore"
CHECKPOINT_SAVED = "checkpoint_saved"
# first step completed after a restore (resilience.ResilienceContext):
# carries seconds-since-restore, i.e. the recompile phase of a resume —
# restore_done -> first post-resume step, compile time included
FIRST_RESUME_STEP = "first_resume_step"
CLOCK_ANCHOR = "clock_anchor"
FAULT_INJECTED = "fault_injected"
REPLICA_FROZEN = "replica_frozen"
RUN_COMPLETE = "run_complete"
# disaggregated serving: one record per prefill→decode page handoff
# (serve/engine.py DisaggEngine), with pages moved/cached and seconds
KV_HANDOFF = "kv_handoff"
# a serving request blew its per-request deadline
# (EngineConfig.request_timeout): retired with finish_reason "timeout",
# slot + KV pages reclaimed through the normal retire path — carries
# request id, tokens generated, and the deadline that expired
REQUEST_TIMEOUT = "request_timeout"
# Controller-side kinds (the operator's own EventLog; stamped with a
# "job" field and merged with worker records into <job>/timeline.jsonl):
JOB_CREATED = "job_created"
GANG_RESTART = "gang_restart"
# progress lease expired (spec.progressDeadlineSeconds): a Running gang
# whose federated step frontier advanced by zero across the window —
# carries stall_seconds + last_observed_step; a GANG_RESTART (or
# job_failed with reason StuckGang) ordinarily follows
GANG_STUCK = "gang_stuck"
# partial partition: SOME worker scrapes unreachable while the reachable
# remainder's frontier still advances — a DegradedGang condition, never
# a restart (scrape flakiness alone must not kill a healthy gang).
# Carries the unreachable rank set + partitioned_ranks/total_ranks;
# a follow-up record with healed=True closes the window.
GANG_DEGRADED = "gang_degraded"
PODS_READY = "pods_ready"
FIRST_STEP_OBSERVED = "first_step_observed"
JOB_PACKED = "packed"
JOB_RESIZED = "resize"
# user-driven gang resize (spec.resize / worker-count edit): the drain ->
# rescale -> re-bootstrap cycle, distinct from the capacity-driven
# elastic JOB_RESIZED shrink above. scripts/tier1.sh --elastic greps for
# this literal.
GANG_RESIZE = "gang_resize"
# surgical decode-pool scale step (serving): ONE replica attached or
# drained while the rest of the fleet keeps serving — no checkpoint, no
# fleet recompile, so unlike GANG_RESIZE this is a single self-contained
# record, not an open/close phase pair. Carries action="attach"|"detach",
# the decode target, and the measured phase split (drain_seconds for a
# detach's graceful drain, warmup_seconds for an attach's compile pin,
# total_seconds = the goodput hole — survivors never pause, so it prices
# only the stepped replica's own transition). The resize ledger files
# these under kind="live_scale"; the autoscaler's cooldown reads the
# newest entry OF ITS OWN KIND so one expensive gang resize cannot pin
# live-scale reaction times. scripts/tier1.sh greps for this literal.
LIVE_SCALE = "live_scale"
# SLO-breach-driven autoscale decision (controller/autoscale.py): a
# persisted p99/queue breach the controller acted on. Carries the
# decision target + reason and, when the trace federation had a
# completed trace in its exemplar window, exemplar_trace= — the trace
# id of the slowest request behind the breached percentile, which the
# postmortem's "slow traces:" section renders as a hop tree
AUTOSCALE_BREACH = "autoscale_breach"
# Fleet-scheduler decisions (controller/scheduler.py). Every record
# carries the action's principals so the postmortem can explain WHY a
# gang shrank: victim/beneficiary job names, chip targets, and the
# ledger-predicted cost the gate charged.
#   sched_queue    — a job was held at admission (pool full); carries
#                    needed/free chips
#   sched_preempt  — a low-priority elastic gang was shrunk to admit a
#                    higher-priority job (victim=, beneficiary=,
#                    from_tpus=, to_tpus=, predicted_cost_seconds=)
#   sched_admit    — a queued job got in (beneficiary=, free chips,
#                    via="capacity"|"preempt")
#   sched_grow_back— a preempted gang was restored to full size
#                    (victim=, to_tpus=)
#   sched_skip     — the cost gate or hysteresis declined an otherwise
#                    legal action (reason=, predicted_cost_seconds=,
#                    reclaim_seconds=) — the anti-thrash evidence
#   sched_migrate  — a DegradedGang dark pod was deleted so the
#                    StatefulSet reschedules it (rank=, pod=,
#                    migration_count=) — distinct from gang restarts
SCHED_QUEUE = "sched_queue"
SCHED_PREEMPT = "sched_preempt"
SCHED_ADMIT = "sched_admit"
SCHED_GROW_BACK = "sched_grow_back"
SCHED_SKIP = "sched_skip"
SCHED_MIGRATE = "sched_migrate"
JOB_SUCCEEDED = "job_succeeded"
JOB_FAILED = "job_failed"

# Rotation knobs: TPU_EVENTS_MAX_BYTES caps the live file (0/unset =
# rotation off, the historical behaviour); TPU_EVENTS_KEEP is how many
# rotated generations (.1 oldest-kept ... highest newest) survive.
ENV_MAX_BYTES = "TPU_EVENTS_MAX_BYTES"
ENV_KEEP = "TPU_EVENTS_KEEP"

# Module-level tally of undecodable lines skipped by read_events since
# import — a warning counter, not an error channel: mid-file garbage is
# logged and skipped so a live read never aborts on a concurrent write.
DECODE_ERRORS = 0


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


class EventLog:
    """Append-only JSONL event sink with per-record durability."""

    def __init__(self, path: str, clock=time.time,
                 max_bytes: Optional[int] = None,
                 keep: Optional[int] = None):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._clock = clock
        self._lock = threading.Lock()
        self.max_bytes = _env_int(ENV_MAX_BYTES, 0) if max_bytes is None \
            else max_bytes
        self.keep = max(1, _env_int(ENV_KEEP, 1) if keep is None else keep)
        self._fh = open(path, "a", encoding="utf-8")

    def emit(self, event: str, **fields) -> Dict:
        """Write one event record; durable on disk when this returns.

        No-op after close() — shutdown paths (resilience __exit__,
        benchmark finally blocks) may race a late checkpoint thread, and
        losing a post-close event beats crashing the drain.
        """
        rec = {"ts": round(self._clock(), 3), "event": event, **fields}
        line = json.dumps(rec) + "\n"
        with self._lock:
            if self._fh.closed:
                return rec
            if self.max_bytes and self._fh.tell() + len(line) > self.max_bytes:
                self._rotate_locked()
            self._fh.write(line)
            self._fh.flush()
            os.fsync(self._fh.fileno())
        return rec

    def _rotate_locked(self) -> None:
        """Shift events.jsonl -> .1 -> .2 ... keeping the newest `keep`
        rotated generations. Caller holds the lock; the live handle is
        reopened on the (now empty) base path. Rotation is best-effort:
        an OSError (read-only dir mid-teardown) falls back to appending
        past the cap rather than dropping the record."""
        try:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
            rotate_chain(self.path, self.keep)
        except OSError:
            logger.warning("event log rotation failed for %s", self.path,
                           exc_info=True)
        self._fh = open(self.path, "a", encoding="utf-8")

    def bind(self, **fields) -> "BoundEventLog":
        """A view of this log that stamps `fields` into every record —
        how HFTA packed replicas get a `replica` (and `pack_group`)
        field without threading labels through every emit site."""
        return BoundEventLog(self, fields)

    def flush(self) -> None:
        """Force-durability barrier. emit() already fsyncs per record, so
        this only matters for buffered writes from a future batched mode;
        kept explicit so shutdown paths can state their ordering."""
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                os.fsync(self._fh.fileno())

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                try:
                    os.fsync(self._fh.fileno())
                except OSError:
                    pass
                self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BoundEventLog:
    """EventLog view with pre-bound fields (see EventLog.bind).

    Duck-type compatible with EventLog at the emit/flush/close/path
    surface; close() and flush() delegate to the SHARED underlying log,
    so ownership stays with whoever opened it. Explicit emit() kwargs
    win over bound fields."""

    def __init__(self, log, fields: Dict):
        self._log = log
        self.fields = dict(fields)

    @property
    def path(self) -> str:
        return self._log.path

    def emit(self, event: str, **fields) -> Dict:
        return self._log.emit(event, **{**self.fields, **fields})

    def bind(self, **fields) -> "BoundEventLog":
        return BoundEventLog(self._log, {**self.fields, **fields})

    def flush(self) -> None:
        self._log.flush()

    def close(self) -> None:
        self._log.close()


def rotate_chain(path: str, keep: int) -> None:
    """Shift `path` -> .1 -> .2 ... keeping the newest `keep` rotated
    generations; the base path no longer exists on return (the caller
    reopens or rewrites it). ONE chain layout shared by every size-
    capped JSONL sink — EventLog above and the collector's
    timeline.jsonl — so event_files/read_events span them all."""
    oldest = path + ".%d" % keep
    if os.path.exists(oldest):
        os.remove(oldest)
    for i in range(keep - 1, 0, -1):
        src = path + ".%d" % i
        if os.path.exists(src):
            os.replace(src, path + ".%d" % (i + 1))
    if os.path.exists(path):
        os.replace(path, path + ".1")


def event_files(path: str) -> List[str]:
    """The rotation chain for `path`, oldest first: highest-numbered
    .N down to .1, then the live file. Only existing files returned."""
    suffixes = []
    for name in os.listdir(os.path.dirname(path) or "."):
        full = os.path.join(os.path.dirname(path) or ".", name)
        prefix = os.path.basename(path) + "."
        if name.startswith(prefix):
            tail = name[len(prefix):]
            if tail.isdigit():
                suffixes.append((int(tail), full))
    out = [full for _, full in sorted(suffixes, reverse=True)]
    if os.path.exists(path):
        out.append(path)
    return out


def read_events(path: str, kind: Optional[str] = None) -> List[Dict]:
    """Parse an event log — including any rotated generations (.N files,
    oldest first) — skipping ANY undecodable line. A mid-write SIGKILL
    tears at most the final line; a concurrent writer can expose a
    half-record anywhere a reader races it. Either way the skip is
    counted in DECODE_ERRORS and logged, never raised, so a live
    postmortem read cannot abort. Optionally filter by event kind."""
    global DECODE_ERRORS
    out: List[Dict] = []
    try:
        files = event_files(path)
    except FileNotFoundError:
        return out
    for fname in files:
        try:
            with open(fname, "r", encoding="utf-8") as fh:
                lines = fh.read().split("\n")
        except FileNotFoundError:
            continue
        for line in lines:
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                DECODE_ERRORS += 1
                logger.warning("skipping undecodable event line in %s "
                               "(%d skipped since import)",
                               fname, DECODE_ERRORS)
                continue
            if kind is None or rec.get("event") == kind:
                out.append(rec)
    return out


__all__ = ["EventLog", "BoundEventLog", "read_events", "event_files",
           "rotate_chain", "DECODE_ERRORS", "PREEMPTION_DRAIN",
           "EMERGENCY_CHECKPOINT", "DIVERGENCE_ROLLBACK", "INIT_RETRY",
           "SLOT_ADMIT", "SLOT_RETIRE", "CHECKPOINT_RESTORE",
           "CHECKPOINT_SAVED", "CLOCK_ANCHOR", "FAULT_INJECTED",
           "REPLICA_FROZEN", "RUN_COMPLETE", "REQUEST_TIMEOUT",
           "JOB_CREATED", "GANG_RESTART", "GANG_STUCK", "GANG_DEGRADED",
           "PODS_READY", "FIRST_STEP_OBSERVED",
           "JOB_PACKED", "JOB_RESIZED", "GANG_RESIZE", "LIVE_SCALE",
           "AUTOSCALE_BREACH",
           "SCHED_QUEUE", "SCHED_PREEMPT", "SCHED_ADMIT",
           "SCHED_GROW_BACK", "SCHED_SKIP", "SCHED_MIGRATE",
           "FIRST_RESUME_STEP", "JOB_SUCCEEDED", "JOB_FAILED"]
