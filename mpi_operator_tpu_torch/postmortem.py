"""Postmortem CLI: turn a merged job timeline into a gang-lifecycle report.

The PyTorch port's own copy of mpi_operator_tpu/postmortem.py: the port
imports nothing of the JAX package, and this CLI runs where the
operator runs, in an image without torch or jax, so it imports neither
(the drain-cadence suggestion comes from telemetry/drain.py, not from
the torch-importing train/resilience.py). Its report is the
reference's, held to it by tests/test_torch_postmortem.py.

    python -m mpi_operator_tpu_torch.postmortem <timeline.jsonl> [--json]

The input is the ``timeline.jsonl`` a JobObservatory writes (or the
``telemetry.collector merge`` subcommand): controller + worker event
records, clock-corrected and sorted by ``ts``, each carrying a ``host``
field. This tool answers the question a human asks AFTER a job died or
ran slow — "what happened, in order, and where did the time and the
steps go?" — without Prometheus or kubectl access, from the one file the
operator leaves behind:

  - the **lifecycle** section lists every milestone (created, pods
    ready, first step, restarts, resizes, terminal) with the duration of
    the phase each one closes — so "4 min stuck between pods_ready and
    first_step_observed" (compile or rendezvous hang) is one glance;
  - the **incidents** section lists the resilience events between the
    milestones (preemption drains, emergency checkpoints, restores,
    rollbacks, injected faults) with their step numbers;
  - the **goodput ledger** replays the same arithmetic the controller's
    federated ``tpu_job_goodput`` gauge uses (telemetry/collector.py
    goodput_ledger — ONE implementation, so the postmortem never
    disagrees with the live metric): every executed step is either
    useful or lost to a restart/rollback re-execution.

Exit status: 0 on a rendered report, 2 when the timeline is missing,
empty, or contains no parseable record — a smoke test can assert "the
run left a usable postmortem" with plain ``&&``.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence, TextIO

from .telemetry import events as ev
from .telemetry.collector import goodput_ledger, resize_ledger
from .telemetry.trace import build_trees, read_trace_spans, render_tree
from .telemetry.drain import suggest_stop_check_every

#: milestone kinds, i.e. records that OPEN a new lifecycle phase; every
#: other record is an incident inside the current phase
MILESTONES = (
    ev.JOB_CREATED, ev.PODS_READY, ev.FIRST_STEP_OBSERVED,
    ev.JOB_PACKED, ev.JOB_RESIZED, ev.GANG_RESIZE, ev.GANG_RESTART,
    ev.RUN_COMPLETE, ev.JOB_SUCCEEDED, ev.JOB_FAILED,
)

#: incident kinds worth a line of their own (everything else — window
#: stats, slot churn — is summarized as a count)
INCIDENTS = (
    ev.PREEMPTION_DRAIN, ev.EMERGENCY_CHECKPOINT, ev.CHECKPOINT_RESTORE,
    ev.CHECKPOINT_SAVED, ev.FIRST_RESUME_STEP, ev.DIVERGENCE_ROLLBACK,
    ev.FAULT_INJECTED, ev.REPLICA_FROZEN, ev.INIT_RETRY, ev.CLOCK_ANCHOR,
    ev.GANG_STUCK, ev.GANG_DEGRADED, ev.REQUEST_TIMEOUT,
    ev.AUTOSCALE_BREACH,
)

#: fleet-scheduler decision kinds — rendered as their own section, with
#: preempts paired against the resize ledger for predicted-vs-measured
SCHED_EVENTS = (
    ev.SCHED_QUEUE, ev.SCHED_PREEMPT, ev.SCHED_ADMIT,
    ev.SCHED_GROW_BACK, ev.SCHED_SKIP, ev.SCHED_MIGRATE,
)

#: fields a sched_* record may carry that the report keeps verbatim
_SCHED_FIELDS = ("victim", "beneficiary", "via", "reason", "priority",
                 "from_tpus", "to_tpus", "rank", "pod", "migration_count",
                 "waited_seconds", "window_age_seconds",
                 "predicted_cost_seconds", "reclaim_seconds")

_DETAIL_FIELDS = ("step", "from_step", "to_step", "last_observed_step",
                  "exit_code", "restart", "replicas", "num_slices", "tpus",
                  "workers", "k", "fault", "signal", "seconds", "leaves",
                  "resharded", "stop_check_every", "path", "boot_id",
                  "stall_seconds", "progress_deadline_seconds",
                  "ranks", "partitioned_ranks", "total_ranks", "healed",
                  "request", "new_tokens", "deadline_seconds",
                  "target", "trace", "exemplar_trace")


def read_timeline(path: str) -> List[Dict]:
    """Parse a timeline.jsonl tolerantly: undecodable lines are skipped
    (a postmortem must survive the torn tail of a crashed writer), but
    ZERO parseable records is an error the caller turns into exit 2.
    Rotated generations (timeline.jsonl.1, .2 ... from the collector's
    TPU_TIMELINE_MAX_BYTES cap) are read through the same chain walk
    events.py uses, oldest first, so a capped long-run timeline still
    yields the full lifecycle."""
    records: List[Dict] = []
    try:
        files = ev.event_files(path)
    except OSError:
        files = [path]
    for fname in files:
        try:
            with open(fname, "r") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and "ts" in rec \
                            and "event" in rec:
                        records.append(rec)
        except OSError:
            continue
    records.sort(key=lambda r: r.get("ts", 0.0))
    return records


def _fmt_duration(seconds: float) -> str:
    if seconds >= 3600:
        return f"{seconds / 3600:.1f}h"
    if seconds >= 60:
        return f"{seconds / 60:.1f}m"
    return f"{seconds:.1f}s"


def _fmt_detail(rec: Dict) -> str:
    parts = [f"{k}={rec[k]}" for k in _DETAIL_FIELDS if k in rec]
    return "  ".join(parts)


def summarize(records: Sequence[Dict]) -> Dict:
    """Machine-readable report: milestones with per-phase durations,
    incident list, other-event counts, and the goodput ledger."""
    t0 = records[0].get("ts", 0.0)
    hosts = sorted({str(r.get("host", "?")) for r in records})
    milestones: List[Dict] = []
    incidents: List[Dict] = []
    other: Dict[str, int] = {}
    last_milestone_ts = t0
    # drain latency: preemption_drain -> the same host's next
    # emergency_checkpoint — the window the grace period has to cover;
    # the delta lands on the checkpoint's incident entry. The drain
    # record carries the stop_check_every cadence it ran under, so the
    # report can suggest a better one (see render).
    drain_open: Dict[str, Dict] = {}
    drain_latencies: List[Dict] = []
    # stuck->restart pairing: a gang_stuck verdict opens a stall; the next
    # gang_restart (or terminal job_failed) names how it was resolved —
    # the incident a postmortem reader needs as ONE line, not two greps
    stalls: List[Dict] = []
    # degraded-window pairing, same shape: a gang_degraded record opens a
    # window (further opens update the rank set in place), the healed=True
    # record — or a terminal event — closes it
    degraded: List[Dict] = []
    # fleet-scheduler decisions, paired with the resize ledger below so a
    # preempt shows predicted vs MEASURED cost on one line
    sched_actions: List[Dict] = []
    # SLO breaches with exemplar trace ids: autoscale_breach records
    # (exemplar_trace=) and request-level incidents that name the trace
    # directly (request_timeout's trace= IS the request id) — rendered
    # as the "slow traces:" hop trees when a trace file is supplied
    slo_breaches: List[Dict] = []
    for rec in records:
        kind = rec.get("event")
        entry = {
            "t": round(rec.get("ts", t0) - t0, 3),
            "host": str(rec.get("host", "?")),
            "event": kind,
            "detail": _fmt_detail(rec),
        }
        if kind == ev.GANG_STUCK:
            stall = {"t": entry["t"],
                     "stall_seconds": rec.get("stall_seconds"),
                     "deadline": rec.get("progress_deadline_seconds"),
                     "last_observed_step": rec.get("last_observed_step"),
                     "resolution": None}
            stalls.append(stall)
        elif kind in (ev.GANG_RESTART, ev.JOB_FAILED) and stalls \
                and stalls[-1]["resolution"] is None:
            stalls[-1]["resolution"] = kind
            stalls[-1]["resolution_t"] = entry["t"]
        if kind == ev.GANG_DEGRADED:
            open_win = degraded and degraded[-1]["resolution"] is None
            if rec.get("healed"):
                if open_win:
                    degraded[-1]["resolution"] = "healed"
                    degraded[-1]["resolution_t"] = entry["t"]
            elif open_win:
                degraded[-1]["ranks"] = rec.get("ranks")   # set changed
            else:
                degraded.append({
                    "t": entry["t"],
                    "ranks": rec.get("ranks"),
                    "total_ranks": rec.get("total_ranks"),
                    "resolution": None})
        elif kind in (ev.JOB_FAILED, ev.JOB_SUCCEEDED) and degraded \
                and degraded[-1]["resolution"] is None:
            degraded[-1]["resolution"] = kind
            degraded[-1]["resolution_t"] = entry["t"]
        if kind == ev.PREEMPTION_DRAIN:
            drain_open[entry["host"]] = {
                "ts": rec.get("ts", t0),
                "stop_check_every": rec.get("stop_check_every"),
            }
        elif kind == ev.EMERGENCY_CHECKPOINT \
                and entry["host"] in drain_open:
            opened = drain_open.pop(entry["host"])
            seconds = round(rec.get("ts", t0) - opened["ts"], 3)
            entry["drain_seconds"] = seconds
            latency = {"t": entry["t"], "host": entry["host"],
                       "seconds": seconds}
            if opened["stop_check_every"] is not None:
                latency["stop_check_every"] = opened["stop_check_every"]
            drain_latencies.append(latency)
        if kind in (ev.AUTOSCALE_BREACH, ev.REQUEST_TIMEOUT):
            trace = rec.get("exemplar_trace", rec.get("trace"))
            slo_breaches.append({
                "t": entry["t"], "event": kind, "trace": trace,
                "reason": rec.get("reason"),
                "request": rec.get("request")})
        if kind in SCHED_EVENTS:
            action = {"t": entry["t"], "event": kind,
                      "job": rec.get("job")}
            for f in _SCHED_FIELDS:
                if f in rec:
                    action[f] = rec[f]
            sched_actions.append(action)
        elif kind in MILESTONES:
            # the duration of the phase this milestone CLOSES
            entry["phase_seconds"] = round(rec.get("ts", t0)
                                           - last_milestone_ts, 3)
            last_milestone_ts = rec.get("ts", t0)
            milestones.append(entry)
        elif kind in INCIDENTS:
            incidents.append(entry)
        else:
            other[str(kind)] = other.get(str(kind), 0) + 1
    # auto-tune hint: scale the cadence the worst drain actually ran
    # under so that the next drain lands near the target latency
    suggested = None
    paced = [d for d in drain_latencies if "stop_check_every" in d]
    if paced:
        worst = max(paced, key=lambda d: d["seconds"])
        suggested = suggest_stop_check_every(worst["seconds"],
                                             worst["stop_check_every"])
    resizes = []
    for r in resize_ledger(records):
        r = dict(r)
        r["t"] = round(r.pop("ts") - t0, 3)
        r.pop("drain_start_ts", None)
        resizes.append(r)
    # predicted vs measured: a preempt (or grow-back) decision is
    # actuated as a gang resize, so its MEASURED cost is the
    # total_seconds of the first completed resize-ledger entry at or
    # after the decision — the number the scheduler's next ledger_cost()
    # read will see. Unpaired actions (resize still in flight, or a
    # controller-only sim with no worker records) stay predicted-only.
    for action in sched_actions:
        if action["event"] not in (ev.SCHED_PREEMPT, ev.SCHED_GROW_BACK):
            continue
        measured = next(
            (r["total_seconds"] for r in resizes
             if r["t"] >= action["t"] and "total_seconds" in r), None)
        if measured is not None:
            action["measured_cost_seconds"] = measured
    return {
        "records": len(records),
        "span_seconds": round(records[-1].get("ts", t0) - t0, 3),
        "hosts": hosts,
        "job": next((r["job"] for r in records if "job" in r), None),
        "milestones": milestones,
        "incidents": incidents,
        "drain_latencies": drain_latencies,
        "suggested_stop_check_every": suggested,
        "stalls": stalls,
        "degraded": degraded,
        "resizes": resizes,
        "scheduler_actions": sched_actions,
        "slo_breaches": slo_breaches,
        "other_events": other,
        "ledger": goodput_ledger(records),
    }


def _fmt_sched_action(a: Dict) -> str:
    """One line per fleet-scheduler decision: who it hit, who it served,
    and the cost arithmetic the scheduler gated it on — predicted from
    the resize ledger at decision time, measured once the resize the
    decision caused has completed."""
    kind = a["event"]
    job = a.get("job") or "?"
    if kind == ev.SCHED_PREEMPT:
        cost = f"predicted {_fmt_duration(float(a['predicted_cost_seconds']))}" \
            if a.get("predicted_cost_seconds") is not None else "predicted ?"
        if a.get("measured_cost_seconds") is not None:
            cost += (f", measured "
                     f"{_fmt_duration(float(a['measured_cost_seconds']))}")
        else:
            cost += ", measured pending"
        return (f"preempt    victim {a.get('victim', job)} -> beneficiary "
                f"{a.get('beneficiary', '?')}  "
                f"{a.get('from_tpus', '?')} -> {a.get('to_tpus', '?')} tpus"
                f"  ({cost})")
    if kind == ev.SCHED_GROW_BACK:
        measured = (f"  (measured "
                    f"{_fmt_duration(float(a['measured_cost_seconds']))})"
                    if a.get("measured_cost_seconds") is not None else "")
        return (f"grow back  {job}  {a.get('from_tpus', '?')} -> "
                f"{a.get('to_tpus', '?')} tpus{measured}")
    if kind == ev.SCHED_SKIP:
        cost = ""
        if a.get("predicted_cost_seconds") is not None \
                and a.get("reclaim_seconds") is not None:
            cost = (f"  (predicted "
                    f"{_fmt_duration(float(a['predicted_cost_seconds']))}"
                    f" vs reclaimable "
                    f"{_fmt_duration(float(a['reclaim_seconds']))})")
        return f"skip       {job}: {a.get('reason', '?')}{cost}"
    if kind == ev.SCHED_MIGRATE:
        return (f"migrate    {job} rank {a.get('rank', '?')} pod "
                f"{a.get('pod', '?')}  (migration "
                f"#{a.get('migration_count', '?')}, window dark "
                f"{_fmt_duration(float(a.get('window_age_seconds', 0.0)))})")
    if kind == ev.SCHED_ADMIT:
        waited = (f" after {_fmt_duration(float(a['waited_seconds']))} queued"
                  if a.get("waited_seconds") is not None else "")
        return f"admit      {job} via {a.get('via', '?')}{waited}"
    if kind == ev.SCHED_QUEUE:
        prio = (f" (priority {a['priority']})"
                if a.get("priority") is not None else "")
        return f"queue      {job}{prio}: {a.get('reason', '?')}"
    return f"{kind}  {job}"


def render(summary: Dict, out: TextIO,
           trees: Optional[Dict[int, Dict]] = None) -> None:
    job = summary["job"] or "<unknown>"
    out.write(f"postmortem: job {job} — {summary['records']} records over "
              f"{_fmt_duration(summary['span_seconds'])} from "
              f"{len(summary['hosts'])} host(s)\n")
    out.write(f"hosts: {', '.join(summary['hosts'])}\n\n")

    out.write("lifecycle:\n")
    if not summary["milestones"]:
        out.write("  (no milestone events — timeline has worker records "
                  "only)\n")
    for m in summary["milestones"]:
        phase = (f"  (+{_fmt_duration(m['phase_seconds'])})"
                 if m["phase_seconds"] > 0 else "")
        detail = f"  {m['detail']}" if m["detail"] else ""
        out.write(f"  {m['t']:>9.3f}s  {m['host']:<12} "
                  f"{m['event']:<22}{detail}{phase}\n")

    drains = summary.get("drain_latencies") or []
    if drains:
        worst = max(d["seconds"] for d in drains)
        out.write(f"  drain latency: {len(drains)} preemption drain(s) "
                  f"reached the emergency checkpoint, worst "
                  f"{_fmt_duration(worst)}\n")
        suggested = summary.get("suggested_stop_check_every")
        if suggested is not None:
            out.write(f"  suggested --stop-check-every: {suggested}  "
                      f"(or TPU_STOP_CHECK_EVERY=auto to derive it from "
                      f"this run's events.jsonl)\n")

    stalls = summary.get("stalls") or []
    if stalls:
        out.write("\nstuck gangs:\n")
        for s in stalls:
            window = (f"no step progress for "
                      f"{_fmt_duration(float(s['stall_seconds']))}"
                      if s.get("stall_seconds") is not None
                      else "no step progress")
            deadline = (f" (deadline {s['deadline']}s)"
                        if s.get("deadline") is not None else "")
            step = (f", last step {s['last_observed_step']}"
                    if s.get("last_observed_step") is not None else "")
            if s.get("resolution") == ev.GANG_RESTART:
                fate = (f" -> gang restart at t={s['resolution_t']:.3f}s")
            elif s.get("resolution") == ev.JOB_FAILED:
                fate = (f" -> job failed at t={s['resolution_t']:.3f}s")
            else:
                fate = "  (unresolved)"
            out.write(f"  stalled at t={s['t']:.3f}s: {window}{deadline}"
                      f"{step}{fate}\n")

    degraded = summary.get("degraded") or []
    if degraded:
        out.write("\ndegraded gangs:\n")
        for d in degraded:
            ranks = d.get("ranks")
            who = (f"rank(s) {', '.join(str(r) for r in ranks)}"
                   if ranks else "some ranks")
            total = (f" of {d['total_ranks']}"
                     if d.get("total_ranks") else "")
            if d.get("resolution") == "healed":
                width = d["resolution_t"] - d["t"]
                fate = (f" -> healed at t={d['resolution_t']:.3f}s "
                        f"(window {_fmt_duration(width)})")
            elif d.get("resolution") is not None:
                fate = (f" -> {d['resolution']} at "
                        f"t={d['resolution_t']:.3f}s")
            else:
                fate = "  (unresolved)"
            out.write(f"  {who}{total} unreachable from t={d['t']:.3f}s, "
                      f"progress still observed — no restart{fate}\n")

    resizes = summary.get("resizes") or []
    if resizes:
        out.write("\ngang resizes:\n")
        for r in resizes:
            t = r["t"]
            size = "".join(f"  {k}={r[k]}" for k in
                           ("workers", "tpus", "replicas") if k in r)
            phases = "  ".join(
                f"{p}={_fmt_duration(r[f'{p}_seconds'])}"
                for p in ("drain", "restore", "recompile")
                if f"{p}_seconds" in r)
            total = (f"  total {_fmt_duration(r['total_seconds'])}"
                     if "total_seconds" in r else "  (never resumed)")
            out.write(f"  resize at t={t:.3f}s{size}  [{phases}]{total}\n")

    sched = summary.get("scheduler_actions") or []
    if sched:
        out.write("\nscheduler actions:\n")
        for a in sched:
            out.write(f"  {a['t']:>9.3f}s  {_fmt_sched_action(a)}\n")

    if summary["incidents"]:
        out.write("\nincidents:\n")
        for i in summary["incidents"]:
            detail = f"  {i['detail']}" if i["detail"] else ""
            drain = (f"  (drain->ckpt {_fmt_duration(i['drain_seconds'])})"
                     if "drain_seconds" in i else "")
            out.write(f"  {i['t']:>9.3f}s  {i['host']:<12} "
                      f"{i['event']:<22}{detail}{drain}\n")

    breaches = summary.get("slo_breaches") or []
    if breaches:
        out.write("\nslow traces:\n")
        rendered = set()
        for b in breaches:
            tid = b.get("trace")
            label = (f"request {b['request']}"
                     if b.get("request") is not None else f"trace {tid}")
            why = f": {b['reason']}" if b.get("reason") else ""
            out.write(f"  {b['t']:>9.3f}s  {b['event']:<22} "
                      f"{label}{why}\n")
            if tid is None:
                out.write("    exemplar pending (no trace id attached — "
                          "sampled out or federation window empty)\n")
                continue
            tree = (trees or {}).get(tid)
            if tree is None or tree.get("root") is None:
                out.write(f"    exemplar pending (trace {tid} not in the "
                          f"trace file yet)\n")
                continue
            if tid in rendered:
                out.write(f"    (trace {tid} rendered above)\n")
                continue
            rendered.add(tid)
            for line in render_tree(tree):
                out.write(f"    {line}\n")

    if summary["other_events"]:
        pairs = ", ".join(f"{k}×{v}"
                          for k, v in sorted(summary["other_events"].items()))
        out.write(f"\nother events: {pairs}\n")

    led = summary["ledger"]
    out.write("\ngoodput ledger:\n")
    out.write(f"  useful steps   {led['useful_steps']}\n")
    out.write(f"  lost steps     {led['lost_steps']}"
              f"  (re-executed after restart/rollback)\n")
    out.write(f"  restarts       {led['restarts']}"
              f"    restores {led['restores']}"
              f"    rollbacks {led['rollbacks']}\n")
    out.write(f"  goodput        {led['goodput']:.4f}\n")


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_operator_tpu_torch.postmortem",
        description="Render a merged job timeline (timeline.jsonl) as a "
                    "gang-lifecycle report with a goodput ledger.")
    parser.add_argument("timeline", help="path to timeline.jsonl")
    parser.add_argument("--json", action="store_true",
                        help="emit the machine-readable summary instead "
                             "of the human report")
    parser.add_argument("--traces", default=None, metavar="PATH",
                        help="traces.jsonl span log (telemetry/trace.py); "
                             "lets the slow-traces section render each "
                             "SLO breach's exemplar as a hop tree")
    args = parser.parse_args(argv)

    records = read_timeline(args.timeline)
    if not records:
        print(f"postmortem: no parseable event records in "
              f"{args.timeline}", file=sys.stderr)
        return 2
    trees = None
    if args.traces:
        try:
            trees = build_trees(read_trace_spans(args.traces))
        except OSError:
            trees = {}        # breaches render "exemplar pending"
    summary = summarize(records)
    if args.json:
        json.dump(summary, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        render(summary, sys.stdout, trees=trees)
    return 0


if __name__ == "__main__":
    sys.exit(main())
