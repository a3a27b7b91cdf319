"""The resize ledger of the controller-side collector.

The PyTorch port's own copy of `resize_ledger` from
mpi_operator_tpu/telemetry/collector.py: the port imports nothing of the
JAX package, not even its framework-free modules. The serving fleet's
live-scaling leg (examples/serve_benchmark.py run_livescale_benchmark)
prices its +1/-1 steps through it, as the reference's leg does. The rest
of the collector (metrics federation, merged timelines, the goodput
ledger, JobObservatory) comes with the port's control plane.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from . import events as ev


def resize_ledger(records: Iterable[Dict]) -> List[Dict]:
    """Split each ``gang_resize`` into drain / restore / recompile phases.

    drain     = the preemption_drain -> emergency_checkpoint wall time of
                the drain that handed the gang over to the resize;
    restore   = the first post-resize checkpoint_restore's ``seconds``
                (shard read + assembly, resharded or not);
    recompile = the first post-resume step's ``seconds``
                (first_resume_step: restore-done -> step completion, i.e.
                jit recompilation at the new world size plus one step);
    total     = drain start -> first post-resume step completion — the
                goodput hole the resize punched into the run.
    Entries missing a phase (job died mid-resize) keep whatever phases
    were observed; ``total_seconds`` is only set once the gang stepped.

    Every entry carries ``kind``: ``"gang_resize"`` for the phase-pair
    machinery above, ``"live_scale"`` for surgical decode-pool steps.
    A ``live_scale`` record is SELF-CONTAINED (the survivors never
    paused, so there is no checkpoint/restore/recompile to pair): its
    entry copies the record's drain_seconds (graceful detach drain) /
    warmup_seconds (attach compile pin) and total_seconds (defaulting
    to drain + warmup when the emitter measured only the phases).
    Cooldown readers MUST filter on kind — pricing a live step off a
    gang total (or a gang preemption off a live step) inverts the
    whole point of the split."""
    resizes: List[Dict] = []
    drain_open: Optional[float] = None
    last_drain: Optional[Tuple[float, float]] = None
    current: Optional[Dict] = None
    for rec in sorted(records, key=lambda r: r.get("ts", 0.0)):
        kind = rec.get("event")
        ts = rec.get("ts", 0.0)
        if kind == ev.PREEMPTION_DRAIN:
            drain_open = ts
        elif kind == ev.EMERGENCY_CHECKPOINT and drain_open is not None:
            last_drain = (drain_open, round(ts - drain_open, 3))
            drain_open = None
        elif kind == ev.LIVE_SCALE:
            entry = {"ts": ts, "kind": ev.LIVE_SCALE}
            for key in ("action", "replicas", "decode_replicas", "reason",
                        "token"):
                if key in rec:
                    entry[key] = rec[key]
            phases = 0.0
            for key in ("drain_seconds", "warmup_seconds"):
                try:
                    entry[key] = float(rec[key])
                    phases += entry[key]
                except (KeyError, TypeError, ValueError):
                    pass
            try:
                entry["total_seconds"] = float(rec["total_seconds"])
            except (KeyError, TypeError, ValueError):
                if "drain_seconds" in entry or "warmup_seconds" in entry:
                    entry["total_seconds"] = round(phases, 3)
            resizes.append(entry)
        elif kind == ev.GANG_RESIZE:
            if current is not None:
                resizes.append(current)
            current = {"ts": ts, "kind": ev.GANG_RESIZE}
            for key in ("workers", "tpus", "replicas", "num_slices",
                        "reason"):
                if key in rec:
                    current[key] = rec[key]
            if last_drain is not None:
                current["drain_start_ts"] = last_drain[0]
                current["drain_seconds"] = last_drain[1]
                last_drain = None
        elif (current is not None and kind == ev.CHECKPOINT_RESTORE
              and "restore_seconds" not in current):
            try:
                current["restore_seconds"] = float(rec["seconds"])
            except (KeyError, TypeError, ValueError):
                pass
        elif current is not None and kind == ev.FIRST_RESUME_STEP:
            try:
                current["recompile_seconds"] = float(rec["seconds"])
            except (KeyError, TypeError, ValueError):
                pass
            start = current.get("drain_start_ts", current["ts"])
            current["total_seconds"] = round(ts - start, 3)
            resizes.append(current)
            current = None
    if current is not None:
        resizes.append(current)
    return resizes


__all__ = ["resize_ledger"]
