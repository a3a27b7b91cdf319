"""SLO-driven decode autoscaling policy (spec.serving.slo).

The controller's serving-autoscale pass closes the loop from federated
job-level latency series into the decode-pool size: the observatory's
MetricsFederation already aggregates every replica's
``tpu_worker_ttft_seconds`` / ``tpu_worker_tpot_seconds`` histograms
and ``tpu_worker_queue_depth`` gauge; this module turns those
observations into scale-up/scale-down decisions against the
``spec.serving.slo`` targets.

This file is PURE POLICY — a per-job hysteresis state machine with no
cluster I/O — so every decision path unit-tests without a controller.
The controller glue (`TPUJobController._autoscale_reconcile`) feeds it
observations, lands accepted targets in ``status.serving_decode_replicas``
(the same status-override discipline as elastic_tpus: the user's spec is
never edited), and the next sync materializes the delta as a LIVE
decode-pool step: a replica-count-only StatefulSet update behind the
``scalingReplica`` status marker — survivors never pause, nothing
recompiles, no gang restart (that path still exists, but only a USER
edit of the serving spec takes it).

Hysteresis has three independent brakes:

  * breach persistence — a p99 spike must hold for ``breach_seconds``
    before a scale-up (one bad scrape never moves the fleet);
  * clear persistence — the fleet must run inside SLO for
    ``clear_seconds`` before a scale-down (reclaiming capacity is never
    urgent);
  * scale-cost cooldown — after any decision, further decisions wait
    ``cooldown_multiplier`` x the last measured cost of the action kind
    the scaler TAKES — the newest ``live_scale`` ledger entry, NOT the
    newest entry of any kind (``cooldown_floor_seconds`` until one has
    been measured). Pricing off the cheap action is the point of live
    scaling's second-order win: a fleet whose live steps take ~2s can
    react every ~2 minutes at the default floor, where pricing off a
    stray 90s gang resize would have pinned it to ~6 minutes.

Scaling steps ±1 replica per decision: even with cheap steps, the
drain/warmup of overshooting (another step to walk back) costs more
than converging over two windows — and the persistence windows are the
real reaction-time floor anyway.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..api.types import ServingSLO

__all__ = ["AutoscaleDecision", "DecodeAutoscaler", "SLOObservation"]


@dataclass
class SLOObservation:
    """One federated snapshot: job-level p99s (histogram bucket-walk
    upper bounds) and the summed queue depth. None = the series has no
    data yet (empty histogram / unreported gauge) — missing evidence
    never breaches and never counts as clear."""
    ttft_p99: Optional[float] = None
    tpot_p99: Optional[float] = None
    queue_depth: Optional[float] = None
    #: trace id of the slowest completed request in the federation's
    #: exemplar window (TraceFederation.slowest_trace) — pure evidence,
    #: never part of the breach math; a breach decision carries it so
    #: the postmortem can render the worst span tree behind the p99
    exemplar_trace: Optional[int] = None


@dataclass
class AutoscaleDecision:
    """target None = hold. wake_after (seconds) is the soonest a
    re-evaluation could change the answer — the controller schedules a
    queue wake-up for it so pending timers fire without cluster
    events."""
    target: Optional[int] = None
    reason: str = ""
    wake_after: Optional[float] = None
    #: the observation's exemplar trace id, copied onto breach-driven
    #: scale-ups only (hold/scale-down decisions carry None — there is
    #: no breach to exemplify)
    exemplar_trace: Optional[int] = None


class DecodeAutoscaler:
    """Per-job hysteresis state machine. Feed decide() monotonic
    observations; it returns at most one ±1 step when a persistence
    window AND the cooldown have both elapsed."""

    def __init__(self, slo: ServingSLO):
        self.slo = slo
        self.breach_since: Optional[float] = None
        self.clear_since: Optional[float] = None

    # -- evidence ---------------------------------------------------------

    def _violations(self, obs: SLOObservation) -> List[str]:
        """Human-readable list of targets the snapshot exceeds."""
        out = []
        slo = self.slo
        checks: List[Tuple[str, Optional[float], Optional[float]]] = [
            ("ttft_p99", obs.ttft_p99, slo.ttft_p99_seconds),
            ("tpot_p99", obs.tpot_p99, slo.tpot_p99_seconds),
            ("queue_depth", obs.queue_depth, slo.queue_depth),
        ]
        for name, seen, target in checks:
            if target is not None and seen is not None and seen > target:
                out.append(f"{name} {seen:.4g} > {target:.4g}")
        return out

    def _all_clear(self, obs: SLOObservation) -> bool:
        """Every CONFIGURED target has data and sits within SLO — the
        scale-down bar. Unobserved targets block clearing (an empty
        histogram after a restart is not evidence of headroom)."""
        slo = self.slo
        checks = [(obs.ttft_p99, slo.ttft_p99_seconds),
                  (obs.tpot_p99, slo.tpot_p99_seconds),
                  (obs.queue_depth, slo.queue_depth)]
        live = [(seen, target) for seen, target in checks
                if target is not None]
        return bool(live) and all(seen is not None and seen <= target
                                  for seen, target in live)

    # -- the decision -----------------------------------------------------

    def cooldown_seconds(self,
                         last_resize_seconds: Optional[float]) -> float:
        """The thrash brake: a multiple of the last MEASURED cost of the
        action this scaler takes — the newest ``live_scale`` entry's
        drain + warmup from the resize ledger (the controller glue does
        the kind filtering) — never below the configured floor."""
        slo = self.slo
        if last_resize_seconds is None:
            return slo.cooldown_floor_seconds
        return max(slo.cooldown_floor_seconds,
                   slo.cooldown_multiplier * last_resize_seconds)

    def decide(self, now: float, obs: SLOObservation, current: int,
               last_scaled_at: Optional[float],
               last_resize_seconds: Optional[float]) -> AutoscaleDecision:
        """One evaluation. `current` is the EFFECTIVE decode-replica
        count (status override or spec baseline); `last_scaled_at` the
        status timestamp of the previous accepted decision."""
        slo = self.slo
        cooldown = self.cooldown_seconds(last_resize_seconds)
        cooling = (last_scaled_at is not None
                   and now - last_scaled_at < cooldown)
        violations = self._violations(obs)
        if violations:
            self.clear_since = None
            if self.breach_since is None:
                self.breach_since = now
            held = now - self.breach_since
            if held < slo.breach_seconds:
                return AutoscaleDecision(
                    reason=f"breach held {held:.0f}s < "
                           f"{slo.breach_seconds:.0f}s",
                    wake_after=slo.breach_seconds - held)
            if cooling:
                remaining = cooldown - (now - last_scaled_at)
                return AutoscaleDecision(
                    reason=f"breach persisted but cooling down "
                           f"({remaining:.0f}s of {cooldown:.0f}s left)",
                    wake_after=remaining)
            if current >= slo.max_decode_replicas:
                return AutoscaleDecision(
                    reason=f"breach persisted at maxDecodeReplicas="
                           f"{slo.max_decode_replicas}; holding")
            self.breach_since = None
            return AutoscaleDecision(
                target=current + 1,
                reason=f"SLO breached for >= {slo.breach_seconds:.0f}s "
                       f"({'; '.join(violations)}); scaling decode "
                       f"{current} -> {current + 1}",
                exemplar_trace=obs.exemplar_trace)
        self.breach_since = None
        if not self._all_clear(obs):
            # partial evidence: inside SLO where observed, but some
            # configured target is dark — hold everything
            self.clear_since = None
            return AutoscaleDecision(reason="insufficient SLO evidence")
        if current <= slo.min_decode_replicas:
            self.clear_since = None
            return AutoscaleDecision(
                reason=f"clear at minDecodeReplicas="
                       f"{slo.min_decode_replicas}")
        if self.clear_since is None:
            self.clear_since = now
        held = now - self.clear_since
        if held < slo.clear_seconds:
            return AutoscaleDecision(
                reason=f"clear held {held:.0f}s < {slo.clear_seconds:.0f}s",
                wake_after=slo.clear_seconds - held)
        if cooling:
            remaining = cooldown - (now - last_scaled_at)
            return AutoscaleDecision(
                reason=f"clear persisted but cooling down "
                       f"({remaining:.0f}s of {cooldown:.0f}s left)",
                wake_after=remaining)
        self.clear_since = None
        return AutoscaleDecision(
            target=current - 1,
            reason=f"inside SLO for >= {slo.clear_seconds:.0f}s; scaling "
                   f"decode {current} -> {current - 1}")
