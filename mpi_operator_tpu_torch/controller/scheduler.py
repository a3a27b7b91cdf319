"""Fleet scheduler policy (spec.priority + ControllerConfig.sched_pool_chips).

The controller reconciles each TPUJob independently and first-come-
first-hold; this module adds the missing POLICY layer: treat every
TPUJob as a claim against ONE slice pool and rebalance elastic gangs to
serve priorities ("Dynamic Scheduling of MPI-based Distributed Deep
Learning Training Jobs", PAPERS.md). Three action kinds come out of it:

  * admission — a job whose chips do not fit the pool is HELD (a Queued
    condition, no resources created) until capacity frees; pending jobs
    admit in descending spec.priority then creation order, strictly
    head-of-line (no backfill past a blocked higher-priority job — the
    blocked job's claim must never be starved by a stream of small
    low-priority arrivals);
  * preempt-to-admit / grow-back — the head-of-line blocked job may
    shrink the LOWEST-priority admitted elastic gang one or more ladder
    steps (through the existing drain -> emergency-checkpoint ->
    exit-215 -> rescale protocol) to get in, and the victim grows back
    once slices free again;
  * degraded-rank migration — a DegradedGang window naming partitioned
    ranks deletes the dark pod (the StatefulSet reschedules it), at
    most once per window, counted distinctly from gang restarts.

This file is PURE POLICY, the `controller/autoscale.py` discipline: a
deterministic function of (now, fleet status view) with no cluster I/O,
so every decision path unit-tests without a controller. The glue
(`TPUJobController._sched_reconcile`) feeds it SchedJob views derived
ONLY from status — which is what makes every decision crash-consistent:
a controller killed after any write boundary replays the sync, derives
the same view, and re-plans to the same answer.

Anti-thrash is the resize ledger used as a cost model: an action's
predicted cost is the victim's last MEASURED drain+restore+recompile
total (``ledger_cost`` — incomplete entries from a crash mid-drain fall
back to the configured floor, never KeyError, never zero), and the gate
refuses any action whose predicted cost exceeds the slice-time it
reclaims (the beneficiary's accrued queue wait — which grows
monotonically, so no admission is ever lost, only delayed past the
point where the resize pays for itself). On top of that sits the
autoscaler's cooldown brake: after any scheduler action against a gang,
further actions against it wait ``cooldown_multiplier`` x the last
measured resize cost (``cooldown_floor_seconds`` until one has been
measured). Declined actions are explicit ``sched_skip`` decisions, so
the postmortem can show the scheduler REFUSING to thrash.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["FleetScheduler", "SchedDecision", "SchedJob", "SchedPlan",
           "ledger_cost"]


def ledger_cost(resizes: Sequence[Dict], default: float) -> float:
    """Newest MEASURED gang-resize cost from a resize-ledger read
    (telemetry/collector.py resize_ledger), else ``default``.

    A resize entry is complete only once FIRST_RESUME_STEP landed; a
    crash mid-drain leaves partial entries with no ``total_seconds``.
    Cost reads must degrade to the configured floor — never KeyError,
    and never treat the cost as zero (a zero cost would let the gate
    approve every action the moment a ledger entry is incomplete,
    which is exactly when the fleet is least stable).

    Only ``gang_resize`` entries count: scheduler actions (preempt,
    grow-back, migration-adjacent shrink) all materialize as gang
    restarts, so pricing them off a sub-second serving ``live_scale``
    entry would wave every preemption through the cost gate the moment
    a decode pool scaled once. Entries predating the kind field are
    all gang."""
    for r in reversed(list(resizes)):
        if r.get("kind", "gang_resize") != "gang_resize":
            continue
        total = r.get("total_seconds")
        if total:
            return float(total)
    return float(default)


@dataclass
class SchedJob:
    """One job's scheduler-relevant view, derived ONLY from status (plus
    the spec's priority/elastic shape) so crash replays re-derive it
    bit-identically. ``chips`` is the ENTITLEMENT (the size the job runs
    at absent any scheduler override — spec/resize/elastic already
    folded in); ``held_chips`` is the pool charge right now (sched
    override folded in too; 0 while pending or done)."""
    name: str                                  # "namespace/name"
    priority: int = 0
    created: float = 0.0
    chips: int = 0
    held_chips: int = 0
    pending: bool = False                      # queued / never admitted
    done: bool = False
    elastic: bool = False
    #: valid shrink targets for this gang, DESCENDING — the v5e ladder
    #: below the entitlement, floored at spec.minTpus, per-worker tiled
    shrink_ladder: Tuple[int, ...] = ()
    sched_tpus: Optional[int] = None           # live preemption override
    sched_scaled_at: Optional[float] = None    # last scheduler action ts
    queued_since: Optional[float] = None       # Queued=True transition ts
    last_resize_seconds: Optional[float] = None  # ledger_cost() output
    preempt_beneficiary: Optional[str] = None  # who sched_tpus serves


@dataclass
class SchedDecision:
    """One scheduler action (or an explicit refusal). ``wake_after``
    seconds is the soonest a re-evaluation could change the answer —
    the glue arms a queue wake-up for it (coalesced per key)."""
    action: str                                # preempt|grow_back|migrate|skip
    victim: Optional[str] = None
    beneficiary: Optional[str] = None
    from_chips: Optional[int] = None
    to_chips: Optional[int] = None
    predicted_cost_seconds: Optional[float] = None
    reclaim_seconds: Optional[float] = None
    reason: str = ""
    wake_after: Optional[float] = None


@dataclass
class SchedPlan:
    """One planning pass over the fleet. ``admit``/``hold`` partition
    the pending jobs; ``action`` is AT MOST ONE preempt or grow-back
    (each is a gang restart — the cost of overshooting dwarfs the cost
    of converging over two passes, the autoscaler's ±1 discipline);
    ``skips`` are the explicit refusals with their evidence."""
    admit: List[Tuple[str, str]] = field(default_factory=list)   # (job, via)
    hold: List[Tuple[str, str]] = field(default_factory=list)    # (job, why)
    action: Optional[SchedDecision] = None
    skips: List[SchedDecision] = field(default_factory=list)
    wake_after: Optional[float] = None


class FleetScheduler:
    """Deterministic fleet planner. Feed plan() the status-derived
    SchedJob views; it returns the admissions, at most one rebalance
    action, and the explicit skips."""

    def __init__(self, pool_chips: int,
                 cooldown_floor_seconds: float = 60.0,
                 cooldown_multiplier: float = 4.0):
        self.pool_chips = pool_chips
        self.cooldown_floor_seconds = cooldown_floor_seconds
        self.cooldown_multiplier = cooldown_multiplier

    # -- cost model -------------------------------------------------------

    def cooldown_seconds(self,
                         last_resize_seconds: Optional[float]) -> float:
        """The thrash brake (autoscale.py discipline): a multiple of the
        gang's last MEASURED resize cost, never below the floor."""
        if not last_resize_seconds:
            return self.cooldown_floor_seconds
        return max(self.cooldown_floor_seconds,
                   self.cooldown_multiplier * last_resize_seconds)

    def predicted_cost_seconds(
            self, last_resize_seconds: Optional[float]) -> float:
        """What one drain->restore->recompile cycle of this gang is
        predicted to burn: the measured ledger cost, floor-defaulted
        (never zero — see ledger_cost)."""
        if not last_resize_seconds:
            return self.cooldown_floor_seconds
        return last_resize_seconds

    # -- the planning pass ------------------------------------------------

    @staticmethod
    def _pending_order(j: SchedJob):
        return (-j.priority, j.created, j.name)

    def plan(self, now: float, jobs: Sequence[SchedJob]) -> SchedPlan:
        plan = SchedPlan()
        admitted = [j for j in jobs if not j.done and not j.pending]
        pending = sorted((j for j in jobs if not j.done and j.pending),
                         key=self._pending_order)
        free = self.pool_chips - sum(j.held_chips for j in admitted)
        in_flight = {j.preempt_beneficiary for j in admitted
                     if j.sched_tpus is not None}

        blocked: Optional[SchedJob] = None
        for p in pending:
            if blocked is None and p.chips <= free:
                via = "preempt" if p.name in in_flight else "capacity"
                plan.admit.append((p.name, via))
                free -= p.chips
            elif blocked is None:
                blocked = p
                plan.hold.append((p.name, f"needs {p.chips} chips, "
                                          f"{free} free"))
            else:
                # strict head-of-line: no backfill past a blocked
                # higher-priority claim
                plan.hold.append((p.name, f"behind {blocked.name}"))

        wakes: List[float] = []
        if blocked is not None:
            decision = self._plan_preempt(now, blocked, free, admitted)
            if decision.action == "preempt":
                plan.action = decision
            else:
                plan.skips.append(decision)
                if decision.wake_after is not None:
                    wakes.append(decision.wake_after)

        if plan.action is None:
            decision = self._plan_grow_back(now, free, admitted)
            if decision is not None:
                if decision.action == "grow_back":
                    plan.action = decision
                else:
                    plan.skips.append(decision)
                    if decision.wake_after is not None:
                        wakes.append(decision.wake_after)

        plan.wake_after = min(wakes) if wakes else None
        return plan

    def _plan_preempt(self, now: float, blocked: SchedJob, free: int,
                      admitted: Sequence[SchedJob]) -> SchedDecision:
        """Shrink ONE victim to admit the head-of-line blocked job, or
        explain the refusal. Victim selection: lowest priority first
        (strictly below the beneficiary's), youngest first within a
        priority (the newest claim yields before an older one), never a
        gang that is already preempted (zero double-shrinks by
        construction) and never a non-elastic gang (nothing else can
        give chips back without dying)."""
        victims = sorted(
            (j for j in admitted
             if j.elastic and j.sched_tpus is None
             and j.priority < blocked.priority and j.shrink_ladder),
            key=lambda j: (j.priority, -j.created, j.name))
        candidate = None
        target = None
        for v in victims:
            # smallest shrink that fits: the ladder is descending, so
            # take the LARGEST target that frees enough
            for c in v.shrink_ladder:
                if free + (v.held_chips - c) >= blocked.chips:
                    candidate, target = v, c
                    break
            if candidate is not None:
                break
        if candidate is None:
            return SchedDecision(
                action="skip", beneficiary=blocked.name,
                reason=f"no viable victim: {blocked.name} needs "
                       f"{blocked.chips} chips ({free} free) and no "
                       f"lower-priority elastic gang can free the "
                       f"difference")
        predicted = self.predicted_cost_seconds(
            candidate.last_resize_seconds)
        cooldown = self.cooldown_seconds(candidate.last_resize_seconds)
        if candidate.sched_scaled_at is not None:
            elapsed = now - candidate.sched_scaled_at
            if elapsed < cooldown:
                remaining = cooldown - elapsed
                return SchedDecision(
                    action="skip", victim=candidate.name,
                    beneficiary=blocked.name,
                    predicted_cost_seconds=predicted,
                    reason=f"victim {candidate.name} cooling down "
                           f"({remaining:.0f}s of {cooldown:.0f}s left)",
                    wake_after=remaining)
        reclaim = (now - blocked.queued_since
                   if blocked.queued_since is not None else 0.0)
        if reclaim < predicted:
            # the anti-thrash pin: reclaimable slice-time (the
            # beneficiary's accrued wait) below the ledger-measured
            # resize cost -> explicit decline. The wait grows
            # monotonically, so this delays the admission, never
            # loses it.
            return SchedDecision(
                action="skip", victim=candidate.name,
                beneficiary=blocked.name,
                predicted_cost_seconds=predicted,
                reclaim_seconds=round(reclaim, 3),
                reason=f"queued wait {reclaim:.0f}s has not yet paid "
                       f"for the predicted resize cost "
                       f"{predicted:.0f}s of {candidate.name}",
                wake_after=predicted - reclaim)
        return SchedDecision(
            action="preempt", victim=candidate.name,
            beneficiary=blocked.name,
            from_chips=candidate.held_chips, to_chips=target,
            predicted_cost_seconds=predicted,
            reclaim_seconds=round(reclaim, 3),
            reason=f"shrinking {candidate.name} "
                   f"{candidate.held_chips} -> {target} chips to admit "
                   f"{blocked.name} (priority {blocked.priority} > "
                   f"{candidate.priority}; predicted cost "
                   f"{predicted:.0f}s <= queued wait {reclaim:.0f}s)")

    def _plan_grow_back(self, now: float, free: int,
                        admitted: Sequence[SchedJob]
                        ) -> Optional[SchedDecision]:
        """Restore the longest-preempted gang whose entitlement fits the
        free pool again. No decision (None) while the pool is still
        tight — a capacity release is a cluster event that resyncs the
        victim anyway, so no timer is needed for that half."""
        preempted = sorted(
            (j for j in admitted if j.sched_tpus is not None),
            key=lambda j: (j.sched_scaled_at or 0.0, j.name))
        for v in preempted:
            delta = v.chips - v.held_chips
            if delta > 0 and free < delta:
                continue
            cooldown = self.cooldown_seconds(v.last_resize_seconds)
            elapsed = now - (v.sched_scaled_at or 0.0)
            if elapsed < cooldown:
                remaining = cooldown - elapsed
                return SchedDecision(
                    action="skip", victim=v.name,
                    predicted_cost_seconds=self.predicted_cost_seconds(
                        v.last_resize_seconds),
                    reason=f"grow-back of {v.name} cooling down "
                           f"({remaining:.0f}s of {cooldown:.0f}s left)",
                    wake_after=remaining)
            return SchedDecision(
                action="grow_back", victim=v.name,
                from_chips=v.held_chips, to_chips=v.chips,
                reason=f"restoring {v.name} to {v.chips} chips "
                       f"({free} chips free)")
        return None

    # -- degraded-rank migration -----------------------------------------

    def migration(self, now: float, window_age: float,
                  already_migrated: bool) -> SchedDecision:
        """Migrate a DegradedGang dark pod — behind the same gate
        discipline as rebalancing: at most once per degraded window
        (the caller's status marker makes that crash-consistent), and
        only once the window has outlived the cooldown floor (a scrape
        flicker shorter than one resize must never reschedule a pod —
        the reclaim here is the partitioned rank's dead slice-time,
        which only exceeds the pod-restart cost once the window has
        actually persisted)."""
        if already_migrated:
            return SchedDecision(
                action="skip",
                reason="dark rank already migrated this degraded window")
        if window_age < self.cooldown_floor_seconds:
            remaining = self.cooldown_floor_seconds - window_age
            return SchedDecision(
                action="skip",
                predicted_cost_seconds=self.cooldown_floor_seconds,
                reclaim_seconds=round(window_age, 3),
                reason=f"degraded window {window_age:.0f}s has not yet "
                       f"paid for a pod migration "
                       f"({self.cooldown_floor_seconds:.0f}s floor)",
                wake_after=remaining)
        return SchedDecision(
            action="migrate",
            reclaim_seconds=round(window_age, 3),
            reason=f"partitioned rank dark for {window_age:.0f}s; "
                   f"deleting the pod so the StatefulSet reschedules it")
