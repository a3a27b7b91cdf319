"""The fleet scheduler of the port's operator against the reference's:
the 31 cases of tests/test_scheduler.py, unchanged but for their
imports, on the port's controller/scheduler.py, controller glue,
serializer and postmortem.

Policy tests exercise FleetScheduler directly — it is a deterministic
function of (now, fleet view), no cluster needed. Glue tests reuse the
test_controller.py fixture idiom: InMemoryAPIServer as both tracker and
informer source, sync_handler called synchronously. The jobs keep the
tpus sizing mode (TPU mode, whatever the operator's GPU defaults), the
mode the fleet scheduler counts.
"""
import copy
import io
import time

import pytest

from mpi_operator_tpu_torch.api import types as api
from mpi_operator_tpu_torch.api.types import (
    Container, ObjectMeta, PodTemplateSpec, TPUJob, TPUJobSpec,
)
from mpi_operator_tpu_torch.api.validation import ValidationError, validate_spec
from mpi_operator_tpu_torch.cluster.apiserver import InMemoryAPIServer
from mpi_operator_tpu_torch.cluster.serialize import from_manifest, to_manifest
from mpi_operator_tpu_torch.controller import ControllerConfig, TPUJobController
from mpi_operator_tpu_torch.controller.controller import WORKER_SUFFIX
from mpi_operator_tpu_torch.controller.scheduler import (
    FleetScheduler, SchedDecision, SchedJob, ledger_cost,
)
from mpi_operator_tpu_torch import postmortem
from mpi_operator_tpu_torch.telemetry import events as ev


# ---------------------------------------------------------------------------
# fixture (same shape as test_controller.py's)
# ---------------------------------------------------------------------------

class Fixture:
    def __init__(self, **config_kwargs):
        self.api = InMemoryAPIServer()
        self.controller = TPUJobController(
            self.api, config=ControllerConfig(**config_kwargs)
        )
        self.controller.factory.start_all()

    def seed(self, obj):
        return self.api.create(obj)

    def run(self, key):
        self.api.clear_actions()
        self.controller.sync_handler(key)
        return self.api.write_actions()

    def job(self, name):
        return self.api.get(api.KIND, "default", name)

    def worker_set(self, name):
        return self.api.try_get("StatefulSet", "default",
                                name + WORKER_SUFFIX)

    def cond(self, name, ctype):
        return self.job(name).status.get_condition(ctype)


def new_job(name="test", tpus=8, **kw) -> TPUJob:
    spec = TPUJobSpec(
        tpus=tpus,
        template=PodTemplateSpec(
            containers=[Container(name="train", image="tpu-bench:latest")]
        ),
        **kw,
    )
    return TPUJob(metadata=ObjectMeta(name=name, namespace="default"),
                  spec=spec)


class FakeObservatory:
    """The two observatory surfaces the scheduler glue touches, recorded
    raw (the real note_sched dedup is collector.py's concern)."""

    def __init__(self, dark=frozenset(), total=0):
        self.sched = []
        self._dark = set(dark)
        self._total = total

    def merged_records(self, job):
        return []

    def __getattr__(self, name):
        # the glue calls many note_* hooks; only note_sched matters here
        if name.startswith("note_"):
            return lambda *a, **k: None
        raise AttributeError(name)

    def partition_state(self, job):
        return set(self._dark), self._total

    def note_sched(self, job, event, token, **fields):
        self.sched.append({"job": job, "event": event, "token": token,
                           **fields})


# ---------------------------------------------------------------------------
# ledger_cost: incomplete resize entries fall back, never KeyError/zero
# ---------------------------------------------------------------------------

def test_ledger_cost_empty_ledger_uses_default():
    assert ledger_cost([], 60.0) == 60.0


def test_ledger_cost_skips_incomplete_entries():
    # a crash mid-drain leaves entries with NO total_seconds (and a
    # died-before-resume one with total 0 is equally unusable): the read
    # must fall back to the newest MEASURED total, never raise, never
    # return zero
    resizes = [
        {"ts": 1.0, "total_seconds": 42.0},
        {"ts": 2.0, "drain_seconds": 3.0},          # crashed mid-resize
        {"ts": 3.0, "total_seconds": 0},            # degenerate
        {"ts": 4.0},                                # nothing measured
    ]
    assert ledger_cost(resizes, 60.0) == 42.0


def test_ledger_cost_newest_measured_wins():
    resizes = [{"total_seconds": 10.0}, {"total_seconds": 99.0}]
    assert ledger_cost(resizes, 60.0) == 99.0


def test_ledger_cost_all_incomplete_uses_default():
    resizes = [{"drain_seconds": 1.0}, {"restore_seconds": 2.0}]
    assert ledger_cost(resizes, 7.5) == 7.5


# ---------------------------------------------------------------------------
# policy: admission order + strict head-of-line
# ---------------------------------------------------------------------------

def _sched(pool=8, floor=0.0, mult=4.0):
    return FleetScheduler(pool_chips=pool, cooldown_floor_seconds=floor,
                          cooldown_multiplier=mult)


def test_admission_descending_priority_then_creation_order():
    s = _sched(pool=8)
    jobs = [
        SchedJob(name="d/old-low", priority=0, created=1.0, chips=2,
                 pending=True),
        SchedJob(name="d/young-high", priority=2, created=9.0, chips=2,
                 pending=True),
        SchedJob(name="d/old-high", priority=2, created=5.0, chips=2,
                 pending=True),
    ]
    plan = s.plan(100.0, jobs)
    assert [n for n, _ in plan.admit] == [
        "d/old-high", "d/young-high", "d/old-low"]
    assert plan.hold == []
    assert plan.action is None


def test_strict_head_of_line_no_backfill():
    # the blocked high-priority claim must not be starved by a stream of
    # small low-priority arrivals that WOULD fit
    s = _sched(pool=8)
    jobs = [
        SchedJob(name="d/running", chips=8, held_chips=8),
        SchedJob(name="d/big-high", priority=2, created=1.0, chips=8,
                 pending=True, queued_since=90.0),
        SchedJob(name="d/small-low", priority=0, created=2.0, chips=2,
                 pending=True),
    ]
    plan = s.plan(100.0, jobs)
    assert plan.admit == []
    holds = dict(plan.hold)
    assert "needs 8 chips" in holds["d/big-high"]
    assert holds["d/small-low"] == "behind d/big-high"


# ---------------------------------------------------------------------------
# policy: preempt victim selection + ladder target
# ---------------------------------------------------------------------------

def test_preempt_picks_lowest_priority_then_youngest_victim():
    s = _sched(pool=8)
    jobs = [
        SchedJob(name="d/old-low", priority=0, created=1.0, chips=4,
                 held_chips=4, elastic=True, shrink_ladder=(2, 1)),
        SchedJob(name="d/young-low", priority=0, created=5.0, chips=4,
                 held_chips=4, elastic=True, shrink_ladder=(2, 1)),
        SchedJob(name="d/hi", priority=1, chips=2, pending=True,
                 queued_since=0.0),
    ]
    plan = s.plan(100.0, jobs)
    assert plan.action is not None and plan.action.action == "preempt"
    assert plan.action.victim == "d/young-low"   # newest claim yields


def test_preempt_takes_largest_ladder_target_that_frees_enough():
    s = _sched(pool=8)
    jobs = [
        SchedJob(name="d/lo", priority=0, chips=8, held_chips=8,
                 elastic=True, shrink_ladder=(4, 2, 1)),
        SchedJob(name="d/hi", priority=1, chips=4, pending=True,
                 queued_since=0.0),
    ]
    plan = s.plan(100.0, jobs)
    d = plan.action
    assert d.action == "preempt" and d.to_chips == 4   # not 2, not 1


def test_preempt_never_targets_nonelastic_equal_priority_or_preempted():
    # pool exactly full (7 held of 7) so the already-shrunk job cannot
    # grow back either — the pass must end with NO action at all
    s = _sched(pool=7)
    jobs = [
        SchedJob(name="d/rigid", priority=0, chips=3, held_chips=3),
        SchedJob(name="d/peer", priority=1, chips=3, held_chips=3,
                 elastic=True, shrink_ladder=(1,)),
        SchedJob(name="d/shrunk", priority=0, chips=2, held_chips=1,
                 elastic=True, shrink_ladder=(1,), sched_tpus=1,
                 sched_scaled_at=0.0, preempt_beneficiary="d/other"),
        SchedJob(name="d/hi", priority=1, chips=4, pending=True,
                 queued_since=0.0),
    ]
    plan = s.plan(100.0, jobs)
    assert plan.action is None
    skips = [d for d in plan.skips if d.beneficiary == "d/hi"]
    assert skips and "no viable victim" in skips[0].reason


# ---------------------------------------------------------------------------
# policy: the cost gate (anti-thrash) and the cooldown brake
# ---------------------------------------------------------------------------

def test_cost_gate_declines_until_wait_pays_for_resize():
    # victim's last measured resize cost 100s, beneficiary queued 5s ago:
    # reclaimable slice-time < ledger cost -> explicit skip with the
    # evidence, wake armed for the crossover point
    s = _sched(pool=8, floor=0.0)
    jobs = [
        SchedJob(name="d/lo", priority=0, chips=8, held_chips=8,
                 elastic=True, shrink_ladder=(4,),
                 last_resize_seconds=100.0),
        SchedJob(name="d/hi", priority=1, chips=4, pending=True,
                 queued_since=95.0),
    ]
    plan = s.plan(100.0, jobs)
    assert plan.action is None
    d = plan.skips[0]
    assert d.action == "skip"
    assert d.predicted_cost_seconds == 100.0
    assert d.reclaim_seconds == 5.0
    assert d.wake_after == pytest.approx(95.0)
    assert plan.wake_after == pytest.approx(95.0)
    # ...and the admission is only DELAYED: once the wait crosses the
    # predicted cost the same fleet state preempts
    plan2 = s.plan(200.0, jobs)
    assert plan2.action is not None and plan2.action.action == "preempt"


def test_cooldown_brake_multiplies_last_measured_cost():
    s = _sched(pool=8, floor=10.0, mult=4.0)
    assert s.cooldown_seconds(None) == 10.0       # floor until measured
    assert s.cooldown_seconds(1.0) == 10.0        # never below the floor
    assert s.cooldown_seconds(50.0) == 200.0


def test_recently_scaled_victim_cools_down_with_wake():
    s = _sched(pool=8, floor=60.0)
    jobs = [
        # grew back at t=90 (sched_tpus cleared, stamp remains): the
        # brake must hold a re-preempt until the cooldown elapses
        SchedJob(name="d/lo", priority=0, chips=8, held_chips=8,
                 elastic=True, shrink_ladder=(4,), sched_scaled_at=90.0),
        SchedJob(name="d/hi", priority=1, chips=4, pending=True,
                 queued_since=0.0),
    ]
    plan = s.plan(100.0, jobs)
    assert plan.action is None
    d = plan.skips[0]
    assert "cooling down" in d.reason
    assert d.wake_after == pytest.approx(50.0)


def test_grow_back_when_pool_frees_and_at_most_one_action_per_pass():
    s = _sched(pool=8, floor=0.0)
    shrunk = SchedJob(name="d/lo", priority=0, chips=8, held_chips=4,
                      elastic=True, sched_tpus=4, sched_scaled_at=0.0,
                      preempt_beneficiary="d/hi")
    # pool still tight: no decision, no timer (a capacity release
    # resyncs the victim anyway)
    tight = SchedJob(name="d/hi", priority=1, chips=4, held_chips=4)
    plan = s.plan(100.0, [shrunk, tight])
    assert plan.action is None and plan.skips == []
    # beneficiary done -> grow back; and even with another pending job
    # blocked, the pass emits AT MOST ONE action
    done = SchedJob(name="d/hi", priority=1, chips=4, done=True)
    plan = s.plan(100.0, [shrunk, done])
    d = plan.action
    assert d.action == "grow_back"
    assert (d.from_chips, d.to_chips) == (4, 8)


def test_grow_back_respects_cooldown():
    s = _sched(pool=8, floor=60.0)
    shrunk = SchedJob(name="d/lo", priority=0, chips=8, held_chips=4,
                      elastic=True, sched_tpus=4, sched_scaled_at=70.0)
    plan = s.plan(100.0, [shrunk])
    assert plan.action is None
    assert plan.skips[0].wake_after == pytest.approx(30.0)


# ---------------------------------------------------------------------------
# policy: degraded-rank migration gate
# ---------------------------------------------------------------------------

def test_migration_once_per_window_and_cost_floor():
    s = _sched(pool=8, floor=60.0)
    early = s.migration(100.0, window_age=10.0, already_migrated=False)
    assert early.action == "skip"
    assert early.wake_after == pytest.approx(50.0)
    ripe = s.migration(100.0, window_age=75.0, already_migrated=False)
    assert ripe.action == "migrate"
    again = s.migration(100.0, window_age=200.0, already_migrated=True)
    assert again.action == "skip"
    assert "already migrated" in again.reason


# ---------------------------------------------------------------------------
# glue: admission + hold through the controller
# ---------------------------------------------------------------------------

def test_first_job_admitted_and_stamped_then_second_held():
    f = Fixture(sched_pool_chips=8, sched_cooldown_floor_seconds=0.0)
    f.seed(new_job("lo", tpus=8))
    f.run("default/lo")
    qc = f.cond("lo", api.COND_QUEUED)
    assert qc is not None and qc.status == "False"
    assert f.worker_set("lo") is not None
    # a rigid second job cannot fit and cannot preempt: held with a
    # Queued condition and ZERO resources created
    f.seed(new_job("hi", tpus=8, priority=1))
    actions = f.run("default/hi")
    qc = f.cond("hi", api.COND_QUEUED)
    assert qc is not None and qc.status == "True"
    assert qc.reason == "SchedQueued"
    assert f.worker_set("hi") is None
    assert all(a.verb == "update-status" for a in actions)


def test_preempt_to_admit_then_grow_back_end_to_end():
    f = Fixture(sched_pool_chips=8, sched_cooldown_floor_seconds=0.0)
    f.seed(new_job("lo", tpus=8, elastic=True, min_tpus=2))
    f.run("default/lo")
    assert f.worker_set("lo").spec.replicas == 2

    # hi arrives: its own sync queues it AND executes the preempt as a
    # guarded cross-job status write on lo
    f.seed(new_job("hi", tpus=4, priority=1))
    f.run("default/hi")
    lo = f.job("lo")
    assert lo.status.sched_tpus == 4
    pc = lo.status.get_condition(api.COND_PREEMPTED)
    assert pc is not None and pc.status == "True"
    assert "for=default/hi" in pc.message

    # hi's replan (the self re-enqueue) admits it into the freed chips
    f.run("default/hi")
    qc = f.cond("hi", api.COND_QUEUED)
    assert qc is not None and qc.status == "False"
    assert "via preempt" in qc.message
    assert f.worker_set("hi") is not None

    # lo's next sync materializes the shrink (2 -> 1 worker)
    f.run("default/lo")
    assert f.worker_set("lo").spec.replicas == 1

    # hi completes; lo's sync grows it back and rescales the same pass
    hi = f.job("hi")
    hi.status.set_condition(api.JobCondition(
        api.COND_SUCCEEDED, "True", "JobSucceeded", "done"))
    f.api.update_status(hi)
    f.run("default/lo")
    lo = f.job("lo")
    assert lo.status.sched_tpus is None
    pc = lo.status.get_condition(api.COND_PREEMPTED)
    assert pc is not None and pc.status == "False"
    assert f.worker_set("lo").spec.replicas == 2


def test_preempt_victim_guard_blocks_double_shrink():
    # the crash-replay guard: a victim that ALREADY carries a scheduler
    # override is never written again, whatever the decision says
    f = Fixture(sched_pool_chips=8, sched_cooldown_floor_seconds=0.0)
    f.seed(new_job("lo", tpus=8, elastic=True, min_tpus=2))
    f.run("default/lo")
    lo = f.job("lo")
    lo.status.sched_tpus = 4
    f.api.update_status(lo)
    f.api.clear_actions()
    f.controller._preempt_victim(SchedDecision(
        action="preempt", victim="default/lo", beneficiary="default/x",
        from_chips=8, to_chips=2, predicted_cost_seconds=0.0,
        reclaim_seconds=1.0))
    assert f.api.write_actions() == []
    assert f.job("lo").status.sched_tpus == 4          # unchanged


def test_anti_thrash_pin_holds_admission_and_records_skip():
    # floor >> any accrued wait: the gate must DECLINE (hi stays Queued,
    # lo untouched) and leave an explicit sched_skip with the evidence —
    # never a resize
    f = Fixture(sched_pool_chips=8,
                sched_cooldown_floor_seconds=3600.0)
    obs = FakeObservatory()
    f.controller.observatory = obs
    f.seed(new_job("lo", tpus=8, elastic=True, min_tpus=2))
    f.run("default/lo")
    f.seed(new_job("hi", tpus=4, priority=1))
    f.run("default/hi")
    f.run("default/hi")
    assert f.job("lo").status.sched_tpus is None
    assert f.worker_set("lo").spec.replicas == 2
    qc = f.cond("hi", api.COND_QUEUED)
    assert qc is not None and qc.status == "True"
    skips = [r for r in obs.sched if r["event"] == "sched_skip"
             and r["job"] == "hi"]
    assert skips
    assert skips[0]["predicted_cost_seconds"] == 3600.0
    assert skips[0]["reclaim_seconds"] < 3600.0


# ---------------------------------------------------------------------------
# glue: degraded-rank migration (status-first, once per window)
# ---------------------------------------------------------------------------

def _degraded_fixture(floor=0.0):
    f = Fixture(sched_cooldown_floor_seconds=floor)
    f.seed(new_job("mig", tpus=8, restart_policy="OnFailure"))
    f.run("default/mig")
    obs = FakeObservatory(dark={0}, total=2)
    f.controller.observatory = obs
    job = f.job("mig")
    job.status.set_condition(api.JobCondition(
        api.COND_DEGRADED_GANG, "True", "PartialPartition",
        "rank 0 unreachable, progress still observed"))
    job = f.api.update_status(job)
    alloc = f.controller.allocate_processing_units(job, False)
    return f, obs, job, alloc


def test_migration_deletes_dark_pod_once_per_window():
    f, obs, job, alloc = _degraded_fixture(floor=0.0)
    pod_names = f.controller.worker_pod_names(job, alloc)
    job = f.controller._sched_migrate_reconcile(job, alloc, "default/mig")
    assert job.status.migration_count == 1
    window = job.status.migrated_window
    assert window is not None and window.endswith(pod_names[0])
    migs = [r for r in obs.sched if r["event"] == "sched_migrate"]
    assert len(migs) == 1 and migs[0]["rank"] == 0
    # distinct from gang restarts: the restart counter never moved
    assert f.job("mig").status.restart_count == 0
    # replayed sync (same window): marker matches -> no second count
    replay = f.job("mig")
    replay = f.controller._sched_migrate_reconcile(
        replay, alloc, "default/mig")
    assert replay.status.migration_count == 1
    assert replay.status.migrated_window == window


def test_migration_skipped_below_cost_floor():
    f, obs, job, alloc = _degraded_fixture(floor=3600.0)
    job = f.controller._sched_migrate_reconcile(job, alloc, "default/mig")
    assert job.status.migration_count == 0
    assert job.status.migrated_window is None
    skips = [r for r in obs.sched if r["event"] == "sched_skip"]
    assert skips and "has not yet paid" in skips[0]["reason"]


def test_migration_ignores_total_partition():
    # every rank dark is a dead gang, not a partition — the restart
    # path owns it, the migration hook must not touch a pod
    f, obs, job, alloc = _degraded_fixture(floor=0.0)
    obs._dark = {0, 1}
    job = f.controller._sched_migrate_reconcile(job, alloc, "default/mig")
    assert job.status.migration_count == 0
    assert obs.sched == []


# ---------------------------------------------------------------------------
# serialized surface + admission validation
# ---------------------------------------------------------------------------

def test_priority_and_sched_status_round_trip():
    job = new_job("rt", tpus=8, priority=3)
    job.status.sched_tpus = 4
    job.status.sched_scaled_at = 1700000000.0
    job.status.migration_count = 2
    job.status.migrated_window = "1700000000.000:uid-9"
    back = from_manifest(to_manifest(job))
    assert back.spec.priority == 3
    assert back.status.sched_tpus == 4
    assert back.status.sched_scaled_at == pytest.approx(1700000000.0)
    assert back.status.migration_count == 2
    assert back.status.migrated_window == "1700000000.000:uid-9"
    # default priority serializes away entirely
    assert "priority" not in to_manifest(new_job("d"))["spec"]


@pytest.mark.parametrize("bad", [-1, True, 1.5, "2"])
def test_priority_validation_rejects_non_nonnegative_int(bad):
    job = new_job("bad", tpus=8)
    job.spec.priority = bad
    with pytest.raises(ValidationError, match="priority"):
        validate_spec(job.spec)


def test_priority_validation_accepts_zero_and_positive():
    for ok in (0, 7):
        job = new_job("ok", tpus=8, priority=ok)
        validate_spec(job.spec)


# ---------------------------------------------------------------------------
# postmortem: the "scheduler actions:" section
# ---------------------------------------------------------------------------

def _sched_timeline():
    return [
        {"ts": 100.0, "event": ev.JOB_CREATED, "host": "c", "job": "d/lo"},
        {"ts": 101.0, "event": ev.SCHED_QUEUE, "host": "c", "job": "d/hi",
         "reason": "waiting for 4 chips", "priority": 1},
        {"ts": 110.0, "event": ev.SCHED_PREEMPT, "host": "c",
         "job": "d/lo", "victim": "d/lo", "beneficiary": "d/hi",
         "from_tpus": 8, "to_tpus": 4, "predicted_cost_seconds": 60.0},
        {"ts": 112.0, "event": ev.GANG_RESIZE, "host": "c", "job": "d/lo",
         "tpus": 4},
        {"ts": 154.0, "event": ev.FIRST_RESUME_STEP, "host": "w",
         "job": "d/lo", "seconds": 39.0, "step": 12},
        {"ts": 116.0, "event": ev.SCHED_ADMIT, "host": "c", "job": "d/hi",
         "via": "preempt", "waited_seconds": 15.0},
        {"ts": 300.0, "event": ev.SCHED_SKIP, "host": "c", "job": "d/h2",
         "reason": "queued wait 4s has not yet paid for 42s",
         "predicted_cost_seconds": 42.0, "reclaim_seconds": 4.0},
        {"ts": 400.0, "event": ev.SCHED_GROW_BACK, "host": "c",
         "job": "d/lo", "from_tpus": 4, "to_tpus": 8},
        {"ts": 500.0, "event": ev.SCHED_MIGRATE, "host": "c",
         "job": "d/lo", "rank": 0, "pod": "lo-worker-0",
         "migration_count": 1, "window_age_seconds": 75.0},
        {"ts": 600.0, "event": ev.JOB_SUCCEEDED, "host": "c",
         "job": "d/lo"},
    ]


def test_postmortem_pairs_predicted_with_measured_cost():
    records = sorted(_sched_timeline(), key=lambda r: r["ts"])
    summary = postmortem.summarize(records)
    actions = summary["scheduler_actions"]
    assert [a["event"] for a in actions] == [
        ev.SCHED_QUEUE, ev.SCHED_PREEMPT, ev.SCHED_ADMIT, ev.SCHED_SKIP,
        ev.SCHED_GROW_BACK, ev.SCHED_MIGRATE]
    preempt = actions[1]
    assert preempt["predicted_cost_seconds"] == 60.0
    # measured = the total of the resize the preempt caused (drain ->
    # first resumed step), read from the SAME resize ledger the live
    # cost gate uses
    assert preempt["measured_cost_seconds"] == pytest.approx(42.0)
    # grow-back never completed a resize afterwards: predicted-only
    assert "measured_cost_seconds" not in actions[4]
    # sched_* kinds are their own section, not noise in other_events
    assert not any(k.startswith("sched_") for k in summary["other_events"])


def test_postmortem_renders_scheduler_actions_section():
    records = sorted(_sched_timeline(), key=lambda r: r["ts"])
    out = io.StringIO()
    postmortem.render(postmortem.summarize(records), out)
    text = out.getvalue()
    assert "scheduler actions:" in text
    assert "preempt    victim d/lo -> beneficiary d/hi" in text
    assert "measured 42.0s" in text
    assert "skip       d/h2" in text
    assert "grow back  d/lo  4 -> 8 tpus" in text
    assert "migrate    d/lo rank 0 pod lo-worker-0" in text


def test_postmortem_without_sched_records_has_no_section():
    records = [
        {"ts": 1.0, "event": ev.JOB_CREATED, "host": "c", "job": "d/a"},
        {"ts": 2.0, "event": ev.JOB_SUCCEEDED, "host": "c", "job": "d/a"},
    ]
    summary = postmortem.summarize(records)
    assert summary["scheduler_actions"] == []
    out = io.StringIO()
    postmortem.render(summary, out)
    assert "scheduler actions:" not in out.getvalue()
