"""The port's chaos harness (controller/chaos.py) against the JAX
package's: the 25 cases of tests/test_chaos.py on the port's controller,
cluster fakes, observatory and postmortem (the lifecycle case now runs
the seven scenarios, the reference's five in TPU mode and train-gpu and
restart-gpu as nvidia.com/gpu jobs), then the GPU mode and the soak's
determinism across packages. 33 cases.

Three layers, mirroring the harness:

- **Fault injection** (cluster/chaos.py): seeded per-verb/kind rules are
  deterministic and replayable; the controller absorbs transient errors
  via rate-limited requeue (visible in tpu_operator_requeues_total),
  retries conflicts bounded and in place, and converges anyway.
- **Crash-consistent reconcile**: the controller is killed at EVERY
  write boundary (ControllerCrash after the write lands — the
  SIGKILL-shaped schedule) across each lifecycle shape — create,
  restart, resize, pack, disagg serving split, teardown — and must
  converge to the same terminal conditions, restart count, and owned
  resource set as the uninterrupted oracle, leak nothing, wedge no key.
- **Stuck-gang detection** (spec.progressDeadlineSeconds): a Running
  gang whose federated step frontier stops advancing is declared stuck,
  restarted through the ordinary restart-policy path (counted against
  backoffLimit), and the stall window lands in the postmortem. The
  lease runs on a fake clock here (the controller's wake-ups use real
  time; the tests call sync_handler themselves).

The soak's determinism across packages (H23): the fault sequence is
drawn from random.Random(seed) per API call, so it equals the JAX
package's only if the port's controller makes the same calls in the
same order; for seeds 0 and 1 at 5 lifecycles the two soak reports
(faults by verb and error, crashes, controller restarts, writes) are
equal.
"""
import io

import pytest

from mpi_operator_tpu_torch.api import types as api
from mpi_operator_tpu_torch.api.types import COND_STUCK
from mpi_operator_tpu_torch.api.validation import validate_spec
from mpi_operator_tpu_torch.cluster import (
    ConflictError,
    ControllerCrash,
    FaultingAPIServer,
    FaultRule,
    InMemoryAPIServer,
    TransientApiError,
    is_transient,
)
from mpi_operator_tpu_torch.controller import chaos as chaos_mod
from mpi_operator_tpu_torch.controller.chaos import (
    ChaosHarness,
    ConvergenceError,
    SCENARIOS,
    oracle_snapshots,
    soak,
)
from mpi_operator_tpu_torch.controller.controller import ControllerConfig
from mpi_operator_tpu_torch.controller.metrics import render_metrics
from mpi_operator_tpu_torch.telemetry.collector import JobObservatory
from mpi_operator_tpu_torch import postmortem

pytestmark = pytest.mark.chaos


# ---------------------------------------------------------------------------
# fault rules: parsing, matching, determinism
# ---------------------------------------------------------------------------

def test_fault_rule_parses_the_documented_syntax():
    rule = FaultRule.parse("update-status/TPUJob=0.3:conflict")
    assert rule == FaultRule(verb="update-status", kind="TPUJob",
                             rate=0.3, error="conflict")
    assert FaultRule.parse("mutate/*=0.1:transient").matches("delete", "Pod")
    assert not FaultRule.parse("mutate/*=1:transient").matches("get", "Pod")
    wildcard = FaultRule.parse("*/*=1:drop")
    assert wildcard.matches("watch", "StatefulSet")


@pytest.mark.parametrize("bad", [
    "nonsense", "create/Pod=2.0:transient", "create/Pod=0.5:explode"])
def test_fault_rule_rejects_malformed_rules(bad):
    with pytest.raises(ValueError):
        FaultRule.parse(bad)


def test_fault_injection_is_deterministic_per_seed():
    def run(seed):
        server = FaultingAPIServer(InMemoryAPIServer(),
                                   rules=["create/*=0.5:transient"],
                                   seed=seed)
        outcomes = []
        for i in range(40):
            job = api.TPUJob(metadata=api.ObjectMeta(name=f"j{i}",
                                                     namespace="default"),
                             spec=api.TPUJobSpec(replicas=1))
            try:
                server.create(job)
                outcomes.append("ok")
            except TransientApiError:
                outcomes.append("fault")
        return outcomes

    assert run(7) == run(7)
    assert run(7) != run(8)   # astronomically unlikely to collide


def test_transient_fault_leaves_store_unchanged():
    """Faults fire BEFORE the write applies: the client saw an error, the
    server never committed — the retry must find a clean slate."""
    server = FaultingAPIServer(InMemoryAPIServer(),
                               rules=["create/*=1:transient"], seed=0)
    job = api.TPUJob(metadata=api.ObjectMeta(name="j", namespace="default"),
                     spec=api.TPUJobSpec(replicas=1))
    with pytest.raises(TransientApiError) as err:
        server.create(job)
    assert is_transient(err.value)
    assert server.inner.try_get("TPUJob", "default", "j") is None
    assert server.fault_count("transient") == 1


def test_stale_read_serves_previous_version():
    server = FaultingAPIServer(InMemoryAPIServer(),
                               rules=["get/*=1:stale"], seed=0)
    job = api.TPUJob(metadata=api.ObjectMeta(name="j", namespace="default"),
                     spec=api.TPUJobSpec(replicas=1))
    created = server.inner.create(job)
    created.spec.replicas = 2
    server.update(created)                      # snapshots the prior version
    stale = server.get("TPUJob", "default", "j")
    assert stale.spec.replicas == 1             # the lagging watch cache
    assert server.inner.get("TPUJob", "default", "j").spec.replicas == 2


def test_crash_fires_after_the_write_lands():
    """ControllerCrash semantics: the store HAS the write; the client
    never saw the response — the mid-flight state replay must absorb."""
    server = FaultingAPIServer(InMemoryAPIServer(), seed=0)
    job = api.TPUJob(metadata=api.ObjectMeta(name="j", namespace="default"),
                     spec=api.TPUJobSpec(replicas=1))
    server.arm_crash(after_writes=1)
    with pytest.raises(ControllerCrash):
        server.create(job)
    assert server.inner.get("TPUJob", "default", "j") is not None
    assert isinstance(ControllerCrash("x"), BaseException)
    assert not isinstance(ControllerCrash("x"), Exception)  # ≈ SIGKILL


# ---------------------------------------------------------------------------
# client-go discipline: requeue on transient, bounded in-place conflict retry
# ---------------------------------------------------------------------------

def test_transient_fault_requeues_and_counts_reason():
    h = ChaosHarness(rules=["create/ConfigMap=1:transient"], seed=3)
    h.create_job("t1")
    h.drive()
    # every sync dies at the ConfigMap create -> rate-limited requeue
    counters = h.controller.sync_counters
    assert counters.requeues_snapshot().get("transient", 0) >= 1
    text = render_metrics(h.controller)
    assert 'tpu_operator_requeues_total{reason="transient"}' in text
    # lifting the fault lets the SAME key converge (never dropped)
    h.api.rules = []
    h.resync()
    h.drive_until(lambda: h.worker_sets("t1"), "t1 converges after faults")


def test_status_conflicts_are_retried_in_place_and_converge():
    h = ChaosHarness(rules=["update-status/TPUJob=0.5:conflict"], seed=11)
    h.create_job("c1")
    h.drive_until(lambda: h.worker_sets("c1"), "c1 sts")
    h.make_workers_ready("c1")
    h.drive_until(lambda: h.launcher("c1") is not None, "c1 launcher")
    h.set_launcher_active("c1")
    h.finish_launcher("c1")
    h.drive_until(lambda: h.cond("c1", api.COND_SUCCEEDED) == "True",
                  "c1 succeeds through conflicts")
    assert h.api.fault_count("conflict") >= 1
    assert h.controller.sync_counters.requeues_snapshot().get(
        "conflict", 0) >= 0  # most conflicts retire in place, not by requeue


def test_conflict_retry_is_bounded():
    """A conflict storm (rate 1.0) must exhaust MAX_CONFLICT_RETRIES and
    surface as a requeue — not spin in place forever."""
    from mpi_operator_tpu_torch.controller.controller import MAX_CONFLICT_RETRIES
    h = ChaosHarness(rules=["update-status/TPUJob=1:conflict"], seed=5)
    h.create_job("b1")
    before = h.api.fault_count("conflict")
    h.drive(max_items=30)
    per_sync = MAX_CONFLICT_RETRIES + 1
    assert h.api.fault_count("conflict") >= per_sync
    assert h.controller.sync_counters.requeues_snapshot()["conflict"] >= 1
    assert before == 0


# ---------------------------------------------------------------------------
# crash-consistent reconcile: every lifecycle, killed at every write boundary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(SCENARIOS))
def test_lifecycle_converges_with_crash_at_every_write(kind):
    chaos = ChaosHarness(crash_every_write=True, seed=0)
    got = chaos_mod._normalize(SCENARIOS[kind](chaos, f"x-{kind}"),
                               f"x-{kind}")
    want = chaos_mod._normalize(oracle_snapshots(kind, f"o-{kind}"),
                                f"o-{kind}")
    assert got == want
    assert chaos.api.crashes > 0                 # the schedule actually ran
    assert all(not s["leaked"] for s in got.values())
    assert not chaos.queue_wedged()


def test_gang_restart_is_counted_once_across_crash_replays():
    """The launcher-uid marker in the Restarting condition: a crash
    between the status write and the launcher delete replays the sync,
    which must NOT charge a second restart against backoffLimit."""
    h = ChaosHarness(seed=0)
    h.create_job("g1", restart_policy="OnFailure")
    h.drive_until(lambda: h.worker_sets("g1"), "g1 sts")
    h.make_workers_ready("g1")
    h.drive_until(lambda: h.launcher("g1") is not None, "g1 launcher")
    h.set_launcher_active("g1")
    h.drive_until(lambda: h.cond("g1", api.COND_RUNNING) == "True", "g1 run")
    h.finish_launcher("g1", exit_code=137)
    # crash exactly at the restart-count status write: the count lands,
    # the launcher delete does not
    h.api.arm_crash(after_writes=1)
    h.resync()
    with pytest.raises(ControllerCrash):
        while h.controller.process_next_work_item(timeout=0.02):
            pass
    assert h.job("g1").status.restart_count == 1
    assert h.launcher("g1") is not None          # delete never happened
    h.kill_controller()
    h.drive_until(
        lambda: (h.launcher("g1") is not None
                 and not h.launcher("g1").failed()),
        "g1 fresh launcher after replay")
    assert h.job("g1").status.restart_count == 1  # replay did not re-count


def test_small_soak_in_process():
    """The tier-1-sized soak: one pass over every lifecycle shape with
    the full fault mix + crash-every-write. The 25-lifecycle version
    runs out of process via scripts/tier1.sh --chaos."""
    report = soak(seed=0, lifecycles=5)
    assert report["completed"] == 5
    assert report["crashes"] > 0
    assert report["total_faults"] > 0


def test_soak_failure_names_the_reproducer_seed():
    with pytest.raises(ConvergenceError, match="seed=99"):
        raise ConvergenceError("synthetic", seed=99)


# ---------------------------------------------------------------------------
# stuck-gang detection: progress lease end to end
# ---------------------------------------------------------------------------

def _stuck_fixture(tmp_path, policy="OnFailure", deadline=60):
    """A Running gang scraped through a fake clock + frozen step gauge."""
    h = ChaosHarness(config=ControllerConfig(worker_metrics_port=9100))
    clock = {"now": 1000.0}
    step = {"v": 5}

    def fetch(url):
        if url.endswith("/metrics"):
            return f"tpu_worker_step {step['v']}\n"
        raise IOError("no events endpoint in this fixture")

    obs = JobObservatory(events_dir=str(tmp_path),
                         clock=lambda: clock["now"], fetch=fetch,
                         scrape_interval=0.0)
    h.controller.observatory = obs
    h.create_job("s1", restart_policy=policy,
                 progress_deadline_seconds=deadline)
    sync = lambda: h.controller.sync_handler("default/s1")  # noqa: E731
    sync()
    h.resync()
    h.make_workers_ready("s1")
    sync()
    h.resync()
    h.set_launcher_active("s1")
    h.resync()
    sync()                                   # Running; lease armed at step 5
    h.resync()
    return h, clock, step, sync, obs


def test_progress_deadline_requires_positive_seconds():
    spec = api.TPUJobSpec(tpus=8, progress_deadline_seconds=0)
    with pytest.raises(ValueError, match="progressDeadlineSeconds"):
        validate_spec(spec)


def test_stall_below_deadline_is_not_stuck(tmp_path):
    h, clock, _step, sync, _obs = _stuck_fixture(tmp_path)
    clock["now"] += 30                       # 30s of zero progress, < 60s
    sync()
    job = h.job("s1")
    assert job.status.get_condition(COND_STUCK) is None
    assert job.status.restart_count == 0


def test_stuck_gang_restarts_and_lands_in_postmortem(tmp_path):
    h, clock, step, sync, obs = _stuck_fixture(tmp_path)
    clock["now"] += 70                       # stall 70s >= deadline 60s
    sync()
    h.resync()

    job = h.job("s1")
    stuck = job.status.get_condition(COND_STUCK)
    assert stuck is not None and stuck.status == "True"
    assert stuck.reason == "ProgressDeadlineExceeded"
    assert "no observed step progress for 70s" in stuck.message
    # the ordinary restart-policy path: counted against backoffLimit
    assert job.status.restart_count == 1
    restarting = job.status.get_condition(api.COND_RESTARTING)
    assert restarting.reason == "GangStuck"
    assert h.launcher("s1") is None          # gang torn down
    assert any(e.reason == "GangStuck" and e.type == "Warning"
               for e in h.controller.recorder.events)

    # timeline: gang_stuck then gang_restart, stall window named
    records = obs.merged_records("s1")
    kinds = [r["event"] for r in records]
    assert "gang_stuck" in kinds
    assert kinds.index("gang_stuck") < kinds.index("gang_restart")
    stuck_rec = next(r for r in records if r["event"] == "gang_stuck")
    assert stuck_rec["stall_seconds"] == pytest.approx(70.0)
    assert stuck_rec["progress_deadline_seconds"] == 60

    # postmortem renders the stall as an incident with its resolution
    summary = postmortem.summarize(records)
    assert len(summary["stalls"]) == 1
    stall = summary["stalls"][0]
    assert stall["stall_seconds"] == pytest.approx(70.0)
    assert stall["resolution"] == "gang_restart"
    buf = io.StringIO()
    postmortem.render(summary, buf)
    out = buf.getvalue()
    assert "stuck gangs:" in out
    assert "no step progress for" in out

    # recovery: gang comes back, step advances, verdict retires
    sync()                                   # recreates the launcher
    h.resync()
    assert h.launcher("s1") is not None
    h.set_launcher_active("s1")
    h.resync()
    step["v"] = 6
    clock["now"] += 5
    sync()                                   # re-arms lease on fresh scrape
    h.resync()
    clock["now"] += 5
    sync()
    h.resync()
    resumed = h.job("s1").status.get_condition(COND_STUCK)
    assert resumed.status == "False"
    assert resumed.reason == "ProgressResumed"


def test_stuck_gang_with_policy_never_fails_terminally(tmp_path):
    h, clock, _step, sync, obs = _stuck_fixture(tmp_path, policy="Never")
    clock["now"] += 120
    sync()
    h.resync()
    job = h.job("s1")
    failed = job.status.get_condition(api.COND_FAILED)
    assert failed is not None and failed.status == "True"
    assert failed.reason == "StuckGang"
    assert job.status.restart_count == 0
    assert h.launcher("s1") is None
    records = obs.merged_records("s1")
    assert [r["event"] for r in records
            if r["event"] in ("gang_stuck", "job_failed")] == [
        "gang_stuck", "job_failed"]
    stall = postmortem.summarize(records)["stalls"][0]
    assert stall["resolution"] == "job_failed"
    # crash replay after the terminal verdict: the level-triggered
    # teardown clause must finish deleting a resurrected launcher
    sync()
    assert h.launcher("s1") is None


def test_all_scrapes_stale_freezes_the_frontier(tmp_path):
    """A dead metrics plane reads as a stall BY DESIGN: an unobservable
    gang cannot prove liveness."""
    h, clock, _step, sync, obs = _stuck_fixture(tmp_path)

    def broken(_url):
        raise IOError("metrics endpoint dark")

    obs.fetch = broken
    clock["now"] += 70                       # every scrape now fails
    sync()
    h.resync()
    assert h.job("s1").status.restart_count == 1
    assert h.job("s1").status.get_condition(COND_STUCK).status == "True"


# ---------------------------------------------------------------------------
# dropped watch events: the informer re-list heals a wedged cache
# ---------------------------------------------------------------------------

def test_relist_evicts_objects_whose_delete_event_was_dropped():
    h = ChaosHarness(seed=0)
    h.create_job("d1")
    h.drive_until(lambda: h.worker_sets("d1"), "d1 sts")
    # drop EVERY watch event from here on: the controller never hears
    # about the deletion
    h.api.rules = [FaultRule.parse("watch/*=1:drop")]
    uid = h.job("d1").metadata.uid
    h.inner.delete("TPUJob", "default", "d1")
    h.inner.cascade_delete(uid)
    assert h.controller.job_lister.try_get("default", "d1") is not None
    h.resync()                               # the periodic re-list
    assert h.controller.job_lister.try_get("default", "d1") is None
    h.drive()
    assert h.owned(uid) == []


# ---------------------------------------------------------------------------
# GPU mode: nvidia.com/gpu jobs under the operator's defaults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", chaos_mod.GPU_LIFECYCLES)
def test_gpu_lifecycle_workers_ask_for_cards(kind):
    """The GPU lifecycles' workers carry nvidia.com/gpu limits of 8 (the
    operator's default a worker, 2 workers for processingUnits 16) under
    crash-every-write; the lifecycle case above holds each snapshot,
    limits included, to its oracle."""
    snaps = SCENARIOS[kind](ChaosHarness(crash_every_write=True, seed=3),
                            f"g-{kind}")
    (snap,) = snaps.values()
    assert snap["limits"] == [[(api.RESOURCE_GPU, 8)]]
    assert snap["restart_count"] == (1 if kind == "restart-gpu" else 0)
    sets = [r for r in snap["resources"] if r[0] == "StatefulSet"]
    assert sets == [("StatefulSet", f"g-{kind}-worker")]


def test_gpu_soak_in_process():
    """The GPU soak the CLI runs after the main one (each GPU lifecycle
    twice): train and restart as nvidia.com/gpu jobs under the full
    fault mix and crash-every-write, each against its oracle."""
    report = soak(seed=0, lifecycles=4, kinds=chaos_mod.GPU_LIFECYCLES)
    assert report["completed"] == 4
    assert report["crashes"] > 0
    assert report["total_faults"] > 0


def test_tpus_jobs_stay_tpu_mode_under_the_gpu_defaults():
    """The harness's controller runs on the port's GPU defaults, and a
    tpus job still renders google.com/tpu workers: the reference's
    lifecycles keep their mode."""
    h = ChaosHarness(seed=0)
    assert h.controller.config.processing_resource_type == api.RESOURCE_GPU
    h.create_job("t1")
    h.drive_until(lambda: h.worker_sets("t1"), "t1 sts")
    (sts,) = h.worker_sets("t1")
    assert sts.spec.template.main_container().limits == {
        api.RESOURCE_TPU: 4}


# ---------------------------------------------------------------------------
# H23: the soak is the JAX package's soak, fault for fault
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_soak_report_equals_the_reference(seed):
    from mpi_operator_tpu.controller import chaos as jchaos
    want = jchaos.soak(seed=seed, lifecycles=5)
    got = soak(seed=seed, lifecycles=5)
    assert got == want
    assert got["crashes"] > 0 and got["total_faults"] > 0
