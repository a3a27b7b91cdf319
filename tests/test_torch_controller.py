"""Controller reconcile tests.

Mirrors the reference's single test layer — controller unit tests against
fake clientsets asserting the exact emitted write actions
(reference pkg/controllers/mpi_job_controller_test.go, 16 scenarios at
:466-789; fixture/oracle mechanics at :48-311, SURVEY.md §4).

The fixture here plays the same roles: the InMemoryAPIServer is both the
fake object tracker (recording Actions) and the informer source; sync_handler
is called synchronously with zero concurrency (ref alwaysReady stubs :169-177).

The scenarios of tests/test_controller.py against the PyTorch port's
controller (mpi_operator_tpu_torch.controller), in TPU mode as the JAX
tests run them: every controller here is built on TPU_MODE, the JAX
controller's defaults (the port's own defaults are GPU ones). The GPU
cases, the differential test against the JAX controller and the
observatory's switches (each builds the job observatory, the worker env
carries TPU_METRICS_PORT, the demo runs with them and without torch)
follow the copied scenarios.
"""
import pytest

from mpi_operator_tpu_torch.api import types as api
from mpi_operator_tpu_torch.api.types import (
    Container, ObjectMeta, PodTemplateSpec, TPUJob, TPUJobSpec,
)
from mpi_operator_tpu_torch.cluster.apiserver import InMemoryAPIServer
from mpi_operator_tpu_torch.cluster.resources import (
    ConfigMap, Job, JobStatus, Role, ServiceAccount, StatefulSet,
    StatefulSetSpec, StatefulSetStatus, RoleBinding,
)
from mpi_operator_tpu_torch.controller import (
    ControllerConfig, ForeignOwnershipError, TPUJobController,
)
from mpi_operator_tpu_torch.controller.controller import (
    CONFIG_SUFFIX, LAUNCHER_SUFFIX, WORKER_SUFFIX,
)


# ---------------------------------------------------------------------------
# fixture (ref mpi_job_controller_test.go:48-267)
# ---------------------------------------------------------------------------

#: the JAX controller's defaults: the copied scenarios run in TPU mode
TPU_MODE = dict(processing_resource_type=api.RESOURCE_TPU,
                processing_units_per_worker=4)


class Fixture:
    def __init__(self, **config_kwargs):
        self.api = InMemoryAPIServer()
        self.controller = TPUJobController(
            self.api, config=ControllerConfig(**{**TPU_MODE, **config_kwargs})
        )
        self.controller.factory.start_all()

    def seed(self, obj):
        """Seed both the fake tracker and the informer cache, like setUp*
        helpers (ref :401-445). Watch events keep informers in sync."""
        return self.api.create(obj)

    def run(self, key, expect_error=None):
        """ref: fixture.run/runController (:214-267). Clears setup actions so
        assertions see only what sync emitted."""
        self.api.clear_actions()
        if expect_error is None:
            self.controller.sync_handler(key)
        else:
            with pytest.raises(expect_error):
                self.controller.sync_handler(key)
        return self.api.write_actions()


def new_job(name="test", tpus=8, **kw) -> TPUJob:
    spec = TPUJobSpec(
        tpus=tpus,
        template=PodTemplateSpec(
            containers=[Container(name="train", image="tpu-bench:latest")]
        ),
        **kw,
    )
    return TPUJob(metadata=ObjectMeta(name=name, namespace="default"), spec=spec)


def owned(job: TPUJob):
    return [job.controller_owner_reference()]


def verbs(actions):
    return [(a.verb, a.kind) for a in actions]


# ---------------------------------------------------------------------------
# no-op paths (ref TestDoNothingWithInvalidKey / NonexistentMPIJob :466-477)
# ---------------------------------------------------------------------------

def test_invalid_key_is_noop():
    f = Fixture()
    actions = f.run("metadata")     # no namespace separator
    assert actions == []


def test_nonexistent_job_is_noop():
    f = Fixture()
    actions = f.run("default/nonexistent")
    assert actions == []


# ---------------------------------------------------------------------------
# full creation fan-out (ref TestAllResourcesCreated :533-562)
# ---------------------------------------------------------------------------

def test_all_resources_created():
    f = Fixture()
    job = f.seed(new_job(tpus=8))   # 8 chips / 4 per worker = 2 workers
    actions = f.run("default/test")
    assert verbs(actions) == [
        ("create", "ConfigMap"),
        ("create", "Service"),      # headless worker DNS (no ref equivalent)
        ("create", "ServiceAccount"),
        ("create", "Role"),
        ("create", "RoleBinding"),
        ("create", "StatefulSet"),
        ("update-status", "TPUJob"),   # status subresource: Created condition
    ]
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert sts.spec.replicas == 2
    assert sts.spec.pod_management_policy == "Parallel"
    assert sts.metadata.owner_references[0].uid == job.metadata.uid
    # TPU resource limits injected, zero nvidia.com/gpu anywhere (BASELINE.md)
    limits = sts.spec.template.main_container().limits
    assert limits == {api.RESOURCE_TPU: 4}
    cm = f.api.get("ConfigMap", "default", "test" + CONFIG_SUFFIX)
    assert cm.data["worker-hostnames"] == (
        "test-worker-0.test-worker.default.svc\n"
        "test-worker-1.test-worker.default.svc\n"
    )
    assert cm.data["coordinator-address"].startswith("test-worker-0.")
    assert cm.data["num-processes"] == "2"


def test_worker_service_headless_and_selects_workers():
    """The headless Service must exist (worker DNS backing) and its selector
    must match the worker pod labels, or jax.distributed rendezvous gets
    NXDOMAIN on a real cluster."""
    f = Fixture()
    job = f.seed(new_job(tpus=8))
    f.run("default/test")
    svc = f.api.get("Service", "default", "test" + WORKER_SUFFIX)
    assert svc.cluster_ip == "None"                   # headless
    assert svc.metadata.owner_references[0].uid == job.metadata.uid
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert sts.spec.service_name == svc.metadata.name
    pod_labels = sts.spec.template.metadata.labels
    for k, v in svc.selector.items():
        assert pod_labels.get(k) == v, (k, v, pod_labels)


def test_single_worker_when_total_below_per_worker():
    """ref allocateProcessingUnits: total < perNode → 1 worker (:573-578)."""
    f = Fixture()
    f.seed(new_job(tpus=2))
    f.run("default/test")
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert sts.spec.replicas == 1
    assert sts.spec.template.main_container().limits[api.RESOURCE_TPU] == 2


def test_indivisible_total_converges_to_invalid_spec_failed():
    """ref: total % perNode != 0 → error (:580). The reference requeues
    that error forever with nothing in status; here the sync converges to
    a terminal Failed/InvalidTPUJobSpec condition + Warning Event in ONE
    sync. Per-worker comes from the operator FLAG (the case admission and
    the CRD CEL rules cannot see)."""
    f = Fixture(tpus_per_worker=5)
    f.seed(new_job(tpus=16))
    actions = f.run("default/test")
    assert verbs(actions) == [("update-status", "TPUJob")]
    job = f.api.get(api.KIND, "default", "test")
    cond = job.status.get_condition(api.COND_FAILED)
    assert cond is not None
    assert cond.reason == "InvalidTPUJobSpec"
    assert "multiple" in cond.message
    assert any(e.type == "Warning" and e.reason == "InvalidTPUJobSpec"
               for e in f.controller.recorder.events)
    # second sync is a converged no-op, not a hot loop
    assert f.run("default/test") == []


def test_invalid_spec_bypassing_admission_forgets_key():
    """A spec only a real API server would admit (it enforces just the
    CRD-schema subset of api/validation.py) must not hot-loop the
    workqueue (the reference rate-limited-requeues forever, :399-404):
    one sync lands the Failed condition and the queue forgets the key."""
    f = Fixture()
    f.api._admission.clear()        # simulate schema-only enforcement
    job = new_job(tpus=None)
    job.spec.replicas = 3
    job.spec.num_slices = 2         # 3 workers % 2 slices → backstop error
    job.spec.template.main_container().limits = {api.RESOURCE_TPU: 4}
    f.seed(job)
    f.controller.enqueue_tpu_job(job)
    # drain: the status write re-enqueues once via its own watch event;
    # the follow-up sync is a converged no-op
    while f.controller.process_next_work_item(timeout=0.05):
        pass
    assert f.controller.queue.num_requeues("default/test") == 0
    job = f.api.get(api.KIND, "default", "test")
    cond = job.status.get_condition(api.COND_FAILED)
    assert cond is not None
    assert cond.reason == "InvalidTPUJobSpec"


def test_invalid_spec_recovers_when_fixed():
    """InvalidTPUJobSpec is level-triggered, not terminal: fixing the spec
    clears the condition and reconciliation resumes (the reference
    recovered here too — by retrying forever)."""
    f = Fixture(tpus_per_worker=5)
    f.seed(new_job(tpus=16))
    f.run("default/test")
    job = f.api.get(api.KIND, "default", "test")
    assert job.status.get_condition(api.COND_FAILED).status == "True"
    job.spec.tpus_per_worker = 4           # user fixes the spec
    f.api.update(job)
    actions = f.run("default/test")
    job = f.api.get(api.KIND, "default", "test")
    cond = job.status.get_condition(api.COND_FAILED)
    assert cond.status == "False"
    assert cond.reason == "SpecValidated"
    assert ("create", "StatefulSet") in verbs(actions)


def test_invalid_spec_message_refreshes_on_different_breakage():
    """A spec re-broken a DIFFERENT way must refresh the condition message
    instead of freezing the first failure text."""
    f = Fixture(tpus_per_worker=5)
    f.api._admission.clear()
    f.seed(new_job(tpus=16))
    f.run("default/test")
    job = f.api.get(api.KIND, "default", "test")
    first_msg = job.status.get_condition(api.COND_FAILED).message
    job.spec.tpus = None
    job.spec.replicas = 3
    job.spec.num_slices = 2
    job.spec.template.main_container().limits = {api.RESOURCE_TPU: 4}
    f.api.update(job)
    f.run("default/test")
    job = f.api.get(api.KIND, "default", "test")
    cond = job.status.get_condition(api.COND_FAILED)
    assert cond.status == "True"
    assert cond.message != first_msg
    assert "numSlices" in cond.message


def test_invalid_spec_edit_never_resurrects_terminal_job():
    """A job already terminally Failed (reason TPUJobFailed) whose spec is
    later edited invalid must keep its terminal condition — converting it
    to the level-triggered InvalidTPUJobSpec reason would let a
    subsequent spec FIX clear Failed and resurrect a finished job despite
    restartPolicy Never (advisor r04)."""
    f = Fixture()
    f.api._admission.clear()
    job = f.seed(new_job(tpus=8, restart_policy="Never"))
    _seed_finished_launcher(f, job, succeeded=False)
    f.run("default/test")                  # terminal: Failed/TPUJobFailed
    job = f.api.get(api.KIND, "default", "test")
    assert job.status.get_condition(api.COND_FAILED).reason == "TPUJobFailed"
    job.spec.tpus = 7                      # edit the dead job's spec invalid
    f.api.update(job)
    f.run("default/test")
    job = f.api.get(api.KIND, "default", "test")
    cond = job.status.get_condition(api.COND_FAILED)
    assert cond.status == "True"
    assert cond.reason == "TPUJobFailed"   # NOT InvalidTPUJobSpec
    job.spec.tpus = 8                      # ...and fixing it changes nothing
    f.api.update(job)
    actions = f.run("default/test")
    job = f.api.get(api.KIND, "default", "test")
    assert job.status.get_condition(api.COND_FAILED).status == "True"
    assert ("create", "Job") not in verbs(actions)   # stays dead


def test_midrun_invalid_spec_tears_down_gang():
    """A RUNNING job edited into an invalid spec must not strand its gang
    burning chips behind a Failed status: the launcher is deleted and the
    workers scale to 0 in the same sync that records the condition."""
    f = Fixture()
    f.api._admission.clear()
    job = f.seed(new_job(tpus=8))
    _seed_workers(f, job, replicas=2, ready=2)
    f.run("default/test")                   # creates the launcher
    assert f.api.try_get("Job", "default", "test" + LAUNCHER_SUFFIX) \
        is not None
    job = f.api.get(api.KIND, "default", "test")
    job.spec.tpus = 10                      # 10 % 4 != 0 → invalid
    f.api.update(job)
    f.run("default/test")
    job = f.api.get(api.KIND, "default", "test")
    assert job.status.get_condition(api.COND_FAILED).reason == \
        "InvalidTPUJobSpec"
    assert f.api.try_get("Job", "default", "test" + LAUNCHER_SUFFIX) is None
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert sts.spec.replicas == 0


def test_zero_per_worker_flag_is_invalid_spec_not_crash():
    """--tpus-per-worker 0 (a flag admission never sees) must surface as
    the ValueError the invalid-spec path converges on, not a
    ZeroDivisionError that requeues forever."""
    f = Fixture(tpus_per_worker=0)
    f.seed(new_job(tpus=8))
    f.run("default/test")
    job = f.api.get(api.KIND, "default", "test")
    cond = job.status.get_condition(api.COND_FAILED)
    assert cond is not None
    assert cond.reason == "InvalidTPUJobSpec"
    assert ">= 1" in cond.message


# ---------------------------------------------------------------------------
# elastic membership (spec.elastic — checkpoint-restart elasticity)
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _elastic_fixture(degraded=60, recovery=120, **job_kw):
    f = Fixture(elastic_degraded_seconds=degraded,
                elastic_recovery_seconds=recovery)
    clock = FakeClock()
    f.controller.now = clock
    job = new_job(tpus=8)
    job.spec.elastic = True
    for k, v in job_kw.items():
        setattr(job.spec, k, v)
    f.seed(job)
    return f, clock


def _elastic_go_running(f, name="test", workers=2):
    """Walk a fresh elastic gang to its first Running observation, then
    break readiness. The degraded countdown only arms after the gang has
    been Ready at least once (persisted as the Running condition) — a
    brand-new gang still scheduling/pulling images is not lost capacity,
    so without this warmup no elastic timer ever starts."""
    f.run(f"default/{name}")               # creates the worker STS
    _seed_ready(f, name, workers, workers)
    f.run(f"default/{name}")               # readiness gate → launcher
    launcher = f.api.get("Job", "default", name + LAUNCHER_SUFFIX)
    launcher.status.active = 1
    f.api.update(launcher)
    f.run(f"default/{name}")               # Running condition lands
    _seed_ready(f, name, 0, workers)       # ...and capacity is lost


def test_elastic_shrinks_after_persistent_unavailability():
    """Workers stuck not-Ready past the degraded window → the job shrinks
    to the next valid v5e size via STATUS (spec untouched), records a
    Degraded condition + Warning Event, and the next sync materializes
    the smaller world through the ordinary resize machinery."""
    f, clock = _elastic_fixture()
    _elastic_go_running(f)                 # first Ready observed, then lost
    f.run("default/test")                  # not-Ready timer arms
    clock.t += 61                          # past elastic_degraded_seconds
    f.run("default/test")
    job = f.api.get(api.KIND, "default", "test")
    assert job.spec.tpus == 8              # spec never edited
    assert job.status.elastic_tpus == 4    # next valid count below 8
    cond = job.status.get_condition(api.COND_DEGRADED)
    assert cond is not None and cond.status == "True"
    assert any(e.reason == "ElasticShrink" and e.type == "Warning"
               for e in f.controller.recorder.events)
    # next sync: the worker set converges to the 1-worker degraded world
    f.run("default/test")
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert sts.spec.replicas == 1
    env = sts.spec.template.main_container().env
    assert env["TPU_NUM_PROCESSES"] == "1"


def test_elastic_restores_after_recovery_window():
    """A shrunken job that has run Ready for the recovery window retries
    the full spec size (Degraded flips False, gang resizes back up)."""
    f, clock = _elastic_fixture()
    _elastic_go_running(f)
    f.run("default/test")                  # timer arms
    clock.t += 61
    f.run("default/test")                  # shrink decision
    f.run("default/test")                  # materialize 1-worker world
    # the degraded gang comes up Ready
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    from mpi_operator_tpu_torch.cluster.resources import StatefulSetStatus
    sts.status = StatefulSetStatus(ready_replicas=1, replicas=1)
    f.api.update(sts)
    f.run("default/test")                  # running degraded; timer arms
    clock.t += 121                         # past elastic_recovery_seconds
    f.run("default/test")
    job = f.api.get(api.KIND, "default", "test")
    assert job.status.elastic_tpus is None
    cond = job.status.get_condition(api.COND_DEGRADED)
    assert cond is not None and cond.status == "False"
    assert any(e.reason == "ElasticRestore"
               for e in f.controller.recorder.events)
    # next sync resizes the worker set back toward the full world
    f.run("default/test")
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert sts.spec.replicas == 2


def test_elastic_shrink_recomputes_topology_selector():
    """The shrunken world must NOT stay pinned to the full size's
    sliceTopology nodepool — that is exactly the capacity that's gone.
    The selector is recomputed for the degraded chip count."""
    f, clock = _elastic_fixture(slice_topology="2x4")
    _elastic_go_running(f)
    f.run("default/test")                  # timer arms
    clock.t += 61
    f.run("default/test")                  # shrink 8 -> 4
    f.run("default/test")                  # materialize
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    sel = sts.spec.template.node_selector
    assert sel["cloud.google.com/gke-tpu-topology"] == "2x2"   # 4 chips


def test_elastic_recovery_counts_from_ready_not_shrink():
    """A shrunken gang that took longer than the recovery window to
    become Ready must still get a FULL window of degraded running before
    restore — the countdown arms at the first Ready observation."""
    f, clock = _elastic_fixture()
    _elastic_go_running(f)
    f.run("default/test")                  # timer arms
    clock.t += 61
    f.run("default/test")                  # shrink at t0
    f.run("default/test")                  # materialize 1-worker world
    clock.t += 200                         # way past recovery (120s)...
    _seed_ready(f, "test", 1, 1)
    f.run("default/test")                  # ...but Ready only NOW: arms
    job = f.api.get(api.KIND, "default", "test")
    assert job.status.elastic_tpus == 4    # NOT restored yet
    clock.t += 121                         # a full window of Ready
    f.run("default/test")
    job = f.api.get(api.KIND, "default", "test")
    assert job.status.elastic_tpus is None # now restored


def test_elastic_respects_min_tpus_floor():
    """minTpus floors the ladder: a job already at the floor stays
    pending instead of shrinking further."""
    f, clock = _elastic_fixture(min_tpus=8)
    _elastic_go_running(f)
    f.run("default/test")                  # timer arms
    clock.t += 61
    f.run("default/test")
    job = f.api.get(api.KIND, "default", "test")
    assert job.status.elastic_tpus is None          # 8 is the floor
    assert job.status.get_condition(api.COND_DEGRADED) is None


def test_elastic_timer_clears_when_workers_recover():
    """Workers turning Ready inside the window must clear the countdown —
    a later blip starts a FRESH window instead of inheriting the old
    one."""
    f, clock = _elastic_fixture()
    _elastic_go_running(f)
    f.run("default/test")                  # timer arms
    clock.t += 50                          # inside the window
    _seed_ready(f, "test", 2, 2)
    f.run("default/test")                  # Ready → timer cleared
    _seed_ready(f, "test", 0, 2)
    clock.t += 30                          # 50+30 > 60, but fresh window
    f.run("default/test")
    job = f.api.get(api.KIND, "default", "test")
    assert job.status.elastic_tpus is None


def test_elastic_window_rearms_on_operator_restart():
    """The degraded/recovery COUNTDOWNS are process-memory by design: a
    new controller re-observes not-Ready and starts a FRESH window (the
    level-triggered-acceptable trade — a restart can delay a shrink by
    up to one window, never cause a spurious one). The ARMING gate (has
    the gang ever been Ready) is NOT process-memory: it rides the
    persisted Running condition, so a restarted operator still knows a
    once-Ready gang from a never-Ready one. Pinned here; documented in
    README."""
    f, clock = _elastic_fixture()
    _elastic_go_running(f)
    f.run("default/test")                  # timer arms in controller #1
    clock.t += 45                          # 45s of the 60s window elapse

    # operator restart: fresh controller, same API server state
    f2 = Fixture.__new__(Fixture)
    f2.api = f.api
    from mpi_operator_tpu_torch.controller import TPUJobController
    from mpi_operator_tpu_torch.controller.controller import ControllerConfig
    f2.controller = TPUJobController(
        f.api, config=ControllerConfig(elastic_degraded_seconds=60,
                                       elastic_recovery_seconds=120,
                                       **TPU_MODE))
    f2.controller.factory.start_all()
    f2.controller.now = clock
    f2.run("default/test")                 # re-arms a FRESH window
    clock.t += 30                          # 45 + 30 > 60 but fresh window
    f2.run("default/test")
    job = f.api.get(api.KIND, "default", "test")
    assert job.status.elastic_tpus is None  # NOT shrunk yet
    clock.t += 31                           # full fresh window elapses
    f2.run("default/test")
    job = f.api.get(api.KIND, "default", "test")
    assert job.status.elastic_tpus == 4     # now it shrinks


def test_elastic_never_shrinks_before_first_ready():
    """A fresh elastic gang that takes longer than the degraded window to
    schedule (image pulls, capacity waits) must NOT shrink below spec
    before ever running at spec size — 'never yet Ready' is not 'lost
    capacity'. The countdown arms only once the Running condition (set at
    the first readiness-gate pass, persisted in status) exists."""
    f, clock = _elastic_fixture()
    f.run("default/test")                  # creates the 2-worker STS
    f.run("default/test")                  # still scheduling...
    clock.t += 3600                        # way past the degraded window
    f.run("default/test")
    job = f.api.get(api.KIND, "default", "test")
    assert job.status.elastic_tpus is None
    assert job.status.get_condition(api.COND_DEGRADED) is None


def _seed_ready(f, name, ready, replicas):
    from mpi_operator_tpu_torch.cluster.resources import StatefulSetStatus
    sts = f.api.get("StatefulSet", "default", name + WORKER_SUFFIX)
    sts.status = StatefulSetStatus(ready_replicas=ready, replicas=replicas)
    f.api.update(sts)
    return sts


def test_custom_replicas_cpu():
    """Mode B with cpu resource type (ref TestAllResourcesCreatedCustom
    cpu variant :564-596)."""
    f = Fixture()
    job = new_job(tpus=None)
    job.spec.replicas = 4
    job.spec.processing_resource_type = api.RESOURCE_CPU
    job.spec.template.main_container().limits = {"cpu": 2}
    f.seed(job)
    f.run("default/test")
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert sts.spec.replicas == 4
    # cpu jobs get no TPU node selectors
    assert "cloud.google.com/gke-tpu-accelerator" not in (
        sts.spec.template.node_selector
    )


def test_custom_replicas_tpu_limits():
    """Mode B with explicit google.com/tpu limits (ref :584-593)."""
    f = Fixture()
    job = new_job(tpus=None)
    job.spec.replicas = 2
    job.spec.template.main_container().limits = {api.RESOURCE_TPU: 4}
    f.seed(job)
    f.run("default/test")
    cm = f.api.get("ConfigMap", "default", "test" + CONFIG_SUFFIX)
    assert cm.data["tpus-per-worker"] == "4"


def test_gang_scheduling_creates_pdb():
    """ref: getOrCreatePDB (:490-494, :601-623) minAvailable=workers."""
    f = Fixture(enable_gang_scheduling=True)
    f.seed(new_job(tpus=16))
    actions = f.run("default/test")
    assert ("create", "PodDisruptionBudget") in verbs(actions)
    pdb = f.api.get("PodDisruptionBudget", "default", "test" + WORKER_SUFFIX)
    assert pdb.min_available == 4


# ---------------------------------------------------------------------------
# launcher gating (ref TestWorkerNotReady / TestWorkerReady :712-789)
# ---------------------------------------------------------------------------

def _seed_workers(f, job, replicas, ready):
    alloc = f.controller.allocate_processing_units(job, False)
    sts = f.controller.new_worker(job, alloc)
    sts.status = StatefulSetStatus(ready_replicas=ready, replicas=replicas)
    return f.seed(sts)


def test_launcher_not_created_until_workers_ready():
    f = Fixture()
    job = f.seed(new_job(tpus=8))
    _seed_workers(f, job, replicas=2, ready=1)
    actions = f.run("default/test")
    assert ("create", "Job") not in verbs(actions)


def test_launcher_created_when_workers_ready():
    """ref TestWorkerReady (:739-763): ready==desired → launcher Job."""
    f = Fixture()
    job = f.seed(new_job(tpus=8))
    _seed_workers(f, job, replicas=2, ready=2)
    # seed remaining deps so only the launcher create is new
    actions = f.run("default/test")
    assert ("create", "Job") in verbs(actions)
    launcher = f.api.get("Job", "default", "test" + LAUNCHER_SUFFIX)
    env = launcher.spec.template.main_container().env
    assert env["TPU_COORDINATOR_ADDRESS"].startswith("test-worker-0.")
    assert env["TPU_NUM_PROCESSES"] == "2"
    assert env["TPU_LAUNCHER"] == "1"
    assert "TPU_WORKER_ID" not in env
    # no kubectl-delivery init container (SURVEY §7: bootstrap path is env)
    assert launcher.spec.template.init_containers == []
    assert launcher.spec.backoff_limit == api.DEFAULT_BACKOFF_LIMIT


def test_launcher_created_cpu_variant():
    """ref TestWorkerReadyCPU variant (:765-789)."""
    f = Fixture()
    job = new_job(tpus=None)
    job.spec.processing_units = 2
    job.spec.processing_resource_type = api.RESOURCE_CPU
    job = f.seed(job)
    _seed_workers(f, job, replicas=1, ready=1)
    actions = f.run("default/test")
    assert ("create", "Job") in verbs(actions)


# ---------------------------------------------------------------------------
# status propagation (ref TestLauncherSucceeded/Failed :494-531)
# ---------------------------------------------------------------------------

def _seed_finished_launcher(f, job, *, succeeded):
    alloc = f.controller.allocate_processing_units(job, False)
    launcher = f.controller.new_launcher(job, alloc)
    launcher.status = JobStatus(
        succeeded=1 if succeeded else 0, failed=0 if succeeded else 1,
        completion_time=123.0,
    )
    return f.seed(launcher)


def test_launcher_succeeded_updates_status_and_scales_down():
    """ref TestLauncherSucceeded (:494-512) + TestShutdownWorker (:667-692):
    done → status Succeeded, workers scaled to 0."""
    f = Fixture()
    job = f.seed(new_job(tpus=8))
    _seed_workers(f, job, replicas=2, ready=2)
    _seed_finished_launcher(f, job, succeeded=True)
    actions = f.run("default/test")
    # no ConfigMap/RBAC recreation when done (ref :468)
    assert ("create", "ConfigMap") not in verbs(actions)
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert sts.spec.replicas == 0                       # ref :594-596
    updated = f.api.get(api.KIND, "default", "test")
    assert updated.status.launcher_status == api.LAUNCHER_SUCCEEDED
    assert updated.status.completion_time == 123.0
    assert updated.status.is_done()
    assert updated.status.get_condition(api.COND_SUCCEEDED).status == "True"


def test_launcher_failed_updates_status():
    f = Fixture()
    job = f.seed(new_job(tpus=8))
    _seed_finished_launcher(f, job, succeeded=False)
    f.run("default/test")
    updated = f.api.get(api.KIND, "default", "test")
    assert updated.status.launcher_status == api.LAUNCHER_FAILED
    assert updated.status.get_condition(api.COND_FAILED).status == "True"


def test_launcher_active_sets_running_condition_and_start_time():
    f = Fixture()
    job = f.seed(new_job(tpus=8))
    alloc = f.controller.allocate_processing_units(job, False)
    launcher = f.controller.new_launcher(job, alloc)
    launcher.status = JobStatus(active=1, start_time=100.0)
    f.seed(launcher)
    f.run("default/test")
    updated = f.api.get(api.KIND, "default", "test")
    assert updated.status.launcher_status == api.LAUNCHER_ACTIVE
    assert updated.status.start_time == 100.0
    assert updated.status.get_condition(api.COND_RUNNING).status == "True"


def test_worker_replicas_status_tracks_ready():
    """ref updateMPIJobStatus worker readiness (:780-786)."""
    f = Fixture()
    job = f.seed(new_job(tpus=8))
    _seed_workers(f, job, replicas=2, ready=2)
    f.run("default/test")
    updated = f.api.get(api.KIND, "default", "test")
    assert updated.status.worker_replicas == 2


def test_replica_statuses_track_launcher_and_workers():
    """v1alpha2 ReplicaStatus (common_types.go:68-80): per-role
    active/succeeded/failed counts reconciled into status."""
    f = Fixture()
    job = f.seed(new_job(tpus=8))
    _seed_workers(f, job, replicas=2, ready=2)
    f.run("default/test")          # creates the launcher (workers ready)
    # play kubelet: launcher pod starts
    launcher = f.api.get("Job", "default", "test" + LAUNCHER_SUFFIX)
    launcher.status.active = 1
    f.api.update(launcher)
    f.run("default/test")
    updated = f.api.get(api.KIND, "default", "test")
    assert updated.status.replica_statuses["worker"].active == 2
    assert updated.status.replica_statuses["launcher"].active == 1

    # launcher completes → launcher succeeded=1, workers scale to 0
    launcher = f.api.get("Job", "default", "test" + LAUNCHER_SUFFIX)
    launcher.status.succeeded = 1
    launcher.status.active = 0
    f.api.update(launcher)
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    sts.status.ready_replicas = 0
    f.api.update(sts)
    f.run("default/test")
    updated = f.api.get(api.KIND, "default", "test")
    assert updated.status.replica_statuses["launcher"].succeeded == 1
    assert updated.status.replica_statuses["launcher"].active == 0
    assert updated.status.replica_statuses["worker"].active == 0


def test_launcher_on_master_pins_launcher_only():
    """ref types.go:90-94: launcherOnMaster → control-plane node selector +
    taint toleration on the launcher pod; workers keep TPU node selectors."""
    f = Fixture()
    job = f.seed(new_job(tpus=8, launcher_on_master=True))
    _seed_workers(f, job, replicas=2, ready=2)
    f.run("default/test")
    launcher = f.api.get("Job", "default", "test" + LAUNCHER_SUFFIX)
    sel = launcher.spec.template.node_selector
    assert sel.get("node-role.kubernetes.io/control-plane") == ""
    assert any(t.get("key") == "node-role.kubernetes.io/control-plane"
               for t in launcher.spec.template.tolerations)
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert "node-role.kubernetes.io/control-plane" \
        not in sts.spec.template.node_selector
    assert sts.spec.template.tolerations == []


# ---------------------------------------------------------------------------
# ownership conflicts — one per child kind (ref :479-492, :598-710)
# ---------------------------------------------------------------------------

def _foreign_meta(name):
    return ObjectMeta(
        name=name, namespace="default",
        owner_references=[api.OwnerReference(
            api_version="v1", kind="Foreign", name="other", uid="foreign-uid",
        )],
    )


@pytest.mark.parametrize("make_obj", [
    lambda: ConfigMap(metadata=_foreign_meta("test" + CONFIG_SUFFIX)),
    lambda: ServiceAccount(metadata=_foreign_meta("test" + LAUNCHER_SUFFIX)),
    lambda: Role(metadata=_foreign_meta("test" + LAUNCHER_SUFFIX)),
    lambda: RoleBinding(metadata=_foreign_meta("test" + LAUNCHER_SUFFIX)),
    lambda: StatefulSet(metadata=_foreign_meta("test" + WORKER_SUFFIX)),
    lambda: Job(metadata=_foreign_meta("test" + LAUNCHER_SUFFIX)),
], ids=["configmap", "serviceaccount", "role", "rolebinding",
        "statefulset", "launcher-job"])
def test_foreign_ownership_refused(make_obj):
    """Adoption is refused, never forced (ref :641-645 and siblings); a
    Warning event is recorded (ref :539)."""
    f = Fixture()
    f.seed(new_job(tpus=8))
    f.seed(make_obj())
    f.run("default/test", expect_error=ForeignOwnershipError)
    assert any(e.type == "Warning" for e in f.controller.recorder.events)


# ---------------------------------------------------------------------------
# idempotence / drift repair (level-triggered model, SURVEY §3.2)
# ---------------------------------------------------------------------------

def test_second_sync_is_idempotent():
    f = Fixture()
    job = f.seed(new_job(tpus=8))
    f.run("default/test")
    actions = f.run("default/test")
    # nothing to create or update on a converged state
    assert verbs(actions) == []


def test_replica_drift_is_repaired():
    """ref :748-756: update worker set if replica drift."""
    f = Fixture()
    job = f.seed(new_job(tpus=8))
    alloc = f.controller.allocate_processing_units(job, False)
    sts = f.controller.new_worker(job, alloc)
    sts.spec.replicas = 5   # drifted
    f.seed(sts)
    actions = f.run("default/test")
    assert ("update", "StatefulSet") in verbs(actions)
    assert f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX).spec.replicas == 2


def test_configmap_drift_is_repaired():
    """The hostfile analogue is rewritten when contents drift
    (ref getOrCreateConfigMap :627-648)."""
    f = Fixture()
    job = f.seed(new_job(tpus=8))
    cm = f.controller.new_config_map(
        job, f.controller.allocate_processing_units(job, False))
    cm.data = {"worker-hostnames": "stale\n"}
    f.seed(cm)
    actions = f.run("default/test")
    assert ("update", "ConfigMap") in verbs(actions)
    fixed = f.api.get("ConfigMap", "default", "test" + CONFIG_SUFFIX)
    assert "test-worker-0" in fixed.data["worker-hostnames"]


# ---------------------------------------------------------------------------
# event → queue plumbing (ref handleObject :811-844)
# ---------------------------------------------------------------------------

def _drain(queue):
    while True:
        key = queue.get(timeout=0)
        if key is None:
            return
        queue.done(key)


def test_dependent_event_enqueues_owner():
    f = Fixture()
    job = f.seed(new_job(tpus=8))
    _drain(f.controller.queue)
    sts = StatefulSet(metadata=ObjectMeta(
        name="test" + WORKER_SUFFIX, namespace="default",
        owner_references=owned(job),
    ), spec=StatefulSetSpec(replicas=2))
    f.api.create(sts)
    key = f.controller.queue.get(timeout=1)
    assert key == "default/test"


def test_orphan_event_ignored():
    f = Fixture()
    f.seed(new_job(tpus=8))
    _drain(f.controller.queue)
    f.api.create(StatefulSet(metadata=_foreign_meta("orphan")))
    assert f.controller.queue.get(timeout=0.05) is None


def test_admission_rejects_invalid_spec_at_create():
    """Invalid shapes fail at admission, not at runtime (SURVEY §7): the
    controller registers validate_spec as the CRD-schema analogue."""
    from mpi_operator_tpu_torch.cluster.apiserver import InMemoryAPIServer as S
    f = Fixture()
    with pytest.raises(S.AdmissionError, match="slice chip count"):
        f.api.create(new_job(tpus=3))


def test_launcher_restart_policy_is_on_failure():
    """ref :1175-1177 — Never would make the first pod failure terminal,
    defeating backoffLimit."""
    f = Fixture()
    job = f.seed(new_job(tpus=8))
    alloc = f.controller.allocate_processing_units(job, False)
    launcher = f.controller.new_launcher(job, alloc)
    assert launcher.spec.template.restart_policy == "OnFailure"


def test_per_worker_default_pairs_with_sizing_field():
    """tpus pairs with tpus_per_worker config; processing_units with
    processing_units_per_worker (ref :449-460)."""
    f = Fixture(tpus_per_worker=4, processing_units_per_worker=8)
    job = new_job(tpus=None)
    job.spec.processing_units = 16
    job.spec.processing_resource_type = api.RESOURCE_CPU
    alloc = f.controller.allocate_processing_units(job, False)
    assert alloc.worker_replicas == 2       # 16/8, not 16/4
    assert alloc.units_per_worker == 8


def test_workqueue_returns_due_rate_limited_item():
    """A due rate-limited item must be returned, not treated as timeout."""
    from mpi_operator_tpu_torch.cluster.workqueue import RateLimitingQueue
    q = RateLimitingQueue(base_delay=0.01)
    q.add_rate_limited("ns/x")
    assert q.get(timeout=2.0) == "ns/x"


def test_cascade_delete_on_owner():
    """ref SURVEY §3.4: deletion is K8s GC via ownerReferences — the
    controller has no delete logic of its own."""
    f = Fixture()
    job = f.seed(new_job(tpus=8))
    f.run("default/test")
    doomed = f.api.cascade_delete(job.metadata.uid)
    assert {k for k, _, _ in doomed} >= {
        "ConfigMap", "ServiceAccount", "Role", "RoleBinding", "StatefulSet",
    }


# ---------------------------------------------------------------------------
# gang restart (v1alpha2 RestartPolicy, common_types.go:131-156) and
# CleanPodPolicy (v1alpha2 types.go:55-66)
# ---------------------------------------------------------------------------

def _seed_failed_launcher(f, job, exit_code=None):
    alloc = f.controller.allocate_processing_units(job, False)
    launcher = f.controller.new_launcher(job, alloc)
    launcher.status = JobStatus(failed=1, completion_time=123.0,
                                exit_code=exit_code)
    return f.seed(launcher)


def test_restart_policy_never_is_terminal():
    """Default (v1alpha1 behavior): a failed launcher ends the job."""
    f = Fixture()
    job = f.seed(new_job(tpus=8))
    _seed_failed_launcher(f, job)
    f.run("default/test")
    updated = f.api.get(api.KIND, "default", "test")
    assert updated.status.get_condition(api.COND_FAILED) is not None
    assert updated.status.restart_count == 0


def test_restart_policy_onfailure_recreates_launcher():
    f = Fixture()
    job = f.seed(new_job(tpus=8, restart_policy="OnFailure"))
    _seed_workers(f, job, replicas=2, ready=2)
    _seed_failed_launcher(f, job, exit_code=1)
    f.run("default/test")
    updated = f.api.get(api.KIND, "default", "test")
    assert updated.status.restart_count == 1
    assert updated.status.get_condition(api.COND_RESTARTING) is not None
    assert updated.status.get_condition(api.COND_FAILED) is None
    # the launcher was recreated fresh (workers were ready)
    fresh = f.api.get("Job", "default", "test" + LAUNCHER_SUFFIX)
    assert fresh.status.failed == 0


def test_restart_policy_exitcode_distinguishes_permanent_and_retryable():
    # retryable (>=128): restart
    f = Fixture()
    job = f.seed(new_job(tpus=8, restart_policy="ExitCode"))
    _seed_workers(f, job, replicas=2, ready=2)
    _seed_failed_launcher(f, job, exit_code=213)     # LAUNCHER_LOST_EXIT
    f.run("default/test")
    assert f.api.get(api.KIND, "default", "test").status.restart_count == 1

    # permanent (1-127): terminal
    f2 = Fixture()
    job2 = f2.seed(new_job(tpus=8, restart_policy="ExitCode"))
    _seed_failed_launcher(f2, job2, exit_code=2)
    f2.run("default/test")
    updated = f2.api.get(api.KIND, "default", "test")
    assert updated.status.restart_count == 0
    assert updated.status.get_condition(api.COND_FAILED) is not None


def test_restart_budget_exhaustion_fails_job():
    f = Fixture()
    job = new_job(tpus=8, restart_policy="OnFailure", backoff_limit=1)
    job = f.seed(job)
    _seed_workers(f, job, replicas=2, ready=2)
    _seed_failed_launcher(f, job, exit_code=137)
    f.run("default/test")          # restart 1/1
    assert f.api.get(api.KIND, "default", "test").status.restart_count == 1
    # fail the recreated launcher too
    relaunched = f.api.get("Job", "default", "test" + LAUNCHER_SUFFIX)
    relaunched.status = JobStatus(failed=1, exit_code=137)
    f.api.update(relaunched)
    f.run("default/test")          # budget exhausted → terminal
    updated = f.api.get(api.KIND, "default", "test")
    assert updated.status.restart_count == 1
    assert updated.status.get_condition(api.COND_FAILED) is not None


def test_clean_pod_policy_none_keeps_workers():
    f = Fixture()
    job = f.seed(new_job(tpus=8, clean_pod_policy="None"))
    _seed_workers(f, job, replicas=2, ready=2)
    _seed_finished_launcher(f, job, succeeded=True)
    f.run("default/test")
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert sts.spec.replicas == 2          # NOT scaled down
    assert f.api.get(api.KIND, "default",
                     "test").status.get_condition(api.COND_SUCCEEDED)


def test_clean_pod_policy_all_deletes_launcher_and_stays_done():
    from mpi_operator_tpu_torch.cluster.apiserver import NotFoundError
    f = Fixture()
    job = f.seed(new_job(tpus=8, clean_pod_policy="All"))
    _seed_workers(f, job, replicas=2, ready=2)
    _seed_finished_launcher(f, job, succeeded=True)
    f.run("default/test")
    with pytest.raises(NotFoundError):
        f.api.get("Job", "default", "test" + LAUNCHER_SUFFIX)
    # level-triggered: a later reconcile must NOT recreate the launcher
    # (terminal state lives in conditions now)
    f.run("default/test")
    with pytest.raises(NotFoundError):
        f.api.get("Job", "default", "test" + LAUNCHER_SUFFIX)
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert sts.spec.replicas == 0
    # replicaStatuses must keep the terminal launcher counts, not flap to 0
    # after the launcher Job object is garbage-collected
    updated = f.api.get(api.KIND, "default", "test")
    assert updated.status.replica_statuses["launcher"].succeeded == 1


def test_restart_policy_validation():
    from mpi_operator_tpu_torch.api.validation import ValidationError, validate_spec
    with pytest.raises(ValidationError, match="restartPolicy"):
        validate_spec(new_job(tpus=8, restart_policy="Always").spec)


def test_metrics_and_healthz_endpoints():
    """Operator observability (extension over the reference, which has
    glog only — SURVEY §5): /metrics exposes sync counters, queue depth,
    and per-phase job gauges in Prometheus text format; /healthz reports
    200 while starting AND while workers run (so a slow cache sync can't
    crash-loop the pod), 503 once a worker thread has died."""
    import urllib.error
    from urllib.request import urlopen

    from mpi_operator_tpu_torch.controller.metrics import MetricsServer

    f = Fixture()
    f.seed(new_job("obs", tpus=8))
    f.controller.enqueue_tpu_job(f.api.get(api.KIND, "default", "obs"))
    assert f.controller.process_next_work_item(timeout=1.0)

    server = MetricsServer(f.controller, port=0)
    try:
        base = f"http://127.0.0.1:{server.port}"
        body = urlopen(base + "/metrics").read().decode()
        assert "tpu_operator_syncs_total 1" in body
        assert "tpu_operator_sync_errors_total 0" in body
        assert "tpu_operator_workqueue_depth" in body
        assert 'tpu_operator_jobs{phase="Created"} 1' in body
        # zero phases are emitted too — a vanishing series reads as "no
        # data", not 0
        assert 'tpu_operator_jobs{phase="Failed"} 0' in body
        assert "tpu_operator_job_restarts 0" in body

        # healthy while starting (run() not yet called): the probe must not
        # crash-loop a pod that is still syncing caches
        assert urlopen(base + "/healthz").status == 200
        with pytest.raises(urllib.error.HTTPError) as exc:
            urlopen(base + "/nope")
        assert exc.value.code == 404

        stop = f.controller.run(threadiness=1)
        assert urlopen(base + "/healthz").status == 200
        # dead worker threads flip liveness to 503
        stop.set()
        f.controller.queue.shut_down()
        for t in f.controller._threads:
            t.join(timeout=5)
        with pytest.raises(urllib.error.HTTPError) as exc:
            urlopen(base + "/healthz")
        assert exc.value.code == 503
    finally:
        server.close()


def test_metrics_sync_error_counter():
    """A failing sync (foreign-owned child → ForeignOwnershipError) lands in
    sync_errors_total and the key re-enters the queue via the rate limiter."""
    from mpi_operator_tpu_torch.controller.metrics import render_metrics

    f = Fixture()
    f.seed(new_job(tpus=8))
    f.seed(ConfigMap(metadata=_foreign_meta("test" + CONFIG_SUFFIX)))
    f.controller.enqueue_tpu_job(f.api.get(api.KIND, "default", "test"))
    assert f.controller.process_next_work_item(timeout=1.0)
    body = render_metrics(f.controller)
    assert "tpu_operator_sync_errors_total 1" in body


# ---------------------------------------------------------------------------
# real Kubernetes Events (ref StartRecordingToSink :165-172; Synced :518,
# ErrResourceExists :539)
# ---------------------------------------------------------------------------

def test_synced_event_posted_and_aggregated():
    """The recorder POSTs a core/v1 Event through the API server on every
    Synced, and a repeated identical event bumps count on the SAME Event
    object (client-go correlator aggregation) instead of flooding new
    ones."""
    f = Fixture()
    f.seed(new_job(tpus=8))
    f.run("default/test")
    events = f.api.list("Event", "default")
    synced = [e for e in events if e.reason == "Synced"]
    assert len(synced) == 1
    ev = synced[0]
    assert ev.type == "Normal"
    assert ev.involved_object.kind == api.KIND
    assert ev.involved_object.name == "test"
    assert ev.involved_object.uid
    assert ev.count == 1
    assert ev.source_component == "tpu-operator"
    assert ev.first_timestamp and ev.last_timestamp

    f.run("default/test")                 # level-triggered re-sync
    events = f.api.list("Event", "default")
    synced = [e for e in events if e.reason == "Synced"]
    assert len(synced) == 1               # still one object...
    assert synced[0].count == 2           # ...with the count bumped
    assert synced[0].last_timestamp >= ev.last_timestamp


def test_ownership_conflict_event_posted():
    """The ErrResourceExists warning reaches the Events API (ref :539) so
    `kubectl describe tpujob` shows it while a user debugs a stuck job."""
    f = Fixture()
    f.seed(new_job(tpus=8))
    f.seed(ConfigMap(metadata=_foreign_meta("test" + CONFIG_SUFFIX)))
    f.run("default/test", expect_error=ForeignOwnershipError)
    warnings = [e for e in f.api.list("Event", "default")
                if e.type == "Warning"]
    assert len(warnings) == 1
    assert warnings[0].reason == "ErrResourceExists"
    assert "test-config" in warnings[0].message


def test_event_posts_never_fail_reconcile():
    """A broken Events sink must not fail a sync — posting is best-effort
    observability (the reference's broadcaster is fire-and-forget too)."""
    class ExplodingSink:
        def __getattr__(self, _name):
            raise RuntimeError("sink down")

    f = Fixture()
    f.seed(new_job(tpus=8))
    f.controller.recorder.api = ExplodingSink()
    f.run("default/test")      # must not raise
    status = f.api.get(api.KIND, "default", "test").status
    assert status.conditions              # sync actually did its work


# ---------------------------------------------------------------------------
# worker failure visibility (v1alpha2 ReplicaStatus, common_types.go:68-80)
# ---------------------------------------------------------------------------

def _worker_pod(name, job="test", restarts=0, phase="Running"):
    from mpi_operator_tpu_torch.cluster.resources import Pod, PodStatus
    return Pod(
        metadata=ObjectMeta(
            name=name, namespace="default",
            labels={"tpu_job_name": job, "tpu_job_role": "worker"}),
        status=PodStatus(phase=phase, restart_count=restarts),
    )


def test_worker_restarts_surface_in_replica_status():
    """A crash-looping worker must be visible: kubelet resurrects workers
    in place (RestartPolicy=Always) so the StatefulSet always looks
    healthy — the controller reads worker pods and surfaces restart
    DELTAS into replicaStatuses["worker"].failed, plus a Warning Event.
    (The first sync adopts current counts as the baseline, so crashes are
    counted from when this controller started watching.)"""
    f = Fixture()
    f.seed(new_job(tpus=8))
    _seed_workers(f, job=f.api.get(api.KIND, "default", "test"),
                  replicas=2, ready=2)
    f.seed(_worker_pod("test-worker-0", restarts=0))
    f.seed(_worker_pod("test-worker-1", restarts=0))
    f.run("default/test")                   # baseline sync
    pod = f.api.get("Pod", "default", "test-worker-0")
    pod.status.restart_count = 3            # three crashes since
    f.api.update(pod)
    f.run("default/test")
    st = f.api.get(api.KIND, "default", "test").status
    assert st.replica_statuses["worker"].failed == 3
    assert st.replica_statuses["worker"].active == 2
    warnings = [e for e in f.controller.recorder.events
                if e.type == "Warning"]
    assert any(e.reason == "WorkerCrashLoop" for e in warnings)


def test_operator_restart_does_not_recount_crashes():
    """A fresh controller process must adopt current restart counts as the
    baseline instead of re-counting history into .failed (which would
    double the number on every operator redeploy)."""
    f = Fixture()
    f.seed(new_job(tpus=8))
    _seed_workers(f, job=f.api.get(api.KIND, "default", "test"),
                  replicas=2, ready=2)
    f.seed(_worker_pod("test-worker-0", restarts=0))
    f.run("default/test")                   # baseline
    pod = f.api.get("Pod", "default", "test-worker-0")
    pod.status.restart_count = 5
    f.api.update(pod)
    f.run("default/test")
    assert f.api.get(api.KIND, "default", "test") \
        .status.replica_statuses["worker"].failed == 5
    # "operator restart": a NEW controller over the same API server
    ctrl2 = TPUJobController(f.api, config=ControllerConfig(**TPU_MODE))
    ctrl2.factory.start_all()
    ctrl2.sync_handler("default/test")
    st = f.api.get(api.KIND, "default", "test").status
    assert st.replica_statuses["worker"].failed == 5   # not 10


def test_healthy_workers_report_zero_failed():
    f = Fixture()
    f.seed(new_job(tpus=8))
    _seed_workers(f, job=f.api.get(api.KIND, "default", "test"),
                  replicas=2, ready=2)
    f.seed(_worker_pod("test-worker-0"))
    f.seed(_worker_pod("test-worker-1"))
    f.run("default/test")
    st = f.api.get(api.KIND, "default", "test").status
    assert st.replica_statuses["worker"].failed == 0
    assert not any(e.reason == "WorkerCrashLoop"
                   for e in f.controller.recorder.events)


def test_failed_count_is_cumulative_across_pod_recreation():
    """Pod deletion resets kubelet restart counters; the recorded failed
    count is a true cumulative crash history — it neither regresses NOR
    hides fresh crashes of the replacement pod (per-pod uid-keyed restart
    baselines, not a high-water mark)."""
    f = Fixture()
    f.seed(new_job(tpus=8))
    _seed_workers(f, job=f.api.get(api.KIND, "default", "test"),
                  replicas=2, ready=2)
    f.seed(_worker_pod("test-worker-0", restarts=0))
    f.run("default/test")                              # baseline
    pod = f.api.get("Pod", "default", "test-worker-0")
    pod.status.restart_count = 4
    f.api.update(pod)
    f.run("default/test")
    st = f.api.get(api.KIND, "default", "test").status
    assert st.replica_statuses["worker"].failed == 4
    f.api.delete("Pod", "default", "test-worker-0")   # pod recreated fresh
    f.seed(_worker_pod("test-worker-0", restarts=0))  # counter reset
    f.run("default/test")
    st = f.api.get(api.KIND, "default", "test").status
    assert st.replica_statuses["worker"].failed == 4   # no regression
    # the REPLACEMENT crash-loops: its fresh restarts must still count
    pod = f.api.get("Pod", "default", "test-worker-0")
    pod.status.restart_count = 3
    f.api.update(pod)
    f.run("default/test")
    st = f.api.get(api.KIND, "default", "test").status
    assert st.replica_statuses["worker"].failed == 7   # 4 + 3, cumulative


def test_foreign_pods_ignored_in_failure_count():
    """Pods of other jobs (or non-worker roles) don't pollute the count."""
    f = Fixture()
    f.seed(new_job(tpus=8))
    _seed_workers(f, job=f.api.get(api.KIND, "default", "test"),
                  replicas=2, ready=2)
    f.seed(_worker_pod("other-worker-0", job="other", restarts=0))
    launcher_pod = _worker_pod("test-launcher-x", restarts=0)
    launcher_pod.metadata.labels["tpu_job_role"] = "launcher"
    f.seed(launcher_pod)
    f.run("default/test")                              # baseline
    for name in ("other-worker-0", "test-launcher-x"):
        pod = f.api.get("Pod", "default", name)
        pod.status.restart_count = 9                   # foreign crashes
        f.api.update(pod)
    f.run("default/test")
    st = f.api.get(api.KIND, "default", "test").status
    assert st.replica_statuses["worker"].failed == 0


# ---------------------------------------------------------------------------
# create-race read-through (real-cluster informer lag)
# ---------------------------------------------------------------------------

def test_create_race_resolved_by_read_through():
    """Against a real API server the informer lags its own writes by a
    watch round-trip: a child can exist server-side while the lister still
    misses it. The sync must read through (create → AlreadyExists → direct
    GET + ownership check) and converge in THIS pass instead of failing
    8-10 syncs on requeue backoff (which is what the reference does)."""
    f = Fixture()
    job = f.seed(new_job(tpus=8))
    alloc = f.controller.allocate_processing_units(job, False)
    cm = f.controller.new_config_map(job, alloc)
    # plant the child server-side WITHOUT a watch notification — the
    # informer-lag state (white-box: the in-memory server's watch fanout
    # is synchronous, so this is the only way to simulate the lag)
    cm.metadata.resource_version = 999
    cm.metadata.uid = "uid-race"
    f.api._store[("ConfigMap", "default", "test" + CONFIG_SUFFIX)] = cm
    assert f.controller.configmap_lister.try_get(
        "default", "test" + CONFIG_SUFFIX) is None     # lister blind
    f.run("default/test")                              # must not raise
    st = f.api.get(api.KIND, "default", "test").status
    assert st.conditions                               # sync completed


def test_create_race_foreign_owner_still_refused():
    """Read-through must NOT become adoption: a same-named child owned by
    someone else still fails the sync (ref :641-645)."""
    f = Fixture()
    f.seed(new_job(tpus=8))
    foreign = ConfigMap(metadata=_foreign_meta("test" + CONFIG_SUFFIX))
    foreign.metadata.resource_version = 999
    foreign.metadata.uid = "uid-foreign"
    f.api._store[("ConfigMap", "default", "test" + CONFIG_SUFFIX)] = foreign
    f.run("default/test", expect_error=ForeignOwnershipError)


# ---------------------------------------------------------------------------
# TPU-health readiness gate (SURVEY §7 "Readiness vs ICI formation")
# ---------------------------------------------------------------------------

def test_worker_readiness_probe_injected():
    """TPU workers carry a readinessProbe checking the bootstrap's health
    marker, so ReadyReplicas (the launcher gate, ref :503-509) means "the
    TPU runtime enumerated its chips", not "the container started"."""
    f = Fixture()
    f.seed(new_job(tpus=8))
    f.run("default/test")
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    c = sts.spec.template.main_container()
    probe = c.readiness_probe
    assert probe is not None
    assert probe["exec"]["command"][-1] == "test -f /tmp/tpu-ready"
    assert probe["failureThreshold"] >= 30     # first libtpu init is slow
    assert c.env["TPU_READY_FILE"] == "/tmp/tpu-ready"
    assert c.env["TPU_EXPECTED_CHIPS"] == "4"  # tpus=8 / 2 workers


def test_cpu_workers_get_no_tpu_probe():
    """cpu-resource jobs have no TPU runtime to gate on."""
    f = Fixture()
    job = new_job(tpus=None)
    job.spec.replicas = 2
    job.spec.processing_resource_type = api.RESOURCE_CPU
    job.spec.template.main_container().limits = {"cpu": 2}
    f.seed(job)
    f.run("default/test")
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    c = sts.spec.template.main_container()
    assert c.readiness_probe is None
    assert "TPU_READY_FILE" not in c.env


def test_user_supplied_probe_not_overwritten():
    """A user's own readinessProbe in the pod template wins — the operator
    only fills the gap."""
    f = Fixture()
    job = new_job(tpus=8)
    job.spec.template.main_container().readiness_probe = {
        "httpGet": {"path": "/healthz", "port": 9999}}
    f.seed(job)
    f.run("default/test")
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    probe = sts.spec.template.main_container().readiness_probe
    assert probe == {"httpGet": {"path": "/healthz", "port": 9999}}


def test_health_gate_annotation_opt_out():
    """Worker images that never call mpi_operator_tpu_torch.bootstrap can opt
    out of the TPU-health probe (they would otherwise sit NotReady
    forever, since nothing writes the marker)."""
    f = Fixture()
    job = new_job(tpus=8)
    job.metadata.annotations["tpu.kubeflow.org/health-gate"] = "false"
    f.seed(job)
    f.run("default/test")
    c = f.api.get("StatefulSet", "default",
                  "test" + WORKER_SUFFIX).spec.template.main_container()
    assert c.readiness_probe is None
    assert "TPU_READY_FILE" not in c.env


# ---------------------------------------------------------------------------
# multi-slice topology (SURVEY §7 "Multi-slice (DCN) bootstrap";
# VERDICT r02 missing #2 — the controller must actually PLACE slices)
# ---------------------------------------------------------------------------

def _two_slice_job(name="ms", tpus=16, num_slices=2):
    job = new_job(name=name, tpus=tpus)
    job.spec.num_slices = num_slices
    job.spec.slice_topology = "2x4"      # per-slice v5e-8
    return job


def test_multislice_materializes_per_slice_worker_groups():
    """numSlices=2, tpus=16, 4/worker → two StatefulSets of 2 workers
    each, named <job>-worker-s<k>, with slice-id env and a SHARED
    governing Service (pod names are unique across groups)."""
    f = Fixture()
    f.seed(_two_slice_job())
    f.run("default/ms")
    groups = []
    for k in (0, 1):
        sts = f.api.get("StatefulSet", "default", f"ms-worker-s{k}")
        groups.append(sts)
        assert sts.spec.replicas == 2
        assert sts.spec.service_name == "ms-worker"   # shared DNS backing
        c = sts.spec.template.main_container()
        assert c.env["TPU_SLICE_ID"] == str(k)
        assert c.env["MEGASCALE_SLICE_ID"] == str(k)
        assert c.env["MEGASCALE_NUM_SLICES"] == "2"
        assert c.env["TPU_WORKERS_PER_SLICE"] == "2"
        assert c.env["TPU_NUM_SLICES"] == "2"
        assert sts.spec.template.metadata.labels["tpu_job_slice"] == str(k)
        # each slice carries the per-slice topology selector
        assert sts.spec.template.node_selector[
            "cloud.google.com/gke-tpu-topology"] == "2x4"
    # the flat single-slice name must NOT exist
    from mpi_operator_tpu_torch.cluster.apiserver import NotFoundError
    with pytest.raises(NotFoundError):
        f.api.get("StatefulSet", "default", "ms-worker")
    # megascale coordinator points at slice-0 worker-0
    c0 = groups[0].spec.template.main_container()
    assert c0.env["MEGASCALE_COORDINATOR_ADDRESS"].startswith(
        "ms-worker-s0-0.")


def test_multislice_configmap_is_rank_major():
    """worker-hostnames must list slice-0's workers first (global rank
    order = slice-major), and the role must name every pod of every
    slice — the hostfile-as-topology-truth analogue
    (ref mpi_job_controller.go:857-869)."""
    f = Fixture()
    f.seed(_two_slice_job())
    f.run("default/ms")
    cm = f.api.get("ConfigMap", "default", "ms" + CONFIG_SUFFIX)
    assert cm.data["worker-hostnames"] == (
        "ms-worker-s0-0.ms-worker.default.svc\n"
        "ms-worker-s0-1.ms-worker.default.svc\n"
        "ms-worker-s1-0.ms-worker.default.svc\n"
        "ms-worker-s1-1.ms-worker.default.svc\n"
    )
    assert cm.data["coordinator-address"] == (
        "ms-worker-s0-0.ms-worker.default.svc:8476")
    assert cm.data["num-slices"] == "2"
    assert cm.data["workers-per-slice"] == "2"
    assert cm.data["num-processes"] == "4"
    role = f.api.get("Role", "default", "ms-launcher")
    names = [n for rule in role.rules for n in rule.resource_names]
    for pod in ("ms-worker-s0-0", "ms-worker-s0-1",
                "ms-worker-s1-0", "ms-worker-s1-1"):
        assert pod in names


def test_multislice_launcher_gated_on_all_slices():
    """One Ready slice is NOT enough — the launcher must wait for every
    slice (a missing slice would hang the first cross-slice collective)."""
    f = Fixture()
    f.seed(_two_slice_job())
    f.run("default/ms")
    # slice 0 fully ready, slice 1 not
    s0 = f.api.get("StatefulSet", "default", "ms-worker-s0")
    s0.status = StatefulSetStatus(ready_replicas=2, replicas=2)
    f.api.update(s0)
    f.run("default/ms")
    from mpi_operator_tpu_torch.cluster.apiserver import NotFoundError
    with pytest.raises(NotFoundError):
        f.api.get("Job", "default", "ms-launcher")
    # slice 1 comes up → launcher created
    s1 = f.api.get("StatefulSet", "default", "ms-worker-s1")
    s1.status = StatefulSetStatus(ready_replicas=2, replicas=2)
    f.api.update(s1)
    f.run("default/ms")
    f.api.get("Job", "default", "ms-launcher")      # exists now
    st = f.api.get(api.KIND, "default", "ms").status
    assert st.worker_replicas == 4                  # aggregated across slices


def test_multislice_scale_down_covers_all_groups():
    f = Fixture()
    f.seed(_two_slice_job())
    f.run("default/ms")
    for k in (0, 1):
        s = f.api.get("StatefulSet", "default", f"ms-worker-s{k}")
        s.status = StatefulSetStatus(ready_replicas=2, replicas=2)
        f.api.update(s)
    f.run("default/ms")
    launcher = f.api.get("Job", "default", "ms-launcher")
    launcher.status.succeeded = 1
    f.api.update_status(launcher)
    f.run("default/ms")
    for k in (0, 1):
        assert f.api.get("StatefulSet", "default",
                         f"ms-worker-s{k}").spec.replicas == 0


def test_multislice_indivisible_replicas_rejected_at_admission():
    """replicas mode: 3 workers cannot split into 2 slices — rejected at
    admission (fail at admission, not at runtime); the controller's
    allocate keeps the same check as a backstop."""
    f = Fixture()
    job = new_job(name="bad", tpus=None)
    job.spec.replicas = 3
    job.spec.num_slices = 2
    job.spec.template.main_container().limits = {api.RESOURCE_TPU: 4}
    with pytest.raises(InMemoryAPIServer.AdmissionError,
                       match="does not divide into 2 slices"):
        f.seed(job)


def test_discovery_init_container_wired():
    """--discovery-image injects the init container into WORKERS (they do
    the DNS rendezvous) and the LAUNCHER (ref kubectl-delivery injection
    :1106-1121), each with the ConfigMap mount its wait script reads."""
    f = Fixture(discovery_image="tpu-discovery:latest")
    f.seed(new_job(tpus=8))
    f.run("default/test")
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    sts.status = StatefulSetStatus(ready_replicas=2, replicas=2)
    f.api.update(sts)
    f.run("default/test")
    launcher = f.api.get("Job", "default", "test" + LAUNCHER_SUFFIX)
    for tmpl in (sts.spec.template, launcher.spec.template):
        inits = tmpl.init_containers
        assert len(inits) == 1
        assert inits[0].image == "tpu-discovery:latest"
        assert inits[0].env["TPU_CONFIG_PATH"] == "/etc/tpu"
        assert inits[0].env["DISCOVERY_TIMEOUT"] == "300"
        assert {"name": "tpu-job-config",
                "mountPath": "/etc/tpu"} in inits[0].volume_mounts



def test_worker_service_drift_repaired():
    """Spec fixes must reach Services created by older operator versions
    (e.g. publishNotReadyAddresses — without the repair, pre-upgrade jobs
    stay DNS-deadlocked forever)."""
    f = Fixture()
    job = f.seed(new_job(tpus=8))
    f.run("default/test")
    svc = f.api.get("Service", "default", "test" + WORKER_SUFFIX)
    svc.publish_not_ready_addresses = False    # pre-fix operator wrote this
    f.api.update(svc)
    f.run("default/test")
    svc = f.api.get("Service", "default", "test" + WORKER_SUFFIX)
    assert svc.publish_not_ready_addresses is True


def test_resize_reconciles_worker_env_and_topology():
    """tpus 8→16 mid-run: the reference only fixes the replica count
    (:748-756), leaving surviving pods on stale TPU_NUM_PROCESSES/
    hostnames — a broken rendezvous after the gang restart. The full
    template reconciles, so the StatefulSet rolls every worker onto the
    new topology (checkpoint resume carries the run over)."""
    f = Fixture()
    f.seed(new_job(tpus=8))
    f.run("default/test")
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert sts.spec.replicas == 2
    assert sts.spec.template.main_container().env["TPU_NUM_PROCESSES"] == "2"

    job = f.api.get(api.KIND, "default", "test")
    job.spec.tpus = 16
    f.api.update(job)
    f.run("default/test")
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert sts.spec.replicas == 4
    env = sts.spec.template.main_container().env
    assert env["TPU_NUM_PROCESSES"] == "4"
    assert env["TPU_WORKER_HOSTNAMES"].count(",") == 3     # 4 workers
    cm = f.api.get("ConfigMap", "default", "test" + CONFIG_SUFFIX)
    assert cm.data["num-processes"] == "4"                 # consistent


def test_template_edit_propagates_to_workers():
    """User edits the pod template image: the worker StatefulSet follows
    (the reference never reconciles templates at all)."""
    f = Fixture()
    f.seed(new_job(tpus=8))
    f.run("default/test")
    job = f.api.get(api.KIND, "default", "test")
    job.spec.template.main_container().image = "tpu-bench:v2"
    f.api.update(job)
    f.run("default/test")
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert sts.spec.template.main_container().image == "tpu-bench:v2"


def test_stable_spec_causes_no_update_churn():
    """Template reconciliation must be change-driven: an unchanged spec
    re-synced twice emits NO StatefulSet update actions (level-triggered
    idempotence, ref test style :533-562)."""
    f = Fixture()
    f.seed(new_job(tpus=8))
    f.run("default/test")
    actions = f.run("default/test")       # second sync, nothing changed
    assert ("update", "StatefulSet") not in verbs(actions)


def test_resize_replaces_launcher_without_burning_restart_budget():
    """A running launcher carries the old-topology env (Job pod templates
    are immutable): resize must replace it OUTSIDE the failure path — no
    restart_count bump, no terminal failure under restart_policy=Never —
    and the readiness gate recreates it with the new env."""
    f = Fixture()
    f.seed(new_job(tpus=8))
    f.run("default/test")
    _seed_ready_workers(f, "test" + WORKER_SUFFIX, 2)
    f.run("default/test")
    launcher = f.api.get("Job", "default", "test" + LAUNCHER_SUFFIX)
    assert launcher.spec.template.main_container().env[
        "TPU_NUM_PROCESSES"] == "2"

    job = f.api.get(api.KIND, "default", "test")
    job.spec.tpus = 16
    f.api.update(job)
    f.run("default/test")
    # old launcher deleted, none recreated yet (workers not Ready at the
    # new size), and the restart budget untouched
    from mpi_operator_tpu_torch.cluster.apiserver import NotFoundError
    with pytest.raises(NotFoundError):
        f.api.get("Job", "default", "test" + LAUNCHER_SUFFIX)
    st = f.api.get(api.KIND, "default", "test").status
    assert st.restart_count == 0
    assert st.get_condition(api.COND_FAILED) is None
    # gang comes up at the new size → launcher recreated with new env
    _seed_ready_workers(f, "test" + WORKER_SUFFIX, 4)
    f.run("default/test")
    launcher = f.api.get("Job", "default", "test" + LAUNCHER_SUFFIX)
    assert launcher.spec.template.main_container().env[
        "TPU_NUM_PROCESSES"] == "4"
    assert any(e.reason == "TPUJobResized"
               for e in f.controller.recorder.events)


def _seed_ready_workers(f, name, n):
    sts = f.api.get("StatefulSet", "default", name)
    sts.status = StatefulSetStatus(ready_replicas=n, replicas=n)
    f.api.update(sts)


def test_numslices_downsize_prunes_orphaned_groups():
    """numSlices 2→1: the old per-slice groups must be deleted — their
    stale-topology pods would keep matching the shared Service selector
    and dial the new coordinator with the old world size."""
    f = Fixture()
    job = new_job(name="ms2", tpus=16)
    job.spec.num_slices = 2
    job.spec.slice_topology = "2x4"
    f.seed(job)
    f.run("default/ms2")
    f.api.get("StatefulSet", "default", "ms2-worker-s0")
    f.api.get("StatefulSet", "default", "ms2-worker-s1")

    job = f.api.get(api.KIND, "default", "ms2")
    job.spec.num_slices = 1
    job.spec.slice_topology = "4x4"
    f.api.update(job)
    f.run("default/ms2")
    from mpi_operator_tpu_torch.cluster.apiserver import NotFoundError
    sts = f.api.get("StatefulSet", "default", "ms2-worker")   # flat group
    assert sts.spec.replicas == 4
    with pytest.raises(NotFoundError):
        f.api.get("StatefulSet", "default", "ms2-worker-s0")
    with pytest.raises(NotFoundError):
        f.api.get("StatefulSet", "default", "ms2-worker-s1")


def test_resize_gang_deletes_worker_pods():
    """OnDelete update strategy: the controller must delete the worker
    pods itself after a template change, or nothing ever restarts them
    onto the new topology."""
    f = Fixture()
    f.seed(new_job(tpus=8))
    f.run("default/test")
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert sts.spec.update_strategy == "OnDelete"
    f.seed(_worker_pod("test-worker-0"))
    f.seed(_worker_pod("test-worker-1"))
    job = f.api.get(api.KIND, "default", "test")
    job.spec.tpus = 16
    f.api.update(job)
    f.run("default/test")
    assert f.api.list("Pod", "default",
                      label_selector="tpu_job_name=test") == []


def test_template_edit_defers_launcher_until_gang_restarts():
    """Same-world-size template edit: the StatefulSet status still shows
    the PRE-deletion ready count during the resize sync — the launcher
    must NOT be recreated against a gang that was just deleted."""
    f = Fixture()
    f.seed(new_job(tpus=8))
    f.run("default/test")
    _seed_ready_workers(f, "test" + WORKER_SUFFIX, 2)
    f.run("default/test")
    f.api.get("Job", "default", "test" + LAUNCHER_SUFFIX)   # running

    job = f.api.get(api.KIND, "default", "test")
    job.spec.template.main_container().image = "tpu-bench:v2"
    f.api.update(job)
    f.run("default/test")       # resize sync: ready counts are stale lies
    from mpi_operator_tpu_torch.cluster.apiserver import NotFoundError
    with pytest.raises(NotFoundError):
        f.api.get("Job", "default", "test" + LAUNCHER_SUFFIX)
    # next sync with the gang genuinely Ready → launcher reborn on v2
    _seed_ready_workers(f, "test" + WORKER_SUFFIX, 2)
    f.run("default/test")
    launcher = f.api.get("Job", "default", "test" + LAUNCHER_SUFFIX)
    assert launcher.spec.template.main_container().image == "tpu-bench:v2"


def test_failed_gang_deletion_is_retried():
    """The restart signal is level-triggered: a failed pod deletion must
    leave the template-hash annotation stale so a LATER sync retries —
    under OnDelete nothing else ever replaces the old pods."""
    f = Fixture()
    f.seed(new_job(tpus=8))
    f.run("default/test")
    f.seed(_worker_pod("test-worker-0"))
    f.seed(_worker_pod("test-worker-1"))
    job = f.api.get(api.KIND, "default", "test")
    job.spec.template.main_container().image = "tpu-bench:v2"
    f.api.update(job)

    real_list = f.api.list
    def broken_list(kind, *a, **k):
        if kind == "Pod":
            raise RuntimeError("transient apiserver hiccup")
        return real_list(kind, *a, **k)
    f.api.list = broken_list
    f.run("default/test")                    # deletion fails, logged
    f.api.list = real_list
    assert f.api.list("Pod", "default",
                      label_selector="tpu_job_name=test") != []
    f.run("default/test")                    # retried and succeeds
    assert f.api.list("Pod", "default",
                      label_selector="tpu_job_name=test") == []


# ---------------------------------------------------------------------------
# job packing (controller/packing.py: shared gang for compatible jobs)
# ---------------------------------------------------------------------------

def _pack_job(name, ts, tpus=8, group="sweep"):
    job = new_job(name=name, tpus=tpus, pack_group=group)
    job.metadata.creation_timestamp = ts
    return job


def test_pack_leader_gang_carries_membership_env():
    """Oldest compatible member leads: its worker gang (and launcher)
    carry the TPU_PACK_* identity env naming every packed job."""
    f = Fixture()
    f.seed(_pack_job("a", 100.0))
    f.seed(_pack_job("b", 200.0))
    actions = f.run("default/a")
    assert ("create", "StatefulSet") in verbs(actions)
    sts = f.api.get("StatefulSet", "default", "a" + WORKER_SUFFIX)
    env = sts.spec.template.main_container().env
    assert env["TPU_PACK_GROUP"] == "sweep"
    assert env["TPU_PACK_JOBS"] == "a,b"      # leader first = replica 0
    assert env["TPU_PACK_K"] == "2"
    job = f.api.get(api.KIND, "default", "a")
    cond = job.status.get_condition("Packed")
    assert cond is not None and cond.reason == "PackLeader"
    # launcher (gated on Ready workers) inherits the same identity env
    _seed_ready_workers(f, "a" + WORKER_SUFFIX, 2)
    f.run("default/a")
    launcher = f.api.get("Job", "default", "a" + LAUNCHER_SUFFIX)
    assert launcher.spec.template.main_container().env[
        "TPU_PACK_JOBS"] == "a,b"


def test_packed_member_owns_nothing():
    """A non-leader's sync short-circuits: no gang, no launcher — only a
    Packed condition naming the leader and its replica index."""
    f = Fixture()
    f.seed(_pack_job("a", 100.0))
    f.seed(_pack_job("b", 200.0))
    actions = f.run("default/b")
    assert verbs(actions) == [("update-status", "TPUJob")]
    job = f.api.get(api.KIND, "default", "b")
    cond = job.status.get_condition("Packed")
    assert cond is not None and cond.reason == "PackedWithLeader"
    assert "'a'" in cond.message and "replica 1 of 2" in cond.message
    # idempotent: a second sync emits nothing
    assert f.run("default/b") == []


def test_pack_requires_identical_resource_shape():
    """Same group, different shape (tpus=16): NOT forced into the pack —
    it leads its own shape-class with no pack env (a gang of one)."""
    f = Fixture()
    f.seed(_pack_job("a", 100.0))
    f.seed(_pack_job("b", 200.0))
    f.seed(_pack_job("big", 50.0, tpus=16))   # oldest overall, wrong shape
    f.run("default/a")
    env = f.api.get("StatefulSet", "default",
                    "a" + WORKER_SUFFIX).spec.template.main_container().env
    assert env["TPU_PACK_JOBS"] == "a,b"      # big excluded despite age
    f.run("default/big")
    env = f.api.get("StatefulSet", "default",
                    "big" + WORKER_SUFFIX).spec.template.main_container().env
    assert "TPU_PACK_GROUP" not in env        # solo leader: template as-is


def test_pack_membership_change_is_a_template_edit():
    """Adding a member to a running solo leader rewrites the worker env —
    an ordinary level-triggered template drift, so the gang restarts on
    the new member list. A member finishing shrinks it back."""
    f = Fixture()
    f.seed(_pack_job("a", 100.0))
    f.run("default/a")
    env = f.api.get("StatefulSet", "default",
                    "a" + WORKER_SUFFIX).spec.template.main_container().env
    assert "TPU_PACK_GROUP" not in env        # pack of one: no env at all
    f.seed(_pack_job("b", 200.0))
    f.run("default/a")
    env = f.api.get("StatefulSet", "default",
                    "a" + WORKER_SUFFIX).spec.template.main_container().env
    assert env["TPU_PACK_JOBS"] == "a,b"
    # b finishes: it drops out of the plan and the env shrinks again
    b = f.api.get(api.KIND, "default", "b")
    b.status.set_condition(api.JobCondition(
        api.COND_SUCCEEDED, "True", "Done", "done"))
    f.api.update_status(b)
    f.run("default/a")
    env = f.api.get("StatefulSet", "default",
                    "a" + WORKER_SUFFIX).spec.template.main_container().env
    assert "TPU_PACK_GROUP" not in env


def test_packed_member_tears_down_pre_packing_resources():
    """b ran standalone first (created its own gang), THEN an older peer
    appeared (lister lag): b's next sync deletes its launcher/workers and
    defers to the leader."""
    f = Fixture()
    f.seed(_pack_job("b", 200.0))
    f.run("default/b")                        # standalone life: owns a gang
    assert f.api.get("StatefulSet", "default", "b" + WORKER_SUFFIX)
    f.seed(_pack_job("a", 100.0))             # older peer appears
    actions = f.run("default/b")
    assert ("delete", "StatefulSet") in verbs(actions)
    assert ("update-status", "TPUJob") in verbs(actions)

# ---------------------------------------------------------------------------
# disaggregated serving role pools (spec.serving; serve/engine.py DisaggEngine)
# ---------------------------------------------------------------------------

def _serving_job(name="test", tpus=16, prefill=3, decode=1, **kw):
    return new_job(name=name, tpus=tpus,
                   serving=api.ServingSpec(prefill_replicas=prefill,
                                           decode_replicas=decode), **kw)


def test_serving_stands_up_both_role_pools():
    """One TPUJob spec materializes TWO worker StatefulSets — the
    reference's heterogeneous-roles trick (launcher vs worker) extended
    to prefill vs decode. Each pool carries its role + both pools' peer
    addresses in env, and the pool label for per-pool federation."""
    from mpi_operator_tpu_torch.controller.controller import (
        DECODE_SUFFIX, KV_TRANSFER_PORT, LABEL_SERVE_ROLE, PREFILL_SUFFIX,
    )
    f = Fixture()
    f.seed(_serving_job())            # 16 chips / 4 per worker = 4 workers
    f.run("default/test")
    pre = f.api.get("StatefulSet", "default", "test" + PREFILL_SUFFIX)
    dec = f.api.get("StatefulSet", "default", "test" + DECODE_SUFFIX)
    assert pre.spec.replicas == 3 and dec.spec.replicas == 1
    for sts, role in ((pre, "prefill"), (dec, "decode")):
        env = sts.spec.template.main_container().env
        assert env["TPU_SERVE_ROLE"] == role
        assert env["TPU_SERVE_PREFILL_HOSTS"] == (
            "test-prefill-0.test-worker.default.svc,"
            "test-prefill-1.test-worker.default.svc,"
            "test-prefill-2.test-worker.default.svc")
        assert env["TPU_SERVE_DECODE_HOSTS"] == (
            "test-decode-0.test-worker.default.svc")
        assert env["TPU_SERVE_KV_PORT"] == str(KV_TRANSFER_PORT)
        assert sts.spec.template.metadata.labels[LABEL_SERVE_ROLE] == role
        # both pools still match the shared governing Service selector
        assert sts.spec.template.metadata.labels["tpu_job_role"] == "worker"
    # discovery data is prefill-major and records the split
    cm = f.api.get("ConfigMap", "default", "test" + CONFIG_SUFFIX)
    assert cm.data["worker-hostnames"].splitlines()[0].startswith(
        "test-prefill-0.")
    assert cm.data["serving-prefill-replicas"] == "3"
    assert cm.data["serving-decode-replicas"] == "1"


def test_serving_launcher_gated_on_both_pools():
    """The readiness gate spans BOTH pools (total ready == worker
    replicas); the launcher — the serving router — gets the peer host
    lists but no role of its own."""
    from mpi_operator_tpu_torch.controller.controller import (
        DECODE_SUFFIX, PREFILL_SUFFIX,
    )
    f = Fixture()
    f.seed(_serving_job())
    f.run("default/test")
    _seed_ready_workers(f, "test" + PREFILL_SUFFIX, 3)
    f.run("default/test")             # decode pool not Ready yet
    from mpi_operator_tpu_torch.cluster.apiserver import NotFoundError
    with pytest.raises(NotFoundError):
        f.api.get("Job", "default", "test" + LAUNCHER_SUFFIX)
    _seed_ready_workers(f, "test" + DECODE_SUFFIX, 1)
    f.run("default/test")
    launcher = f.api.get("Job", "default", "test" + LAUNCHER_SUFFIX)
    env = launcher.spec.template.main_container().env
    assert "TPU_SERVE_ROLE" not in env
    assert env["TPU_SERVE_PREFILL_HOSTS"].count("test-prefill-") == 3
    assert env["TPU_SERVE_DECODE_HOSTS"] == (
        "test-decode-0.test-worker.default.svc")


def test_serving_pool_split_change_is_a_gang_restart():
    """Re-partitioning 3/1 -> 2/2 at the same chip count changes every
    pod's peer env — template drift on BOTH pools, so the change rides
    the template hash as one ordinary level-triggered gang restart."""
    from mpi_operator_tpu_torch.controller.controller import (
        DECODE_SUFFIX, PREFILL_SUFFIX,
    )
    f = Fixture()
    f.seed(_serving_job())
    f.run("default/test")
    job = f.api.get(api.KIND, "default", "test")
    job.spec.serving = api.ServingSpec(prefill_replicas=2, decode_replicas=2)
    f.api.update(job)
    f.run("default/test")
    pre = f.api.get("StatefulSet", "default", "test" + PREFILL_SUFFIX)
    dec = f.api.get("StatefulSet", "default", "test" + DECODE_SUFFIX)
    assert pre.spec.replicas == 2 and dec.spec.replicas == 2
    assert dec.spec.template.main_container().env[
        "TPU_SERVE_DECODE_HOSTS"].count("test-decode-") == 2
    assert any(e.reason == "TPUJobResized"
               for e in f.controller.recorder.events)


def test_serving_scales_down_both_pools_when_done():
    from mpi_operator_tpu_torch.controller.controller import (
        DECODE_SUFFIX, PREFILL_SUFFIX,
    )
    f = Fixture()
    f.seed(_serving_job())
    f.run("default/test")
    _seed_ready_workers(f, "test" + PREFILL_SUFFIX, 3)
    _seed_ready_workers(f, "test" + DECODE_SUFFIX, 1)
    f.run("default/test")                         # creates the launcher
    launcher = f.api.get("Job", "default", "test" + LAUNCHER_SUFFIX)
    launcher.status = JobStatus(succeeded=1, completion_time=123.0)
    f.api.update(launcher)
    f.run("default/test")
    assert f.api.get("StatefulSet", "default",
                     "test" + PREFILL_SUFFIX).spec.replicas == 0
    assert f.api.get("StatefulSet", "default",
                     "test" + DECODE_SUFFIX).spec.replicas == 0


def test_serving_admission_rejects_bad_pool_split():
    """Pool counts must re-partition the derived worker count exactly —
    and serving composes with neither elastic nor packing."""
    from mpi_operator_tpu_torch.cluster.apiserver import InMemoryAPIServer as S
    f = Fixture()
    with pytest.raises(S.AdmissionError, match="prefillReplicas"):
        # explicit per-worker: admission can derive 4 workers != 3 pooled
        f.api.create(_serving_job(prefill=2, decode=1, tpus_per_worker=4))
    with pytest.raises(S.AdmissionError, match="elastic"):
        f.api.create(_serving_job(elastic=True))
    with pytest.raises(S.AdmissionError, match="packGroup"):
        f.api.create(_serving_job(pack_group="sweep"))
    with pytest.raises(S.AdmissionError, match="decodeReplicas"):
        f.api.create(_serving_job(prefill=4, decode=0))
    # flag-default per-worker count: only the controller can derive the
    # worker count — the backstop converges to Failed/InvalidTPUJobSpec
    f.seed(_serving_job(prefill=2, decode=1))
    f.run("default/test")
    cond = f.api.get(api.KIND, "default", "test").status.get_condition(
        api.COND_FAILED)
    assert cond is not None and cond.reason == "InvalidTPUJobSpec"
    assert "prefillReplicas" in cond.message


# ---------------------------------------------------------------------------
# pack-aware slice quota accounting (controller/packing.py slices_used)
# ---------------------------------------------------------------------------

def test_slice_quota_counts_packed_gang_once():
    """Two packed members share ONE physical gang: quota accounting must
    charge their slice once (via the leader), not once per member job —
    the naive per-job sum overcharges by k-1 slices per gang."""
    f = Fixture()
    f.seed(_pack_job("a", 100.0))
    f.seed(_pack_job("b", 200.0))
    f.seed(new_job(name="solo", tpus=8))
    assert f.controller.slices_in_use() == 2      # pack(a,b) + solo
    # a member finishing doesn't change the count (its gang was never
    # separately charged); the LEADER finishing releases the pack's slice
    b = f.api.get(api.KIND, "default", "b")
    b.status.set_condition(api.JobCondition(
        api.COND_SUCCEEDED, "True", "Done", "done"))
    f.api.update_status(b)
    assert f.controller.slices_in_use() == 2
    a = f.api.get(api.KIND, "default", "a")
    a.status.set_condition(api.JobCondition(
        api.COND_SUCCEEDED, "True", "Done", "done"))
    f.api.update_status(a)
    assert f.controller.slices_in_use() == 1      # solo only


def test_slice_quota_multi_slice_and_metrics_surface():
    """A multi-slice job charges num_slices; the gauge rides the operator
    /metrics scrape so a cluster quota check can consume it."""
    from mpi_operator_tpu_torch.controller.metrics import render_metrics
    f = Fixture()
    f.seed(new_job(name="ms", tpus=16, num_slices=2))
    f.seed(_pack_job("a", 100.0))
    f.seed(_pack_job("b", 200.0))
    assert f.controller.slices_in_use() == 3      # 2 + pack(a,b)
    assert "tpu_operator_slices_in_use 3" in render_metrics(f.controller)


# ---------------------------------------------------------------------------
# GPU mode: the port's own defaults (nvidia.com/gpu, 8 per worker)
# ---------------------------------------------------------------------------

class GPUFixture(Fixture):
    """A controller on the port's defaults, with no TPU_MODE override."""

    def __init__(self, **config_kwargs):
        self.api = InMemoryAPIServer()
        self.controller = TPUJobController(
            self.api, config=ControllerConfig(**config_kwargs))
        self.controller.factory.start_all()


#: what the bootstrap exports itself; the pod spec never renders them
TORCH_RENDEZVOUS_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK")
TPU_SELECTORS = ("cloud.google.com/gke-tpu-accelerator",
                 "cloud.google.com/gke-tpu-topology")


def gpu_job(name="test", units=16, per_worker=None, **kw) -> TPUJob:
    return new_job(name, tpus=None, processing_units=units,
                   processing_units_per_worker=per_worker, **kw)


def test_operator_defaults_are_gpu():
    """ControllerConfig and the CLI default to the reference's GPU node:
    nvidia.com/gpu at 8 per worker; the tpus mode keeps its 4."""
    from mpi_operator_tpu_torch.__main__ import build_parser
    cfg = ControllerConfig()
    assert cfg.processing_resource_type == api.RESOURCE_GPU == "nvidia.com/gpu"
    assert cfg.processing_units_per_worker == 8
    assert cfg.tpus_per_worker == 4
    args = build_parser().parse_args([])
    assert args.processing_resource_type == api.RESOURCE_GPU
    assert args.processing_units_per_worker == 8
    assert args.tpus_per_worker == 4
    choices = next(a.choices for a in build_parser()._actions
                   if a.dest == "processing_resource_type")
    assert set(choices) == {api.RESOURCE_GPU, api.RESOURCE_CPU,
                            api.RESOURCE_TPU}


def test_all_resources_created_gpu():
    """processingUnits on the GPU defaults: 16 / 8 per worker = 2 workers
    with nvidia.com/gpu limits, the readiness gate, no TPU selectors and
    no torch.distributed env (the bootstrap exports that itself)."""
    f = GPUFixture()
    job = f.seed(gpu_job(units=16))
    actions = f.run("default/test")
    assert ("create", "StatefulSet") in verbs(actions)
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert sts.spec.replicas == 2
    assert sts.metadata.owner_references[0].uid == job.metadata.uid
    c = sts.spec.template.main_container()
    assert c.limits == {api.RESOURCE_GPU: 8}
    assert not set(TPU_SELECTORS) & set(sts.spec.template.node_selector)
    assert c.env["TPU_READY_FILE"] == "/tmp/tpu-ready"
    assert c.env["TPU_EXPECTED_CHIPS"] == "8"
    assert c.readiness_probe["exec"]["command"][-1] == "test -f /tmp/tpu-ready"
    assert not set(TORCH_RENDEZVOUS_ENV) & set(c.env)
    cm = f.api.get("ConfigMap", "default", "test" + CONFIG_SUFFIX)
    assert cm.data["num-processes"] == "2"
    assert cm.data["tpus-per-worker"] == "8"
    assert cm.data["resource-type"] == api.RESOURCE_GPU


def test_single_worker_when_total_below_per_worker_gpu():
    f = GPUFixture()
    f.seed(gpu_job(units=2))
    f.run("default/test")
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert sts.spec.replicas == 1
    c = sts.spec.template.main_container()
    assert c.limits == {api.RESOURCE_GPU: 2}
    assert c.env["TPU_EXPECTED_CHIPS"] == "2"


def test_custom_replicas_gpu_limits():
    """Mode B with explicit nvidia.com/gpu limits: each worker is sized
    from its own limit, which renders unchanged."""
    f = GPUFixture()
    job = new_job(tpus=None)
    job.spec.replicas = 2
    job.spec.template.main_container().limits = {api.RESOURCE_GPU: 4}
    f.seed(job)
    f.run("default/test")
    cm = f.api.get("ConfigMap", "default", "test" + CONFIG_SUFFIX)
    assert cm.data["tpus-per-worker"] == "4"
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert sts.spec.replicas == 2
    c = sts.spec.template.main_container()
    assert c.limits == {api.RESOURCE_GPU: 4}
    assert c.env["TPU_EXPECTED_CHIPS"] == "4"
    assert not set(TPU_SELECTORS) & set(sts.spec.template.node_selector)


def test_custom_replicas_gpu_needs_its_limit():
    """Mode B on the GPU default with no nvidia.com/gpu limit fails at
    admission, as a TPU job without google.com/tpu does."""
    f = GPUFixture()
    job = new_job(tpus=None)
    job.spec.replicas = 2
    with pytest.raises(InMemoryAPIServer.AdmissionError,
                       match="nvidia.com/gpu"):
        f.seed(job)
    job.spec.processing_resource_type = api.RESOURCE_GPU
    job.spec.template.main_container().limits = {api.RESOURCE_TPU: 4}
    with pytest.raises(InMemoryAPIServer.AdmissionError,
                       match="nvidia.com/gpu"):
        f.seed(job)


def test_launcher_created_when_gpu_workers_ready():
    """The gate holds the launcher until every GPU worker is Ready; the
    launcher itself asks for no card."""
    f = GPUFixture()
    job = f.seed(gpu_job(units=16))
    _seed_workers(f, job, replicas=2, ready=1)
    assert ("create", "Job") not in verbs(f.run("default/test"))
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    sts.status = StatefulSetStatus(ready_replicas=2, replicas=2)
    f.api.update(sts)
    assert ("create", "Job") in verbs(f.run("default/test"))
    launcher = f.api.get("Job", "default", "test" + LAUNCHER_SUFFIX)
    c = launcher.spec.template.main_container()
    assert c.env["TPU_NUM_PROCESSES"] == "2"
    assert c.env["TPU_LAUNCHER"] == "1"
    assert api.RESOURCE_GPU not in c.limits
    assert c.readiness_probe is None
    assert not set(TORCH_RENDEZVOUS_ENV) & set(c.env)


def test_gpu_worker_readiness_probe_injected():
    """GPU workers are gated like TPU workers; the expected count is per
    process (8 cards over 2 slots = 4 each)."""
    f = GPUFixture()
    f.seed(gpu_job(units=16, slots_per_worker=2))
    f.run("default/test")
    c = f.api.get("StatefulSet", "default",
                  "test" + WORKER_SUFFIX).spec.template.main_container()
    assert c.readiness_probe["exec"]["command"][-1] == "test -f /tmp/tpu-ready"
    assert c.readiness_probe["failureThreshold"] >= 30
    assert c.env["TPU_EXPECTED_CHIPS"] == "4"


def test_cpu_workers_get_no_tpu_probe_on_the_gpu_defaults():
    """A cpu job under the GPU-default operator stays ungated."""
    f = GPUFixture()
    job = new_job(tpus=None)
    job.spec.replicas = 2
    job.spec.processing_resource_type = api.RESOURCE_CPU
    job.spec.template.main_container().limits = {"cpu": 2}
    f.seed(job)
    f.run("default/test")
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    c = sts.spec.template.main_container()
    assert c.readiness_probe is None
    assert "TPU_READY_FILE" not in c.env
    assert c.limits == {"cpu": 2}
    assert not set(TPU_SELECTORS) & set(sts.spec.template.node_selector)


def test_gpu_health_gate_annotation_opt_out():
    f = GPUFixture()
    job = gpu_job(units=8)
    job.metadata.annotations["tpu.kubeflow.org/health-gate"] = "false"
    f.seed(job)
    f.run("default/test")
    c = f.api.get("StatefulSet", "default",
                  "test" + WORKER_SUFFIX).spec.template.main_container()
    assert c.readiness_probe is None
    assert "TPU_READY_FILE" not in c.env
    assert c.limits == {api.RESOURCE_GPU: 8}


def test_tpus_spelling_stays_tpu_mode_on_the_gpu_defaults():
    """`tpus` with --tpus-per-worker is TPU mode whatever the operator's
    default type: google.com/tpu limits and the slice selectors."""
    f = GPUFixture()
    f.seed(new_job(tpus=8, slice_topology="2x4"))
    f.run("default/test")
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert sts.spec.replicas == 2
    assert sts.spec.template.main_container().limits == {api.RESOURCE_TPU: 4}
    assert sts.spec.template.node_selector[
        "cloud.google.com/gke-tpu-topology"] == "2x4"
    assert "cloud.google.com/gke-tpu-accelerator" in (
        sts.spec.template.node_selector)


_TPUS_GPU = "spec.tpus is the TPU sizing mode and cannot take"


@pytest.mark.parametrize("make,match", [
    (lambda: gpu_job(units=16, elastic=True),
     "spec.elastic requires the tpus sizing mode"),
    (lambda: gpu_job(units=16, resize=16),
     "spec.resize requires the tpus sizing mode"),
    (lambda: new_job(tpus=8, processing_resource_type=api.RESOURCE_GPU),
     _TPUS_GPU),
    (lambda: new_job(tpus=16, elastic=True,
                     processing_resource_type=api.RESOURCE_GPU), _TPUS_GPU),
    (lambda: new_job(tpus=8, resize=16,
                     processing_resource_type=api.RESOURCE_GPU), _TPUS_GPU)],
    ids=["elastic", "resize", "tpus", "tpus-elastic", "tpus-resize"])
def test_gpu_elastic_and_resize_refused(make, match):
    """Elastic membership and resize stay on the tpus sizing mode, and the
    tpus mode stays TPU: a GPU job that asks for either, in any spelling,
    is refused at admission."""
    f = GPUFixture()
    with pytest.raises(InMemoryAPIServer.AdmissionError, match=match):
        f.seed(make())


def test_gpu_jobs_bypass_the_fleet_scheduler():
    """The fleet scheduler's pool counts TPU chips only: a GPU job larger
    than the pool is admitted, as a cpu job is in the JAX controller."""
    f = GPUFixture(sched_pool_chips=4)
    f.seed(gpu_job(units=16))
    f.run("default/test")
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    assert sts.spec.replicas == 2


class ScrapeLog:
    """An injected observatory that records the controller's scrape
    calls and answers the readers with "nothing observed yet"."""

    def __init__(self):
        self.observed = []

    def observe(self, job, targets, force=False, serving=False):
        self.observed.append((job, dict(targets), serving))

    def __getattr__(self, name):
        if name.startswith("note_") or name == "reset_progress_lease":
            return lambda *a, **k: None
        if name in ("stall_seconds", "partition_state"):
            return lambda *a, **k: None if name == "stall_seconds" \
                else (set(), 0)
        raise AttributeError(name)


@pytest.mark.parametrize("flag", ["events_dir", "worker_metrics_port",
                                  "scrape_interval"])
def test_observatory_switches_build_the_observatory(flag, tmp_path):
    """Each switch does what the JAX controller's does: --events-dir or
    --worker-metrics-port builds a JobObservatory (the port's collector)
    with the config's scrape interval, which defaults to the reference's
    10 s; neither leaves the controller without one; an injected
    observatory wins."""
    from mpi_operator_tpu.controller import ControllerConfig as JConfig
    from mpi_operator_tpu_torch.__main__ import build_parser
    from mpi_operator_tpu_torch.telemetry.collector import JobObservatory
    assert ControllerConfig().scrape_interval == JConfig().scrape_interval \
        == build_parser().parse_args([]).scrape_interval == 10.0
    kw = {"events_dir": {"events_dir": str(tmp_path)},
          "worker_metrics_port": {"worker_metrics_port": 9100},
          "scrape_interval": {"worker_metrics_port": 9100,
                              "scrape_interval": 2.5}}[flag]
    ctrl = TPUJobController(InMemoryAPIServer(),
                            config=ControllerConfig(**kw))
    obs = ctrl.observatory
    assert isinstance(obs, JobObservatory)
    assert obs.scrape_interval == kw.get("scrape_interval", 10.0)
    assert obs.events_dir == kw.get("events_dir")
    assert (obs.events is not None) == (flag == "events_dir")
    assert TPUJobController(InMemoryAPIServer()).observatory is None
    sentinel = ScrapeLog()
    ctrl = TPUJobController(InMemoryAPIServer(),
                            config=ControllerConfig(**kw),
                            observatory=sentinel)
    assert ctrl.observatory is sentinel


@pytest.mark.parametrize("mode", ["gpu", "tpu"])
def test_metrics_port_reaches_the_worker_env_and_the_scrape(mode):
    """With a worker metrics port, every worker's env carries
    TPU_METRICS_PORT (the port's lm_benchmark serves /metrics there) and
    the controller scrapes each worker pod's hostname at that port, rank
    by rank, once the gang is ready; the TPU-mode env equals the JAX
    controller's. Without the port there is neither."""
    from mpi_operator_tpu.api.types import new_tpu_job as j_new_tpu_job
    from mpi_operator_tpu.cluster.apiserver import \
        InMemoryAPIServer as JAPIServer
    from mpi_operator_tpu.controller import ControllerConfig as JConfig
    from mpi_operator_tpu.controller import TPUJobController as JController
    log = ScrapeLog()
    f = (GPUFixture if mode == "gpu" else Fixture)(worker_metrics_port=9100)
    f.controller.observatory = log
    f.seed(gpu_job() if mode == "gpu" else new_job())
    f.run("default/test")
    sts = f.api.get("StatefulSet", "default", "test" + WORKER_SUFFIX)
    env = sts.spec.template.main_container().env
    assert env["TPU_METRICS_PORT"] == "9100"
    assert log.observed == []                # not ready: nothing to scrape
    sts.status.ready_replicas = sts.spec.replicas
    f.api.update(sts)
    f.run("default/test")
    host = "test-worker-{}.test-worker.default.svc:9100"
    assert log.observed == [("test", {r: "http://" + host.format(r)
                                      for r in range(2)}, False)]
    if mode == "tpu":
        japi = JAPIServer()
        jctrl = JController(japi, config=JConfig(worker_metrics_port=9100))
        jctrl.observatory = ScrapeLog()
        jctrl.factory.start_all()
        job = j_new_tpu_job("test", tpus=8)
        job.spec.template.main_container().image = "tpu-bench:latest"
        japi.create(job)
        jctrl.sync_handler("default/test")
        jenv = japi.get("StatefulSet", "default", "test" + WORKER_SUFFIX
                        ).spec.template.main_container().env
        assert jenv == env
    bare = (GPUFixture if mode == "gpu" else Fixture)()
    bare.seed(gpu_job() if mode == "gpu" else new_job())
    bare.run("default/test")
    assert "TPU_METRICS_PORT" not in bare.api.get(
        "StatefulSet", "default", "test" + WORKER_SUFFIX
    ).spec.template.main_container().env


def test_demo_with_the_observatory_runs_without_torch(tmp_path):
    """`python -m mpi_operator_tpu_torch --demo --worker-metrics-port 9100
    --events-dir <dir>` in an interpreter where torch and jax cannot
    load: the GPU job reaches Succeeded, the controller's event log and
    the job's merged timeline land under the events dir (its scrapes
    fail, as the demo starts no worker process), and the postmortem
    renders that timeline."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    code = ("import runpy, sys\n"
            "for m in ('torch', 'jax', 'jaxlib', 'triton'):\n"
            "    sys.modules[m] = None\n"
            "sys.argv = ['x'] + sys.argv[1:]\n"
            "runpy.run_module(sys.argv.pop(1), run_name='__main__',"
            " alter_sys=True)\n")
    events = tmp_path / "events"
    out = subprocess.run(
        [sys.executable, "-c", code, "mpi_operator_tpu_torch", "--demo",
         "--worker-metrics-port", "9100", "--events-dir", str(events)],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "demo lifecycle complete" in out.stderr
    timeline = events / "demo" / "timeline.jsonl"
    kinds = [json.loads(line)["event"]
             for line in timeline.read_text().splitlines()]
    assert kinds[0] == "job_created" and kinds[-1] == "job_succeeded"
    assert "pods_ready" in kinds
    assert (events / "controller-events.jsonl").exists()
    out = subprocess.run(
        [sys.executable, "-c", code, "mpi_operator_tpu_torch.postmortem",
         str(timeline)], cwd=root, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "postmortem: job demo" in out.stdout and "goodput" in out.stdout


def test_gpu_job_lifecycle_through_the_run_loop():
    """Submit → gated workers → launcher → Succeeded → workers scaled to
    0, through the threaded run loop on the GPU defaults."""
    import threading
    import time
    f = GPUFixture()
    stop = threading.Event()
    f.controller.run(threadiness=2, stop_event=stop)

    def wait(pred, desc, timeout=10.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            got = pred()
            if got:
                return got
            time.sleep(0.01)
        raise TimeoutError(desc)

    try:
        f.api.create(gpu_job("life", units=8, restart_policy="Never"))
        sts = wait(lambda: f.api.try_get("StatefulSet", "default",
                                         "life-worker"), "worker set")
        assert sts.spec.template.main_container().limits == {
            api.RESOURCE_GPU: 8}
        time.sleep(0.05)
        assert f.api.try_get("Job", "default", "life-launcher") is None
        sts.status.ready_replicas = sts.spec.replicas
        f.api.update(sts)
        launcher = wait(lambda: f.api.try_get("Job", "default",
                                              "life-launcher"), "launcher")
        launcher.status.succeeded = 1
        launcher.status.completion_time = time.time()
        f.api.update(launcher)
        wait(lambda: f.api.get(api.KIND, "default", "life")
             .status.is_done(), "Succeeded")
        assert f.api.get(api.KIND, "default", "life").status.get_condition(
            api.COND_SUCCEEDED).status == "True"
        wait(lambda: f.api.get("StatefulSet", "default",
                               "life-worker").spec.replicas == 0,
             "workers scaled to 0")
    finally:
        stop.set()
        f.controller.queue.shut_down()


# ---------------------------------------------------------------------------
# differential: the same job stream through the JAX controller and the port's
# ---------------------------------------------------------------------------

def _side(pkg):
    """The modules of one package's control plane, by their shared paths."""
    import importlib
    return {m: importlib.import_module(f"{pkg}.{m}") for m in (
        "api.types", "cluster.apiserver", "cluster.serialize",
        "controller.controller")}


JAX_SIDE = _side("mpi_operator_tpu")
PORT_SIDE = _side("mpi_operator_tpu_torch")
#: every kind the reconciler writes, and the Events its recorder posts
KINDS = ("TPUJob", "ConfigMap", "Service", "ServiceAccount", "Role",
         "RoleBinding", "PodDisruptionBudget", "StatefulSet", "Job", "Event")
#: (name, spec fields, container limits) of the JAX scenarios' jobs; None
#: in the limits stands for the side's own accelerator resource
STREAM = (
    ("mode-a", dict(tpus=8), {}),
    ("units", dict(processing_units=8, processing_units_per_worker=4), {}),
    ("mode-b", dict(replicas=2), {None: 4}),
    ("cpu", dict(replicas=2, processing_resource_type="cpu"), {"cpu": 2}),
    ("slices", dict(tpus=16, num_slices=2), {}),
    ("serve", dict(tpus=8, serving="1+1"), {}),
    ("pack-a", dict(tpus=4, pack_group="sweep"), {}),
    ("pack-b", dict(tpus=4, pack_group="sweep"), {}),
    ("never", dict(tpus=4, restart_policy="Never"), {}),
    ("onfailure", dict(tpus=4, restart_policy="OnFailure",
                       backoff_limit=2), {}),
    ("exitcode", dict(tpus=4, restart_policy="ExitCode"), {}),
    ("gang", dict(tpus=8, gang_scheduling=True), {}),
)
#: the stream spelled for GPUs: processingUnits or replicas, never tpus
GPU_STREAM = (
    ("units", dict(processing_units=8, processing_units_per_worker=4), {}),
    ("below", dict(processing_units=2, processing_units_per_worker=4), {}),
    ("mode-b", dict(replicas=2), {None: 4}),
    ("cpu", dict(replicas=2, processing_resource_type="cpu"), {"cpu": 2}),
    ("slices", dict(processing_units=16, processing_units_per_worker=4,
                    num_slices=2), {}),
    ("serve", dict(processing_units=8, processing_units_per_worker=4,
                   serving="1+1"), {}),
    ("pack-a", dict(processing_units=4, processing_units_per_worker=4,
                    pack_group="sweep"), {}),
    ("pack-b", dict(processing_units=4, processing_units_per_worker=4,
                    pack_group="sweep"), {}),
    ("onfailure", dict(processing_units=4, processing_units_per_worker=4,
                       restart_policy="OnFailure", backoff_limit=2), {}),
    ("exitcode", dict(processing_units=4, processing_units_per_worker=4,
                      restart_policy="ExitCode"), {}),
    ("gang", dict(processing_units=8, processing_units_per_worker=4,
                  gang_scheduling=True), {}),
)
#: the launchers the kubelet fails (the rest succeed)
FAILING = ("onfailure", "exitcode", "never")
_VOLATILE = ("uid", "resourceVersion")


def _normalise(m):
    """Timestamps and server-made ids out; an Event's generated name
    becomes its involved object's."""
    if isinstance(m, dict):
        out = {k: "*" if (k in _VOLATILE or k.endswith("Time")
                          or k.endswith("Timestamp")) else _normalise(v)
               for k, v in m.items()}
        if m.get("kind") == "Event":
            out["metadata"] = {**out["metadata"],
                               "name": m["involvedObject"]["name"]}
        return out
    if isinstance(m, list):
        return [_normalise(v) for v in m]
    return m


def _drive(side, config, stream, resource):
    """Create the stream's jobs, then play kubelet in steps: workers
    Ready, launchers active, launchers done. Returns each step's
    snapshot: kind -> sorted normalised manifests."""
    import json
    t = side["api.types"]
    server = side["cluster.apiserver"].InMemoryAPIServer()
    ctrl_mod = side["controller.controller"]
    ctrl = ctrl_mod.TPUJobController(
        server, config=ctrl_mod.ControllerConfig(**config))
    ctrl.factory.start_all()
    ctrl.now = lambda: 1.7e9
    keys = []
    for name, spec, limits in stream:
        spec = dict(spec)
        if spec.pop("serving", None):
            spec["serving"] = t.ServingSpec(prefill_replicas=1,
                                            decode_replicas=1)
        job = t.new_tpu_job(name, **spec)
        c = job.spec.template.main_container()
        c.image = "trainer:latest"
        c.command = ["python", "-m", "trainer"]
        c.limits = {resource if k is None else k: v
                    for k, v in limits.items()}
        server.create(job)
        keys.append(f"default/{name}")

    def sync():
        for _ in range(2):
            for key in keys:
                ctrl.sync_handler(key)

    def snapshot():
        to_manifest = side["cluster.serialize"].to_manifest
        return {kind: sorted((_normalise(to_manifest(o))
                              for o in server.list(kind)),
                             key=lambda m: json.dumps(m, sort_keys=True))
                for kind in KINDS}

    def each(kind, fn):
        for obj in server.list(kind):
            fn(obj)
            server.update(obj)

    def ready(sts):
        sts.status.replicas = sts.spec.replicas
        sts.status.ready_replicas = sts.spec.replicas

    def active(job):
        job.status.active = 1

    def done(job):
        job.status.active = 0
        failed = job.metadata.name.rsplit("-", 1)[0] in FAILING
        job.status.failed = int(failed)
        job.status.succeeded = int(not failed)
        job.status.completion_time = 1.7e9

    snaps = []
    sync()
    snaps.append(snapshot())
    for kind, fn in (("StatefulSet", ready), ("Job", active),
                     ("Job", done)):
        each(kind, fn)
        sync()
        snaps.append(snapshot())
    return snaps


#: the spec fields the port's serializer writes and the JAX package's
#: drops (ROADMAP.md Queue 3, O4, fixed): the TPUJobs differ in them only
O4_FIELDS = ("packGroup", "serving")


def _without_o4(snaps):
    """The port's snapshots with the O4 fields taken out of its TPUJobs,
    after checking that the serving and pack jobs carry them."""
    for snap in snaps:
        for m in snap["TPUJob"]:
            name, spec = m["metadata"]["name"], m["spec"]
            got = {k: spec.pop(k) for k in O4_FIELDS if k in spec}
            want = ({"packGroup": "sweep"} if name.startswith("pack-") else
                    {"serving": {"prefillReplicas": 1, "decodeReplicas": 1}}
                    if name == "serve" else {})
            assert got == want, (name, got)
    return snaps


def _tpu_mode(gang):
    return dict(processing_resource_type="google.com/tpu",
                processing_units_per_worker=4, enable_gang_scheduling=gang)


@pytest.mark.parametrize("gang", [False, True], ids=["plain", "gang"])
def test_tpu_mode_manifests_equal_the_jax_controllers(gang):
    """In TPU mode the port's controller writes, step by step, exactly the
    objects the JAX controller writes for the same job stream, but for
    the O4 fields of its TPUJobs (the serving pools, the pack group),
    which the JAX package's serializer drops."""
    jax_snaps = _drive(JAX_SIDE, dict(enable_gang_scheduling=gang), STREAM,
                       "google.com/tpu")
    port_snaps = _without_o4(_drive(PORT_SIDE, _tpu_mode(gang), STREAM,
                                    "google.com/tpu"))
    assert len(jax_snaps) == len(port_snaps) == 4
    for step, (j, p) in enumerate(zip(jax_snaps, port_snaps)):
        for kind in KINDS:
            assert p[kind] == j[kind], (step, kind)
    final = port_snaps[-1]
    assert len(final["StatefulSet"]) >= 10 and len(final["Job"]) >= 9
    assert any(m["kind"] == "PodDisruptionBudget"
               for m in final["PodDisruptionBudget"])
    phases = {m["metadata"]["name"]: [c["type"] for c in m["status"].get(
        "conditions", []) if c["status"] == "True"]
        for m in final["TPUJob"]}
    assert "Succeeded" in phases["mode-a"] and "Failed" in phases["never"]


def _flatten(m, path=()):
    if isinstance(m, dict):
        for k, v in m.items():
            yield from _flatten(v, path + (k,))
    elif isinstance(m, list):
        for i, v in enumerate(m):
            yield from _flatten(v, path + (i,))
    else:
        yield path, m


#: the fields in which a GPU job's objects may differ from the same job's
#: in TPU mode, and nothing else: the resource in the container limits
#: (same count), the TPU node selectors (TPU only), the ConfigMap's
#: resource-type, and the template hash that covers the first two
GPU_FIELDS = ("limits: google.com/tpu -> nvidia.com/gpu",
              "nodeSelector: cloud.google.com/gke-tpu-* (TPU only)",
              "ConfigMap data.resource-type",
              "annotation tpu.kubeflow.org/template-hash")


def _gpu_field(path, j, p):
    """Which GPU_FIELDS entry explains a differing path (None: none)."""
    last = path[-1] if path else None
    if "limits" in path and last in ("google.com/tpu", "nvidia.com/gpu"):
        other = path[:-1] + ("nvidia.com/gpu" if last == "google.com/tpu"
                             else "google.com/tpu",)
        mine, theirs = (j, p) if last == "google.com/tpu" else (p, j)
        if path in mine and path not in theirs and theirs.get(other) == \
                mine[path]:
            return GPU_FIELDS[0]
    if ("nodeSelector" in path and str(last).startswith(
            "cloud.google.com/gke-tpu-") and path in j and path not in p):
        return GPU_FIELDS[1]
    if path[:2] == ("data", "resource-type") and (j.get(path), p.get(
            path)) == ("google.com/tpu", "nvidia.com/gpu"):
        return GPU_FIELDS[2]
    if last == "tpu.kubeflow.org/template-hash":
        return GPU_FIELDS[3]
    return None


def test_gpu_mode_differs_from_the_jax_controller_only_in_gpu_fields():
    """The port on its GPU defaults against the JAX controller on its TPU
    defaults, for the same stream spelled with processingUnits or
    replicas: every object pairs up, and each differing field is one of
    GPU_FIELDS; the GPU workers carry nvidia.com/gpu and no TPU
    selector."""
    jax_snaps = _drive(JAX_SIDE, {}, GPU_STREAM, "google.com/tpu")
    port_snaps = _without_o4(_drive(PORT_SIDE, {}, GPU_STREAM,
                                    "nvidia.com/gpu"))
    seen = set()
    for step, (js, ps) in enumerate(zip(jax_snaps, port_snaps)):
        for kind in KINDS:
            key = (lambda m: (m["metadata"]["name"], m.get("reason"),
                              m.get("message")))
            jm = sorted(js[kind], key=key)
            pm = sorted(ps[kind], key=key)
            assert [key(m) for m in jm] == [key(m) for m in pm], (step, kind)
            for a, b in zip(jm, pm):
                fa, fb = dict(_flatten(a)), dict(_flatten(b))
                for path in set(fa) | set(fb):
                    if fa.get(path, KeyError) != fb.get(path, KeyError):
                        why = _gpu_field(path, fa, fb)
                        assert why is not None, (step, kind, path,
                                                 fa.get(path), fb.get(path))
                        seen.add(why)
    assert seen == set(GPU_FIELDS)
    for sts in port_snaps[0]["StatefulSet"]:
        c = sts["spec"]["template"]["spec"]["containers"][0]
        selectors = sts["spec"]["template"]["spec"].get("nodeSelector", {})
        assert not [k for k in selectors if "gke-tpu" in k]
        if sts["metadata"]["name"].startswith("cpu-"):
            assert "readinessProbe" not in c
            continue
        assert set(c["resources"]["limits"]) == {"nvidia.com/gpu"}
        env = {e["name"]: e.get("value") for e in c["env"]}
        assert env["TPU_READY_FILE"] == "/tmp/tpu-ready"
        assert "TPU_EXPECTED_CHIPS" in env and "readinessProbe" in c
        assert not set(TORCH_RENDEZVOUS_ENV) & set(env)
