"""TPUJobController — the watch-driven reconciler.

ref: pkg/controllers/mpi_job_controller.go (1,236 LoC, the reference's core).
This module mirrors its state machine (SURVEY.md §3.2) while replacing every
GPU/MPI mechanism with the TPU-native counterpart (SURVEY.md §7):

  reference                          this controller
  ---------                          ---------------
  hostfile + kubexec.sh ConfigMap    worker-hostnames + coordinator ConfigMap
  per-job Role: create pods/exec     per-job Role: get pods/configmaps (discovery)
  kubectl-delivery init container    none needed (env-based bootstrap)
  launcher runs `mpirun`             launcher = thin coordinator / rank 0
  workers `sleep 365d`               workers run the training process
  gpus / nvidia.com/gpu              tpus / google.com/tpu + slice topology

The reconcile loop is level-triggered and idempotent: it re-runs on every
event and converges desired → actual, refusing to adopt foreign-owned
children (ref :641-645 and siblings).

The PyTorch port's copy of mpi_operator_tpu/controller/controller.py. It
imports neither torch nor jax, and differs from that file in GPU mode
only: the operator's defaults are `nvidia.com/gpu` at 8 per worker (the
reference's --gpus-per-node 8), GPU workers get the readiness gate as TPU
workers do (and no TPU node selectors). Its job observatory
(telemetry/collector.py JobObservatory) is the port's own copy.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from ..api import types as api
from ..api.types import (
    COND_CREATED,
    COND_FAILED,
    COND_RUNNING,
    COND_SUCCEEDED,
    LAUNCHER_ACTIVE,
    LAUNCHER_FAILED,
    LAUNCHER_SUCCEEDED,
    RESOURCE_CPU,
    RESOURCE_GPU,
    RESOURCE_TPU,
    Container,
    ObjectMeta,
    PodTemplateSpec,
    TPUJob,
    is_controlled_by,
)
from ..cluster.apiserver import (
    AlreadyExistsError, ApiError, ConflictError, InMemoryAPIServer,
    NotFoundError, is_transient)
from ..cluster.informers import InformerFactory
from ..cluster.resources import (
    ConfigMap,
    Job,
    JobSpec,
    PodDisruptionBudget,
    PolicyRule,
    Role,
    RoleBinding,
    Service,
    ServiceAccount,
    StatefulSet,
    StatefulSetSpec,
)
from ..cluster.workqueue import RateLimitingQueue, meta_namespace_key, split_key
from ..telemetry.events import (
    SCHED_ADMIT, SCHED_GROW_BACK, SCHED_MIGRATE, SCHED_PREEMPT,
    SCHED_QUEUE, SCHED_SKIP)
from .packing import COND_PACKED, PackPlan, plan_packing, slices_used

logger = logging.getLogger("tpujob-controller")

# suffixes / mount paths (ref mpi_job_controller.go:58-78 constants)
CONFIG_SUFFIX = "-config"
LAUNCHER_SUFFIX = "-launcher"
WORKER_SUFFIX = "-worker"
CONFIG_VOLUME_NAME = "tpu-job-config"
CONFIG_MOUNT_PATH = "/etc/tpu"          # ref configMountPath "/etc/mpi" (:62)
COORDINATOR_PORT = 8476                 # jax.distributed default port
LABEL_GROUP = "tpu_job_name"            # ref "mpi_job_name" label (:1007-1012)

# Disaggregated serving (spec.serving, serve/engine.py DisaggEngine): the
# worker gang splits into two role pools, each its own StatefulSet. The
# role + peer addresses ride pod env — covered by the template hash, so a
# pool-split change is an ordinary level-triggered gang restart.
PREFILL_SUFFIX = "-prefill"
DECODE_SUFFIX = "-decode"
SERVE_ROLES = ("prefill", "decode")     # pool index -> role name
LABEL_SERVE_ROLE = "tpu_serve_role"     # pool-distinguishing pod label
SERVE_ENV_ROLE = "TPU_SERVE_ROLE"
SERVE_ENV_PREFILL_HOSTS = "TPU_SERVE_PREFILL_HOSTS"
SERVE_ENV_DECODE_HOSTS = "TPU_SERVE_DECODE_HOSTS"
SERVE_ENV_KV_PORT = "TPU_SERVE_KV_PORT"
KV_TRANSFER_PORT = 8477                 # page-handoff listener (D2D proxy)

# Kubernetes node-selector keys for TPU slices (GKE conventions).
NS_ACCELERATOR = "cloud.google.com/gke-tpu-accelerator"
NS_TOPOLOGY = "cloud.google.com/gke-tpu-topology"

# TPU-health readiness gate wiring (bootstrap.ENV_READY_FILE /
# ENV_EXPECTED_CHIPS — string literals here so the operator image never
# imports the jax-adjacent bootstrap module)
READINESS_ENV_FILE_KEY = "TPU_READY_FILE"
READINESS_ENV_CHIPS_KEY = "TPU_EXPECTED_CHIPS"
READINESS_FILE_PATH = "/tmp/tpu-ready"
# opt-out for worker images that don't call mpi_operator_tpu.bootstrap
# (they'd never write the marker and would sit NotReady forever)
ANNOTATION_HEALTH_GATE = "tpu.kubeflow.org/health-gate"
# hash of the worker template whose pods have actually been (re)started —
# recorded ON the StatefulSet so the resize gang-restart is level-triggered
# and survives operator restarts (see get_or_create_worker_statefulsets)
ANNOTATION_TEMPLATE_HASH = "tpu.kubeflow.org/template-hash"
# worker default SIGTERM→SIGKILL budget when the template doesn't set one:
# covers one training step plus the synchronous emergency checkpoint the
# preemption drain writes (train/resilience.py) — k8s' 30s is too short
# once model state reaches tens of GB
DEFAULT_TERMINATION_GRACE_SECONDS = 60


def _template_hash(template) -> str:
    import hashlib
    import json as _json

    from ..cluster.serialize import template_to_manifest

    return hashlib.sha1(_json.dumps(
        template_to_manifest(template), sort_keys=True).encode()
    ).hexdigest()[:12]

ERR_RESOURCE_EXISTS = "ErrResourceExists"   # ref :88-96
MSG_RESOURCE_EXISTS = "Resource %s already exists and is not managed by TPUJob"

#: bounded RetryOnConflict attempts per status write (client-go's
#: retry.DefaultRetry runs 5 steps); past this the sync raises and the
#: key takes the ordinary rate-limited requeue instead of spinning
MAX_CONFLICT_RETRIES = 4


def _classify_requeue_reason(exc: BaseException) -> str:
    """Label for tpu_operator_requeues_total{reason=...}: why a key went
    back through the rate limiter."""
    if isinstance(exc, ConflictError):
        return "conflict"
    if is_transient(exc):
        return "transient"
    if isinstance(exc, ApiError):
        return "api_error"
    return "error"


def _probe_subset(desired: Optional[dict], existing: Optional[dict]) -> bool:
    """True when every key the controller set in the desired probe matches
    the live one (the server adds defaults like successThreshold)."""
    if desired is None:
        return True
    if existing is None:
        return False
    return all(existing.get(k) == v for k, v in desired.items())


def _worker_template_drifted(existing, desired) -> bool:
    """Compare ONLY the template fields the controller owns. A real API
    server decorates live objects with defaults (probe timeoutSeconds,
    volume defaultMode, ...), so whole-object equality would report drift
    on every sync of every job and churn updates forever. Fields the
    server never defaults (env, labels, nodeSelector) compare EXACTLY —
    subset checks would miss user-removed keys."""
    try:
        ec, dc = existing.main_container(), desired.main_container()
    except ValueError:
        return True
    if (ec.image, ec.command, ec.args) != (dc.image, dc.command, dc.args):
        return True
    if ec.env != dc.env or ec.limits != dc.limits:
        return True
    if not _probe_subset(dc.readiness_probe, ec.readiness_probe):
        return True
    if [(c.image, c.env) for c in existing.init_containers] != \
            [(c.image, c.env) for c in desired.init_containers]:
        return True
    if existing.node_selector != desired.node_selector:
        return True
    if existing.metadata.labels != desired.metadata.labels:
        return True
    return existing.restart_policy != desired.restart_policy


class ForeignOwnershipError(Exception):
    """Raised when a dependent resource exists but is not controlled by the
    TPUJob (ref :641-645 — adoption is refused, never forced)."""
    def __init__(self, kind: str, name: str):
        self.kind = kind
        self.name = name
        super().__init__(MSG_RESOURCE_EXISTS % f"{kind}/{name}")


@dataclass
class Event:
    """Recorded controller event (ref record.EventRecorder, :169-172)."""
    type: str       # Normal | Warning
    reason: str
    message: str


class EventRecorder:
    """Event recorder with a real core-v1 sink.

    The reference wires its broadcaster into the Events API
    (StartRecordingToSink, mpi_job_controller.go:165-172) so `kubectl
    describe mpijob` shows Synced/ErrResourceExists at exactly the moment
    a user debugs a stuck job. Given an api_server this does the same:
    every event is POSTed as a core/v1 Event; a repeat of an identical
    (object, type, reason, message) bumps `count` on the existing Event
    instead of creating a new one (client-go's correlator aggregation).

    Without an api_server it degrades to the in-memory deque — the
    FakeRecorder equivalent tests use (ref mpi_job_controller_test.go:177).
    Posting is best-effort: a sink failure must never fail a reconcile.
    Bounded deque: a run-forever operator appends per reconcile, so an
    unbounded list would leak."""
    MAX_EVENTS = 1000
    COMPONENT = "tpu-operator"

    def __init__(self, api_server=None):
        import itertools
        from collections import deque
        self.events = deque(maxlen=self.MAX_EVENTS)
        self.api = api_server
        # correlator: (ns, involved uid, type, reason, message) -> Event name
        self._correlated: Dict[tuple, str] = {}
        # name uniqueness within this process — time.time() microseconds
        # alone can collide for two events in the same sync
        self._seq = itertools.count()
        # the recorder is shared across threadiness>1 sync workers; the
        # correlator get-then-update and the count bump are read-modify-
        # write, so unguarded concurrent syncs could duplicate Events or
        # lose increments
        self._lock = threading.Lock()

    def event(self, obj, etype: str, reason: str, message: str) -> None:
        self.events.append(Event(etype, reason, message))
        if self.api is None or obj is None:
            return
        try:
            self._post(obj, etype, reason, message)
        except Exception as exc:  # noqa: BLE001 — observability only
            logger.warning("event sink post failed: %s", exc)

    def _post(self, obj, etype: str, reason: str, message: str) -> None:
        with self._lock:
            self._post_locked(obj, etype, reason, message)

    def _post_locked(self, obj, etype: str, reason: str, message: str) -> None:
        from ..cluster.resources import Event as CoreEvent, ObjectReference

        ns = obj.metadata.namespace
        now = time.time()
        key = (ns, obj.metadata.uid or obj.metadata.name, etype, reason,
               message)
        name = self._correlated.get(key)
        if name is not None:
            existing = None
            try:
                existing = self.api.get("Event", ns, name)
            except NotFoundError:
                pass                  # pruned server-side; recreate below
            if existing is not None:
                existing.count += 1
                existing.last_timestamp = now
                self.api.update(existing)
                return
        # client-go names events "<involved>.<unique hex>"; the counter
        # suffix keeps same-microsecond events from colliding
        name = (f"{obj.metadata.name}.{int(now * 1e6):x}"
                f".{next(self._seq):x}")
        self.api.create(CoreEvent(
            metadata=ObjectMeta(name=name, namespace=ns),
            involved_object=ObjectReference(
                kind=obj.kind, namespace=ns, name=obj.metadata.name,
                uid=obj.metadata.uid,
                api_version=f"{api.GROUP_NAME}/{api.API_VERSION}"
                if obj.kind == api.KIND else "v1",
            ),
            reason=reason, message=message, type=etype, count=1,
            first_timestamp=now, last_timestamp=now,
            source_component=self.COMPONENT,
        ))
        self._correlated[key] = name
        # bound the correlator like the deque — drop oldest entries
        while len(self._correlated) > self.MAX_EVENTS:
            self._correlated.pop(next(iter(self._correlated)))


@dataclass
class ControllerConfig:
    """Cluster-level flags (ref cmd/mpi-operator/main.go:98-115). Spec fields
    override these per-job (ref mpi_job_controller.go:447-460)."""
    tpus_per_worker: int = 4            # the tpus sizing mode; v5e host = 4 chips
    # the operator's defaults are the reference's GPU ones: an H100 node
    # of 8 cards (ref --gpus-per-node 8, deploy/3-mpi-operator.yaml)
    processing_units_per_worker: int = 8
    processing_resource_type: str = RESOURCE_GPU
    enable_gang_scheduling: bool = False
    namespace: Optional[str] = None
    # ref --kubectl-delivery-image; on TPU an optional discovery init image
    discovery_image: Optional[str] = None
    # how long the discovery init step waits for worker DNS before failing
    discovery_timeout_seconds: int = 300
    # elastic membership (spec.elastic): how long workers may sit not-Ready
    # before the job shrinks to the next valid topology, and how long a
    # shrunken job runs before the full spec size is retried
    elastic_degraded_seconds: int = 300
    elastic_recovery_seconds: int = 1800
    # job-level observability (telemetry/collector.py): when
    # worker_metrics_port is set the controller injects TPU_METRICS_PORT
    # into workers, scrapes each pod's /metrics + /events every
    # scrape_interval seconds, and re-exports federated tpu_job_* series
    # on its own MetricsServer. events_dir roots the controller's own
    # event log and the per-job timeline.jsonl files.
    worker_metrics_port: Optional[int] = None
    events_dir: Optional[str] = None
    scrape_interval: float = 10.0
    # serving progress lease TPOT-slope floor (observed tokens+requests
    # per second between frontier advances): a serving gang whose
    # frontier creeps below this rate arms the lease like a frozen one.
    # None keeps the lease purely wall-clock.
    serving_rate_floor: Optional[float] = None
    # fleet scheduler (controller/scheduler.py): treat every TPUJob as a
    # claim against ONE slice pool of this many chips — jobs that don't
    # fit are queued by spec.priority, and a higher-priority pending job
    # may shrink a lower-priority elastic gang (status.sched_tpus) to
    # get admitted. None disables admission/rebalancing entirely. The
    # cooldown knobs are the anti-thrash brake, fed by the resize
    # ledger like the decode autoscaler's.
    sched_pool_chips: Optional[int] = None
    sched_cooldown_floor_seconds: float = 60.0
    sched_cooldown_multiplier: float = 4.0
    # degraded-rank pod migration (independent of the pool): a
    # persistent DegradedGang partition deletes the dark worker pod so
    # the StatefulSet reschedules it — at most once per degraded
    # window, counted as status.migration_count (never a gang restart)
    sched_migration: bool = True


@dataclass
class AllocationResult:
    """Output of allocate_processing_units (ref :547-598).
    worker_replicas is the TOTAL across slices; multi-slice jobs split it
    into num_slices worker groups of workers_per_slice each."""
    worker_replicas: int
    units_per_worker: int
    resource_type: str
    slots_per_worker: int
    num_slices: int = 1
    # disaggregated serving (spec.serving): per-pool worker counts,
    # aligned with worker_group_names order (prefill, decode). None keeps
    # the uniform slice-group partitioning.
    serving_pools: Optional[Tuple[int, ...]] = None

    @property
    def workers_per_slice(self) -> int:
        if self.num_slices <= 1:
            return self.worker_replicas
        return self.worker_replicas // self.num_slices

    def group_sizes(self) -> List[int]:
        """Replica count per worker group, aligned with
        worker_group_names. Uniform per slice normally; the serving pool
        split otherwise. Zeros on scale-down (worker_replicas == 0)."""
        if self.serving_pools is not None:
            return [n if self.worker_replicas > 0 else 0
                    for n in self.serving_pools]
        per = self.workers_per_slice if self.worker_replicas > 0 else 0
        return [per] * self.num_slices


class TPUJobController:
    """ref: MPIJobController struct + NewMPIJobController (:102-324)."""

    def __init__(
        self,
        api_server: InMemoryAPIServer,
        factory: Optional[InformerFactory] = None,
        config: Optional[ControllerConfig] = None,
        recorder: Optional[EventRecorder] = None,
        observatory=None,
    ):
        self.api = api_server
        self.config = config or ControllerConfig()
        # job-level observability: controller event log + metrics
        # federation + timeline merge (telemetry/collector.py). Built
        # when the config asks for it; tests inject their own with a
        # fake clock/fetcher. None disables every hook.
        if observatory is None and (self.config.events_dir
                                    or self.config.worker_metrics_port):
            from ..telemetry.collector import JobObservatory
            observatory = JobObservatory(
                events_dir=self.config.events_dir,
                scrape_interval=self.config.scrape_interval,
                serving_rate_floor=self.config.serving_rate_floor)
        self.observatory = observatory
        # default recorder posts real core-v1 Events through the same API
        # server the reconciler writes to (ref StartRecordingToSink,
        # mpi_job_controller.go:165-172)
        self.recorder = recorder or EventRecorder(api_server)
        self.factory = factory or InformerFactory(api_server, self.config.namespace)
        self.queue = RateLimitingQueue()
        from .metrics import SyncCounters
        self.sync_counters = SyncCounters()
        # per-job {pod_uid: (max restart count seen, last phase)} — the
        # delta baseline for cumulative worker-crash accounting; entries
        # are dropped once a job reaches a terminal state
        self._worker_restart_marks: Dict[tuple, dict] = {}
        # elastic membership: when each job's workers were first observed
        # not-Ready, and when a DEGRADED job's gang was first observed
        # continuously Ready (the recovery countdown base — measuring
        # from the shrink decision would restore a slow-to-schedule gang
        # the instant it first turns Ready). In-memory — an operator
        # restart conservatively restarts the countdowns. Injectable
        # clock for tests.
        self._not_ready_since: Dict[tuple, float] = {}
        self._elastic_ready_since: Dict[tuple, float] = {}
        # SLO-driven decode autoscaling (spec.serving.slo): one pure
        # hysteresis state machine per job. In-memory like the elastic
        # timers — an operator restart conservatively restarts the
        # persistence windows (the status-side cooldown timestamp
        # survives, so restarts never un-brake the thrash guard).
        self._autoscalers: Dict[tuple, "DecodeAutoscaler"] = {}
        self.now = time.time

        # Admission: reject invalid TPUJob specs at create/update, the CRD
        # openAPIV3-schema analogue (ref deploy/0-crd.yaml:16-99) — invalid
        # shapes must fail at admission, not at runtime (SURVEY §7).
        from ..api.validation import validate_spec
        api_server.register_admission_validator(
            api.KIND, lambda obj: validate_spec(
                obj.spec,
                default_resource_type=self.config.processing_resource_type)
        )

        # 8 informers, matching the reference's registration (:204-321)
        self.job_informer = self.factory.informer(api.KIND)
        self.configmap_informer = self.factory.informer("ConfigMap")
        self.sa_informer = self.factory.informer("ServiceAccount")
        self.role_informer = self.factory.informer("Role")
        self.rolebinding_informer = self.factory.informer("RoleBinding")
        self.statefulset_informer = self.factory.informer("StatefulSet")
        self.batchjob_informer = self.factory.informer("Job")
        self.pdb_informer = self.factory.informer("PodDisruptionBudget")
        self.service_informer = self.factory.informer("Service")

        self.job_lister = self.job_informer.lister()
        self.configmap_lister = self.configmap_informer.lister()
        self.sa_lister = self.sa_informer.lister()
        self.role_lister = self.role_informer.lister()
        self.rolebinding_lister = self.rolebinding_informer.lister()
        self.statefulset_lister = self.statefulset_informer.lister()
        self.batchjob_lister = self.batchjob_informer.lister()
        self.pdb_lister = self.pdb_informer.lister()
        self.service_lister = self.service_informer.lister()

        # TPUJob events: enqueue the job itself (ref :204-209); a packed
        # job's events additionally fan out to its pack peers — the
        # leader's gang must absorb membership changes, including member
        # DELETION (which the per-job key alone would never resync)
        self.job_informer.add_event_handler(
            on_add=self._enqueue_job_event,
            on_update=lambda old, new: self._enqueue_job_event(new),
            on_delete=self._enqueue_job_event,
        )
        # dependent kinds: map back to owning TPUJob (ref :210-321)
        for informer in (
            self.configmap_informer, self.sa_informer, self.role_informer,
            self.rolebinding_informer, self.statefulset_informer,
            self.batchjob_informer, self.pdb_informer,
            self.service_informer,
        ):
            informer.add_event_handler(
                on_add=self.handle_object,
                on_update=lambda old, new: self.handle_object(new),
                on_delete=self.handle_object,
            )

        self._threads: List[threading.Thread] = []

    # ------------------------------------------------------------------
    # queue plumbing
    # ------------------------------------------------------------------

    def enqueue_tpu_job(self, obj) -> None:
        """ref: enqueueMPIJob (:796-804)."""
        self.queue.add(meta_namespace_key(obj))

    def _enqueue_job_event(self, obj) -> None:
        """TPUJob informer event: enqueue the job, plus its pack peers
        when it opts into packing (controller/packing.py) — the peers'
        plans all depend on this job's existence and shape."""
        self.enqueue_tpu_job(obj)
        group = getattr(obj.spec, "pack_group", None)
        if not group:
            return
        for peer in self.job_lister.list():
            if (peer.spec.pack_group == group
                    and peer.metadata.namespace == obj.metadata.namespace
                    and peer.metadata.name != obj.metadata.name):
                self.enqueue_tpu_job(peer)

    def handle_object(self, obj) -> None:
        """ref: handleObject (:811-844) — owner lookup → enqueue TPUJob."""
        ref = obj.metadata.controller_ref()
        if ref is None or ref.kind != api.KIND:
            return
        owner = self.job_lister.try_get(obj.metadata.namespace, ref.name)
        if owner is None:
            logger.debug(
                "ignoring orphaned %s/%s of tpujob %s",
                obj.kind, obj.metadata.name, ref.name,
            )
            return
        self.enqueue_tpu_job(owner)

    # ------------------------------------------------------------------
    # run loop (ref Run/runWorker/processNextWorkItem :330-415)
    # ------------------------------------------------------------------

    def run(self, threadiness: int = 2, stop_event: Optional[threading.Event] = None):
        self.factory.start_all()
        if not self.factory.wait_for_cache_sync():
            raise RuntimeError("failed to wait for caches to sync")
        for obj in self.job_lister.list():
            self.enqueue_tpu_job(obj)
        stop_event = stop_event or threading.Event()
        for i in range(threadiness):
            t = threading.Thread(
                target=self._run_worker, args=(stop_event,),
                name=f"tpujob-worker-{i}", daemon=True,
            )
            t.start()
            self._threads.append(t)
        return stop_event

    def _run_worker(self, stop_event: threading.Event) -> None:
        while not stop_event.is_set():
            if not self.process_next_work_item(timeout=0.1):
                if self.queue._shutting_down:  # noqa: SLF001
                    return

    def process_next_work_item(self, timeout: Optional[float] = None) -> bool:
        key = self.queue.get(timeout=timeout)
        if key is None:
            return False
        t0 = time.monotonic()
        try:
            self.sync_handler(key)
            self.queue.forget(key)          # ref :399-404
            self.sync_counters.record(ok=True)
        except Exception as exc:            # noqa: BLE001
            # client-go discipline: NEVER give up the key. Transient API
            # failures, conflicts that exhausted their in-place retries,
            # and plain bugs all take the same rate-limited requeue; the
            # per-reason counter keeps the causes distinguishable.
            reason = _classify_requeue_reason(exc)
            logger.exception("error syncing %s; requeuing (%s)", key, reason)
            self.queue.add_rate_limited(key)
            self.sync_counters.record_retry()
            self.sync_counters.record_requeue(reason)
            self.sync_counters.record(ok=False)
        finally:
            # failure durations observed too: the slow FAILING sync is the
            # one an operator most needs the histogram to show
            self.sync_counters.observe_sync(time.monotonic() - t0)
            self.queue.done(key)
        return True

    def slices_in_use(self) -> int:
        """Pack-aware slice quota usage over the informer cache: physical
        slices claimed by live jobs, counting each packed gang ONCE (its
        leader) instead of once per member. This is the number a cluster
        quota check must compare against capacity — the naive per-job sum
        overcharges by k-1 slices per packed gang. Exported as the
        tpu_operator_slices_in_use gauge (controller/metrics.py)."""
        return slices_used(self.job_lister.list())

    def workers_alive(self) -> bool:
        """Liveness signal for /healthz: healthy while starting (run() not
        yet called — the metrics server binds BEFORE run() so a slow
        cache sync can't crash-loop the pod) and while every started
        worker thread is alive; unhealthy once any worker has died."""
        if not self._threads:
            return True
        return all(t.is_alive() for t in self._threads)

    # ------------------------------------------------------------------
    # THE core: sync_handler (ref syncHandler :420-520; SURVEY §3.2)
    # ------------------------------------------------------------------

    def sync_handler(self, key: str) -> None:
        try:
            namespace, name = split_key(key)
        except ValueError:
            logger.error("invalid resource key: %s", key)
            return  # invalid key is a no-op, not a retry (ref :422-426)

        job = self.job_lister.try_get(namespace, name)
        if job is None:
            # work item no longer exists → drop (ref :431-436); release its
            # crash-baseline state too (jobs deleted mid-run would leak it)
            self._worker_restart_marks.pop((namespace, name), None)
            self._not_ready_since.pop((namespace, name), None)
            self._elastic_ready_since.pop((namespace, name), None)
            self._autoscalers.pop((namespace, name), None)
            logger.debug("tpujob '%s' no longer exists", key)
            return

        launcher = self.get_launcher_job(job)                  # ref :440, :522-544

        # terminal state persists in conditions — the launcher Job object
        # may be gone afterwards (CleanPodPolicy "All").
        # Failed/InvalidTPUJobSpec is deliberately NOT terminal: it's a
        # level-triggered "desired state is unsatisfiable" signal that
        # clears itself the moment the user fixes the spec (the reference
        # recovered here too, by retrying forever).
        failed_cond = job.status.get_condition(api.COND_FAILED)
        invalid_spec = (
            failed_cond is not None and failed_cond.status == "True"
            and failed_cond.reason == "InvalidTPUJobSpec"
        )
        terminal = (
            job.status.get_condition(api.COND_SUCCEEDED) is not None
            or (failed_cond is not None and failed_cond.status == "True"
                and not invalid_spec)
        )

        if (terminal and launcher is not None
                and not (launcher.succeeded() or launcher.failed())
                and failed_cond is not None
                and failed_cond.reason == "StuckGang"):
            # a StuckGang terminal verdict landed but the crash lost the
            # launcher delete: finish the teardown, level-triggered — a
            # wedged launcher holds the gang rendezvous open forever
            self._delete_ignore_missing("Job", launcher.metadata.namespace,
                                        launcher.metadata.name)
            launcher = None

        # job packing (controller/packing.py): resolve this job's pack
        # from the informer view. A non-leader member short-circuits —
        # it creates NO pods; the leader's gang is its data plane.
        pack: Optional[PackPlan] = None
        if job.spec.pack_group and not terminal:
            pack = plan_packing(job, self.job_lister.list())
            if pack is not None and not pack.is_leader(job.metadata.name):
                self._sync_packed_member(job, pack, launcher)
                return
            if pack is not None and pack.k > 1:
                job = self._note_pack_leader(job, pack)

        # fleet scheduler (controller/scheduler.py): with a bounded slice
        # pool (sched_pool_chips) every job passes admission BEFORE any
        # resource is created; a held job parks on a Queued condition
        # owning nothing. Terminal jobs still run the planning pass —
        # the chips they free are what wakes queued beneficiaries and
        # preempted victims (delegated by enqueue, never executed in a
        # foreign sync).
        if self.config.sched_pool_chips is not None:
            job, held = self._sched_reconcile(job, key, terminal)
            if held:
                self.update_tpu_job_status(job, launcher, [])
                return

        # gang restart (v1alpha2 RestartPolicy, common_types.go:131-156):
        # a failed launcher is recreated when the policy allows it and the
        # backoff budget isn't exhausted; workers stay up (kubelet restarts
        # their processes), so the whole gang relaunches from the latest
        # checkpoint.
        if (launcher is not None and launcher.failed() and not terminal
                and self._should_restart(job, launcher)):
            # Crash-consistent ordering: count the restart in status FIRST
            # (stamped with the failed launcher's uid so a crash-replayed
            # sync never double-counts), THEN delete the launcher. The old
            # delete-first order lost the count entirely when the process
            # died between the two writes — the restarted controller found
            # no failed launcher left to account for.
            job = self._count_gang_restart(
                job, launcher, "TPUJobRestarting",
                f"launcher failed (exit_code={launcher.status.exit_code})")
            self._delete_ignore_missing("Job", launcher.metadata.namespace,
                                        launcher.metadata.name)
            launcher = None

        done = terminal or (launcher is not None and (
            launcher.succeeded() or launcher.failed()          # ref :445
        ))

        # CleanPodPolicy "None" keeps the worker set after completion
        # (v1alpha2 types.go:55-66); "Running"/"All" scale it to 0 (the
        # v1alpha1 behavior, ref :594-596)
        scale_down = done and job.spec.clean_pod_policy != "None"
        try:
            alloc = self.allocate_processing_units(job, scale_down)  # ref :462, :547-598
        except ValueError as exc:
            # an invalid spec that slipped past admission (a real cluster
            # only enforces the CRD-schema subset of api/validation.py)
            # must converge to a Failed/InvalidTPUJobSpec condition in one
            # sync — not requeue forever with no user-visible signal.
            # Returning (instead of raising) makes process_next_work_item
            # forget the key; the Warning Event + condition tell the user
            # why nothing is running.
            if terminal:
                # ... but NEVER for a job that already finished: editing a
                # terminally-Failed/Succeeded job's spec invalid must not
                # overwrite its terminal condition with the level-triggered
                # InvalidTPUJobSpec reason (a later spec fix would clear
                # that and resurrect the job despite restartPolicy Never).
                # The terminal record wins; the bad spec is inert.
                logger.info("tpujob '%s' is terminal; ignoring invalid "
                            "spec edit: %s", key, exc)
                return
            self._fail_invalid_spec(job, str(exc), launcher)
            return
        if invalid_spec and not done:
            # the spec is allocatable again (user fixed it): clear the
            # InvalidTPUJobSpec signal and reconcile normally
            job.status.set_condition(api.JobCondition(
                api.COND_FAILED, "False", "SpecValidated",
                "spec is valid again; resuming reconciliation"))
            job = self._update_status_apply(job)
            self.recorder.event(job, "Normal", "SpecValidated",
                                "spec is valid again")

        if not done:
            self.get_or_create_config_map(job, alloc)          # ref :470
            # headless Service — gives workers the stable DNS names the
            # discovery data points at (no reference equivalent: the
            # reference assumed a pre-provisioned governing service)
            self.get_or_create_worker_service(job)
            self.get_or_create_launcher_service_account(job)   # ref :475
            self.get_or_create_launcher_role(job, alloc)       # ref :480
            self.get_or_create_launcher_role_binding(job)      # ref :485
            if self.config.enable_gang_scheduling or job.spec.gang_scheduling:
                self.get_or_create_pdb(job, alloc.worker_replicas)  # ref :490-494

        workers, resized = self.get_or_create_worker_statefulsets(
            job, alloc, pack=pack)                                 # ref :497

        if resized and launcher is not None and not done:
            # the running launcher carries the OLD topology env (batch Job
            # pod templates are immutable); replace it OUTSIDE the failure
            # path so the resize burns no restart budget and can't
            # terminally fail a restart_policy=Never job — the readiness
            # gate below recreates it with the new env once the restarted
            # gang is Ready
            self._delete_ignore_missing("Job", launcher.metadata.namespace,
                                        launcher.metadata.name)
            launcher = None

        # THE GATE: launcher starts only once ALL workers of ALL slices
        # report Ready (ref :503-509). On TPU this is also the
        # ICI/DCN-formation gate: the jax.distributed coordinator must not
        # start before every worker process of every slice can come up
        # (SURVEY §7 hard parts — a multi-slice job with one slice pending
        # would hang its first cross-slice collective).
        total_ready = sum(w.status.ready_replicas for w in workers
                          if w is not None)
        workers_ready = (
            all(w is not None for w in workers)
            and total_ready == alloc.worker_replicas
        ) or alloc.worker_replicas == 0
        # elastic membership: persistent worker unavailability shrinks the
        # job to the next valid topology (status.elastic_tpus); a shrunken
        # job that has run a recovery window retries the full spec size.
        # Decisions land in STATUS this sync; the NEXT sync (triggered by
        # the status watch event) materializes the new world through the
        # ordinary resize/gang-restart machinery.
        if (not done and job.spec.elastic and job.spec.tpus is not None
                and alloc.worker_replicas > 0 and not resized):
            job = self._elastic_reconcile(job, alloc, workers_ready, key)

        # `not resized`: in the resize sync itself the StatefulSet status
        # still shows the PRE-deletion ready counts (same-size template
        # edits included) — creating a launcher now would rendezvous
        # against a gang that was just deleted. The next sync sees the
        # true readiness and recreates it with the new env.
        if (self.observatory is not None and not done and workers_ready
                and not resized and alloc.worker_replicas > 0):
            self.observatory.note_pods_ready(
                job.metadata.name, replicas=alloc.worker_replicas)
            self._observe_job(job, alloc)
            # partial-partition verdict off the scrape just taken: some
            # ranks dark + frontier advancing = DegradedGang (observed,
            # never restarted); genuine stalls stay with the progress
            # lease below
            job = self._check_degraded_gang(job)
            # degraded-rank remainder (fleet scheduler): a partition
            # that persists past the cost floor MIGRATES the dark pod
            # (StatefulSet reschedules it) instead of watching forever —
            # once per degraded window, never a gang restart
            job = self._sched_migrate_reconcile(job, alloc, key)
            # SLO-driven decode autoscaling consumes the same scrape:
            # decisions land in STATUS (serving_decode_replicas); the
            # next sync materializes the new pool split through the
            # ordinary template-hash resize
            if (job.spec.serving is not None
                    and job.spec.serving.slo is not None):
                job = self._autoscale_reconcile(job, key)

        # progress lease (spec.progressDeadlineSeconds): consumes the
        # scrape the observatory just took; a restart here deletes the
        # gang, so launcher re-creation waits for the next sync's
        # readiness gate
        stuck_restarted = False
        if not done and not resized and launcher is not None:
            job, launcher, stuck_restarted = self._check_stuck_gang(
                job, launcher, key)
            done = done or job.status.is_done()

        if (not done and workers_ready and launcher is None
                and not resized and not stuck_restarted):
            launcher, _ = self._create_or_get(
                self.new_launcher(job, alloc, pack=pack), job)

        self.update_tpu_job_status(job, launcher, workers)     # ref :513, :761-791

        # CleanPodPolicy "All": drop the finished launcher Job too — the
        # terminal state was just recorded in conditions, so `done` survives
        # the launcher's disappearance on later reconciles
        if (done and job.spec.clean_pod_policy == "All"
                and launcher is not None
                and (launcher.succeeded() or launcher.failed())):
            self._delete_ignore_missing("Job", launcher.metadata.namespace,
                                        launcher.metadata.name)

        self.recorder.event(job, "Normal", "Synced", "TPUJob synced successfully")

    def _sync_packed_member(self, job: TPUJob, pack: PackPlan,
                            launcher: Optional[Job]) -> None:
        """A packed non-leader's whole reconcile: own NOTHING, say where
        the work actually runs. Any resources from a pre-packing life
        (the job ran standalone before an older peer appeared) are torn
        down; the Packed condition names the leader and the job's replica
        index inside the fused gang; the leader is re-queued so its
        worker template absorbs the membership."""
        member = job.metadata.name
        msg = (f"packed into the gang of leader {pack.leader!r} as "
               f"replica {pack.index(member)} of {pack.k} "
               f"(group {pack.group!r})")
        if launcher is not None:
            self._delete_ignore_missing("Job", launcher.metadata.namespace,
                                        launcher.metadata.name)
        for sts in self.statefulset_lister.list(job.metadata.namespace):
            if (is_controlled_by(sts.metadata, job.metadata)
                    and sts.metadata.labels.get(LABEL_GROUP) == member):
                self._delete_ignore_missing(
                    "StatefulSet", sts.metadata.namespace, sts.metadata.name)
        cond = job.status.get_condition(COND_PACKED)
        if not (cond is not None and cond.status == "True"
                and cond.message == msg):
            job.status.set_condition(api.JobCondition(
                COND_PACKED, "True", "PackedWithLeader", msg))
            job = self._update_status_apply(job)
            self.recorder.event(job, "Normal", "Packed", msg)
        leader = self.job_lister.try_get(job.metadata.namespace, pack.leader)
        if leader is not None:
            self.enqueue_tpu_job(leader)

    def _note_pack_leader(self, job: TPUJob, pack: PackPlan) -> TPUJob:
        """Record pack leadership in status (idempotent per membership);
        returns the fresh object so later status PUTs in the same sync
        carry the right resourceVersion."""
        msg = (f"leading a packed gang of {pack.k} jobs: "
               f"{','.join(pack.members)}")
        cond = job.status.get_condition(COND_PACKED)
        if (cond is not None and cond.status == "True"
                and cond.message == msg):
            return job
        job.status.set_condition(api.JobCondition(
            COND_PACKED, "True", "PackLeader", msg))
        job = self._update_status_apply(job)
        self.recorder.event(job, "Normal", "PackLeader", msg)
        if self.observatory is not None:
            self.observatory.note_packed(job.metadata.name,
                                         group=pack.group,
                                         members=list(pack.members),
                                         k=pack.k, labels=pack.labels())
        return job

    def _observe_job(self, job: TPUJob, alloc: AllocationResult) -> None:
        """One federation pass: scrape every worker pod's /metrics and
        /events through the observatory (rate-limited there). Targets
        come from the same slice-major hostname order as the discovery
        data, so replica_rank labels match TPU_PROCESS_ID. Serving jobs
        flip the progress frontier to the retired-request/token counters
        (a serving gang has no training step to watch)."""
        if self.observatory is None or not self.config.worker_metrics_port:
            return
        targets = {
            rank: f"http://{host}:{self.config.worker_metrics_port}"
            for rank, host in enumerate(self.worker_hostnames(job, alloc))}
        self.observatory.observe(job.metadata.name, targets,
                                 serving=job.spec.serving is not None)

    def _check_degraded_gang(self, job: TPUJob) -> TPUJob:
        """Partial-partition verdict off the latest scrape pass: SOME
        worker ranks unreachable while the rest still report. Observed,
        never acted on — a DegradedGang condition + gang_degraded
        timeline record, NO restart: scrape flakiness alone must never
        kill a healthy gang. Genuine stalls (including every rank dark,
        which freezes the frontier) stay with the StuckGang progress
        lease — an unobservable gang cannot prove liveness, a partially
        observable one can."""
        if self.observatory is None:
            return job
        name = job.metadata.name
        dark, total = self.observatory.partition_state(name)
        cond = job.status.get_condition(api.COND_DEGRADED_GANG)
        if dark and len(dark) < total:
            msg = (f"ranks {','.join(str(r) for r in dark)} unreachable "
                   f"({len(dark)}/{total}); progress still observed via "
                   f"the reachable remainder")
            self.observatory.note_degraded(name, dark, total)
            if not (cond is not None and cond.status == "True"
                    and cond.message == msg):
                job.status.set_condition(api.JobCondition(
                    api.COND_DEGRADED_GANG, "True", "PartialPartition",
                    msg))
                job = self._update_status_apply(job)
                self.recorder.event(job, "Warning", "DegradedGang", msg)
        elif not dark:
            self.observatory.note_degraded_healed(name)
            if cond is not None and cond.status == "True":
                healed = "every worker rank scraping again"
                job.status.set_condition(api.JobCondition(
                    api.COND_DEGRADED_GANG, "False", "PartitionHealed",
                    healed))
                job = self._update_status_apply(job)
                self.recorder.event(job, "Normal", "PartitionHealed",
                                    healed)
        # every rank dark is NOT "degraded": that is the all-stale freeze
        # the progress lease owns — leave the condition untouched
        return job

    def _autoscale_reconcile(self, job: TPUJob, key: str) -> TPUJob:
        """One tick of SLO-driven decode autoscaling (spec.serving.slo).

        Policy lives in controller/autoscale.py (pure hysteresis);
        this glue feeds it the federated p99/queue observations from
        the scrape the observatory just took, the live-scale-cost
        cooldown from the ledger, and lands accepted targets in
        status.serving_decode_replicas — the elastic_tpus discipline:
        the user's spec is NEVER edited, and the next sync materializes
        the delta as a LIVE decode-pool step (replica-count-only
        StatefulSet update behind the scalingReplica marker — see
        get_or_create_worker_statefulsets — never a gang restart, so
        the cooldown prices the cheap action and reaction time stays
        short). Pending persistence/cooldown windows schedule their own
        queue wake-ups so a quiet cluster still re-evaluates."""
        from ..telemetry.collector import resize_ledger
        from ..telemetry.events import AUTOSCALE_BREACH as EV_AUTOSCALE_BREACH
        from ..telemetry.events import LIVE_SCALE as LIVE_SCALE_KIND
        from .autoscale import DecodeAutoscaler, SLOObservation

        if self.observatory is None:
            return job
        if job.status.get_condition(COND_RUNNING) is None:
            # never yet Ready: an empty fleet's silent histograms are
            # not SLO evidence in either direction (the elastic arming
            # gate, applied to serving)
            return job
        slo = job.spec.serving.slo
        name = job.metadata.name
        jkey = (job.metadata.namespace, name)
        scaler = self._autoscalers.setdefault(jkey, DecodeAutoscaler(slo))
        scaler.slo = slo          # a spec edit retargets the machine
        fed = self.observatory.view(name)["federation"]
        obs = SLOObservation(
            ttft_p99=fed.histogram_quantile(
                "tpu_worker_ttft_seconds", 0.99),
            tpot_p99=fed.histogram_quantile(
                "tpu_worker_tpot_seconds", 0.99),
            queue_depth=fed.gauge_value("tpu_worker_queue_depth"),
            # the slowest completed request trace in the federation's
            # exemplar window rides along: a breach decision carries it
            # so the scale-up event / postmortem can show the actual
            # span tree behind the p99 number
            exemplar_trace=self.observatory.slowest_trace(name))
        resizes = resize_ledger(self.observatory.merged_records(name))
        # newest MEASURED cost of the action kind this scaler is about
        # to take: decode deltas materialize as live_scale steps now, so
        # only live_scale entries price the cooldown — the newest-of-any
        # -kind read this replaces let one expensive gang resize (user
        # spec edit, fleet scheduler) pin live-scale cooldowns to
        # minutes for the rest of the run. No live entry yet → None →
        # the autoscaler's cooldown floor (the conservative default).
        last_cost = next((r["total_seconds"] for r in reversed(resizes)
                          if "total_seconds" in r
                          and r.get("kind") == LIVE_SCALE_KIND), None)
        current = (job.status.serving_decode_replicas
                   if job.status.serving_decode_replicas is not None
                   else job.spec.serving.decode_replicas)
        decision = scaler.decide(
            now=self.now(), obs=obs, current=current,
            last_scaled_at=job.status.serving_scaled_at,
            last_resize_seconds=last_cost)
        if decision.wake_after is not None and decision.wake_after > 0:
            self.queue.add_after(key, decision.wake_after)
        if decision.target is None or decision.target == current:
            return job
        up = decision.target > current
        job.status.serving_decode_replicas = decision.target
        job.status.serving_scaled_at = self.now()
        job = self._update_status_apply(job)
        if up:
            # the breach record lands in the job timeline with its
            # exemplar trace id, so the postmortem's "slow traces:"
            # section can render the actual span tree behind the p99
            # that forced this scale-up
            fields = {"target": decision.target, "reason": decision.reason}
            if decision.exemplar_trace is not None:
                fields["exemplar_trace"] = decision.exemplar_trace
            self.observatory.record(
                name, EV_AUTOSCALE_BREACH, **fields)
        self.recorder.event(
            job, "Warning" if up else "Normal",
            "ServingScaleUp" if up else "ServingScaleDown",
            decision.reason)
        return job

    # ------------------------------------------------------------------
    # fleet scheduler (controller/scheduler.py) — priority admission,
    # preempt-to-admit / grow-back, degraded-rank migration
    # ------------------------------------------------------------------

    def _fleet_scheduler(self):
        from .scheduler import FleetScheduler
        return FleetScheduler(
            pool_chips=self.config.sched_pool_chips or 0,
            cooldown_floor_seconds=self.config.sched_cooldown_floor_seconds,
            cooldown_multiplier=self.config.sched_cooldown_multiplier)

    def _sched_chips(self, j: TPUJob, with_sched: bool) -> int:
        """A job's chip claim against the fleet pool: the allocation its
        spec + live status overrides produce. with_sched=False masks the
        scheduler's own override — the ENTITLEMENT the gang returns to
        on grow-back."""
        import copy
        jj = copy.deepcopy(j)
        if not with_sched:
            jj.status.sched_tpus = None
        try:
            alloc = self.allocate_processing_units(jj, False)
        except ValueError:
            return 0            # unallocatable spec claims nothing
        if alloc.resource_type != RESOURCE_TPU:
            return 0
        return alloc.worker_replicas * alloc.units_per_worker

    def _sched_shrink_ladder(self, j: TPUJob, current: int) -> tuple:
        """Valid shrink targets for an elastic gang, DESCENDING: the v5e
        ladder below the current entitlement, floored at spec.minTpus,
        per-worker tiled (the _next_elastic_total rule, enumerated)."""
        spec = j.spec
        if not spec.elastic or spec.tpus is None:
            return ()
        per = (spec.tpus_per_worker
               if spec.tpus_per_worker is not None
               else self.config.tpus_per_worker)
        floor = spec.min_tpus or 1
        return tuple(
            c for c in sorted(api.V5E_VALID_SLICE_CHIPS, reverse=True)
            if floor <= c < current and (c < per or c % per == 0))

    def _owns_worker_sets(self, j: TPUJob) -> bool:
        return any(
            is_controlled_by(sts.metadata, j.metadata)
            and sts.metadata.labels.get(LABEL_GROUP) == j.metadata.name
            for sts in self.statefulset_lister.list(j.metadata.namespace))

    def _sched_view(self, j: TPUJob):
        """One job's scheduler view, derived ONLY from status + spec (so
        crash-replayed syncs re-derive it identically). Returns None for
        jobs with no independent claim (packed non-leaders ride their
        leader's gang)."""
        from .scheduler import SchedJob, ledger_cost
        st = j.status
        packed = st.get_condition(COND_PACKED)
        if (packed is not None and packed.status == "True"
                and packed.reason == "PackedWithLeader"):
            return None
        qcond = st.get_condition(api.COND_QUEUED)
        if qcond is not None:
            pending = qcond.status == "True"
        else:
            # no admission verdict yet: a job that already owns its
            # worker sets predates the scheduler (grandfathered in); a
            # bare one is a new arrival awaiting admission
            pending = not self._owns_worker_sets(j)
        done = st.is_done()
        chips = self._sched_chips(j, with_sched=False)
        held = (0 if pending or done
                else self._sched_chips(j, with_sched=True))
        last_cost = None
        if self.observatory is not None:
            from ..telemetry.collector import resize_ledger
            resizes = resize_ledger(
                self.observatory.merged_records(j.metadata.name))
            # 0.0 default → None: "no measured cost yet"; the policy
            # substitutes its own floor (never zero — scheduler.ledger_cost)
            last_cost = ledger_cost(resizes, 0.0) or None
        beneficiary = None
        pcond = st.get_condition(api.COND_PREEMPTED)
        if pcond is not None and pcond.status == "True":
            for tok in pcond.message.split():
                if tok.startswith("for="):
                    beneficiary = tok[4:].rstrip(";,")
        return SchedJob(
            name=f"{j.metadata.namespace}/{j.metadata.name}",
            priority=j.spec.priority or 0,
            created=j.metadata.creation_timestamp or 0.0,
            chips=chips,
            held_chips=held,
            pending=pending,
            done=done,
            elastic=bool(j.spec.elastic),
            shrink_ladder=self._sched_shrink_ladder(j, held or chips),
            sched_tpus=st.sched_tpus,
            sched_scaled_at=st.sched_scaled_at,
            queued_since=(qcond.last_transition_time
                          if pending and qcond is not None else None),
            last_resize_seconds=last_cost,
            preempt_beneficiary=beneficiary,
        )

    def _sched_reconcile(self, job: TPUJob, key: str,
                         terminal: bool) -> Tuple[TPUJob, bool]:
        """One fleet-planning pass from THIS job's sync. Every decision
        is status-first and idempotent, so a controller killed at any
        write boundary replays to the same fleet state:

          admission     — this job's own Queued condition (held = owns
                          nothing; admitted = reconcile proceeds);
          preempt       — executed by the BENEFICIARY's sync as a guarded
                          cross-job status write on the victim
                          (_preempt_victim re-checks under conflict, so
                          a replay can never double-shrink);
          grow-back     — executed only by the VICTIM's own sync;
          anything aimed at another job — that job is enqueued, its own
                          sync re-plans and acts.

        Returns (job, held)."""
        plan_now = self.now()
        fleet = []
        me = None
        for j in self.job_lister.list():
            view = self._sched_view(j)
            if view is None:
                continue
            fleet.append(view)
            if view.name == key:
                me = view
        if me is None:
            return job, False
        plan = self._fleet_scheduler().plan(plan_now, fleet)
        if plan.wake_after is not None and plan.wake_after > 0:
            self.queue.add_after(key, plan.wake_after)

        # explicit refusals: timeline evidence for the postmortem,
        # recorded by the party the refusal protects/blocks
        if self.observatory is not None:
            for d in plan.skips:
                party = d.beneficiary or d.victim
                if party == key:
                    self.observatory.note_sched(
                        job.metadata.name, SCHED_SKIP,
                        token=f"{d.victim}|{d.beneficiary}",
                        reason=d.reason,
                        predicted_cost_seconds=d.predicted_cost_seconds,
                        reclaim_seconds=d.reclaim_seconds)

        held = False
        if not terminal and not me.done:
            if me.pending:
                via = next((v for n, v in plan.admit if n == key), None)
                if via is not None:
                    job = self._sched_admit(job, via)
                else:
                    why = next((w for n, w in plan.hold if n == key),
                               "pool full")
                    job = self._sched_hold(job, why)
                    held = True
            elif (job.status.get_condition(api.COND_QUEUED) is None
                    and me.held_chips > 0):
                # grandfathered pre-scheduler job: stamp the admission
                # verdict so the fleet view stops depending on owned
                # resources
                job = self._sched_admit(job, "grandfathered")

        act = plan.action
        if act is not None:
            if act.action == "preempt":
                if act.beneficiary == key:
                    self._preempt_victim(act)
                    # the victim's informer event does not fan out to
                    # this job — replan immediately with its freed chips
                    self.queue.add(key)
                else:
                    self.queue.add(act.beneficiary)
            elif act.action == "grow_back":
                if act.victim == key:
                    job = self._sched_grow_back(job, act)
                else:
                    self.queue.add(act.victim)
        # pending jobs the plan would admit only act in their own sync;
        # capacity releases (a job completing, a victim shrinking) would
        # otherwise never reach them
        for n, _ in plan.admit:
            if n != key:
                self.queue.add(n)
        return job, held

    def _sched_hold(self, job: TPUJob, reason: str) -> TPUJob:
        cond = job.status.get_condition(api.COND_QUEUED)
        if cond is not None and cond.status == "True":
            return job          # already queued; keep the original anchor
        msg = f"held by the fleet scheduler: {reason}"
        job.status.set_condition(api.JobCondition(
            api.COND_QUEUED, "True", "SchedQueued", msg))
        job = self._update_status_apply(job)
        self.recorder.event(job, "Normal", "SchedQueued", msg)
        if self.observatory is not None:
            fresh = job.status.get_condition(api.COND_QUEUED)
            self.observatory.note_sched(
                job.metadata.name, SCHED_QUEUE,
                token=f"{fresh.last_transition_time}",
                reason=reason, priority=job.spec.priority or 0)
        return job

    def _sched_admit(self, job: TPUJob, via: str) -> TPUJob:
        cond = job.status.get_condition(api.COND_QUEUED)
        if cond is not None and cond.status == "False":
            return job
        waited = (self.now() - cond.last_transition_time
                  if cond is not None else 0.0)
        msg = f"admitted via {via} after {waited:.0f}s queued"
        job.status.set_condition(api.JobCondition(
            api.COND_QUEUED, "False", "SchedAdmit", msg))
        job = self._update_status_apply(job)
        self.recorder.event(job, "Normal", "SchedAdmit", msg)
        if self.observatory is not None:
            self.observatory.note_sched(
                job.metadata.name, SCHED_ADMIT,
                token=f"{via}:{cond.last_transition_time if cond else 0}",
                via=via, waited_seconds=round(waited, 3))
        return job

    def _preempt_victim(self, decision) -> None:
        """Cross-job preemption write, the one scheduler action executed
        outside the victim's own sync. Crash/conflict discipline: fresh
        read → abort if ANY scheduler override is already live (zero
        double-shrinks even against a concurrent replay) → single status
        PUT carrying the override + Preempted condition; a 409 loops
        back to the fresh read, re-checking the guard."""
        ns, vname = split_key(decision.victim)
        for _ in range(MAX_CONFLICT_RETRIES):
            victim = self.api.try_get(api.KIND, ns, vname)
            if victim is None or victim.status.sched_tpus is not None:
                return
            victim.status.sched_tpus = decision.to_chips
            victim.status.sched_scaled_at = self.now()
            msg = (f"shrunk {decision.from_chips} -> {decision.to_chips} "
                   f"chips for={decision.beneficiary} (predicted resize "
                   f"cost {decision.predicted_cost_seconds:.0f}s vs "
                   f"queued wait {decision.reclaim_seconds:.0f}s)")
            victim.status.set_condition(api.JobCondition(
                api.COND_PREEMPTED, "True", "SchedPreempt", msg))
            try:
                self.api.update_status(victim)
            except ConflictError:
                self.sync_counters.record_requeue("conflict")
                continue
            self.recorder.event(victim, "Warning", "SchedPreempt", msg)
            if self.observatory is not None:
                self.observatory.note_sched(
                    vname, SCHED_PREEMPT,
                    token=f"{decision.beneficiary}:{decision.to_chips}",
                    victim=decision.victim,
                    beneficiary=decision.beneficiary,
                    from_tpus=decision.from_chips,
                    to_tpus=decision.to_chips,
                    predicted_cost_seconds=decision.predicted_cost_seconds)
            return

    def _sched_grow_back(self, job: TPUJob, decision) -> TPUJob:
        if job.status.sched_tpus is None:
            return job          # a replayed sync already restored it
        shrunk_at = job.status.sched_scaled_at
        job.status.sched_tpus = None
        job.status.sched_scaled_at = self.now()
        msg = (f"restored to {decision.to_chips} chips after "
               f"preemption at {decision.from_chips}")
        job.status.set_condition(api.JobCondition(
            api.COND_PREEMPTED, "False", "SchedGrowBack", msg))
        job = self._update_status_apply(job)
        self.recorder.event(job, "Normal", "SchedGrowBack", msg)
        if self.observatory is not None:
            self.observatory.note_sched(
                job.metadata.name, SCHED_GROW_BACK,
                token=f"{shrunk_at}",
                from_tpus=decision.from_chips,
                to_tpus=decision.to_chips)
        return job

    def _sched_migrate_reconcile(self, job: TPUJob,
                                 alloc: AllocationResult,
                                 key: str) -> TPUJob:
        """Degraded-rank migration: a DegradedGang partition that
        persists past the cost floor deletes the dark worker pod so the
        StatefulSet reschedules it onto a healthy node. Crash-consistent
        ordering mirrors _count_gang_restart: the status write (window
        marker + migration_count) lands FIRST, then the idempotent pod
        delete; a replayed sync sees its own marker, skips the count,
        and re-attempts the delete ONLY while the same pod incarnation
        still exists. At most one migration per degraded window — the
        window id is the condition's transition time, which message-only
        updates (rank-set changes) never bump."""
        if not self.config.sched_migration or self.observatory is None:
            return job
        cond = job.status.get_condition(api.COND_DEGRADED_GANG)
        if cond is None or cond.status != "True":
            return job
        dark, total = self.observatory.partition_state(job.metadata.name)
        if not dark or len(dark) >= total:
            return job
        window = cond.last_transition_time or 0.0
        rank = min(dark)
        names = self.worker_pod_names(job, alloc)
        if rank >= len(names):
            return job
        pod_name = names[rank]
        pod = self.api.try_get("Pod", job.metadata.namespace, pod_name)
        uid = pod.metadata.uid if pod is not None else pod_name
        prefix = f"{window:.3f}:"
        if (job.status.migrated_window or "").startswith(prefix):
            # replay: the count landed; finish the delete, level-
            # triggered, only against the SAME pod incarnation (a new
            # uid means the StatefulSet already rescheduled it)
            prev_uid = job.status.migrated_window.split(":", 1)[1]
            if pod is not None and pod.metadata.uid == prev_uid:
                self._delete_ignore_missing(
                    "Pod", job.metadata.namespace, pod_name)
            return job
        now = self.now()
        decision = self._fleet_scheduler().migration(
            now, window_age=now - window, already_migrated=False)
        if decision.action != "migrate":
            if decision.wake_after is not None and decision.wake_after > 0:
                self.queue.add_after(key, decision.wake_after)
            self.observatory.note_sched(
                job.metadata.name, SCHED_SKIP,
                token=f"migrate:{prefix}{uid}", reason=decision.reason,
                predicted_cost_seconds=decision.predicted_cost_seconds,
                reclaim_seconds=decision.reclaim_seconds)
            return job
        job.status.migrated_window = f"{prefix}{uid}"
        job.status.migration_count += 1
        msg = (f"rank {rank} dark for {now - window:.0f}s; migrating pod "
               f"{pod_name} (migration {job.status.migration_count}, "
               f"distinct from gang restarts)")
        job = self._update_status_apply(job)
        self.recorder.event(job, "Warning", "SchedMigrate", msg)
        self.observatory.note_sched(
            job.metadata.name, SCHED_MIGRATE, token=f"{prefix}{uid}",
            rank=rank, pod=pod_name,
            migration_count=job.status.migration_count,
            window_age_seconds=round(now - window, 3))
        self._delete_ignore_missing("Pod", job.metadata.namespace,
                                    pod_name)
        return job

    def _fail_invalid_spec(self, job: TPUJob, message: str,
                           launcher: Optional[Job] = None) -> None:
        """InvalidSpec convergence. The reference hot-loops here:
        allocateProcessingUnits error → syncHandler error → rate-limited
        requeue forever (mpi_job_controller.go:462-466 + :399-404) with
        nothing in status explaining why no pods appear. We record a
        Failed/InvalidTPUJobSpec condition + Warning Event and let the
        queue forget the key. Idempotent per MESSAGE: a spec re-broken a
        different way refreshes the condition instead of freezing the
        first failure text. A RUNNING job edited into an invalid spec
        also tears its gang down (launcher deleted, workers scaled to 0)
        — desired state is unsatisfiable, so leaving chips burning behind
        a Failed status would be the worst of both."""
        existing = job.status.get_condition(COND_FAILED)
        fresh = not (existing is not None and existing.status == "True"
                     and existing.reason == "InvalidTPUJobSpec"
                     and existing.message == message)
        if fresh:
            job.status.set_condition(api.JobCondition(
                COND_FAILED, "True", "InvalidTPUJobSpec", message))
            job = self._update_status_apply(job)
            self.recorder.event(job, "Warning", "InvalidTPUJobSpec",
                                message)
        if job.spec.clean_pod_policy == "None":
            return
        if launcher is not None:
            self._delete_ignore_missing("Job", launcher.metadata.namespace,
                                        launcher.metadata.name)
        for sts in self.statefulset_lister.list(job.metadata.namespace):
            if (is_controlled_by(sts.metadata, job.metadata)
                    and sts.metadata.labels.get(LABEL_GROUP)
                    == job.metadata.name
                    and sts.spec.replicas != 0):
                sts.spec.replicas = 0
                self.api.update(sts)

    # ------------------------------------------------------------------
    # elastic membership (spec.elastic) — checkpoint-restart elasticity
    # ------------------------------------------------------------------

    def _elastic_reconcile(self, job: TPUJob, alloc: AllocationResult,
                           workers_ready: bool, key: str) -> TPUJob:
        """One tick of the elastic state machine (no reference analogue —
        SURVEY §2.3 lists elasticity as absent; MPI's answer was 'mpirun
        dies'). TPU-idiomatic elasticity is checkpoint-restart: XLA
        program shapes are fixed per topology, so changing the world size
        means a gang restart resuming from the latest checkpoint — which
        the resize machinery already does. This method only decides WHAT
        size the world should be:

          not Ready for > elastic_degraded_seconds → shrink to the next
            valid v5e chip count >= minTpus (recorded in status, with a
            Degraded condition + Warning Event);
          Ready at a shrunken size for > elastic_recovery_seconds → try
            the full spec size again (capacity may be back; if it isn't,
            the degraded timer shrinks the job right back, so the job
            oscillates at most once per recovery window).

        Wake-ups are scheduled through queue.add_after — a pending
        timeout fires even with no cluster events."""
        now = self.now()
        jkey = (job.metadata.namespace, job.metadata.name)
        degraded = job.status.elastic_tpus is not None
        if workers_ready:
            self._not_ready_since.pop(jkey, None)
            if not degraded:
                self._elastic_ready_since.pop(jkey, None)
                return job
            # recovery counts CONTINUOUS readiness of the shrunken world,
            # armed at its first Ready observation — not the shrink time
            # (a gang that took the whole window to schedule would
            # otherwise be restored the instant it first turns Ready)
            ready_since = self._elastic_ready_since.setdefault(jkey, now)
            wait = self.config.elastic_recovery_seconds - (now - ready_since)
            if wait > 0:
                self.queue.add_after(key, wait)
                return job
            self._elastic_ready_since.pop(jkey, None)
            job.status.elastic_tpus = None
            job.status.elastic_since = None
            job.status.set_condition(api.JobCondition(
                api.COND_DEGRADED, "False", "ElasticRestore",
                f"retrying the full size (tpus={job.spec.tpus}) after the "
                f"recovery window"))
            job = self._update_status_apply(job)
            self.recorder.event(
                job, "Normal", "ElasticRestore",
                f"restoring to spec size tpus={job.spec.tpus}")
            return job
        self._elastic_ready_since.pop(jkey, None)   # continuity broken
        if job.status.get_condition(api.COND_RUNNING) is None:
            # never yet Ready: a brand-new gang still scheduling/pulling
            # images is not "lost capacity" — arming the degraded timer
            # from the first sync would shrink a fresh job below spec
            # before it ever ran at spec size. The Running condition is
            # set exactly when the readiness gate first passes (launcher
            # active), and it lives in STATUS, so this arming gate also
            # survives operator restarts.
            self._not_ready_since.pop(jkey, None)
            return job
        since = self._not_ready_since.setdefault(jkey, now)
        wait = self.config.elastic_degraded_seconds - (now - since)
        if wait > 0:
            self.queue.add_after(key, wait)
            return job
        next_total = self._next_elastic_total(job)
        if next_total is None:
            return job          # already at the floor; stay pending
        current = job.status.elastic_tpus or job.spec.tpus
        job.status.elastic_tpus = next_total
        job.status.elastic_since = now
        job.status.set_condition(api.JobCondition(
            api.COND_DEGRADED, "True", "ElasticShrink",
            f"workers not Ready for "
            f"{self.config.elastic_degraded_seconds}s; shrinking "
            f"{current} -> {next_total} chips (resumes from the latest "
            f"checkpoint)"))
        job = self._update_status_apply(job)
        self.recorder.event(
            job, "Warning", "ElasticShrink",
            f"shrinking to tpus={next_total} after persistent worker "
            f"unavailability")
        self._not_ready_since.pop(jkey, None)
        return job

    def _next_elastic_total(self, job: TPUJob) -> Optional[int]:
        """Largest valid v5e chip count strictly below the current
        effective size that the per-worker count can still tile
        (divisible, or the single-worker `total < perWorker` form) and
        that respects spec.minTpus."""
        spec = job.spec
        current = job.status.elastic_tpus or spec.tpus
        per = (spec.tpus_per_worker
               if spec.tpus_per_worker is not None
               else self.config.tpus_per_worker)
        floor = spec.min_tpus or 1
        for c in sorted(api.V5E_VALID_SLICE_CHIPS, reverse=True):
            if c >= current or c < floor:
                continue
            if c < per or c % per == 0:
                return c
        return None

    # ------------------------------------------------------------------
    # gang-restart decision (v1alpha2 RestartPolicy, common_types.go:131-156)
    # ------------------------------------------------------------------

    def _restart_budget_left(self, job: TPUJob) -> bool:
        cap = (job.spec.backoff_limit
               if job.spec.backoff_limit is not None
               else api.DEFAULT_BACKOFF_LIMIT)
        return job.status.restart_count < cap

    def _should_restart(self, job: TPUJob, launcher: Job) -> bool:
        policy = job.spec.restart_policy
        if not self._restart_budget_left(job):
            return False
        if policy == "OnFailure":
            return True
        if policy == "ExitCode":
            code = launcher.status.exit_code
            # 1-127 = permanent application failure; 128-255 = retryable
            # (signal-killed / infra loss, incl. LAUNCHER_LOST_EXIT); an
            # unknown code means the pod vanished — treat as retryable
            return code is None or code >= 128
        return False          # "Never" (v1alpha1 behavior)

    def _count_gang_restart(self, job: TPUJob, launcher: Job,
                            reason: str, detail: str) -> TPUJob:
        """Record a gang restart in status exactly once per launcher
        incarnation. The Restarting condition message carries the doomed
        launcher's uid; a sync replayed after a mid-flight crash (status
        write landed, launcher delete didn't) sees its own marker and
        skips the increment — restart_count stays an honest count of
        restarts against backoffLimit, not of sync attempts."""
        marker = f"uid={launcher.metadata.uid}"
        cond = job.status.get_condition(api.COND_RESTARTING)
        if (cond is not None and cond.status == "True"
                and marker in cond.message):
            if self.observatory is not None:
                # the crash may have landed the count but not the lease
                # reset; re-arming is idempotent either way
                self.observatory.reset_progress_lease(job.metadata.name)
            return job
        job.status.restart_count += 1
        job.status.set_condition(api.JobCondition(
            api.COND_RESTARTING, "True", reason,
            f"{detail} (launcher {marker}); restart "
            f"{job.status.restart_count}"))
        # keep the returned object: a second status PUT in this same
        # sync (update_tpu_job_status) must carry the fresh RV or a
        # real API server 409s it
        job = self._update_status_apply(job)
        self.recorder.event(
            job, "Normal", reason,
            f"gang restart {job.status.restart_count}: {detail}")
        if self.observatory is not None:
            # the timeline record carries the launcher exit code AND
            # the last step frontier this controller observed — the
            # goodput ledger charges restart-lost steps against it
            self.observatory.note_restart(
                job.metadata.name,
                exit_code=launcher.status.exit_code,
                restart=job.status.restart_count)
        return job

    # ------------------------------------------------------------------
    # stuck-gang detection (spec.progressDeadlineSeconds progress lease)
    # ------------------------------------------------------------------

    def _check_stuck_gang(self, job: TPUJob, launcher: Job,
                          key: str) -> Tuple[TPUJob, Optional[Job], bool]:
        """Progress lease: a Running job whose federated step frontier
        (max of tpu_worker_step / last_checkpoint_step over every worker's
        latest scrape — all-scrapes-stale freezes it too) advances by zero
        across spec.progressDeadlineSeconds is declared stuck — a hung
        host or stalled ICI that activeDeadlineSeconds would eventually
        kill undiagnosed. The verdict emits a gang_stuck timeline record +
        Warning event, records a StuckGang condition, and rides the
        ordinary restart-policy path: the gang restart is counted against
        backoffLimit, and an exhausted budget (or restartPolicy Never)
        fails the job with reason StuckGang. Returns (job, launcher,
        restarted); `restarted` gates launcher re-creation this sync.

        Wake-ups ride queue.add_after, so the lease expires on schedule
        even with no cluster events."""
        deadline = job.spec.progress_deadline_seconds
        if self.observatory is None or not deadline:
            return job, launcher, False
        running = job.status.get_condition(COND_RUNNING)
        if running is None or running.status != "True":
            return job, launcher, False
        stall = self.observatory.stall_seconds(job.metadata.name)
        if stall is None:       # lease not armed (gang not observed yet)
            return job, launcher, False
        if stall < deadline:
            stuck_cond = job.status.get_condition(api.COND_STUCK)
            if stuck_cond is not None and stuck_cond.status == "True":
                # progress resumed: retire the verdict so the condition
                # reads level-triggered truth, not history
                job.status.set_condition(api.JobCondition(
                    api.COND_STUCK, "False", "ProgressResumed",
                    "step frontier advancing again"))
                job = self._update_status_apply(job)
            self.queue.add_after(key, deadline - stall)
            return job, launcher, False
        msg = (f"no observed step progress for {stall:.0f}s "
               f"(progressDeadlineSeconds={deadline})")
        stuck_cond = job.status.get_condition(api.COND_STUCK)
        if not (stuck_cond is not None and stuck_cond.status == "True"):
            job.status.set_condition(api.JobCondition(
                api.COND_STUCK, "True", "ProgressDeadlineExceeded", msg))
            self.recorder.event(job, "Warning", "GangStuck", msg)
            self.observatory.note_stuck(
                job.metadata.name, stall_seconds=round(stall, 3),
                deadline=deadline)
        if (job.spec.restart_policy in ("OnFailure", "ExitCode")
                and self._restart_budget_left(job)):
            # a hang is infra-shaped, not an application exit code:
            # ExitCode policy treats it as retryable
            job = self._count_gang_restart(job, launcher, "GangStuck", msg)
            self._delete_ignore_missing("Job", launcher.metadata.namespace,
                                        launcher.metadata.name)
            # unlike a launcher failure, the wedged processes live in the
            # WORKER pods — kubelet sees them Running and will never
            # restart them on its own; the gang delete forces it
            self._delete_worker_pods(job)
            return job, None, True
        # budget exhausted (or restartPolicy Never): the stall is terminal
        job.status.set_condition(api.JobCondition(
            COND_FAILED, "True", "StuckGang", msg))
        job = self._update_status_apply(job)
        self.recorder.event(job, "Warning", "StuckGang",
                            f"job failed: {msg}")
        if self.observatory is not None:
            self.observatory.note_terminal(job.metadata.name,
                                           succeeded=False,
                                           reason="StuckGang")
        self._delete_ignore_missing("Job", launcher.metadata.namespace,
                                    launcher.metadata.name)
        return job, None, True

    # ------------------------------------------------------------------
    # launcher lookup (ref getLauncherJob :522-544)
    # ------------------------------------------------------------------

    def get_launcher_job(self, job: TPUJob) -> Optional[Job]:
        launcher = self.batchjob_lister.try_get(
            job.metadata.namespace, job.metadata.name + LAUNCHER_SUFFIX
        )
        if launcher is None:
            return None
        if not is_controlled_by(launcher.metadata, job.metadata):   # ref :537
            self.recorder.event(
                job, "Warning", ERR_RESOURCE_EXISTS,
                MSG_RESOURCE_EXISTS % f"Job/{launcher.metadata.name}",
            )
            raise ForeignOwnershipError("Job", launcher.metadata.name)
        return launcher

    # ------------------------------------------------------------------
    # allocation math (ref allocateProcessingUnits :547-598)
    # ------------------------------------------------------------------

    def allocate_processing_units(self, job: TPUJob, done: bool) -> AllocationResult:
        spec = job.spec
        # the tpus sizing mode stays TPU mode: its unset resource type is
        # google.com/tpu whatever the operator's (GPU) default is
        resource_type = spec.processing_resource_type or (
            RESOURCE_TPU if spec.tpus is not None
            else self.config.processing_resource_type)
        slots = spec.slots_per_worker or api.DEFAULT_SLOTS_PER_WORKER

        if spec.tpus is not None:
            # Mode A via tpus: pair with tpusPerWorker (spec overrides the
            # cluster flag, ref :449-453). An elastic shrink overrides the
            # spec size through STATUS (the user's spec is never edited).
            total = spec.tpus
            if spec.resize is not None:
                # user-driven gang resize: the edited target replaces the
                # spec size outright — the new world rides the worker
                # template hash, so the next sync drains and re-bootstraps
                # the gang at this size (validation guarantees a valid
                # ladder count and no elastic/serving/packing conflict)
                total = spec.resize
            elif spec.elastic and (job.status.elastic_tpus is not None
                                   or job.status.sched_tpus is not None):
                # two independent status overrides may be live at once:
                # the elastic shrink (capacity loss) and the scheduler
                # preemption (priority rebalance). The gang runs at the
                # SMALLER of the two — each owner clears only its own
                # field, so releasing one never releases the other.
                total = min(v for v in (job.status.elastic_tpus,
                                        job.status.sched_tpus)
                            if v is not None)
            per_worker = (
                spec.tpus_per_worker
                if spec.tpus_per_worker is not None
                else self.config.tpus_per_worker
            )
        elif spec.processing_units is not None:
            # Mode A via processingUnits: pair with processingUnitsPerWorker
            # (ref :455-460 — each total field uses ITS OWN per-node default)
            total = spec.processing_units
            per_worker = (
                spec.processing_units_per_worker
                if spec.processing_units_per_worker is not None
                else self.config.processing_units_per_worker
            )
        else:
            total = per_worker = None

        if total is not None:
            # Mode A (ref :573-582). Guard BEFORE dividing: a zero/negative
            # per-worker (possible via the operator FLAG, which admission
            # never sees) must surface as the ValueError the invalid-spec
            # path converges on — not a ZeroDivisionError that requeues
            # forever
            if per_worker is None or per_worker < 1:
                raise ValueError(
                    f"per-worker processing-unit count must be >= 1, got "
                    f"{per_worker} (check --tpus-per-worker / "
                    f"--processing-units-per-worker or the spec overrides)"
                )
            if total < per_worker:
                workers = 1          # total < perNode → 1 worker with all units
                units = total
            elif total % per_worker != 0:
                raise ValueError(
                    f"specified number of processing units ({total}) must be a "
                    f"multiple of the number per worker ({per_worker})"
                )  # ref :580
            else:
                workers = total // per_worker
                units = per_worker
        elif spec.replicas is not None:
            # Mode B (ref :584-593): per-worker from container resource limits
            workers = spec.replicas
            units = spec.template.main_container().limits.get(resource_type, 0)
        else:
            raise ValueError(
                "TPUJob spec must set one of tpus, processingUnits, replicas"
            )

        num_slices = max(spec.num_slices, 1)
        if workers > 0 and workers % num_slices != 0:
            # backstop for what admission can't see (e.g. the per-worker
            # default coming from the operator FLAG); same error contract
            # as the per-worker divisibility rule above (ref :580)
            raise ValueError(
                f"worker replicas ({workers}) must divide evenly into "
                f"numSlices ({num_slices}) worker groups"
            )
        serving_pools = None
        if spec.serving is not None:
            # backstop for what admission can't derive (flag-default
            # per-worker counts); same ValueError contract as the
            # divisibility rules above — converges to InvalidTPUJobSpec
            if num_slices > 1:
                raise ValueError(
                    f"spec.serving does not support numSlices="
                    f"{num_slices} (> 1)")
            want = (spec.serving.prefill_replicas
                    + spec.serving.decode_replicas)
            if workers > 0 and workers != want:
                raise ValueError(
                    f"serving pools need prefillReplicas + "
                    f"decodeReplicas == worker replicas: {want} != "
                    f"{workers}")
            decode = spec.serving.decode_replicas
            if job.status.serving_decode_replicas is not None:
                # SLO autoscaler override — status-driven like
                # elastic_tpus, but here the POOL SPLIT is the primary
                # and the worker count follows it (the spec-consistency
                # check above already ran against the user's numbers,
                # so an invalid spec fails identically with or without
                # an override in status)
                decode = job.status.serving_decode_replicas
                if workers > 0:
                    workers = spec.serving.prefill_replicas + decode
            serving_pools = (spec.serving.prefill_replicas, decode)
        if done:
            workers = 0              # scale-down after completion (ref :594-596)
        return AllocationResult(
            worker_replicas=workers,
            units_per_worker=units,
            resource_type=resource_type,
            slots_per_worker=slots,
            num_slices=num_slices,
            serving_pools=serving_pools,
        )

    # ------------------------------------------------------------------
    # dependent resources — each getOrCreate enforces ownership
    # ------------------------------------------------------------------

    def _check_ownership(self, obj, job: TPUJob):
        if not is_controlled_by(obj.metadata, job.metadata):
            self.recorder.event(
                job, "Warning", ERR_RESOURCE_EXISTS,
                MSG_RESOURCE_EXISTS % f"{obj.kind}/{obj.metadata.name}",
            )
            raise ForeignOwnershipError(obj.kind, obj.metadata.name)
        return obj

    def _create_or_get(self, desired, job: TPUJob) -> Tuple[object, bool]:
        """Create `desired`; on AlreadyExists read the live object through
        the API server (bypassing the informer cache) and ownership-check
        it. Returns (obj, created). Against a real cluster the informer
        lags its own writes by a watch round-trip, so right after a create
        the lister still misses the child; the reference fails the sync
        and relies on requeue backoff (AlreadyExists → error → retry,
         8-10 wasted syncs per job) — reading through converges in THIS
        sync instead."""
        try:
            return self.api.create(desired), True
        except AlreadyExistsError:
            fetched = self.api.get(desired.kind, desired.metadata.namespace,
                                   desired.metadata.name)
            return self._check_ownership(fetched, job), False

    def _update_status_apply(self, job: TPUJob) -> TPUJob:
        """Status PUT with client-go's RetryOnConflict discipline: a 409
        means our resourceVersion went stale, so re-read the object, graft
        our computed status onto the fresh read, and retry — bounded, so a
        persistently conflicting server degrades to the ordinary
        rate-limited requeue instead of a hot loop. The graft is safe
        because sync_handler holds this key exclusively (workqueue
        processing-set semantics): nobody else computes status for it
        concurrently. Every in-place retry is visible as
        tpu_operator_requeues_total{reason="conflict"}."""
        for _ in range(MAX_CONFLICT_RETRIES):
            try:
                return self.api.update_status(job)
            except ConflictError:
                self.sync_counters.record_requeue("conflict")
                fresh = self.api.try_get(job.kind, job.metadata.namespace,
                                         job.metadata.name)
                if fresh is None:
                    raise       # deleted under us; the requeued sync drops it
                fresh.status = job.status
                job = fresh
        return self.api.update_status(job)

    def _delete_ignore_missing(self, kind: str, namespace: str,
                               name: str) -> bool:
        """Idempotent delete: NotFound means an earlier attempt (possibly
        one a crashed sync never saw the response to) already won. Returns
        whether this call did the deleting."""
        try:
            self.api.delete(kind, namespace, name)
            return True
        except NotFoundError:
            return False

    def get_or_create_config_map(self, job: TPUJob, alloc: AllocationResult) -> ConfigMap:
        """ref: getOrCreateConfigMap (:627-648) + newConfigMap (:849-885).
        Updates in place if the discovery data drifted (worker count change),
        as the reference updates the hostfile."""
        name = job.metadata.name + CONFIG_SUFFIX
        desired = self.new_config_map(job, alloc)
        existing = self.configmap_lister.try_get(job.metadata.namespace, name)
        if existing is None:
            existing, created = self._create_or_get(desired, job)
            if created:
                return existing
        else:
            self._check_ownership(existing, job)
        if existing.data != desired.data:
            existing.data = desired.data
            return self.api.update(existing)
        return existing

    def get_or_create_worker_service(self, job: TPUJob) -> Service:
        """Headless governing Service for the worker StatefulSet — the DNS
        backing for the hostnames published in the ConfigMap. Updates on
        spec drift so fixes (e.g. publishNotReadyAddresses) reach
        Services created by older operator versions."""
        name = job.metadata.name + WORKER_SUFFIX
        desired = self.new_worker_service(job)
        existing = self.service_lister.try_get(job.metadata.namespace, name)
        if existing is None:
            existing, created = self._create_or_get(desired, job)
            if created:
                return existing
        else:
            self._check_ownership(existing, job)
        if (existing.selector, existing.ports,
                existing.publish_not_ready_addresses) != (
                desired.selector, desired.ports,
                desired.publish_not_ready_addresses):
            existing.selector = desired.selector
            existing.ports = desired.ports
            existing.publish_not_ready_addresses = \
                desired.publish_not_ready_addresses
            return self.api.update(existing)
        return existing

    def new_worker_service(self, job: TPUJob) -> Service:
        name = job.metadata.name + WORKER_SUFFIX
        return Service(
            metadata=ObjectMeta(
                name=name,
                namespace=job.metadata.namespace,
                labels={LABEL_GROUP: job.metadata.name},
                owner_references=[job.controller_owner_reference()],
            ),
            cluster_ip="None",
            selector={LABEL_GROUP: job.metadata.name,
                      "tpu_job_role": "worker"},
            ports=[COORDINATOR_PORT],
            # rendezvous DNS must exist BEFORE pods are Ready: the
            # TPU-health readiness marker is written only after
            # jax.distributed.initialize, which itself needs worker-0's
            # A-record to resolve (and the discovery init wait needs every
            # worker's) — Ready-gated records would deadlock the bootstrap
            publish_not_ready_addresses=True,
        )

    def get_or_create_launcher_service_account(self, job: TPUJob) -> ServiceAccount:
        """ref: getOrCreateLauncherServiceAccount (:652-673)."""
        name = job.metadata.name + LAUNCHER_SUFFIX
        existing = self.sa_lister.try_get(job.metadata.namespace, name)
        if existing is None:
            return self._create_or_get(
                self.new_launcher_service_account(job), job)[0]
        return self._check_ownership(existing, job)

    def get_or_create_launcher_role(self, job: TPUJob,
                                    alloc: AllocationResult) -> Role:
        """ref: getOrCreateLauncherRole (:676-697); updates rules on drift
        (worker count change alters resourceNames)."""
        name = job.metadata.name + LAUNCHER_SUFFIX
        desired = self.new_launcher_role(job, alloc)
        existing = self.role_lister.try_get(job.metadata.namespace, name)
        if existing is None:
            existing, created = self._create_or_get(desired, job)
            if created:
                return existing
        else:
            self._check_ownership(existing, job)
        if existing.rules != desired.rules:
            existing.rules = desired.rules
            return self.api.update(existing)
        return existing

    def get_or_create_launcher_role_binding(self, job: TPUJob) -> RoleBinding:
        """ref: getLauncherRoleBinding (:701-722)."""
        name = job.metadata.name + LAUNCHER_SUFFIX
        existing = self.rolebinding_lister.try_get(job.metadata.namespace, name)
        if existing is None:
            return self._create_or_get(
                self.new_launcher_role_binding(job), job)[0]
        return self._check_ownership(existing, job)

    def get_or_create_pdb(self, job: TPUJob, worker_replicas: int) -> PodDisruptionBudget:
        """ref: getOrCreatePodGroups/PDB (:601-623)."""
        name = job.metadata.name + WORKER_SUFFIX
        desired = self.new_pdb(job, worker_replicas)
        existing = self.pdb_lister.try_get(job.metadata.namespace, name)
        if existing is None:
            existing, created = self._create_or_get(desired, job)
            if created:
                return existing
        else:
            self._check_ownership(existing, job)
        if existing.min_available != desired.min_available:
            existing.min_available = desired.min_available
            return self.api.update(existing)
        return existing

    def get_or_create_worker_statefulsets(
        self, job: TPUJob, alloc: AllocationResult,
        pack: Optional[PackPlan] = None,
    ) -> Tuple[List[Optional[StatefulSet]], bool]:
        """ref: getOrCreateWorkerStatefulSet (:726-759): create if missing and
        workers>0; update on replica drift (incl. scale-down-to-0 on done).
        Multi-slice: one StatefulSet PER SLICE (`<job>-worker-s<k>`), each
        sized workers_per_slice — the controller actually places slices,
        instead of flattening them into one pool (VERDICT r02 missing #2).
        Returns (groups, resized) — resized means the worker TOPOLOGY
        changed this sync (template reconciled or a slice group pruned)
        and the gang was restarted onto it."""
        out: List[Optional[StatefulSet]] = []
        group_names = self.worker_group_names(job, alloc.num_slices)
        group_sizes = alloc.group_sizes()       # aligned with group_names
        stale_groups: List[StatefulSet] = []    # need a gang restart
        for slice_id, name in enumerate(group_names):
            per_group = group_sizes[slice_id]
            existing = self.statefulset_lister.try_get(
                job.metadata.namespace, name)
            if existing is None:
                if per_group == 0:
                    out.append(None)
                    continue
                existing, created = self._create_or_get(
                    self.new_worker(job, alloc, slice_id=slice_id,
                                    pack=pack), job)
                if created:
                    out.append(existing)
                    continue
            else:
                self._check_ownership(existing, job)
            changed = False
            group_stale = False
            old_replicas = existing.spec.replicas
            if existing.spec.replicas != per_group:            # ref :748-756
                existing.spec.replicas = per_group
                changed = True
            # The reference reconciles only the replica count; a resized
            # spec (tpus 8→16) or an edited template would leave the
            # remaining pods on STALE env (TPU_NUM_PROCESSES, hostnames)
            # — inconsistent with the updated ConfigMap and a broken
            # rendezvous after the gang restart. Drift is judged on the
            # fields the controller OWNS (a real API server defaults
            # extra fields; whole-object equality would churn forever).
            if per_group > 0:
                # pack env rides in the template, so the template hash —
                # and with it the level-triggered gang restart below —
                # covers pack MEMBERSHIP changes too
                desired = self.new_worker(job, alloc, slice_id=slice_id,
                                          pack=pack)
                if _worker_template_drifted(existing.spec.template,
                                            desired.spec.template):
                    existing.spec.template = desired.spec.template
                    changed = True
                # LEVEL-TRIGGERED restart signal: the template-hash
                # annotation records which template the pods were last
                # (re)started on. It only advances after the gang
                # deletion SUCCEEDS, so a failed deletion is retried on
                # every later sync (and survives operator restarts) —
                # under OnDelete nothing else would ever replace the
                # stale pods.
                if existing.metadata.annotations.get(
                        ANNOTATION_TEMPLATE_HASH) != _template_hash(
                        desired.spec.template):
                    stale_groups.append(existing)
                    group_stale = True
            # LIVE decode-pool scale: the decode group's replica count
            # moved but its template did NOT (the env is rendered from
            # the spec baseline — _template_alloc — so an autoscaler
            # override delta lands here, a user spec edit goes the
            # gang-restart path above). Ordinal add/remove under
            # OnDelete+Parallel is restart-free: no pod deletion, no
            # launcher teardown, survivors never pause. The status
            # marker is written BEFORE the StatefulSet update (the
            # migratedWindow discipline) so a crash between the two
            # replays cleanly: same drift → same marker string → the
            # replayed update is a no-op and the timeline record
            # dedupes on the marker token.
            live_scale = None
            if (alloc.serving_pools is not None and slice_id == 1
                    and old_replicas != per_group
                    and old_replicas > 0 and per_group > 0
                    and not group_stale):
                marker = (f"decode:{old_replicas}->{per_group}"
                          f"@{job.status.serving_scaled_at}")
                live_scale = (old_replicas, per_group, marker)
                if job.status.scaling_replica != marker:
                    job.status.scaling_replica = marker
                    fresh = self._update_status_apply(job)
                    job.metadata.resource_version = \
                        fresh.metadata.resource_version
                    job.status = fresh.status
            if changed:
                existing = self.api.update(existing)
                if stale_groups and stale_groups[-1].metadata.name \
                        == existing.metadata.name:
                    stale_groups[-1] = existing     # carry the fresh RV
            if live_scale is not None:
                self._finish_live_scale(job, *live_scale)
            out.append(existing)
        # prune slice groups a numSlices change orphaned (their stale-
        # topology pods would keep matching the shared Service selector
        # and dial the new coordinator with the old world size)
        pruned = False
        keep = set(group_names)
        for sts in self.statefulset_lister.list(job.metadata.namespace):
            if (sts.metadata.name not in keep
                    and is_controlled_by(sts.metadata, job.metadata)
                    and sts.metadata.labels.get(LABEL_GROUP)
                    == job.metadata.name):
                self._delete_ignore_missing(
                    "StatefulSet", sts.metadata.namespace, sts.metadata.name)
                pruned = True
        resized = pruned or bool(stale_groups)
        if resized:
            # OnDelete update strategy (new_worker): the StatefulSet will
            # NOT roll pods itself — and a Ready-gated roll would deadlock
            # on the full-world rendezvous anyway. Delete the whole worker
            # gang explicitly; kubelet recreates every pod on the new
            # template simultaneously (Parallel policy) and the run
            # resumes from the latest checkpoint. Only a SUCCESSFUL
            # deletion advances the hash annotations.
            if self._delete_worker_pods(job):
                for sts in stale_groups:
                    sts.metadata.annotations[ANNOTATION_TEMPLATE_HASH] = \
                        _template_hash(sts.spec.template)
                    self.api.update(sts)
                self.recorder.event(
                    job, "Normal", "TPUJobResized",
                    "worker topology changed; gang restarted on the new "
                    "template")
                if self.observatory is not None:
                    # spec.resize is the user steering the gang size —
                    # it lands in the timeline as gang_resize (the
                    # resize_seconds ledger keys off it). An autoscaler
                    # decode override normally takes the LIVE path above
                    # and never reaches here; it rides along only when a
                    # user template edit forces a restart in the same
                    # sync. Every other template drift stays the plain
                    # elastic resize event
                    fields = {"replicas": alloc.worker_replicas,
                              "num_slices": alloc.num_slices}
                    if job.spec.resize is not None:
                        fields["tpus"] = job.spec.resize
                    scaled = (job.status.serving_decode_replicas
                              is not None)
                    if scaled:
                        fields["decode_replicas"] = \
                            job.status.serving_decode_replicas
                    self.observatory.note_resize(
                        job.metadata.name,
                        gang=job.spec.resize is not None or scaled,
                        **fields)
            else:
                # the restart did NOT happen this sync — the stale hash
                # annotations make the next sync retry; say so instead of
                # claiming success (a misleading Normal event here is the
                # first thing a user debugging a stuck resize would read)
                self.recorder.event(
                    job, "Warning", "TPUJobResizeRetry",
                    "worker topology changed but the gang pod deletion "
                    "failed; will retry on the next sync")
        if job.status.scaling_replica is not None:
            # crash-orphaned marker: the decode StatefulSet update landed
            # in a sync that was killed before recording/clearing (the
            # loop above saw no replica drift, so the live path never
            # re-ran). Finish the step now — note_live_scale dedupes on
            # the marker token if the record itself DID land.
            marker = job.status.scaling_replica
            body = marker.split("@", 1)[0]
            old_s, _, new_s = body[len("decode:"):].partition("->")
            try:
                self._finish_live_scale(job, int(old_s), int(new_s), marker)
            except ValueError:
                # unparseable marker (manual status edit): just clear it
                self._finish_live_scale(job, 0, 0, marker)
        return out, resized

    def _finish_live_scale(self, job: TPUJob, old: int, new: int,
                           marker: str) -> None:
        """Record one completed live decode-pool step and clear its
        status marker — the tail half of the marker-guarded sequence
        (marker write → StatefulSet update → here). Idempotent: the
        timeline record dedupes per marker token, and clearing an
        already-clear marker is a no-op — so crash replays land each
        step in the timeline exactly once."""
        up = new > old
        if self.observatory is not None and new != old:
            self.observatory.note_live_scale(
                job.metadata.name, token=marker,
                action="attach" if up else "detach",
                decode_replicas=new,
                reason=f"decode pool {old}->{new} live")
        if new != old:
            self.recorder.event(
                job, "Normal",
                "ServingLiveScaleUp" if up else "ServingLiveScaleDown",
                f"decode pool scaled {old}->{new} in place (ordinal "
                f"{'add' if up else 'remove'}; no gang restart)")
        if job.status.scaling_replica is not None:
            job.status.scaling_replica = None
            fresh = self._update_status_apply(job)
            job.metadata.resource_version = fresh.metadata.resource_version
            job.status = fresh.status

    # ------------------------------------------------------------------
    # resource constructors (ref newConfigMap etc. :849-1236)
    # ------------------------------------------------------------------

    def worker_group_names(self, job: TPUJob, num_slices: int) -> List[str]:
        """StatefulSet name per slice. Single-slice keeps the flat
        `<job>-worker`; multi-slice materializes `<job>-worker-s<k>` — one
        worker group per slice, the per-slice partitioning the reference's
        single hostfile could not express (SURVEY §7 multi-slice bootstrap;
        the hostfile-as-topology-truth analogue is mpi_job_controller.go:
        857-869)."""
        if job.spec.serving is not None:
            # disaggregated serving: the gang is two ROLE pools, not slice
            # groups — `<job>-prefill` / `<job>-decode` (SERVE_ROLES order)
            return [job.metadata.name + PREFILL_SUFFIX,
                    job.metadata.name + DECODE_SUFFIX]
        base = job.metadata.name + WORKER_SUFFIX
        if num_slices <= 1:
            return [base]
        return [f"{base}-s{k}" for k in range(num_slices)]

    def worker_pod_names(self, job: TPUJob, alloc: AllocationResult) -> List[str]:
        """All worker pod names in GLOBAL RANK ORDER (slice-major): slice k
        worker i has global worker index k*workers_per_slice + i — the
        rank derivation bootstrap.process_info applies from TPU_SLICE_ID +
        the pod ordinal. Serving role pools enumerate prefill-major (the
        coordinator is prefill pod 0)."""
        return [
            f"{group}-{i}"
            for group, size in zip(
                self.worker_group_names(job, alloc.num_slices),
                alloc.group_sizes())
            for i in range(size)
        ]

    def worker_hostnames(self, job: TPUJob, alloc: AllocationResult) -> List[str]:
        """Stable DNS names from the shared headless service (ref
        StatefulSet ServiceName :1079; hostfile lines :857-869). All slice
        groups share ONE governing Service — pod names are unique across
        groups, so `<pod>.<job>-worker.<ns>.svc` resolves for every
        slice."""
        svc = job.metadata.name + WORKER_SUFFIX
        ns = job.metadata.namespace
        return [f"{p}.{svc}.{ns}.svc"
                for p in self.worker_pod_names(job, alloc)]

    def discovery_topology(self, job: TPUJob, alloc: AllocationResult):
        """Single source of truth for the rendezvous data: the ConfigMap and
        the injected env MUST agree for workers to find each other.
        Returns (hostnames, coordinator_address, num_processes)."""
        hostnames = self.worker_hostnames(job, alloc)
        coordinator = (
            f"{hostnames[0]}:{COORDINATOR_PORT}" if hostnames
            else f"localhost:{COORDINATOR_PORT}"
        )
        num_processes = max(alloc.worker_replicas, 1) * alloc.slots_per_worker
        return hostnames, coordinator, num_processes

    def new_config_map(self, job: TPUJob, alloc: AllocationResult) -> ConfigMap:
        """The hostfile analogue (ref newConfigMap :849-885). Instead of
        `<host> slots=<n>` + a kubexec rsh script, we publish exactly what
        `jax.distributed.initialize` needs (SURVEY §2.4 TPU-native equivalent):
        coordinator address, process count, and per-worker hostnames."""
        hostnames, coordinator, num_processes = self.discovery_topology(job, alloc)
        data = {
            # newline list — greppable like the reference hostfile
            "worker-hostnames": "\n".join(hostnames) + ("\n" if hostnames else ""),
            "coordinator-address": coordinator,
            "num-processes": str(num_processes),
            "slots-per-worker": str(alloc.slots_per_worker),
            "tpus-per-worker": str(alloc.units_per_worker),
            "resource-type": alloc.resource_type,
            "num-slices": str(job.spec.num_slices),
            "workers-per-slice": str(alloc.workers_per_slice),
        }
        if alloc.serving_pools is not None:
            # role-pool partitioning, greppable like the hostfile: the
            # hostnames list above is prefill-major, so these two counts
            # split it exactly
            data["serving-prefill-replicas"] = str(alloc.serving_pools[0])
            data["serving-decode-replicas"] = str(alloc.serving_pools[1])
            # the LIVE per-pool host lists, split out explicitly. This —
            # not the worker env — is the authoritative serving topology:
            # the env lists are rendered from the spec BASELINE so a
            # decode autoscale step never drifts the template hash, and
            # this ConfigMap (updated in place, mounted at
            # CONFIG_MOUNT_PATH) is the restart-free channel that carries
            # each ±1 replica to the running fleet.
            pre = alloc.serving_pools[0]
            for key, pool in (("serving-prefill-hosts", hostnames[:pre]),
                              ("serving-decode-hosts", hostnames[pre:])):
                data[key] = "\n".join(pool) + ("\n" if pool else "")
        return ConfigMap(
            metadata=ObjectMeta(
                name=job.metadata.name + CONFIG_SUFFIX,
                namespace=job.metadata.namespace,
                labels={LABEL_GROUP: job.metadata.name},
                owner_references=[job.controller_owner_reference()],
            ),
            data=data,
        )

    def new_launcher_service_account(self, job: TPUJob) -> ServiceAccount:
        """ref: newLauncherServiceAccount (:890-901)."""
        return ServiceAccount(
            metadata=ObjectMeta(
                name=job.metadata.name + LAUNCHER_SUFFIX,
                namespace=job.metadata.namespace,
                labels={LABEL_GROUP: job.metadata.name},
                owner_references=[job.controller_owner_reference()],
            )
        )

    def new_launcher_role(self, job: TPUJob, alloc: AllocationResult) -> Role:
        """ref: newLauncherRole (:906-935). The reference grants `get pods` +
        `create pods/exec` on the named worker pods (the kubexec transport).
        TPU-native: no exec needed — the launcher only reads worker pod state
        and the discovery ConfigMap (least privilege preserved). Multi-slice:
        the named pods span every slice group."""
        pod_names = self.worker_pod_names(job, alloc)
        return Role(
            metadata=ObjectMeta(
                name=job.metadata.name + LAUNCHER_SUFFIX,
                namespace=job.metadata.namespace,
                labels={LABEL_GROUP: job.metadata.name},
                owner_references=[job.controller_owner_reference()],
            ),
            rules=[
                PolicyRule(verbs=["get", "list", "watch"], resources=["pods"],
                           resource_names=pod_names),
                PolicyRule(verbs=["get"], resources=["configmaps"],
                           resource_names=[job.metadata.name + CONFIG_SUFFIX]),
            ],
        )

    def new_launcher_role_binding(self, job: TPUJob) -> RoleBinding:
        """ref: newLauncherRoleBinding (:940-964)."""
        name = job.metadata.name + LAUNCHER_SUFFIX
        return RoleBinding(
            metadata=ObjectMeta(
                name=name,
                namespace=job.metadata.namespace,
                labels={LABEL_GROUP: job.metadata.name},
                owner_references=[job.controller_owner_reference()],
            ),
            role_name=name,
            subject_service_accounts=[name],
        )

    def new_pdb(self, job: TPUJob, worker_replicas: int) -> PodDisruptionBudget:
        """ref: newPDB (:969-986) — minAvailable = workers, the gang hint."""
        return PodDisruptionBudget(
            metadata=ObjectMeta(
                name=job.metadata.name + WORKER_SUFFIX,
                namespace=job.metadata.namespace,
                labels={LABEL_GROUP: job.metadata.name},
                owner_references=[job.controller_owner_reference()],
            ),
            min_available=worker_replicas,
        )

    def _discovery_env(self, job: TPUJob, alloc: AllocationResult,
                       is_launcher: bool) -> dict:
        """Bootstrap env (replaces OMPI_MCA_* injection, ref :1123-1131).

        Workers do NOT get an explicit TPU_WORKER_ID: the StatefulSet gives
        each pod a stable hostname `<job>-worker-<ordinal>`, and
        `mpi_operator_tpu.bootstrap` derives the worker id from that trailing
        ordinal at process start (the same way TPU-VM pods do). Kubernetes
        offers no downward-API field for the ordinal, so hostname parsing is
        the reliable channel."""
        hostnames, coordinator, num_processes = self.discovery_topology(job, alloc)
        env = {
            "TPU_JOB_NAME": job.metadata.name,
            # status-channel handshake token (bootstrap.StatusServer): the
            # job uid is unguessable-enough to keep stray connections from
            # consuming the done-linger, and identical across gang restarts
            "TPU_JOB_TOKEN": job.metadata.uid,
            "TPU_WORKER_HOSTNAMES": ",".join(
                h.split(".")[0] for h in hostnames
            ),
            "TPU_COORDINATOR_ADDRESS": coordinator,
            "TPU_NUM_PROCESSES": str(num_processes),
            "TPU_SLOTS_PER_WORKER": str(alloc.slots_per_worker),
            "TPU_CONFIG_PATH": CONFIG_MOUNT_PATH,
            "TPU_NUM_SLICES": str(job.spec.num_slices),
            "TPU_WORKERS_PER_SLICE": str(alloc.workers_per_slice),
        }
        if self.config.worker_metrics_port:
            # federation contract: workers serve /metrics + /events here
            # (lm_benchmark defaults --metrics-port from this env), and
            # the controller scrapes the same port (_observe_job)
            env["TPU_METRICS_PORT"] = str(self.config.worker_metrics_port)
        if alloc.num_slices > 1:
            # megascale-style coordinator config (SURVEY §7 "Multi-slice
            # (DCN) bootstrap"): the libtpu multislice runtime reads
            # MEGASCALE_* to form the DCN mesh; the coordinator is slice-0
            # worker-0 (per-worker MEGASCALE_SLICE_ID is injected by
            # new_worker, per worker group)
            env["MEGASCALE_NUM_SLICES"] = str(alloc.num_slices)
            env["MEGASCALE_COORDINATOR_ADDRESS"] = (
                coordinator.split(":")[0] if hostnames else "localhost")
        if is_launcher:
            env["TPU_LAUNCHER"] = "1"
        return env

    def _template_alloc(self, job: TPUJob,
                        alloc: AllocationResult) -> AllocationResult:
        """The allocation the worker TEMPLATE is rendered from. For
        serving jobs this is the USER'S spec baseline — the
        status.serving_decode_replicas override is deliberately
        excluded, so an autoscaler decode delta never drifts the
        template hash (which would gang-restart the whole fleet to add
        one replica: the cost the live-scale path exists to avoid).
        The LIVE topology still reaches every worker: new_config_map is
        rendered from the live allocation and updated in place
        (get_or_create_config_map), and the ConfigMap is mounted at
        CONFIG_MOUNT_PATH in each pod — the restart-free channel. A
        USER edit of spec.serving still drifts the template and
        restarts the gang onto the new partitioning, as before."""
        if (alloc.serving_pools is None or job.spec.serving is None
                or job.status.serving_decode_replicas is None):
            return alloc
        prefill = job.spec.serving.prefill_replicas
        decode = job.spec.serving.decode_replicas
        if alloc.serving_pools == (prefill, decode):
            return alloc
        workers = (prefill + decode if alloc.worker_replicas > 0
                   else alloc.worker_replicas)
        return replace(alloc, worker_replicas=workers,
                       serving_pools=(prefill, decode))

    def _serving_env(self, job: TPUJob, alloc: AllocationResult,
                     role: Optional[str] = None) -> dict:
        """Disaggregated-serving env (spec.serving): BOTH pools (and the
        launcher, which fronts as the request router) get the full peer
        address lists, so a prefill worker can push pages to any decode
        worker and the router can target either pool. Workers additionally
        get their own role. DNS rides the shared governing Service — pod
        names are unique across pools, exactly like multi-slice groups."""
        names = self.worker_group_names(job, alloc.num_slices)
        sizes = alloc.group_sizes()
        svc = job.metadata.name + WORKER_SUFFIX
        ns = job.metadata.namespace
        hosts = [
            ",".join(f"{names[i]}-{k}.{svc}.{ns}.svc"
                     for k in range(sizes[i]))
            for i in range(len(SERVE_ROLES))
        ]
        env = {
            SERVE_ENV_PREFILL_HOSTS: hosts[0],
            SERVE_ENV_DECODE_HOSTS: hosts[1],
            SERVE_ENV_KV_PORT: str(KV_TRANSFER_PORT),
        }
        if role is not None:
            env[SERVE_ENV_ROLE] = role
        return env

    def new_worker(self, job: TPUJob, alloc: AllocationResult,
                   slice_id: int = 0,
                   pack: Optional[PackPlan] = None) -> StatefulSet:
        """ref: newWorker (:1004-1083). Differences by design (SURVEY §7):
        workers run the actual training process (not `sleep 365d`), carry
        `google.com/tpu` limits + slice node selectors, and get the bootstrap
        env so `jax.distributed.initialize` needs zero user wiring.
        Multi-slice: one call per slice — the group's StatefulSet carries
        the slice id env its pods derive their global rank from."""
        name = self.worker_group_names(job, alloc.num_slices)[slice_id]
        # everything that rides the template (env, labels, selectors) is
        # rendered from the BASELINE allocation: a live decode-pool step
        # must move only spec.replicas, never the template hash
        env_alloc = self._template_alloc(job, alloc)
        template = api.deepcopy_obj(job.spec.template)
        container = template.main_container()
        if alloc.units_per_worker > 0:
            container.limits = dict(container.limits)
            container.limits[alloc.resource_type] = alloc.units_per_worker
        container.env = {
            **container.env,
            **self._discovery_env(job, env_alloc, is_launcher=False),
            **(pack.env() if pack is not None else {}),
        }
        if alloc.serving_pools is not None:
            # role identity + peer addresses in env: covered by the
            # template hash (like pack.env()), so a USER edit of the pool
            # split gang-restarts onto the new partitioning — while the
            # autoscaler's status override is excluded (_template_alloc)
            # and flows through the ConfigMap instead
            role = SERVE_ROLES[slice_id]
            container.env.update(
                self._serving_env(job, env_alloc, role=role))
            template.metadata.labels = {
                **template.metadata.labels, LABEL_SERVE_ROLE: role}
        if alloc.num_slices > 1:
            container.env["TPU_SLICE_ID"] = str(slice_id)
            container.env["MEGASCALE_SLICE_ID"] = str(slice_id)
        gate_opt_out = (
            job.metadata.annotations.get(ANNOTATION_HEALTH_GATE) == "false"
            or template.metadata.annotations.get(
                ANNOTATION_HEALTH_GATE) == "false")
        if (alloc.resource_type in (RESOURCE_TPU, RESOURCE_GPU)
                and not gate_opt_out):
            # accelerator-health readiness gate, TPU and GPU workers alike
            # (SURVEY §7 "Readiness vs ICI formation"): Ready must mean
            # "chips enumerate", not "container started". The bootstrap
            # writes READY_FILE only after the runtime proves its local
            # devices (bootstrap.device_check counts the cards);
            # this probe turns that into pod Readiness, which the existing
            # ReadyReplicas launcher gate (ref :503-509) then consumes —
            # so the coordinator never starts against a sick runtime.
            # File check, NOT a runtime touch: libtpu is single-owner and
            # a probe opening it would steal the training process's lock.
            # Worker images that never call the port's bootstrap
            # (mpi_operator_tpu_torch.bootstrap.initialize) must opt out
            # via the annotation above (or supply their own probe), else
            # they'd sit NotReady forever.
            container.env.setdefault(
                READINESS_ENV_FILE_KEY, READINESS_FILE_PATH)
            # expected chips are PER PROCESS: slots>1 forks slots local
            # processes per worker (bootstrap.launch) and each sees its
            # share; an indivisible split skips the count check (the
            # marker still gates on devices enumerating at all)
            if alloc.units_per_worker % alloc.slots_per_worker == 0:
                container.env.setdefault(
                    READINESS_ENV_CHIPS_KEY,
                    str(alloc.units_per_worker // alloc.slots_per_worker))
            # the probe checks the SAME path the env names — a user
            # override of TPU_READY_FILE moves both
            marker = container.env[READINESS_ENV_FILE_KEY]
            if container.readiness_probe is None:
                container.readiness_probe = {
                    "exec": {"command": [
                        "/bin/sh", "-c",
                        f"test -f {marker}"]},
                    "initialDelaySeconds": 5,
                    "periodSeconds": 10,
                    # generous: first jax/libtpu init legitimately takes
                    # tens of seconds before the marker appears
                    "failureThreshold": 60,
                }
        container.volume_mounts = container.volume_mounts + [
            {"name": CONFIG_VOLUME_NAME, "mountPath": CONFIG_MOUNT_PATH}
        ]
        template.volumes = template.volumes + [
            {"name": CONFIG_VOLUME_NAME,
             "configMap": job.metadata.name + CONFIG_SUFFIX}
        ]
        if self.config.discovery_image:
            template.init_containers = template.init_containers + [
                self._discovery_init_container()
            ]
        template.restart_policy = "Always"    # ref :1021
        if template.termination_grace_period_seconds is None:
            # preemption drain budget: k8s' 30s default SIGKILLs mid-step
            # for big states — the drain needs one step + one SYNCHRONOUS
            # emergency checkpoint (train/resilience.py). User templates
            # that set their own value win.
            template.termination_grace_period_seconds = (
                DEFAULT_TERMINATION_GRACE_SECONDS)
        if alloc.resource_type == RESOURCE_TPU:
            template.node_selector = {
                **template.node_selector,
                NS_ACCELERATOR: job.spec.accelerator_type,
            }
            topo = job.spec.slice_topology
            if topo and (job.spec.resize is not None
                         or (job.spec.elastic
                             and job.status.elastic_tpus is not None)):
                # the resized/shrunken world must not stay pinned to the
                # FULL size's topology nodepool (for an elastic shrink
                # that's exactly the capacity that's gone) — recompute
                # for the new chip count, or drop the selector if no
                # canonical shape exists
                from ..api.validation import V5E_TOPOLOGIES
                shapes = V5E_TOPOLOGIES.get(
                    env_alloc.worker_replicas * env_alloc.units_per_worker)
                topo = shapes[0] if shapes else None
            if topo:
                template.node_selector[NS_TOPOLOGY] = topo
        template.metadata.labels = {
            **template.metadata.labels, LABEL_GROUP: job.metadata.name,
            "tpu_job_role": "worker",     # headless Service selector target
        }
        if alloc.num_slices > 1:
            template.metadata.labels["tpu_job_slice"] = str(slice_id)
        # the template-hash annotation marks which template the pods were
        # last started on (fresh sets: this one); the resize gang-restart
        # triggers whenever it trails the desired template
        return StatefulSet(
            metadata=ObjectMeta(
                name=name,
                namespace=job.metadata.namespace,
                labels={LABEL_GROUP: job.metadata.name},
                annotations={
                    ANNOTATION_TEMPLATE_HASH: _template_hash(template)},
                owner_references=[job.controller_owner_reference()],
            ),
            spec=StatefulSetSpec(
                replicas=alloc.group_sizes()[slice_id],
                # ALL slice groups share the base governing Service so
                # every pod resolves as <pod>.<job>-worker.<ns>.svc —
                # stable DNS (ref :1079) without per-slice Services
                service_name=job.metadata.name + WORKER_SUFFIX,
                pod_management_policy="Parallel",       # ref :1074
                # resize = explicit gang restart, never a Ready-gated
                # one-at-a-time roll (which deadlocks on the full-world
                # rendezvous); see get_or_create_worker_statefulsets
                update_strategy="OnDelete",
                template=template,
            ),
        )

    def _delete_worker_pods(self, job: TPUJob) -> bool:
        """Gang-delete this job's worker pods (resize semantics: all pods
        must restart together onto the new template — OnDelete strategy,
        see get_or_create_worker_statefulsets). Returns success; a False
        return leaves the template-hash annotations stale so the caller
        RETRIES on the next sync (under OnDelete nothing else would ever
        replace the old pods)."""
        try:
            pods = self.api.list(
                "Pod", job.metadata.namespace,
                label_selector=f"{LABEL_GROUP}={job.metadata.name},"
                               f"tpu_job_role=worker")
            for pod in pods:
                self._delete_ignore_missing("Pod", pod.metadata.namespace,
                                            pod.metadata.name)
            return True
        except Exception as exc:  # noqa: BLE001
            logger.warning("gang pod deletion failed (will retry): %s", exc)
            return False

    def _discovery_init_container(self) -> Container:
        """The discovery init step (discovery/Dockerfile, replacing the
        reference's kubectl-delivery, ref :1106-1121): blocks until every
        worker hostname in the ConfigMap resolves, so neither the workers'
        rendezvous nor the launcher's status poll burns its own connect
        timeout on cold StatefulSet DNS."""
        return Container(
            name="discovery",
            image=self.config.discovery_image,
            env={"TPU_CONFIG_PATH": CONFIG_MOUNT_PATH,
                 "DISCOVERY_TIMEOUT":
                 str(self.config.discovery_timeout_seconds)},
            volume_mounts=[{"name": CONFIG_VOLUME_NAME,
                            "mountPath": CONFIG_MOUNT_PATH}],
        )

    def new_launcher(self, job: TPUJob, alloc: AllocationResult,
                     pack: Optional[PackPlan] = None) -> Job:
        """ref: newLauncher (:1088-1236). No kubectl-delivery init container
        (ref :1106-1121) and no OMPI_MCA_* env (ref :1123-1131): the launcher
        is a thin coordinator / rank-0 process bootstrapped by the same env
        the workers get. It remains the completion signal."""
        name = job.metadata.name + LAUNCHER_SUFFIX
        template = api.deepcopy_obj(job.spec.template)
        container = template.main_container()
        container.env = {
            **container.env,
            **self._discovery_env(job, alloc, is_launcher=True),
            **(pack.env() if pack is not None else {}),
        }
        if alloc.serving_pools is not None:
            # the launcher is the serving frontend/router: it needs both
            # pools' addresses but belongs to neither
            container.env.update(self._serving_env(job, alloc))
        container.volume_mounts = container.volume_mounts + [
            {"name": CONFIG_VOLUME_NAME, "mountPath": CONFIG_MOUNT_PATH}
        ]
        template.volumes = template.volumes + [
            {"name": CONFIG_VOLUME_NAME,
             "configMap": job.metadata.name + CONFIG_SUFFIX}
        ]
        if self.config.discovery_image:
            template.init_containers = template.init_containers + [
                self._discovery_init_container()
            ]
        if job.spec.launcher_on_master:
            # ref types.go:90-94 (launcherOnMaster — declared by the
            # reference, reconciled only here): pin the thin coordinator to a
            # control-plane node and tolerate its taint. Workers are
            # unaffected — they must land on TPU nodes.
            template.node_selector = {
                **template.node_selector,
                "node-role.kubernetes.io/control-plane": "",
            }
            template.tolerations = template.tolerations + [
                {"key": "node-role.kubernetes.io/control-plane",
                 "operator": "Exists", "effect": "NoSchedule"},
            ]
        # OnFailure, not Never (ref :1175-1177): with Never, the batch Job
        # controller increments status.failed on the FIRST pod failure, which
        # our done-check (sync_handler) would read as terminal — backoffLimit
        # would never get a retry. OnFailure retries in place; failed only
        # goes >0 once retries are exhausted.
        template.restart_policy = "OnFailure"
        template.metadata.labels = {
            **template.metadata.labels, LABEL_GROUP: job.metadata.name,
        }
        backoff = (
            job.spec.backoff_limit
            if job.spec.backoff_limit is not None
            else api.DEFAULT_BACKOFF_LIMIT       # ref :1059-1062
        )
        return Job(
            metadata=ObjectMeta(
                name=name,
                namespace=job.metadata.namespace,
                labels={LABEL_GROUP: job.metadata.name},
                owner_references=[job.controller_owner_reference()],
            ),
            spec=JobSpec(
                template=template,
                backoff_limit=backoff,
                active_deadline_seconds=job.spec.active_deadline_seconds,  # ref :1221-1222
            ),
        )

    def _worker_crash_delta(self, job: TPUJob):
        """NEW worker crashes since the last sync: positive per-pod deltas
        of kubelet restart counts (keyed by pod uid, so a recreated pod's
        counter reset never hides its fresh crashes) plus newly-Failed
        pods. Returns (delta, pending_marks) where pending_marks is the
        (key, baselines) the caller commits AFTER its status write lands,
        or None when there is nothing to commit. Best-effort: a backend
        without pod-read access (or no pods yet) reports 0 rather than
        failing the sync. The reference can't see this at all — its
        workers are `sleep` landing pads whose health is irrelevant; ours
        run the training process, so a crash-looping worker means the job
        is sick even while every StatefulSet counter looks green."""
        try:
            pods = self.api.list(
                "Pod", job.metadata.namespace,
                label_selector=f"{LABEL_GROUP}={job.metadata.name},"
                               f"tpu_job_role=worker")
        except Exception as exc:  # noqa: BLE001 — observability only
            logger.debug("worker pod list failed: %s", exc)
            return 0, None
        key = (job.metadata.namespace, job.metadata.name)
        marks = self._worker_restart_marks.get(key)
        if marks is None:
            # first observation of this job (fresh controller process):
            # adopt current counts as the baseline WITHOUT a delta — an
            # operator restart must not re-count historical restarts into
            # .failed (the persisted total already carries them)
            self._worker_restart_marks[key] = {
                (p.metadata.uid or p.metadata.name):
                (p.status.restart_count, p.status.phase) for p in pods}
            return 0, None
        delta = 0
        new_marks = {}
        for pod in pods:
            uid = pod.metadata.uid or pod.metadata.name
            seen, seen_phase = marks.get(uid, (0, ""))
            now_count = pod.status.restart_count
            if now_count > seen:
                delta += now_count - seen
            phase = pod.status.phase
            if phase == "Failed" and seen_phase != "Failed":
                delta += 1
            new_marks[uid] = (max(now_count, seen), phase)
        # new_marks also PRUNES: a recreated pod gets a new uid, so absent
        # uids never return — keeping them would leak across pod churn.
        # The caller commits new_marks only after the status write lands
        # (a failed update must not consume the observed crashes).
        return delta, (key, new_marks)

    # ------------------------------------------------------------------
    # status (ref updateMPIJobStatus :761-791) + v1alpha2 conditions
    # ------------------------------------------------------------------

    def update_tpu_job_status(
        self, job: TPUJob, launcher: Optional[Job],
        workers: List[Optional[StatefulSet]],
    ) -> None:
        import time as _time

        # NEVER mutate the lister's copy (ref DeepCopy note :762-765) — our
        # listers already hand out copies, so mutate-and-update is safe.
        changed = False
        if launcher is not None:
            if launcher.status.active > 0:
                new = LAUNCHER_ACTIVE
            elif launcher.succeeded():
                new = LAUNCHER_SUCCEEDED
            elif launcher.failed():
                new = LAUNCHER_FAILED
            else:
                new = job.status.launcher_status
            if new != job.status.launcher_status:
                job.status.launcher_status = new
                changed = True
                now = _time.time()
                if new == LAUNCHER_ACTIVE:
                    if job.status.start_time is None:
                        job.status.start_time = launcher.status.start_time or now
                    job.status.set_condition(api.JobCondition(
                        COND_RUNNING, "True", "TPUJobRunning",
                        f"launcher {launcher.metadata.name} is active"))
                elif new == LAUNCHER_SUCCEEDED:
                    job.status.completion_time = (
                        launcher.status.completion_time or now)
                    job.status.set_condition(api.JobCondition(
                        COND_SUCCEEDED, "True", "TPUJobSucceeded",
                        f"launcher {launcher.metadata.name} completed"))
                    if self.observatory is not None:
                        self.observatory.note_terminal(
                            job.metadata.name, succeeded=True)
                elif new == LAUNCHER_FAILED:
                    job.status.completion_time = (
                        launcher.status.completion_time or now)
                    job.status.set_condition(api.JobCondition(
                        COND_FAILED, "True", "TPUJobFailed",
                        f"launcher {launcher.metadata.name} failed"))
                    if self.observatory is not None:
                        self.observatory.note_terminal(
                            job.metadata.name, succeeded=False,
                            exit_code=launcher.status.exit_code)
        if job.status.get_condition(COND_CREATED) is None:
            job.status.set_condition(api.JobCondition(
                COND_CREATED, "True", "TPUJobCreated", "TPUJob resources created"))
            changed = True
            if self.observatory is not None:
                self.observatory.note_created(
                    job.metadata.name, namespace=job.metadata.namespace,
                    tpus=job.spec.tpus)

        ready = sum(w.status.ready_replicas for w in workers if w is not None)
        if ready != job.status.worker_replicas:       # ref :780-786
            job.status.worker_replicas = ready
            changed = True

        # per-replica counts (v1alpha2 ReplicaStatus, common_types.go:68-80 —
        # defined by the reference, reconciled only here): the launcher Job's
        # own active/succeeded/failed, and the worker StatefulSet's
        # ready(=active) replicas. Worker pods never "succeed" — they are
        # long-lived training processes scaled to 0 on completion.
        if launcher is not None:
            launcher_rs = api.ReplicaStatus(
                active=launcher.status.active,
                succeeded=launcher.status.succeeded,
                failed=launcher.status.failed,
            )
        elif job.status.is_done():
            # launcher Job deleted after completion (CleanPodPolicy "All"):
            # keep the recorded terminal counts instead of flapping to 0
            launcher_rs = job.status.replica_statuses.get(
                "launcher", api.ReplicaStatus())
        else:
            launcher_rs = api.ReplicaStatus()
        # Worker failures are otherwise invisible (RestartPolicy=Always:
        # kubelet resurrects crashed workers in place, so the StatefulSet
        # always looks healthy). Read the worker pods and accumulate crash
        # events into ReplicaStatus.failed (v1alpha2 common_types.go:68-80)
        # — a true cumulative history: per-pod restart-count deltas survive
        # pod recreation (counter resets) because marks key on pod uid.
        # Terminal jobs stop paying the pod LIST.
        prev_failed = job.status.replica_statuses.get(
            "worker", api.ReplicaStatus()).failed
        pending_marks = None
        if any(w is not None for w in workers) and not job.status.is_done():
            delta, pending_marks = self._worker_crash_delta(job)
        else:
            delta = 0
            # terminal: drop the delta baseline (bounded memory — the
            # recorded .failed total lives on in status); the elastic
            # timers too (a terminal job never reconciles elastically)
            jkey = (job.metadata.namespace, job.metadata.name)
            self._worker_restart_marks.pop(jkey, None)
            if job.status.is_done():
                self._not_ready_since.pop(jkey, None)
                self._elastic_ready_since.pop(jkey, None)
                self._autoscalers.pop(jkey, None)
        worker_failed = prev_failed + delta
        if delta > 0 and worker_failed >= 2:
            # repeated restarts = crash loop; one Warning per escalation
            # (the Events correlator aggregates repeats into count bumps)
            self.recorder.event(
                job, "Warning", "WorkerCrashLoop",
                "worker pods are crash-looping; check "
                "`kubectl logs` on the worker StatefulSet")
        desired = {
            "launcher": launcher_rs,
            "worker": api.ReplicaStatus(active=ready, failed=worker_failed),
        }
        if job.status.replica_statuses != desired:
            job.status.replica_statuses = desired
            changed = True

        if changed:
            # /status subresource, NOT full-object Update: our CRD enables
            # the status subresource (deploy/0-crd.yaml), so a real API
            # server STRIPS .status from plain PUTs — the reference could
            # use full Update (ref :789) only because its v1beta1 CRD
            # predates subresources.
            self._update_status_apply(job)
        # commit the crash baselines only now: if the status write above
        # raised (409 against a real server), the observed deltas stay
        # unconsumed and the requeued sync re-counts them
        if pending_marks is not None:
            key, new_marks = pending_marks
            self._worker_restart_marks[key] = new_marks


__all__ = [
    "TPUJobController", "ControllerConfig", "AllocationResult",
    "EventRecorder", "Event", "ForeignOwnershipError",
    "CONFIG_SUFFIX", "LAUNCHER_SUFFIX", "WORKER_SUFFIX",
    "PREFILL_SUFFIX", "DECODE_SUFFIX", "SERVE_ROLES",
    "LABEL_SERVE_ROLE", "KV_TRANSFER_PORT",
    "CONFIG_MOUNT_PATH", "COORDINATOR_PORT", "LABEL_GROUP",
]
