"""TPUJob API types — the resource users submit to run allreduce-style
distributed training on TPU slices.

This is the TPU-native analogue of the reference MPIJob CRD. It merges the
*served* v1alpha1 surface (reference pkg/apis/kubeflow/v1alpha1/types.go:25-130)
with the strictly-richer v1alpha2 status/condition model (reference
pkg/apis/kubeflow/v1alpha2/common_types.go:23-156), because the latter is the
direction the reference was heading (it defines but never reconciles it).

Key translation decisions (see SURVEY.md §7):
  - ``gpus`` / ``gpusPerNode`` / ``nvidia.com/gpu``  →  ``tpus`` /
    ``tpusPerWorker`` / ``google.com/tpu`` with v5e slice-shape validation.
  - hostfile + ``slots=``                            →  worker-hostnames
    discovery data consumed by ``jax.distributed.initialize``.
  - launcher runs ``mpirun``                         →  launcher is a thin
    coordinator (rank 0); workers run the training process directly.

Everything is a plain frozen-ish dataclass: the in-memory API server
(`mpi_operator_tpu.cluster`) stores deep copies, exactly as the reference's
client-go caches require DeepCopy-before-mutate
(mpi_job_controller.go:762-765).

The PyTorch port's copy of mpi_operator_tpu/api/types.py, with the
reference's own resource type `nvidia.com/gpu` (RESOURCE_GPU) beside the
TPU and CPU ones.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# ---------------------------------------------------------------------------
# Constants mirroring the reference's well-known strings
# ---------------------------------------------------------------------------

GROUP_NAME = "tpu.kubeflow.org"          # ref: pkg/apis/kubeflow/v1alpha1/register.go:23-27
API_VERSION = "v1alpha1"
KIND = "TPUJob"
PLURAL = "tpujobs"

# Processing-resource types (ref types.go:64-69 uses nvidia.com/gpu|cpu).
RESOURCE_TPU = "google.com/tpu"
RESOURCE_CPU = "cpu"
# the reference's own type: an NVIDIA GPU worker (the port's default)
RESOURCE_GPU = "nvidia.com/gpu"

DEFAULT_BACKOFF_LIMIT = 6                # ref types.go:79-83 (OnFailure default 6)
DEFAULT_SLOTS_PER_WORKER = 1             # ref mpi_job_controller.go:861-868

# Valid single-slice chip counts for v5e (host granularity 4 chips; slices of
# 1/2/4 are sub-host). The reference CRD constrains gpus to 1,2,4 or multiples
# of 8 via openAPIV3 oneOf (deploy/0-crd.yaml:27-35); on TPU the analogous
# admission rule is "a valid slice shape", which we enforce at validation time
# rather than at runtime (SURVEY.md §7 "Hard parts").
V5E_VALID_SLICE_CHIPS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


# ---------------------------------------------------------------------------
# Object metadata (apimachinery-equivalent, minimal)
# ---------------------------------------------------------------------------

@dataclass
class OwnerReference:
    """ref: metav1.OwnerReference as set by NewControllerRef
    (mpi_job_controller.go:876-878 and six sibling sites)."""
    api_version: str
    kind: str
    name: str
    uid: str
    controller: bool = True
    block_owner_deletion: bool = True


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    resource_version: int = 0
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    owner_references: List[OwnerReference] = field(default_factory=list)
    creation_timestamp: Optional[float] = None
    deletion_timestamp: Optional[float] = None

    def controller_ref(self) -> Optional[OwnerReference]:
        for ref in self.owner_references:
            if ref.controller:
                return ref
        return None


def is_controlled_by(obj_meta: ObjectMeta, owner_meta: ObjectMeta) -> bool:
    """ref: metav1.IsControlledBy — ownership checks guard every getOrCreate*
    (e.g. mpi_job_controller.go:641-645)."""
    ref = obj_meta.controller_ref()
    return ref is not None and ref.uid == owner_meta.uid


# ---------------------------------------------------------------------------
# Pod template (simplified PodTemplateSpec)
# ---------------------------------------------------------------------------

@dataclass
class Container:
    name: str = "tpu"
    image: str = ""
    command: List[str] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)
    # resource limits, keyed by resource name (e.g. "google.com/tpu": 4)
    limits: Dict[str, int] = field(default_factory=dict)
    requests: Dict[str, int] = field(default_factory=dict)
    volume_mounts: List[Dict[str, str]] = field(default_factory=list)
    # wire-format core/v1 Probe dict ({exec|httpGet, periodSeconds, ...});
    # the controller injects the TPU-health readiness gate here
    readiness_probe: Optional[Dict] = None

    def copy(self) -> "Container":
        return copy.deepcopy(self)


@dataclass
class PodTemplateSpec:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    containers: List[Container] = field(default_factory=lambda: [Container()])
    init_containers: List[Container] = field(default_factory=list)
    restart_policy: str = "OnFailure"
    node_selector: Dict[str, str] = field(default_factory=dict)
    volumes: List[Dict[str, str]] = field(default_factory=list)
    # wire-format toleration dicts ({key, operator, effect, ...}); used by
    # launcherOnMaster to tolerate the control-plane taint
    tolerations: List[Dict[str, str]] = field(default_factory=list)
    # SIGTERM→SIGKILL budget: must cover one training step PLUS the
    # synchronous emergency checkpoint the drain path writes (None =
    # cluster default, k8s' 30s — usually too short for large states)
    termination_grace_period_seconds: Optional[int] = None

    def main_container(self) -> Container:
        if not self.containers:
            raise ValueError("pod template has no containers")
        return self.containers[0]


# ---------------------------------------------------------------------------
# TPUJob spec — sizing modes mirror v1alpha1 (ref types.go:36-100)
# ---------------------------------------------------------------------------

@dataclass
class ServingSLO:
    """Latency/backlog targets for SLO-driven decode autoscaling
    (controller/autoscale.py). All targets are federated job-level
    observations (telemetry/collector.py): ``ttft_p99_seconds`` and
    ``tpot_p99_seconds`` against the ``tpu_job_ttft_seconds`` /
    ``tpu_job_tpot_seconds`` histogram p99s, ``queue_depth`` against
    the summed ``tpu_job_queue_depth`` gauge. A target left None is
    not evaluated; at least one must be set.

    Breaches must PERSIST for ``breach_seconds`` before a scale-up, and
    the fleet must run clear for ``clear_seconds`` before a scale-down
    — and every decision additionally waits out a cooldown of
    ``cooldown_multiplier`` x the last observed gang-resize cost (the
    resize ledger's total_seconds; ``cooldown_floor_seconds`` before
    any resize has been measured), so scaling can never thrash faster
    than resizes actually complete."""
    ttft_p99_seconds: Optional[float] = None
    tpot_p99_seconds: Optional[float] = None
    queue_depth: Optional[float] = None
    min_decode_replicas: int = 1
    max_decode_replicas: int = 8
    breach_seconds: float = 60.0
    clear_seconds: float = 300.0
    cooldown_multiplier: float = 4.0
    cooldown_floor_seconds: float = 120.0


@dataclass
class ServingSpec:
    """Disaggregated-serving role pools (serve/engine.py DisaggEngine).

    The reference's core trick is materializing heterogeneous pod roles
    (launcher vs worker) from ONE job spec; this extends the same move to
    the serving plane: the worker gang splits into a PREFILL pool and a
    DECODE pool, each its own StatefulSet with `TPU_SERVE_ROLE` and peer
    addresses in env (covered by the template hash, so role/count changes
    are an ordinary level-triggered gang restart). The pool sizes must sum
    to the worker replica count the sizing mode derives — serving
    re-partitions the gang, it does not resize it (the autoscaler's
    decode override rides STATUS, never this spec).

    ``slo``: optional autoscaling targets; when set, the controller's
    autoscale pass adjusts the EFFECTIVE decode pool between
    min/max_decode_replicas via status.serving_decode_replicas —
    ``decode_replicas`` here stays the user's baseline."""
    prefill_replicas: int = 1
    decode_replicas: int = 1
    slo: Optional[ServingSLO] = None


@dataclass
class TPUJobSpec:
    """Exactly one of (tpus, processing_units, replicas) must be set — the
    reference enforces this with an openAPIV3 oneOf (deploy/0-crd.yaml:16-99);
    we enforce it in api.validation.validate_spec.

    Mode A ("auto-allocation", ref mpi_job_controller.go:547-582): the user
    gives a total chip count; the controller divides by the per-worker count
    to get the worker replica count.

    Mode B ("custom", ref mpi_job_controller.go:584-593): the user gives an
    explicit replica count and puts per-worker resource limits on the pod
    template's container.
    """
    # --- Mode A: total accelerator count -----------------------------------
    tpus: Optional[int] = None                 # ref: spec.gpus (types.go:38-44)
    tpus_per_worker: Optional[int] = None      # ref: spec.gpusPerNode (types.go:46-50)
    # generic processing-unit surface (ref types.go:52-69)
    processing_units: Optional[int] = None
    processing_units_per_worker: Optional[int] = None
    processing_resource_type: Optional[str] = None   # RESOURCE_GPU | _TPU | _CPU
    # --- Mode B: explicit replicas -----------------------------------------
    replicas: Optional[int] = None             # ref: types.go:96-100

    # ranks per worker written into discovery data (ref: slotsPerWorker,
    # types.go:71-74; hostfile "slots=" mpi_job_controller.go:857-869). On TPU
    # this is processes-per-host (usually 1 process driving all local chips).
    slots_per_worker: Optional[int] = None

    # TPU slice topology hint, e.g. "4x8" for v5e-32. Optional; used for node
    # selectors in the worker set. (TPU-native extension; SURVEY.md §7.)
    slice_topology: Optional[str] = None
    # Accelerator generation for node selection, e.g. "v5litepod".
    accelerator_type: str = "v5litepod"
    # Number of slices (multi-slice DCN training; 1 = single slice).
    num_slices: int = 1

    # run the launcher on the master/control node (ref types.go:90-94)
    launcher_on_master: bool = False

    # failure semantics (ref types.go:76-88; precedence documented there:
    # activeDeadlineSeconds takes precedence over backoffLimit)
    backoff_limit: Optional[int] = None
    active_deadline_seconds: Optional[int] = None

    # progress lease (stuck-gang detection; no reference analogue): if a
    # Running job's federated step frontier (max tpu_worker_step /
    # last_checkpoint_step over the worker scrapes) advances by ZERO for
    # this many seconds — a hung host, stalled ICI, or every scrape gone
    # stale — the controller records a StuckGang condition, emits a
    # gang_stuck event, and takes the ordinary restart-policy path
    # (counted against backoffLimit). None (default) disables the lease;
    # it needs the observatory scraping worker metrics to mean anything.
    progress_deadline_seconds: Optional[int] = None

    # gang scheduling opt-in recorded per job (operator flag in the reference,
    # cmd/mpi-operator/main.go:112-113)
    gang_scheduling: bool = False

    # the worker pod template (ref types.go:99 Template)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)

    # clean-pod policy from v1alpha2 (ref v1alpha2/types.go:55-66):
    # "Running" | "All" | "None". The v1alpha1 controller behaves like
    # "Running" (workers scaled to 0 on done, mpi_job_controller.go:594-596).
    # "All" additionally deletes the finished launcher Job; "None" keeps
    # the worker set running after completion.
    clean_pod_policy: str = "Running"

    # gang-restart policy for a FAILED launcher (v1alpha2 RestartPolicy,
    # ref common_types.go:131-156 — specified there, implemented nowhere):
    #   "Never"     — a failed launcher Job is terminal (v1alpha1 behavior;
    #                 the Job's own backoffLimit already retried in place)
    #   "OnFailure" — always recreate the launcher (the gang restarts)
    #   "ExitCode"  — recreate only for retryable codes (128-255, e.g.
    #                 SIGKILL'd / infra loss); 1-127 are permanent failures
    restart_policy: str = "Never"

    # Elastic membership, TPU-idiomatically (no strategy in the reference,
    # SURVEY §2.3): XLA program shapes are fixed per topology, so
    # elasticity is CHECKPOINT-RESTART elasticity — when workers are
    # persistently unavailable the controller shrinks the job to the next
    # valid v5e chip count (recorded in status.elastic_tpus, never by
    # editing the user's spec), gang-restarts onto it, and training
    # resumes from the latest checkpoint; once the shrunken world has run
    # for a recovery window it tries the full spec size again. Mode A
    # (tpus) single-slice only.
    elastic: bool = False
    # smallest chip count the controller may shrink to (default: any
    # valid v5e size down to 1 chip)
    min_tpus: Optional[int] = None

    # User-driven gang resize (the imperative cousin of `elastic`):
    # editing spec.resize to a valid v5e chip count reallocates the gang
    # at that size — drain (stop bit -> emergency checkpoint -> exit
    # 215) -> StatefulSet rescale -> re-bootstrap at the new world size,
    # training resumed from the drained checkpoint via resharding
    # restore (train/checkpoint.py restore_resharded). None = run at
    # spec.tpus. Mode A (tpus) single-slice only; mutually exclusive
    # with elastic / serving / pack_group.
    resize: Optional[int] = None

    # Job packing opt-in (controller/packing.py): jobs sharing a
    # (namespace, pack_group) whose resource shape matches are fused onto
    # ONE shared worker gang — the oldest member leads and owns the pods;
    # the rest get a "Packed" condition naming the leader. None (default)
    # keeps the ordinary one-job-one-gang behavior.
    pack_group: Optional[str] = None

    # Disaggregated-serving role pools (ServingSpec): when set, the worker
    # gang is partitioned into `<job>-prefill` / `<job>-decode`
    # StatefulSets instead of the flat worker group. Single-slice only;
    # mutually exclusive with elastic and pack_group (each rewrites the
    # worker topology its own way).
    serving: Optional[ServingSpec] = None

    # Fleet-scheduler priority (controller/scheduler.py): when the
    # controller runs with a bounded slice pool (ControllerConfig.
    # sched_pool_chips), jobs that do not fit are queued (a Queued
    # condition) ordered by descending priority then creation time, and
    # a higher-priority pending job may shrink a LOWER-priority elastic
    # gang (status.sched_tpus, the elastic_tpus status-override
    # discipline) to get admitted — grown back once slices free. 0 (the
    # default) is the lowest priority; must be >= 0.
    priority: int = 0


# ---------------------------------------------------------------------------
# Status — v1alpha2 condition model (ref common_types.go:23-156)
# ---------------------------------------------------------------------------

# ref common_types.go:101-127
COND_CREATED = "Created"
COND_RUNNING = "Running"
COND_RESTARTING = "Restarting"
COND_SUCCEEDED = "Succeeded"
COND_FAILED = "Failed"
# beyond the reference: True while elastic shrink has the job running
# below its spec size (status.elastic_tpus set)
COND_DEGRADED = "Degraded"
# beyond the reference: True while the progress lease
# (spec.progressDeadlineSeconds) has expired with zero observed step
# progress; flipped False with reason ProgressResumed once the federated
# step frontier moves again
COND_STUCK = "StuckGang"
# beyond the reference: True while SOME worker ranks are unreachable to
# the collector but the reachable remainder's progress frontier still
# advances — a partial partition / scrape flakiness, observed but NOT
# acted on (no restart; the StuckGang lease handles genuine stalls).
# Flipped False with reason PartitionHealed once every rank scrapes
# again. Distinct from COND_DEGRADED, which is the elastic-shrink state.
COND_DEGRADED_GANG = "DegradedGang"
# beyond the reference (fleet scheduler): True while the job is held in
# the admission queue because the slice pool cannot fit it; flipped
# False with reason SchedAdmit when capacity (possibly reclaimed by a
# preemption) admits it. The True transition time is the queue-wait
# anchor the scheduler's cost gate measures against.
COND_QUEUED = "Queued"
# beyond the reference (fleet scheduler): True while the scheduler has
# this elastic gang shrunk below its own entitlement to serve a
# higher-priority job (status.sched_tpus set); the message names the
# beneficiary. Flipped False with reason SchedGrowBack when the gang is
# restored to full size.
COND_PREEMPTED = "Preempted"

# v1alpha1 launcher status surface kept for parity (ref types.go:102-116)
LAUNCHER_ACTIVE = "Active"
LAUNCHER_SUCCEEDED = "Succeeded"
LAUNCHER_FAILED = "Failed"


@dataclass
class JobCondition:
    """ref: common_types.go:24-48."""
    type: str
    status: str = "True"              # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_update_time: float = field(default_factory=time.time)
    last_transition_time: float = field(default_factory=time.time)


@dataclass
class ReplicaStatus:
    """ref: common_types.go:68-80."""
    active: int = 0
    succeeded: int = 0
    failed: int = 0


@dataclass
class TPUJobStatus:
    """Merged v1alpha1 (launcher_status/worker_replicas, ref types.go:102-130)
    + v1alpha2 (conditions/replica_statuses, ref common_types.go:50-66)."""
    launcher_status: Optional[str] = None       # LAUNCHER_* (v1alpha1 surface)
    worker_replicas: int = 0                    # ready workers (types.go:124-126)
    conditions: List[JobCondition] = field(default_factory=list)
    replica_statuses: Dict[str, ReplicaStatus] = field(default_factory=dict)
    start_time: Optional[float] = None
    completion_time: Optional[float] = None
    # controller-level gang restarts performed (restart_policy != "Never")
    restart_count: int = 0
    # elastic membership (spec.elastic): the chip count the job currently
    # runs at when shrunk below spec.tpus, and when that shrink decision
    # was made. elastic_since is OBSERVABILITY ONLY (kubectl shows when
    # the job degraded): the restore countdown arms at the shrunken
    # gang's first Ready observation, tracked in controller memory
    # (TPUJobController._elastic_ready_since). None = full size.
    elastic_tpus: Optional[int] = None
    elastic_since: Optional[float] = None
    # SLO-driven decode autoscaling (spec.serving.slo): the EFFECTIVE
    # decode-pool size when it differs from spec.serving.decodeReplicas,
    # plus when the last scaling decision landed (the controller's
    # cooldown reference). Same status-override discipline as
    # elastic_tpus: the controller NEVER edits the user's spec — the
    # allocation path reads this override and resizes the gang through
    # the ordinary template-hash restart. None = run at the spec size.
    serving_decode_replicas: Optional[int] = None
    serving_scaled_at: Optional[float] = None
    # in-flight live decode-pool scale step (the surgical path: only the
    # decode StatefulSet's replica count moves, no gang restart). The
    # marker "decode:<old>-><new>" is written BEFORE the StatefulSet
    # update — the migrated_window discipline — so a controller crash
    # between the two replays cleanly: the replay re-derives the same
    # marker string, the StatefulSet update is idempotent, and the
    # live_scale timeline record dedupes on the marker as its token
    # (collector.note_live_scale). Cleared once the step is recorded.
    scaling_replica: Optional[str] = None
    # fleet scheduler (controller/scheduler.py): the chip count a
    # preempted elastic gang currently runs at (same status-override
    # discipline as elastic_tpus — the spec is never edited; the
    # allocation path takes min(elastic_tpus, sched_tpus) when both
    # overrides are live), and when the last scheduler action against
    # this job landed (the grow-back cooldown reference).
    sched_tpus: Optional[int] = None
    sched_scaled_at: Optional[float] = None
    # degraded-rank pod migrations performed (dark pod deleted so the
    # StatefulSet reschedules it) — counted DISTINCTLY from gang
    # restarts: a migration never tears the gang down and never charges
    # backoffLimit. migrated_window is the idempotency marker: the
    # DegradedGang window id ("<transition_ts>:<pod_uid>") already
    # migrated, so crash replays within one window never delete twice.
    migration_count: int = 0
    migrated_window: Optional[str] = None

    # -- condition helpers (ref: v1alpha2 intent; pkg has no impl) ----------
    def get_condition(self, cond_type: str) -> Optional[JobCondition]:
        for c in self.conditions:
            if c.type == cond_type:
                return c
        return None

    def set_condition(self, cond: JobCondition) -> None:
        """Last-writer-wins per type; terminal conditions (Succeeded/Failed)
        flip Running to False, mirroring common job-controller semantics."""
        now = time.time()
        existing = self.get_condition(cond.type)
        if existing is not None:
            if existing.status != cond.status or existing.reason != cond.reason:
                cond.last_transition_time = now
            else:
                cond.last_transition_time = existing.last_transition_time
            self.conditions = [c for c in self.conditions if c.type != cond.type]
        self.conditions.append(cond)
        if cond.type in (COND_SUCCEEDED, COND_FAILED) and cond.status == "True":
            run = self.get_condition(COND_RUNNING)
            if run is not None and run.status == "True":
                run.status = "False"
                run.last_transition_time = now

    def is_done(self) -> bool:
        for t in (COND_SUCCEEDED, COND_FAILED):
            c = self.get_condition(t)
            if c is not None and c.status == "True":
                return True
        return False


# ---------------------------------------------------------------------------
# The TPUJob resource
# ---------------------------------------------------------------------------

@dataclass
class TPUJob:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: TPUJobSpec = field(default_factory=TPUJobSpec)
    status: TPUJobStatus = field(default_factory=TPUJobStatus)
    kind: str = KIND
    api_version: str = f"{GROUP_NAME}/{API_VERSION}"

    def deepcopy(self) -> "TPUJob":
        return copy.deepcopy(self)

    def controller_owner_reference(self) -> OwnerReference:
        """ref: NewControllerRef sites (mpi_job_controller.go:876-878 etc.)."""
        return OwnerReference(
            api_version=self.api_version,
            kind=self.kind,
            name=self.metadata.name,
            uid=self.metadata.uid,
        )


def new_tpu_job(name: str, namespace: str = "default", **spec_kwargs) -> TPUJob:
    """Convenience constructor used by tests and examples."""
    return TPUJob(
        metadata=ObjectMeta(name=name, namespace=namespace),
        spec=TPUJobSpec(**spec_kwargs),
    )


# dataclasses are mutable; provide a module-level deepcopy util the cluster
# layer uses for store round-trips.
def deepcopy_obj(obj):
    return copy.deepcopy(obj)


__all__ = [
    "GROUP_NAME", "API_VERSION", "KIND", "PLURAL",
    "RESOURCE_TPU", "RESOURCE_CPU", "RESOURCE_GPU",
    "DEFAULT_BACKOFF_LIMIT", "DEFAULT_SLOTS_PER_WORKER",
    "V5E_VALID_SLICE_CHIPS",
    "OwnerReference", "ObjectMeta", "is_controlled_by",
    "Container", "PodTemplateSpec",
    "ServingSLO", "ServingSpec", "TPUJobSpec", "JobCondition",
    "ReplicaStatus",
    "TPUJobStatus", "TPUJob",
    "COND_CREATED", "COND_RUNNING", "COND_RESTARTING", "COND_SUCCEEDED",
    "COND_FAILED", "COND_DEGRADED", "COND_STUCK", "COND_DEGRADED_GANG",
    "COND_QUEUED", "COND_PREEMPTED",
    "LAUNCHER_ACTIVE", "LAUNCHER_SUCCEEDED", "LAUNCHER_FAILED",
    "new_tpu_job", "deepcopy_obj",
]
