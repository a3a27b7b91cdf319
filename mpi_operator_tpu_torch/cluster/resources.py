"""Dependent-resource types the controller materializes for each TPUJob.

These are the six child kinds the reference reconciler creates
(reference pkg/controllers/mpi_job_controller.go:849-1236):
ConfigMap, ServiceAccount, Role, RoleBinding, PodDisruptionBudget,
StatefulSet (workers), Job (launcher). Modeled as minimal dataclasses —
just the fields the reconcile loop and tests observe.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api.types import Container, ObjectMeta, PodTemplateSpec


@dataclass
class ConfigMap:
    """ref: newConfigMap (mpi_job_controller.go:849-885) — carried the
    hostfile + kubexec.sh; ours carries worker discovery data (SURVEY §2.4)."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)
    kind: str = "ConfigMap"


@dataclass
class ServiceAccount:
    """ref: newLauncherServiceAccount (mpi_job_controller.go:890-901)."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    kind: str = "ServiceAccount"


@dataclass
class PolicyRule:
    """ref: rbacv1.PolicyRule (mpi_job_controller.go:920-933)."""
    verbs: List[str] = field(default_factory=list)
    resources: List[str] = field(default_factory=list)
    resource_names: List[str] = field(default_factory=list)
    api_groups: List[str] = field(default_factory=lambda: [""])


@dataclass
class Role:
    """ref: newLauncherRole (mpi_job_controller.go:906-935)."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    rules: List[PolicyRule] = field(default_factory=list)
    kind: str = "Role"


@dataclass
class RoleBinding:
    """ref: newLauncherRoleBinding (mpi_job_controller.go:940-964)."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    role_name: str = ""
    subject_service_accounts: List[str] = field(default_factory=list)
    kind: str = "RoleBinding"


@dataclass
class Service:
    """Headless Service giving workers their stable DNS names
    (`<job>-worker-<i>.<job>-worker.<ns>.svc`). The reference never creates
    one — its hostfile names resolve via the StatefulSet's governing service
    that operators had to pre-provision; here the controller owns it so
    worker discovery works with zero cluster prerequisites (StatefulSet
    ServiceName, ref mpi_job_controller.go:1079)."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    cluster_ip: str = "None"              # headless
    selector: Dict[str, str] = field(default_factory=dict)
    ports: List[int] = field(default_factory=list)
    # Publish DNS for NOT-Ready pods. REQUIRED for the worker service:
    # jax.distributed rendezvous (and the discovery init wait) happens
    # BEFORE the TPU-health readiness marker exists, so worker A-records
    # gated on Readiness would deadlock the bootstrap — the standard
    # StatefulSet peer-discovery setting.
    publish_not_ready_addresses: bool = False
    kind: str = "Service"


@dataclass
class PodDisruptionBudget:
    """ref: newPDB (mpi_job_controller.go:969-986) — gang scheduling hint
    (minAvailable = worker replicas) for the batch scheduler."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    min_available: int = 0
    kind: str = "PodDisruptionBudget"


@dataclass
class StatefulSetSpec:
    replicas: int = 0
    service_name: str = ""          # headless svc → stable DNS (ref :1079)
    pod_management_policy: str = "Parallel"   # ref :1074
    # OnDelete for workers: the default RollingUpdate replaces one pod at
    # a time gated on Ready, but Ready needs a FULL-WORLD rendezvous —
    # a one-at-a-time roll deadlocks. The controller instead deletes the
    # gang explicitly after a template change (resize semantics).
    update_strategy: str = "RollingUpdate"
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)


@dataclass
class StatefulSetStatus:
    ready_replicas: int = 0
    replicas: int = 0


@dataclass
class StatefulSet:
    """ref: newWorker (mpi_job_controller.go:1004-1083). Workers get stable
    DNS names `<job>-worker-<i>` matching the discovery data."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: StatefulSetSpec = field(default_factory=StatefulSetSpec)
    status: StatefulSetStatus = field(default_factory=StatefulSetStatus)
    kind: str = "StatefulSet"


@dataclass
class JobSpec:
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    backoff_limit: int = 6                    # ref :1059-1062
    active_deadline_seconds: Optional[int] = None   # ref :1221-1222


@dataclass
class JobStatus:
    active: int = 0
    succeeded: int = 0
    failed: int = 0
    start_time: Optional[float] = None
    completion_time: Optional[float] = None
    # main-container exit code of the (last) failed pod; feeds the
    # ExitCode restart policy (v1alpha2 common_types.go:150-155)
    exit_code: Optional[int] = None


@dataclass
class Job:
    """ref: newLauncher (mpi_job_controller.go:1088-1236) — the batch Job
    whose completion is the TPUJob's completion signal."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: JobSpec = field(default_factory=JobSpec)
    status: JobStatus = field(default_factory=JobStatus)
    kind: str = "Job"

    def succeeded(self) -> bool:
        return self.status.succeeded > 0

    def failed(self) -> bool:
        return self.status.failed > 0


@dataclass
class PodStatus:
    """Minimal pod status: phase + container restart/exit data. Worker
    crash-loops are invisible at the StatefulSet level (RestartPolicy=
    Always means kubelet resurrects the pod in place), so the controller
    reads these to surface failures into replicaStatuses (v1alpha2
    common_types.go:68-80)."""
    phase: str = "Running"            # Pending|Running|Succeeded|Failed
    restart_count: int = 0            # sum over containerStatuses[]
    exit_code: Optional[int] = None   # last terminated container, if any


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    status: PodStatus = field(default_factory=PodStatus)
    kind: str = "Pod"


@dataclass
class ObjectReference:
    """core/v1 ObjectReference — the involvedObject of an Event."""
    kind: str = ""
    namespace: str = ""
    name: str = ""
    uid: str = ""
    api_version: str = ""


@dataclass
class Event:
    """core/v1 Event. The reference wires its recorder into the core-v1
    Events sink (mpi_job_controller.go:165-172) so `kubectl describe
    mpijob` surfaces Synced/ErrResourceExists warnings (:518, :539); this
    is the typed analogue the EventRecorder posts. `count`/timestamps
    implement client-go's correlator aggregation: a repeated identical
    event bumps count instead of creating a new object."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    involved_object: ObjectReference = field(default_factory=ObjectReference)
    reason: str = ""
    message: str = ""
    type: str = "Normal"            # Normal | Warning
    count: int = 1
    first_timestamp: Optional[float] = None
    last_timestamp: Optional[float] = None
    source_component: str = ""
    kind: str = "Event"


def deepcopy_resource(obj):
    return copy.deepcopy(obj)


__all__ = [
    "ConfigMap", "ServiceAccount", "PolicyRule", "Role", "RoleBinding",
    "PodDisruptionBudget", "Service", "StatefulSet", "StatefulSetSpec",
    "StatefulSetStatus", "Job", "JobSpec", "JobStatus", "Container",
    "Event", "ObjectReference", "Pod", "PodStatus", "deepcopy_resource",
]
