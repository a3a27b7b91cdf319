"""Dataclass ↔ Kubernetes-manifest serialization.

The in-memory layer stores typed dataclasses; a real cluster speaks JSON
manifests. This module is the wire format boundary: `to_manifest` emits the
exact camelCase body a real API server expects (the analogue of the
reference's Go structs' json tags, e.g. pkg/apis/kubeflow/v1alpha1/types.go:
25-130), and `from_manifest` parses server responses/watch events back into
the dataclasses the controller reconciles.

Covered kinds (the TPUJob CRD plus every child the reconciler materializes,
ref pkg/controllers/mpi_job_controller.go:849-1236): TPUJob, ConfigMap,
ServiceAccount, Role, RoleBinding, Service, PodDisruptionBudget, StatefulSet,
Job.

Times: dataclasses hold float epoch seconds; manifests hold RFC3339 strings
(metav1.Time). resourceVersion: a real server issues opaque strings; the
dataclass field is compared only for equality (informer resync skip,
ref :221-227), so strings pass through untouched.
"""
from __future__ import annotations

import calendar
import time
from typing import Dict, List, Optional

from ..api.types import (
    API_VERSION,
    GROUP_NAME,
    Container,
    JobCondition,
    ObjectMeta,
    OwnerReference,
    PodTemplateSpec,
    ReplicaStatus,
    ServingSLO,
    ServingSpec,
    TPUJob,
    TPUJobSpec,
    TPUJobStatus,
)
from .resources import (
    ConfigMap,
    Event,
    Job,
    JobSpec,
    JobStatus,
    ObjectReference,
    Pod,
    PodStatus,
    PodDisruptionBudget,
    PolicyRule,
    Role,
    RoleBinding,
    Service,
    ServiceAccount,
    StatefulSet,
    StatefulSetSpec,
    StatefulSetStatus,
)

# kind -> (apiVersion, namespaced plural) for REST path construction
API_RESOURCES: Dict[str, tuple] = {
    "TPUJob": (f"{GROUP_NAME}/{API_VERSION}", "tpujobs"),
    "ConfigMap": ("v1", "configmaps"),
    "ServiceAccount": ("v1", "serviceaccounts"),
    "Service": ("v1", "services"),
    "Role": ("rbac.authorization.k8s.io/v1", "roles"),
    "RoleBinding": ("rbac.authorization.k8s.io/v1", "rolebindings"),
    "PodDisruptionBudget": ("policy/v1", "poddisruptionbudgets"),
    "StatefulSet": ("apps/v1", "statefulsets"),
    "Job": ("batch/v1", "jobs"),
    # Pods are read (never created) by the real backend: the launcher Job's
    # failed pod carries the container exit code the ExitCode restart policy
    # needs (kubeclient.KubeAPIServer._lookup_exit_code)
    "Pod": ("v1", "pods"),
    # core/v1 Events: the recorder sink (ref mpi_job_controller.go:165-172)
    "Event": ("v1", "events"),
}


# ---------------------------------------------------------------------------
# time helpers (metav1.Time ↔ float epoch)
# ---------------------------------------------------------------------------

def rfc3339(t: Optional[float]) -> Optional[str]:
    if t is None:
        return None
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t))


def parse_time(s) -> Optional[float]:
    if s is None or s == "":
        return None
    if isinstance(s, (int, float)):
        return float(s)
    # tolerate fractional seconds / offset "Z"
    base = s.split(".")[0].rstrip("Z")
    return float(calendar.timegm(time.strptime(base, "%Y-%m-%dT%H:%M:%S")))


def _prune(d: dict) -> dict:
    """Drop None values and empty containers so emitted bodies stay minimal
    (matching Go's omitempty json tags)."""
    return {k: v for k, v in d.items()
            if v is not None and v != {} and v != []}


# ---------------------------------------------------------------------------
# metadata
# ---------------------------------------------------------------------------

def meta_to_manifest(meta: ObjectMeta) -> dict:
    return _prune({
        "name": meta.name,
        "namespace": meta.namespace,
        "uid": meta.uid or None,
        "resourceVersion": str(meta.resource_version)
        if meta.resource_version else None,
        "labels": dict(meta.labels),
        "annotations": dict(meta.annotations),
        "creationTimestamp": rfc3339(meta.creation_timestamp),
        "ownerReferences": [
            _prune({
                "apiVersion": r.api_version,
                "kind": r.kind,
                "name": r.name,
                "uid": r.uid,
                "controller": r.controller,
                "blockOwnerDeletion": r.block_owner_deletion,
            })
            for r in meta.owner_references
        ],
    })


def meta_from_manifest(m: dict) -> ObjectMeta:
    return ObjectMeta(
        name=m.get("name", ""),
        namespace=m.get("namespace", "default"),
        uid=m.get("uid", ""),
        resource_version=m.get("resourceVersion", 0),
        labels=dict(m.get("labels") or {}),
        annotations=dict(m.get("annotations") or {}),
        creation_timestamp=parse_time(m.get("creationTimestamp")),
        deletion_timestamp=parse_time(m.get("deletionTimestamp")),
        owner_references=[
            OwnerReference(
                api_version=r.get("apiVersion", ""),
                kind=r.get("kind", ""),
                name=r.get("name", ""),
                uid=r.get("uid", ""),
                controller=bool(r.get("controller", False)),
                block_owner_deletion=bool(r.get("blockOwnerDeletion", False)),
            )
            for r in (m.get("ownerReferences") or [])
        ],
    )


# ---------------------------------------------------------------------------
# pod template
# ---------------------------------------------------------------------------

def _container_to_manifest(c: Container) -> dict:
    return _prune({
        "name": c.name,
        "image": c.image,
        "command": list(c.command),
        "args": list(c.args),
        "env": [{"name": k, "value": str(v)} for k, v in c.env.items()],
        "resources": _prune({
            "limits": {k: str(v) for k, v in c.limits.items()},
            "requests": {k: str(v) for k, v in c.requests.items()},
        }) or None,
        "volumeMounts": [dict(vm) for vm in c.volume_mounts],
        "readinessProbe": dict(c.readiness_probe)
        if c.readiness_probe else None,
    })


def _quantity(v):
    """Parse a k8s resource quantity; plain integers round-trip, anything
    else (e.g. "500m") stays a string."""
    try:
        return int(v)
    except (TypeError, ValueError):
        return v


def _container_from_manifest(m: dict) -> Container:
    res = m.get("resources") or {}
    return Container(
        name=m.get("name", "tpu"),
        image=m.get("image", ""),
        command=list(m.get("command") or []),
        args=list(m.get("args") or []),
        env={e["name"]: e.get("value", "") for e in (m.get("env") or [])},
        limits={k: _quantity(v) for k, v in (res.get("limits") or {}).items()},
        requests={k: _quantity(v)
                  for k, v in (res.get("requests") or {}).items()},
        volume_mounts=[dict(vm) for vm in (m.get("volumeMounts") or [])],
        readiness_probe=(dict(m["readinessProbe"])
                         if m.get("readinessProbe") else None),
    )


def _volume_to_manifest(v: dict) -> dict:
    """The controller models a ConfigMap volume as {"name": n,
    "configMap": <cm-name>}; the wire format nests the name."""
    out = dict(v)
    if isinstance(out.get("configMap"), str):
        out["configMap"] = {"name": out["configMap"]}
    return out


def _volume_from_manifest(v: dict) -> dict:
    out = dict(v)
    cm = out.get("configMap")
    if isinstance(cm, dict) and set(cm) <= {"name", "defaultMode", "items"} \
            and "name" in cm and len(cm) == 1:
        out["configMap"] = cm["name"]
    return out


def template_to_manifest(t: PodTemplateSpec) -> dict:
    return _prune({
        "metadata": _prune({"labels": dict(t.metadata.labels),
                            "annotations": dict(t.metadata.annotations)})
        or None,
        "spec": _prune({
            "containers": [_container_to_manifest(c) for c in t.containers],
            "initContainers": [_container_to_manifest(c)
                               for c in t.init_containers],
            "restartPolicy": t.restart_policy,
            "nodeSelector": dict(t.node_selector),
            "volumes": [_volume_to_manifest(v) for v in t.volumes],
            "tolerations": [dict(tol) for tol in t.tolerations],
            "terminationGracePeriodSeconds":
                t.termination_grace_period_seconds,
        }),
    })


def template_from_manifest(m: dict) -> PodTemplateSpec:
    meta = m.get("metadata") or {}
    spec = m.get("spec") or {}
    return PodTemplateSpec(
        metadata=ObjectMeta(labels=dict(meta.get("labels") or {}),
                            annotations=dict(meta.get("annotations") or {})),
        containers=[_container_from_manifest(c)
                    for c in (spec.get("containers") or [])] or [Container()],
        init_containers=[_container_from_manifest(c)
                         for c in (spec.get("initContainers") or [])],
        restart_policy=spec.get("restartPolicy", "OnFailure"),
        node_selector=dict(spec.get("nodeSelector") or {}),
        volumes=[_volume_from_manifest(v) for v in (spec.get("volumes") or [])],
        tolerations=[dict(t) for t in (spec.get("tolerations") or [])],
        termination_grace_period_seconds=spec.get(
            "terminationGracePeriodSeconds"),
    )


# ---------------------------------------------------------------------------
# TPUJob (the CRD — ref pkg/apis/kubeflow/v1alpha1/types.go:25-130 +
# v1alpha2 status, common_types.go:23-156)
# ---------------------------------------------------------------------------

#: ServingSLO's fields by their wire names
_SLO_FIELDS = (("ttftP99Seconds", "ttft_p99_seconds"),
               ("tpotP99Seconds", "tpot_p99_seconds"),
               ("queueDepth", "queue_depth"),
               ("minDecodeReplicas", "min_decode_replicas"),
               ("maxDecodeReplicas", "max_decode_replicas"),
               ("breachSeconds", "breach_seconds"),
               ("clearSeconds", "clear_seconds"),
               ("cooldownMultiplier", "cooldown_multiplier"),
               ("cooldownFloorSeconds", "cooldown_floor_seconds"))


def _serving_to_manifest(sv: Optional[ServingSpec]) -> Optional[dict]:
    if sv is None:
        return None
    slo = (None if sv.slo is None else _prune(
        {wire: getattr(sv.slo, attr) for wire, attr in _SLO_FIELDS}))
    return _prune({"prefillReplicas": sv.prefill_replicas,
                   "decodeReplicas": sv.decode_replicas, "slo": slo})


def _serving_from_manifest(m: Optional[dict]) -> Optional[ServingSpec]:
    if m is None:
        return None
    slo = m.get("slo")
    if slo is not None:
        slo = ServingSLO(**{attr: slo[wire] for wire, attr in _SLO_FIELDS
                            if wire in slo})
    return ServingSpec(prefill_replicas=int(m.get("prefillReplicas", 1)),
                       decode_replicas=int(m.get("decodeReplicas", 1)),
                       slo=slo)


def _tpujob_spec_to_manifest(s: TPUJobSpec) -> dict:
    return _prune({
        "tpus": s.tpus,
        "tpusPerWorker": s.tpus_per_worker,
        "processingUnits": s.processing_units,
        "processingUnitsPerWorker": s.processing_units_per_worker,
        "processingResourceType": s.processing_resource_type,
        "replicas": s.replicas,
        "slotsPerWorker": s.slots_per_worker,
        "sliceTopology": s.slice_topology,
        "acceleratorType": s.accelerator_type,
        "numSlices": s.num_slices,
        "launcherOnMaster": s.launcher_on_master or None,
        "backoffLimit": s.backoff_limit,
        "activeDeadlineSeconds": s.active_deadline_seconds,
        # the observatory's progress lease (the JAX package's serializer
        # drops it, so a job read from a real API server never arms it)
        "progressDeadlineSeconds": s.progress_deadline_seconds,
        "gangScheduling": s.gang_scheduling or None,
        "cleanPodPolicy": s.clean_pod_policy,
        "restartPolicy": s.restart_policy,
        "elastic": s.elastic or None,
        "minTpus": s.min_tpus,
        "resize": s.resize,
        "priority": s.priority or None,
        # the job-packing group and the serving pools (the JAX package's
        # serializer drops both, so a job read back from a real API server
        # loses them)
        "packGroup": s.pack_group,
        "serving": _serving_to_manifest(s.serving),
        "template": template_to_manifest(s.template),
    })


def _tpujob_spec_from_manifest(m: dict) -> TPUJobSpec:
    return TPUJobSpec(
        tpus=m.get("tpus"),
        tpus_per_worker=m.get("tpusPerWorker"),
        processing_units=m.get("processingUnits"),
        processing_units_per_worker=m.get("processingUnitsPerWorker"),
        processing_resource_type=m.get("processingResourceType"),
        replicas=m.get("replicas"),
        slots_per_worker=m.get("slotsPerWorker"),
        slice_topology=m.get("sliceTopology"),
        accelerator_type=m.get("acceleratorType", "v5litepod"),
        num_slices=int(m.get("numSlices", 1)),
        launcher_on_master=bool(m.get("launcherOnMaster", False)),
        backoff_limit=m.get("backoffLimit"),
        active_deadline_seconds=m.get("activeDeadlineSeconds"),
        progress_deadline_seconds=m.get("progressDeadlineSeconds"),
        gang_scheduling=bool(m.get("gangScheduling", False)),
        clean_pod_policy=m.get("cleanPodPolicy", "Running"),
        restart_policy=m.get("restartPolicy", "Never"),
        elastic=bool(m.get("elastic", False)),
        min_tpus=m.get("minTpus"),
        resize=m.get("resize"),
        priority=int(m.get("priority", 0)),
        pack_group=m.get("packGroup"),
        serving=_serving_from_manifest(m.get("serving")),
        template=template_from_manifest(m.get("template") or {}),
    )


def _tpujob_status_to_manifest(st: TPUJobStatus) -> dict:
    return _prune({
        "launcherStatus": st.launcher_status,
        "workerReplicas": st.worker_replicas,
        "startTime": rfc3339(st.start_time),
        "completionTime": rfc3339(st.completion_time),
        "restartCount": st.restart_count or None,
        "elasticTpus": st.elastic_tpus,
        "elasticSince": rfc3339(st.elastic_since),
        "servingDecodeReplicas": st.serving_decode_replicas,
        "servingScaledAt": rfc3339(st.serving_scaled_at),
        "scalingReplica": st.scaling_replica,
        "schedTpus": st.sched_tpus,
        "schedScaledAt": rfc3339(st.sched_scaled_at),
        "migrationCount": st.migration_count or None,
        "migratedWindow": st.migrated_window,
        "conditions": [
            _prune({
                "type": c.type,
                "status": c.status,
                "reason": c.reason or None,
                "message": c.message or None,
                "lastUpdateTime": rfc3339(c.last_update_time),
                "lastTransitionTime": rfc3339(c.last_transition_time),
            })
            for c in st.conditions
        ],
        "replicaStatuses": {
            role: _prune({"active": rs.active, "succeeded": rs.succeeded,
                          "failed": rs.failed}) or {}
            for role, rs in st.replica_statuses.items()
        } or None,
    })


def _tpujob_status_from_manifest(m: dict) -> TPUJobStatus:
    st = TPUJobStatus(
        launcher_status=m.get("launcherStatus"),
        worker_replicas=int(m.get("workerReplicas", 0)),
        start_time=parse_time(m.get("startTime")),
        completion_time=parse_time(m.get("completionTime")),
        restart_count=int(m.get("restartCount", 0)),
        elastic_tpus=m.get("elasticTpus"),
        elastic_since=parse_time(m.get("elasticSince")),
        serving_decode_replicas=m.get("servingDecodeReplicas"),
        serving_scaled_at=parse_time(m.get("servingScaledAt")),
        scaling_replica=m.get("scalingReplica"),
        sched_tpus=m.get("schedTpus"),
        sched_scaled_at=parse_time(m.get("schedScaledAt")),
        migration_count=int(m.get("migrationCount", 0)),
        migrated_window=m.get("migratedWindow"),
    )
    for c in m.get("conditions") or []:
        st.conditions.append(JobCondition(
            type=c.get("type", ""),
            status=c.get("status", "True"),
            reason=c.get("reason", ""),
            message=c.get("message", ""),
            last_update_time=parse_time(c.get("lastUpdateTime")) or 0.0,
            last_transition_time=parse_time(c.get("lastTransitionTime"))
            or 0.0,
        ))
    for role, rs in (m.get("replicaStatuses") or {}).items():
        st.replica_statuses[role] = ReplicaStatus(
            active=int(rs.get("active", 0)),
            succeeded=int(rs.get("succeeded", 0)),
            failed=int(rs.get("failed", 0)),
        )
    return st


# ---------------------------------------------------------------------------
# child kinds
# ---------------------------------------------------------------------------

def _statefulset_to_manifest(s: StatefulSet) -> dict:
    # A real StatefulSet requires spec.selector; the controller labels the
    # pod template (new_worker, controller.py), so matchLabels mirrors it.
    return {
        "spec": _prune({
            "replicas": s.spec.replicas,
            "serviceName": s.spec.service_name,
            "podManagementPolicy": s.spec.pod_management_policy,
            "updateStrategy": {"type": s.spec.update_strategy},
            "selector": {"matchLabels":
                         dict(s.spec.template.metadata.labels)},
            "template": template_to_manifest(s.spec.template),
        }),
    }


def _statefulset_from_manifest(m: dict) -> StatefulSet:
    spec = m.get("spec") or {}
    status = m.get("status") or {}
    return StatefulSet(
        spec=StatefulSetSpec(
            replicas=int(spec.get("replicas", 0)),
            service_name=spec.get("serviceName", ""),
            pod_management_policy=spec.get("podManagementPolicy", "Parallel"),
            update_strategy=(spec.get("updateStrategy") or {}).get(
                "type", "RollingUpdate"),
            template=template_from_manifest(spec.get("template") or {}),
        ),
        status=StatefulSetStatus(
            ready_replicas=int(status.get("readyReplicas", 0)),
            replicas=int(status.get("replicas", 0)),
        ),
    )


def _job_to_manifest(j: Job) -> dict:
    return {
        "spec": _prune({
            "backoffLimit": j.spec.backoff_limit,
            "activeDeadlineSeconds": j.spec.active_deadline_seconds,
            "template": template_to_manifest(j.spec.template),
        }),
    }


def _job_from_manifest(m: dict) -> Job:
    spec = m.get("spec") or {}
    status = m.get("status") or {}
    # NOTE: batch/v1 JobStatus has no per-container exit code; the ExitCode
    # restart policy (v1alpha2 common_types.go:150-155) needs the failed
    # pod's containerStatuses, which KubeAPIServer fills in separately
    # (see kubeclient.KubeAPIServer._lookup_exit_code).
    return Job(
        spec=JobSpec(
            backoff_limit=int(spec.get("backoffLimit", 6)),
            active_deadline_seconds=spec.get("activeDeadlineSeconds"),
            template=template_from_manifest(spec.get("template") or {}),
        ),
        status=JobStatus(
            active=int(status.get("active", 0)),
            succeeded=int(status.get("succeeded", 0)),
            failed=int(status.get("failed", 0)),
            start_time=parse_time(status.get("startTime")),
            completion_time=parse_time(status.get("completionTime")),
        ),
    )


def _service_to_manifest(s: Service) -> dict:
    return {
        "spec": _prune({
            "clusterIP": s.cluster_ip,
            "selector": dict(s.selector),
            "ports": [{"port": p} for p in s.ports],
            "publishNotReadyAddresses": s.publish_not_ready_addresses
            or None,
        }),
    }


def _service_from_manifest(m: dict) -> Service:
    spec = m.get("spec") or {}
    return Service(
        cluster_ip=spec.get("clusterIP", "None"),
        selector=dict(spec.get("selector") or {}),
        ports=[p.get("port") for p in (spec.get("ports") or [])],
        publish_not_ready_addresses=bool(
            spec.get("publishNotReadyAddresses", False)),
    )


def _role_to_manifest(r: Role) -> dict:
    return {
        "rules": [
            _prune({
                "apiGroups": list(rule.api_groups),
                "resources": list(rule.resources),
                "resourceNames": list(rule.resource_names),
                "verbs": list(rule.verbs),
            })
            for rule in r.rules
        ],
    }


def _role_from_manifest(m: dict) -> Role:
    return Role(rules=[
        PolicyRule(
            api_groups=list(rule.get("apiGroups") or [""]),
            resources=list(rule.get("resources") or []),
            resource_names=list(rule.get("resourceNames") or []),
            verbs=list(rule.get("verbs") or []),
        )
        for rule in (m.get("rules") or [])
    ])


def _rolebinding_to_manifest(rb: RoleBinding, namespace: str) -> dict:
    return {
        "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                    "kind": "Role", "name": rb.role_name},
        "subjects": [
            {"kind": "ServiceAccount", "name": sa, "namespace": namespace}
            for sa in rb.subject_service_accounts
        ],
    }


def _rolebinding_from_manifest(m: dict) -> RoleBinding:
    return RoleBinding(
        role_name=(m.get("roleRef") or {}).get("name", ""),
        subject_service_accounts=[
            s.get("name", "") for s in (m.get("subjects") or [])
            if s.get("kind") == "ServiceAccount"
        ],
    )


def _pdb_to_manifest(p: PodDisruptionBudget) -> dict:
    # ref newPDB (:969-986): selector matches the job's shared label set.
    return {
        "spec": _prune({
            "minAvailable": p.min_available,
            "selector": {"matchLabels": dict(p.metadata.labels)},
        }),
    }


def _pdb_from_manifest(m: dict) -> PodDisruptionBudget:
    spec = m.get("spec") or {}
    return PodDisruptionBudget(min_available=int(spec.get("minAvailable", 0)))


def _pod_to_manifest(p: Pod) -> dict:
    cs = {"restartCount": p.status.restart_count}
    if p.status.exit_code is not None:
        cs["state"] = {"terminated": {"exitCode": p.status.exit_code}}
    return {
        "status": _prune({
            "phase": p.status.phase,
            "containerStatuses": [cs],
        }),
    }


def _pod_from_manifest(m: dict) -> Pod:
    # Canonical containerStatuses parsing — the ONE place that decides
    # exit-code semantics (kubeclient._lookup_exit_code consumes this):
    # the first NON-ZERO terminated exitCode wins (the failure cause);
    # all-zero terminations report 0; no terminations report None.
    status = m.get("status") or {}
    restarts = 0
    exit_code = None
    for cs in status.get("containerStatuses") or []:
        restarts += int(cs.get("restartCount", 0))
        term = (cs.get("state") or {}).get("terminated") or {}
        code = term.get("exitCode")
        if code is not None and (exit_code is None or exit_code == 0):
            exit_code = int(code)
    return Pod(status=PodStatus(
        phase=status.get("phase", "Running"),
        restart_count=restarts,
        exit_code=exit_code,
    ))


def _event_to_manifest(e: Event) -> dict:
    io = e.involved_object
    return {
        "involvedObject": _prune({
            "kind": io.kind,
            "namespace": io.namespace,
            "name": io.name,
            "uid": io.uid or None,
            "apiVersion": io.api_version or None,
        }),
        "reason": e.reason,
        "message": e.message,
        "type": e.type,
        "count": e.count,
        "firstTimestamp": rfc3339(e.first_timestamp),
        "lastTimestamp": rfc3339(e.last_timestamp),
        "source": {"component": e.source_component},
    }


def _event_from_manifest(m: dict) -> Event:
    io = m.get("involvedObject") or {}
    return Event(
        involved_object=ObjectReference(
            kind=io.get("kind", ""),
            namespace=io.get("namespace", ""),
            name=io.get("name", ""),
            uid=io.get("uid", ""),
            api_version=io.get("apiVersion", ""),
        ),
        reason=m.get("reason", ""),
        message=m.get("message", ""),
        type=m.get("type", "Normal"),
        count=int(m.get("count", 1)),
        first_timestamp=parse_time(m.get("firstTimestamp")),
        last_timestamp=parse_time(m.get("lastTimestamp")),
        source_component=(m.get("source") or {}).get("component", ""),
    )


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def to_manifest(obj) -> dict:
    """Serialize a typed resource to its wire-format manifest."""
    kind = obj.kind
    api_version, _ = API_RESOURCES[kind]
    body = {"apiVersion": api_version, "kind": kind,
            "metadata": meta_to_manifest(obj.metadata)}
    if kind == "TPUJob":
        body["spec"] = _tpujob_spec_to_manifest(obj.spec)
        status = _tpujob_status_to_manifest(obj.status)
        if status:
            body["status"] = status
    elif kind == "ConfigMap":
        body["data"] = dict(obj.data)
    elif kind == "ServiceAccount":
        pass
    elif kind == "Service":
        body.update(_service_to_manifest(obj))
    elif kind == "Role":
        body.update(_role_to_manifest(obj))
    elif kind == "RoleBinding":
        body.update(_rolebinding_to_manifest(obj, obj.metadata.namespace))
    elif kind == "PodDisruptionBudget":
        body.update(_pdb_to_manifest(obj))
    elif kind == "StatefulSet":
        body.update(_statefulset_to_manifest(obj))
    elif kind == "Job":
        body.update(_job_to_manifest(obj))
    elif kind == "Event":
        body.update(_event_to_manifest(obj))
    elif kind == "Pod":
        body.update(_pod_to_manifest(obj))
    else:  # pragma: no cover — API_RESOURCES lookup above already raised
        raise KeyError(kind)
    return body


def from_manifest(m: dict):
    """Parse a wire-format manifest into the matching typed resource."""
    kind = m.get("kind", "")
    meta = meta_from_manifest(m.get("metadata") or {})
    if kind == "TPUJob":
        return TPUJob(metadata=meta,
                      spec=_tpujob_spec_from_manifest(m.get("spec") or {}),
                      status=_tpujob_status_from_manifest(
                          m.get("status") or {}))
    if kind == "ConfigMap":
        return ConfigMap(metadata=meta, data=dict(m.get("data") or {}))
    if kind == "ServiceAccount":
        return ServiceAccount(metadata=meta)
    if kind == "Service":
        svc = _service_from_manifest(m)
        svc.metadata = meta
        return svc
    if kind == "Role":
        role = _role_from_manifest(m)
        role.metadata = meta
        return role
    if kind == "RoleBinding":
        rb = _rolebinding_from_manifest(m)
        rb.metadata = meta
        return rb
    if kind == "PodDisruptionBudget":
        pdb = _pdb_from_manifest(m)
        pdb.metadata = meta
        return pdb
    if kind == "StatefulSet":
        sts = _statefulset_from_manifest(m)
        sts.metadata = meta
        return sts
    if kind == "Job":
        job = _job_from_manifest(m)
        job.metadata = meta
        return job
    if kind == "Event":
        ev = _event_from_manifest(m)
        ev.metadata = meta
        return ev
    if kind == "Pod":
        pod = _pod_from_manifest(m)
        pod.metadata = meta
        return pod
    raise KeyError(f"unknown kind {kind!r}")


__all__ = ["API_RESOURCES", "to_manifest", "from_manifest",
           "rfc3339", "parse_time"]
