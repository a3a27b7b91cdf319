"""Job packing: group compatible small TPUJobs onto ONE shared worker gang.

One-job-one-slice wastes most of a big slice on sweep-style traffic —
eight GPT-2-small sweep members each holding a v5litepod-16 leave ~90%
of every slice idle. The HFTA data plane (train/hfta.py) can fuse K
same-architecture runs into one program; this module is the CONTROL
side: an admission pass that groups compatible pending jobs (same
topology / image / resource shape) into one gang.

Opting in is explicit: jobs set ``spec.pack_group`` to a shared group
name. Within a (namespace, pack_group), jobs whose resource shape
matches the leader's are PACKED:

  - the LEADER (oldest by creation time, name as tie-break) owns the
    physical resources — its worker StatefulSets / launcher / ConfigMap
    are the gang, and its worker pods carry the pack membership env
    below. Because worker env is covered by the controller's template
    hash, a membership change is an ordinary level-triggered resize: the
    gang restarts on the new member list and the fused program reloads
    with the new K.
  - MEMBERS create no pods. Their sync short-circuits to a ``Packed``
    condition naming the leader, so `kubectl get`-level introspection
    shows where the job physically runs.

Per-job identity inside the shared gang is threaded through pod env:

  TPU_PACK_GROUP  the pack_group name
  TPU_PACK_JOBS   member job names, comma-joined, index order
                  (leader first) — job j's replica index is its position
  TPU_PACK_K      member count

The fused trainer maps replica axis k <-> TPU_PACK_JOBS[k], and its
per-replica telemetry labels (TrainTelemetry labels={"replica": k})
give each packed job its own labeled tpu_worker_* series on the shared
worker's registry.

Jobs in the same group with a DIFFERENT resource shape are not forced
together: each shape-class packs separately (the leader of each class is
its oldest member). Terminal jobs drop out of the plan, which shrinks
the env, which restarts the gang without the finished member.

Pure planning logic — no API calls — so the controller unit tests drive
it with plain TPUJob objects.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..api import types as api

PACK_ENV_GROUP = "TPU_PACK_GROUP"
PACK_ENV_JOBS = "TPU_PACK_JOBS"
PACK_ENV_K = "TPU_PACK_K"

#: condition type recorded on packed member jobs (and the leader)
COND_PACKED = "Packed"


def pack_key(job: api.TPUJob) -> Tuple:
    """The compatibility fingerprint: jobs pack together only when the
    gang they would individually request is IDENTICAL — same accelerator
    and topology, same image (one pod runs the fused program for all of
    them), same resource shape and slice count."""
    spec = job.spec
    try:
        image = spec.template.main_container().image
    except (AttributeError, ValueError):
        image = None
    return (
        spec.accelerator_type,
        spec.slice_topology,
        spec.num_slices,
        image,
        spec.tpus,
        spec.tpus_per_worker,
        spec.processing_units,
        spec.processing_units_per_worker,
        spec.processing_resource_type,
        spec.replicas,
        spec.slots_per_worker,
    )


def _is_terminal(job: api.TPUJob) -> bool:
    if job.status.get_condition(api.COND_SUCCEEDED) is not None:
        return True
    failed = job.status.get_condition(api.COND_FAILED)
    return failed is not None and failed.status == "True"


def _age_key(job: api.TPUJob) -> Tuple:
    ts = job.metadata.creation_timestamp
    return (ts if ts is not None else float("inf"), job.metadata.name)


@dataclass(frozen=True)
class PackPlan:
    """The resolved pack for one shape-class of one (namespace, group)."""
    group: str
    members: Tuple[str, ...]      # job names, age order — leader first

    @property
    def leader(self) -> str:
        return self.members[0]

    @property
    def k(self) -> int:
        return len(self.members)

    def is_leader(self, name: str) -> bool:
        return name == self.leader

    def index(self, name: str) -> int:
        return self.members.index(name)

    def labels(self) -> Dict[str, str]:
        """Observability labels for the pack: stamped onto federated
        tpu_job_* series and controller timeline events so a packed
        job's telemetry is attributable to its physical gang. Empty for
        a pack of one — a solo leader's series stay label-identical to
        the unpacked job's (same reasoning as env())."""
        if self.k <= 1:
            return {}
        return {"pack_group": self.group}

    def member_labels(self, name: str) -> Dict[str, str]:
        """Per-member variant: pack labels + the member's replica index
        inside the fused program — matches the worker-side
        TrainTelemetry(labels={"replica": k}) convention, so federated
        series and worker series join on the same label."""
        if self.k <= 1:
            return {}
        return {**self.labels(), "replica": str(self.index(name))}

    def env(self) -> Dict[str, str]:
        """Pack-identity env for the LEADER's pods. A pack of one adds
        nothing — a solo leader's template stays bit-identical to the
        unpacked template, so merely setting pack_group on one job does
        not restart its gang."""
        if self.k <= 1:
            return {}
        return {
            PACK_ENV_GROUP: self.group,
            PACK_ENV_JOBS: ",".join(self.members),
            PACK_ENV_K: str(self.k),
        }


def plan_packing(job: api.TPUJob,
                 peers: Sequence[api.TPUJob]) -> Optional[PackPlan]:
    """Resolve `job`'s pack from the current informer view.

    `peers` is the lister's job set (any namespace, any group — the
    filter happens here). Returns None when the job doesn't opt in or is
    terminal; otherwise the plan over all live, shape-compatible members
    of its (namespace, group), ordered oldest-first."""
    group = job.spec.pack_group
    if not group or _is_terminal(job):
        return None
    key = pack_key(job)
    members: List[api.TPUJob] = []
    for peer in peers:
        if (peer.metadata.namespace == job.metadata.namespace
                and peer.spec.pack_group == group
                and not _is_terminal(peer)
                and pack_key(peer) == key):
            members.append(peer)
    if not any(m.metadata.name == job.metadata.name for m in members):
        members.append(job)     # lister lag: the job always sees itself
    members.sort(key=_age_key)
    return PackPlan(group=group,
                    members=tuple(m.metadata.name for m in members))


def slices_used(jobs: Sequence[api.TPUJob]) -> int:
    """Pack-aware slice quota accounting: how many physical slices the
    given jobs actually claim. A packed gang counts its slices ONCE — the
    leader owns the pods and the members are fused into the same program,
    so summing member specs would overcharge the quota by (k-1) slices
    per gang (exactly the overcount job packing exists to avoid).
    Terminal jobs hold no slices (their gangs are scaled down or about to
    be); invalid-spec Failed jobs are terminal by the same condition test
    plan_packing uses, keeping the two views consistent."""
    total = 0
    for job in jobs:
        if _is_terminal(job):
            continue
        plan = plan_packing(job, jobs)
        if plan is not None and not plan.is_leader(job.metadata.name):
            continue        # member: the leader's gang already counts
        total += max(job.spec.num_slices, 1)
    return total


__all__ = ["PACK_ENV_GROUP", "PACK_ENV_JOBS", "PACK_ENV_K", "COND_PACKED",
           "PackPlan", "pack_key", "plan_packing", "slices_used"]
