"""Admission-time validation for TPUJob specs.

The reference enforces its invariants in an openAPIV3 schema on the CRD
(reference deploy/0-crd.yaml:16-99): exactly ONE of the three sizing modes
(``gpus`` / ``processingUnits`` / ``replicas``) may be set, and ``gpus`` is
constrained to 1, 2, 4, or a multiple of 8 (deploy/0-crd.yaml:27-35).

The TPU-native analogue enforces the same oneOf discipline plus slice-shape
validity: an invalid chip count must fail at admission, not at runtime
(SURVEY.md §7 "Hard parts" — slice-topology allocation math).
"""
from __future__ import annotations

from typing import List

from .types import (
    RESOURCE_CPU,
    RESOURCE_GPU,
    RESOURCE_TPU,
    TPUJobSpec,
    V5E_VALID_SLICE_CHIPS,
)


class ValidationError(ValueError):
    """Raised when a TPUJob spec fails admission validation."""

    def __init__(self, errors: List[str]):
        self.errors = list(errors)
        super().__init__("; ".join(self.errors))


# Topology strings accepted for v5e slices, keyed by chip count.
# v5e is a 2D mesh; host granularity is 4 chips (2x2). SURVEY.md §7.
V5E_TOPOLOGIES = {
    1: ("1x1",),
    2: ("1x2", "2x1"),
    4: ("2x2",),
    8: ("2x4", "4x2"),
    16: ("4x4",),
    32: ("4x8", "8x4"),
    64: ("8x8",),
    128: ("8x16", "16x8"),
    256: ("16x16",),
}


def _valid_tpu_count(n: int) -> bool:
    """Mirror of the reference's gpus constraint (1, 2, 4, or multiple of 8;
    deploy/0-crd.yaml:27-35) tightened to valid v5e slice shapes."""
    return n in V5E_VALID_SLICE_CHIPS


def _derived_workers(spec: TPUJobSpec):
    """Worker count when the spec alone determines it (replicas mode, or
    Mode A with an explicit per-worker count); None when only the
    operator's flag default can resolve it — those cases stay controller
    backstops that converge to Failed/InvalidTPUJobSpec."""
    if spec.replicas is not None and spec.replicas >= 1:
        return spec.replicas
    total = spec.tpus if spec.tpus is not None else spec.processing_units
    per = spec.tpus_per_worker if spec.tpus is not None else \
        spec.processing_units_per_worker
    if total is not None and per and per >= 1:
        return 1 if total < per else (
            total // per if total % per == 0 else None)
    return None


def validate_spec(spec: TPUJobSpec,
                  default_resource_type: str = RESOURCE_TPU) -> None:
    """Raises ValidationError listing every violation (the reference's schema
    reports oneOf failure wholesale; we itemize for developer ergonomics).

    `default_resource_type` is the operator's effective default for specs
    that leave processingResourceType unset (the --processing-resource-type
    flag) — admission must agree with the controller's allocation."""
    errs: List[str] = []

    modes = [
        spec.tpus is not None,
        spec.processing_units is not None,
        spec.replicas is not None,
    ]
    if sum(modes) == 0:
        errs.append(
            "exactly one of spec.tpus, spec.processingUnits, spec.replicas "
            "must be set (ref deploy/0-crd.yaml oneOf)"
        )
    elif sum(modes) > 1:
        errs.append(
            "spec.tpus, spec.processingUnits, spec.replicas are mutually "
            "exclusive (ref deploy/0-crd.yaml oneOf)"
        )

    if spec.tpus is not None:
        if spec.tpus < 1:
            errs.append(f"spec.tpus must be >= 1, got {spec.tpus}")
        elif spec.num_slices >= 1 and spec.tpus % spec.num_slices:
            errs.append(
                f"spec.tpus={spec.tpus} does not divide into "
                f"{spec.num_slices} slices"
            )
        elif not _valid_tpu_count(spec.tpus // max(spec.num_slices, 1)):
            # the slice-shape constraint applies PER SLICE: tpus=512 over
            # numSlices=2 is two valid v5e-256 slices
            errs.append(
                f"spec.tpus={spec.tpus} over numSlices={spec.num_slices} "
                f"is {spec.tpus // max(spec.num_slices, 1)} chips per "
                f"slice — not a valid v5e slice chip count "
                f"{V5E_VALID_SLICE_CHIPS}"
            )

    if spec.processing_units is not None and spec.processing_units < 1:
        errs.append(f"spec.processingUnits must be >= 1, got {spec.processing_units}")

    if spec.replicas is not None and spec.replicas < 1:
        errs.append(f"spec.replicas must be >= 1, got {spec.replicas}")
    elif spec.replicas is not None:
        # Mode B sizes each worker from the container's resource limit.
        # The reference silently allocates ZERO units per worker when the
        # limit is absent (mpi_job_controller.go:587-593) and the job then
        # fails at runtime; we reject at admission instead — "fail at
        # admission, not at runtime" (documented divergence).
        # applies to EVERY effective resource type (cpu included): a
        # missing limit silently allocates zero units per worker whatever
        # the type, the exact runtime failure this check exists to prevent
        rtype = spec.processing_resource_type or default_resource_type
        if not spec.template.containers:
            errs.append(
                "spec.replicas mode requires a worker container with a "
                f"{rtype!r} resource limit; the pod template has no "
                "containers"
            )
        elif not spec.template.main_container().limits.get(rtype, 0):
            errs.append(
                f"spec.replicas mode requires a {rtype!r} resource "
                f"limit on the worker container (each worker would "
                f"otherwise get zero chips; ref mpi_job_controller.go"
                f":587-593 allocates 0 silently — rejected here)"
            )

    if spec.tpus_per_worker is not None and spec.tpus_per_worker < 1:
        errs.append(f"spec.tpusPerWorker must be >= 1, got {spec.tpus_per_worker}")

    if (spec.processing_units_per_worker is not None
            and spec.processing_units_per_worker < 1):
        errs.append(
            f"spec.processingUnitsPerWorker must be >= 1, got "
            f"{spec.processing_units_per_worker}"
        )

    # Mode A divisibility with an EXPLICIT per-worker count is checkable at
    # admission (mirrors the new CRD CEL rules; the flag-default case stays
    # a controller backstop that converges to Failed/InvalidTPUJobSpec)
    for total, per, fname in (
        (spec.tpus, spec.tpus_per_worker, "tpus"),
        (spec.processing_units, spec.processing_units_per_worker,
         "processingUnits"),
    ):
        if (total is not None and per is not None and per >= 1
                and total >= per and total % per):
            errs.append(
                f"spec.{fname}={total} must be a multiple of the per-worker "
                f"count ({per}) — ref mpi_job_controller.go:580"
            )

    if (
        spec.processing_resource_type is not None
        and spec.processing_resource_type not in (
            RESOURCE_GPU, RESOURCE_CPU, RESOURCE_TPU)
    ):
        # ref: cmd/mpi-operator/main.go:108-110 restricts to nvidia.com/gpu|cpu;
        # the TPU type stays valid beside them
        errs.append(
            f"spec.processingResourceType must be {RESOURCE_GPU!r}, "
            f"{RESOURCE_CPU!r} or {RESOURCE_TPU!r}, got "
            f"{spec.processing_resource_type!r}"
        )
    elif spec.tpus is not None and spec.processing_resource_type == RESOURCE_GPU:
        # the tpus sizing mode stays TPU mode (its elastic, resize and
        # fleet-scheduler paths count TPU chips): a GPU job is spelled
        # with processingUnits or replicas
        errs.append(
            f"spec.tpus is the TPU sizing mode and cannot take "
            f"processingResourceType {RESOURCE_GPU!r}; spell a GPU job "
            f"with spec.processingUnits or spec.replicas"
        )

    if spec.slots_per_worker is not None and spec.slots_per_worker < 1:
        errs.append(f"spec.slotsPerWorker must be >= 1, got {spec.slots_per_worker}")

    if spec.num_slices < 1:
        errs.append(f"spec.numSlices must be >= 1, got {spec.num_slices}")
    elif spec.num_slices > 1:
        # every slice is a worker group of equal size — the derived worker
        # count must divide. Checkable at admission whenever the spec
        # itself determines the count (replicas mode, or Mode A with an
        # explicit per-worker); the controller keeps a backstop for the
        # flag-default case it alone can see.
        workers = _derived_workers(spec)
        if workers is not None and workers % spec.num_slices:
            errs.append(
                f"the spec derives {workers} worker(s), which does not "
                f"divide into {spec.num_slices} slices (each slice is an "
                f"equal worker group)"
            )

    if spec.slice_topology is not None:
        total = spec.tpus or spec.processing_units
        field = "spec.tpus" if spec.tpus is not None else \
            "spec.processingUnits"
        # sliceTopology describes ONE slice; a multi-slice job's chip
        # count divides over numSlices first (e.g. tpus=64, numSlices=2 →
        # two 4x8 v5e-32 slices joined over DCN)
        per_slice = None
        if total is not None and spec.num_slices >= 1:
            if total % spec.num_slices:
                if spec.tpus is None:   # tpus-mode already reported this
                    errs.append(
                        f"{field}={total} does not divide into "
                        f"{spec.num_slices} slices"
                    )
            else:
                per_slice = total // spec.num_slices
        valid_topos = V5E_TOPOLOGIES.get(per_slice) if per_slice else None
        if valid_topos is not None and spec.slice_topology not in valid_topos:
            errs.append(
                f"spec.sliceTopology={spec.slice_topology!r} does not match "
                f"{per_slice} chips per slice; valid: {valid_topos}"
            )
        elif valid_topos is None and per_slice is not None:
            errs.append(
                f"no known v5e topology for {per_slice} chips per slice "
                f"with an explicit sliceTopology"
            )

    if spec.elastic:
        # checkpoint-restart elasticity needs a topology ladder to walk:
        # Mode A chip counts, one slice (multi-slice shrink would have to
        # re-plan the DCN mesh — not supported)
        if spec.tpus is None:
            errs.append(
                "spec.elastic requires the tpus sizing mode (the "
                "controller shrinks along the valid v5e chip-count ladder)"
            )
        if spec.num_slices > 1:
            errs.append(
                f"spec.elastic does not support numSlices="
                f"{spec.num_slices} (> 1)"
            )
    if spec.min_tpus is not None:
        if not spec.elastic:
            errs.append("spec.minTpus requires spec.elastic")
        if not _valid_tpu_count(spec.min_tpus):
            errs.append(
                f"spec.minTpus={spec.min_tpus} is not a valid v5e chip "
                f"count {V5E_VALID_SLICE_CHIPS}"
            )
        elif spec.tpus is not None and spec.min_tpus > spec.tpus:
            errs.append(
                f"spec.minTpus={spec.min_tpus} exceeds spec.tpus="
                f"{spec.tpus}"
            )

    if spec.resize is not None:
        # user-driven gang resize walks the same single-slice Mode A
        # topology ladder the elastic controller does — but it is the
        # USER steering the size, so it cannot share the job with the
        # controller-driven rewrites
        if spec.tpus is None:
            errs.append(
                "spec.resize requires the tpus sizing mode (the resize "
                "target replaces spec.tpus on the v5e chip-count ladder)"
            )
        if spec.num_slices > 1:
            errs.append(
                f"spec.resize does not support numSlices="
                f"{spec.num_slices} (> 1)"
            )
        if not _valid_tpu_count(spec.resize):
            errs.append(
                f"spec.resize={spec.resize} is not a valid v5e chip "
                f"count {V5E_VALID_SLICE_CHIPS}"
            )
        if spec.elastic:
            errs.append(
                "spec.resize is incompatible with spec.elastic (two "
                "drivers steering one gang size)")
        if spec.serving is not None:
            errs.append(
                "spec.resize is incompatible with spec.serving (a resize "
                "cannot preserve the fixed pool split)")
        if spec.pack_group:
            errs.append(
                "spec.resize is incompatible with spec.packGroup (both "
                "rewrite the worker topology)")

    if spec.serving is not None:
        # disaggregated-serving role pools (serve/engine.py DisaggEngine):
        # the pools re-partition the worker gang the sizing mode derives —
        # they never resize it, so the counts must agree exactly
        sv = spec.serving
        if sv.prefill_replicas < 1:
            errs.append(
                f"spec.serving.prefillReplicas must be >= 1, got "
                f"{sv.prefill_replicas}")
        if sv.decode_replicas < 1:
            errs.append(
                f"spec.serving.decodeReplicas must be >= 1, got "
                f"{sv.decode_replicas}")
        if spec.num_slices > 1:
            errs.append(
                f"spec.serving does not support numSlices="
                f"{spec.num_slices} (> 1); role pools partition a "
                f"single-slice gang")
        if spec.elastic:
            errs.append(
                "spec.serving is incompatible with spec.elastic (an "
                "elastic shrink cannot preserve the fixed pool split)")
        if spec.pack_group:
            errs.append(
                "spec.serving is incompatible with spec.packGroup (both "
                "rewrite the worker topology)")
        if sv.slo is not None:
            # SLO-driven decode autoscaling targets: at least one
            # observable target, a sane replica band containing the
            # spec baseline, and non-negative timing knobs — the
            # autoscale pass assumes all of this and must never have
            # to re-validate mid-decision
            slo = sv.slo
            targets = [("ttftP99Seconds", slo.ttft_p99_seconds),
                       ("tpotP99Seconds", slo.tpot_p99_seconds),
                       ("queueDepth", slo.queue_depth)]
            live = [(n, v) for n, v in targets if v is not None]
            if not live:
                errs.append(
                    "spec.serving.slo must set at least one target "
                    "(ttftP99Seconds, tpotP99Seconds or queueDepth)")
            for n, v in live:
                if v <= 0:
                    errs.append(
                        f"spec.serving.slo.{n} must be > 0, got {v}")
            if slo.min_decode_replicas < 1:
                errs.append(
                    f"spec.serving.slo.minDecodeReplicas must be >= 1, "
                    f"got {slo.min_decode_replicas}")
            if slo.max_decode_replicas < slo.min_decode_replicas:
                errs.append(
                    f"spec.serving.slo.maxDecodeReplicas "
                    f"({slo.max_decode_replicas}) must be >= "
                    f"minDecodeReplicas ({slo.min_decode_replicas})")
            if not (slo.min_decode_replicas <= sv.decode_replicas
                    <= slo.max_decode_replicas):
                errs.append(
                    f"spec.serving.decodeReplicas "
                    f"({sv.decode_replicas}) must sit inside the slo "
                    f"band [{slo.min_decode_replicas}, "
                    f"{slo.max_decode_replicas}] (it is the autoscaler's "
                    f"baseline)")
            for n, v in (("breachSeconds", slo.breach_seconds),
                         ("clearSeconds", slo.clear_seconds),
                         ("cooldownMultiplier", slo.cooldown_multiplier),
                         ("cooldownFloorSeconds",
                          slo.cooldown_floor_seconds)):
                if v < 0:
                    errs.append(
                        f"spec.serving.slo.{n} must be >= 0, got {v}")
        workers = _derived_workers(spec)
        want = sv.prefill_replicas + sv.decode_replicas
        if (workers is not None and spec.num_slices == 1
                and sv.prefill_replicas >= 1 and sv.decode_replicas >= 1
                and workers != want):
            errs.append(
                f"spec.serving pools need prefillReplicas + "
                f"decodeReplicas == worker replicas: {want} != {workers} "
                f"(the sizing mode derives the worker count; serving only "
                f"partitions it)")

    if spec.backoff_limit is not None and spec.backoff_limit < 0:
        errs.append(f"spec.backoffLimit must be >= 0, got {spec.backoff_limit}")

    if (
        spec.active_deadline_seconds is not None
        and spec.active_deadline_seconds < 1
    ):
        errs.append(
            f"spec.activeDeadlineSeconds must be >= 1, got "
            f"{spec.active_deadline_seconds}"
        )

    if (
        spec.progress_deadline_seconds is not None
        and spec.progress_deadline_seconds < 1
    ):
        errs.append(
            f"spec.progressDeadlineSeconds must be >= 1, got "
            f"{spec.progress_deadline_seconds}"
        )

    if not isinstance(spec.priority, int) or isinstance(spec.priority, bool) \
            or spec.priority < 0:
        # fleet-scheduler ordering key: descending priority then creation
        # time. Negative (or non-integer) priorities would make the queue
        # order ambiguous against the 0 default.
        errs.append(
            f"spec.priority must be an integer >= 0, got "
            f"{spec.priority!r}"
        )

    if spec.clean_pod_policy not in ("Running", "All", "None"):
        # ref: v1alpha2/types.go:55-66 CleanPodPolicy
        errs.append(
            f"spec.cleanPodPolicy must be Running|All|None, got "
            f"{spec.clean_pod_policy!r}"
        )

    if spec.restart_policy not in ("Never", "OnFailure", "ExitCode"):
        # ref: v1alpha2 RestartPolicy (common_types.go:131-156); "Always" is
        # rejected for the launcher — a completion signal must terminate
        errs.append(
            f"spec.restartPolicy must be Never|OnFailure|ExitCode, got "
            f"{spec.restart_policy!r}"
        )

    if errs:
        raise ValidationError(errs)


def default_topology(chips: int) -> str:
    """Pick the canonical topology string for a chip count (first entry)."""
    topos = V5E_TOPOLOGIES.get(chips)
    if topos is None:
        raise ValidationError([f"no v5e topology for {chips} chips"])
    return topos[0]


__all__ = ["ValidationError", "validate_spec", "default_topology", "V5E_TOPOLOGIES"]
