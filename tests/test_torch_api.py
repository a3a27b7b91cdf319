"""API type + validation tests (the reference enforces these via the CRD's
openAPIV3 schema, deploy/0-crd.yaml:16-99; SURVEY.md §2.1).

The scenarios of tests/test_api.py against the PyTorch port's copy
(mpi_operator_tpu_torch.api). One differs: the port accepts the
reference's `nvidia.com/gpu` beside `cpu` and `google.com/tpu`, so
test_resource_type_restricted refuses another type and accepts those
three."""
import pytest

from mpi_operator_tpu_torch.api.types import (
    COND_FAILED, COND_RUNNING, COND_SUCCEEDED, JobCondition, ObjectMeta,
    OwnerReference, TPUJobSpec, TPUJobStatus, is_controlled_by, new_tpu_job,
)
from mpi_operator_tpu_torch.api.validation import (
    ValidationError, default_topology, validate_spec,
)


def test_exactly_one_sizing_mode_required():
    with pytest.raises(ValidationError, match="exactly one"):
        validate_spec(TPUJobSpec())
    with pytest.raises(ValidationError, match="mutually exclusive"):
        validate_spec(TPUJobSpec(tpus=8, replicas=2))
    with pytest.raises(ValidationError, match="mutually exclusive"):
        validate_spec(TPUJobSpec(tpus=8, processing_units=8))


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32, 64, 128, 256])
def test_valid_slice_chip_counts(n):
    validate_spec(TPUJobSpec(tpus=n))


@pytest.mark.parametrize("n", [3, 5, 6, 7, 12, 24, 48, 100])
def test_invalid_slice_chip_counts(n):
    """Invalid shapes fail at admission, not at runtime (SURVEY §7)."""
    with pytest.raises(ValidationError, match="slice chip count"):
        validate_spec(TPUJobSpec(tpus=n))


def test_topology_must_match_chip_count():
    validate_spec(TPUJobSpec(tpus=32, slice_topology="4x8"))
    with pytest.raises(ValidationError, match="does not match"):
        validate_spec(TPUJobSpec(tpus=32, slice_topology="4x4"))


def test_default_topology():
    assert default_topology(32) == "4x8"
    assert default_topology(4) == "2x2"
    with pytest.raises(ValidationError):
        default_topology(13)


def test_resource_type_restricted():
    """ref cmd/mpi-operator/main.go:108-110 (nvidia.com/gpu|cpu); the
    port keeps google.com/tpu valid beside them, and the tpus sizing mode
    stays TPU mode, so it refuses nvidia.com/gpu as the JAX package does."""
    with pytest.raises(ValidationError, match="processingResourceType"):
        validate_spec(TPUJobSpec(tpus=8, processing_resource_type="nvidia.com/gpu"))
    with pytest.raises(ValidationError, match="processingResourceType"):
        validate_spec(TPUJobSpec(processing_units=8,
                                 processing_resource_type="amd.com/gpu"))
    for rtype in ("nvidia.com/gpu", "cpu", "google.com/tpu"):
        validate_spec(TPUJobSpec(processing_units=8,
                                 processing_resource_type=rtype))


def test_clean_pod_policy_restricted():
    with pytest.raises(ValidationError, match="cleanPodPolicy"):
        validate_spec(TPUJobSpec(tpus=8, clean_pod_policy="Sometimes"))


def test_backoff_and_deadline_bounds():
    with pytest.raises(ValidationError, match="backoffLimit"):
        validate_spec(TPUJobSpec(tpus=8, backoff_limit=-1))
    with pytest.raises(ValidationError, match="activeDeadlineSeconds"):
        validate_spec(TPUJobSpec(tpus=8, active_deadline_seconds=0))


def test_is_controlled_by():
    owner = new_tpu_job("job1")
    owner.metadata.uid = "u1"
    child = ObjectMeta(
        name="c", owner_references=[owner.controller_owner_reference()]
    )
    assert is_controlled_by(child, owner.metadata)
    other = ObjectMeta(name="c", owner_references=[OwnerReference(
        api_version="v1", kind="TPUJob", name="job1", uid="u2")])
    assert not is_controlled_by(other, owner.metadata)


def test_conditions_model():
    """v1alpha2 condition semantics (ref common_types.go:101-127)."""
    st = TPUJobStatus()
    st.set_condition(JobCondition(COND_RUNNING, "True"))
    assert not st.is_done()
    st.set_condition(JobCondition(COND_SUCCEEDED, "True"))
    assert st.is_done()
    # terminal condition flips Running to False
    assert st.get_condition(COND_RUNNING).status == "False"
    # last-writer-wins per type: no duplicates
    st.set_condition(JobCondition(COND_SUCCEEDED, "True"))
    assert sum(1 for c in st.conditions if c.type == COND_SUCCEEDED) == 1


def test_condition_transition_time_stable_when_unchanged():
    st = TPUJobStatus()
    st.set_condition(JobCondition(COND_RUNNING, "True", reason="r"))
    t0 = st.get_condition(COND_RUNNING).last_transition_time
    st.set_condition(JobCondition(COND_RUNNING, "True", reason="r"))
    assert st.get_condition(COND_RUNNING).last_transition_time == t0


def test_example_manifests_validate():
    """Every shipped examples/*.yaml must deserialize into a TPUJob whose
    spec passes admission validation (the reference's examples are its
    primary user documentation; shipping an invalid one would be a bug)."""
    import glob
    import os

    import yaml

    from mpi_operator_tpu_torch.cluster.serialize import from_manifest

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    manifests = sorted(glob.glob(os.path.join(repo, "examples", "*.yaml")))
    assert len(manifests) >= 8
    for path in manifests:
        with open(path) as f:
            doc = yaml.safe_load(f)
        job = from_manifest(doc)
        validate_spec(job.spec)   # raises on violation


def test_crd_carries_cel_validation_rules():
    """The port's CRD (mpi_operator_tpu_torch/deploy/0-crd.yaml) must
    enforce the port's api/validation.py invariants SERVER-side via
    x-kubernetes-validations (the reference's schema-first posture — ALL
    its sizing constraints live in the CRD schema so `kubectl create`
    rejects bad specs, ref deploy/0-crd.yaml:16-99), the GPU ones too:
    the resource types the validation accepts, and tpus refused with
    nvidia.com/gpu. Real clusters never run our in-process admission for
    user objects."""
    import os

    import yaml

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "mpi_operator_tpu_torch", "deploy",
                           "0-crd.yaml")) as f:
        crd = yaml.safe_load(f)
    spec_schema = crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"][
        "properties"]["spec"]
    validations = spec_schema["x-kubernetes-validations"]
    rules = "\n".join(v["rule"] for v in validations)
    # every invariant family api/validation.py enforces is represented
    assert "numSlices" in rules          # slice divisibility
    assert "tpusPerWorker" in rules      # Mode A divisibility
    assert "processingUnitsPerWorker" in rules
    assert "sliceTopology" in rules      # topology-product check
    for v in validations:
        assert v.get("message"), f"CEL rule without a message: {v['rule']}"
    # the GPU spelling is admitted, and the tpus mode refuses it
    from mpi_operator_tpu_torch.api.types import (RESOURCE_CPU, RESOURCE_GPU,
                                                  RESOURCE_TPU)
    enum = spec_schema["properties"]["processingResourceType"]["enum"]
    assert set(enum) == {RESOURCE_GPU, RESOURCE_CPU, RESOURCE_TPU}
    assert any("self.tpus" in v["rule"] and "'nvidia.com/gpu'" in v["rule"]
               for v in validations)


def test_mode_a_explicit_per_worker_divisibility():
    """Explicit per-worker counts are checkable at admission (parity with
    the CRD CEL rules); the flag-default case stays a controller backstop
    that converges to Failed/InvalidTPUJobSpec."""
    with pytest.raises(ValidationError, match="multiple"):
        validate_spec(TPUJobSpec(tpus=16, tpus_per_worker=5))
    with pytest.raises(ValidationError, match="multiple"):
        validate_spec(TPUJobSpec(processing_units=10,
                                 processing_units_per_worker=4))
    validate_spec(TPUJobSpec(tpus=16, tpus_per_worker=4))
    # total < perWorker is the legal single-worker form (ref :573-582)
    validate_spec(TPUJobSpec(tpus=2, tpus_per_worker=8))
    # zero/negative per-worker is rejected for BOTH mode-A fields (a zero
    # would otherwise reach allocation's divide)
    with pytest.raises(ValidationError, match="processingUnitsPerWorker"):
        validate_spec(TPUJobSpec(processing_units=10,
                                 processing_units_per_worker=0))


def test_elastic_validation():
    """spec.elastic needs a topology ladder to walk: tpus mode, one
    slice; minTpus requires elastic and must be a valid count <= tpus."""
    validate_spec(TPUJobSpec(tpus=8, elastic=True))
    validate_spec(TPUJobSpec(tpus=16, elastic=True, min_tpus=4))
    with pytest.raises(ValidationError, match="tpus sizing mode"):
        validate_spec(TPUJobSpec(replicas=2, elastic=True))
    with pytest.raises(ValidationError, match="numSlices"):
        validate_spec(TPUJobSpec(tpus=16, elastic=True, num_slices=2,
                                 slice_topology="2x4"))
    with pytest.raises(ValidationError, match="requires spec.elastic"):
        validate_spec(TPUJobSpec(tpus=8, min_tpus=4))
    with pytest.raises(ValidationError, match="not a valid v5e"):
        validate_spec(TPUJobSpec(tpus=8, elastic=True, min_tpus=3))
    with pytest.raises(ValidationError, match="exceeds"):
        validate_spec(TPUJobSpec(tpus=8, elastic=True, min_tpus=16))


def test_elastic_fields_round_trip_serialization():
    from mpi_operator_tpu_torch.api.types import ObjectMeta, TPUJob
    from mpi_operator_tpu_torch.cluster.serialize import (from_manifest,
                                                    to_manifest)

    job = TPUJob(metadata=ObjectMeta(name="e", namespace="d"),
                 spec=TPUJobSpec(tpus=16, elastic=True, min_tpus=4))
    job.status.elastic_tpus = 8
    job.status.elastic_since = 1234567890.0
    back = from_manifest(to_manifest(job))
    assert back.spec.elastic is True
    assert back.spec.min_tpus == 4
    assert back.status.elastic_tpus == 8
    assert abs(back.status.elastic_since - 1234567890.0) < 1.0


def test_multislice_validation_is_per_slice():
    """Slice-shape constraints apply PER SLICE: tpus=512 over 2 slices is
    two valid v5e-256 slices; non-divisible counts fail at admission (the
    SURVEY §7 hard part: invalid shapes must not reach runtime)."""
    validate_spec(TPUJobSpec(tpus=512, num_slices=2,
                             slice_topology="16x16"))
    validate_spec(TPUJobSpec(tpus=96, num_slices=3, slice_topology="4x8"))
    with pytest.raises(ValidationError, match="divide into 3"):
        validate_spec(TPUJobSpec(tpus=64, num_slices=3))
    with pytest.raises(ValidationError, match="processingUnits"):
        validate_spec(TPUJobSpec(processing_units=9, num_slices=2,
                                 slice_topology="2x2"))


def test_mode_b_zero_chip_rejected_at_admission():
    """replicas mode with TPU resource type and NO google.com/tpu limit
    would give every worker zero chips. The reference allocates 0 silently
    (mpi_job_controller.go:587-593) and the job fails at runtime; we
    reject at admission instead (documented divergence — "fail at
    admission, not at runtime")."""
    from mpi_operator_tpu_torch.api.types import RESOURCE_CPU, RESOURCE_TPU

    with pytest.raises(ValidationError, match="resource limit"):
        validate_spec(TPUJobSpec(replicas=2))
    # an explicit TPU resource type without the limit is equally invalid
    with pytest.raises(ValidationError, match="resource limit"):
        validate_spec(TPUJobSpec(replicas=2,
                                 processing_resource_type=RESOURCE_TPU))
    # with the limit present the spec is fine
    spec = TPUJobSpec(replicas=2)
    spec.template.main_container().limits = {RESOURCE_TPU: 4}
    validate_spec(spec)
    # the check follows the EFFECTIVE resource type: Mode B sizes each
    # worker from the matching container limit whatever the type, so a
    # cpu-resource spec without a cpu limit is equally degenerate
    with pytest.raises(ValidationError, match="resource limit"):
        validate_spec(TPUJobSpec(replicas=2,
                                 processing_resource_type=RESOURCE_CPU))
    spec = TPUJobSpec(replicas=2, processing_resource_type=RESOURCE_CPU)
    spec.template.main_container().limits = {RESOURCE_CPU: 2}
    validate_spec(spec)


def test_multislice_mode_a_per_worker_divisibility_at_admission():
    """Mode A with an explicit per-worker count: the derived worker count
    must divide into numSlices AT ADMISSION (tpus=16/16-per-worker = 1
    worker can't split over 2 slices); the flag-default case stays a
    controller backstop."""
    with pytest.raises(ValidationError, match="does not divide into 2"):
        validate_spec(TPUJobSpec(tpus=16, tpus_per_worker=16, num_slices=2,
                                 slice_topology="2x4"))
    # divisible derivations pass
    validate_spec(TPUJobSpec(tpus=16, tpus_per_worker=8, num_slices=2,
                             slice_topology="2x4"))
    with pytest.raises(ValidationError, match="does not divide into 2"):
        validate_spec(TPUJobSpec(replicas=3, num_slices=2))
