"""The port's deploy files (mpi_operator_tpu_torch/deploy/): its CRD, the
operator's namespace, RBAC and Deployment, the two images and the GPU
example jobs. 20 cases.

- The CRD's processingResourceType enum is exactly the set the port's
  api/validation.py accepts (nvidia.com/gpu, cpu, google.com/tpu), so a
  real API server admits a GPU job in the processingUnits spelling; it
  keeps every CEL rule of the JAX package's CRD and adds the one that
  refuses tpus with nvidia.com/gpu, which agrees with the validation on
  every spec tried; every spec field the port's serializer writes is a
  property of the schema (the API server prunes the rest).
- Every GPU example job validates through `from_manifest` and
  `validate_spec` under the operator's GPU default, allocates
  nvidia.com/gpu workers, and runs the port's CLI with arguments that
  CLI parses; the six workloads the port trains are there, in both GPU
  spellings (processingUnits with nvidia.com/gpu, replicas with
  nvidia.com/gpu container limits).
- The Deployment's args parse with the port's `build_parser` into the
  GPU defaults, with no observatory flag; the namespace and RBAC are the
  JAX package's, plus the pods grant the controller needs.
- The operator image's import-poison check names every control-plane
  module and passes here, in an interpreter where torch and jax cannot
  load; the worker image names its base image and builds both kernel
  sources.
"""
import argparse
import pathlib
import re
import subprocess
import sys

import pytest
import yaml

from mpi_operator_tpu_torch.api.types import (RESOURCE_CPU, RESOURCE_GPU,
                                              RESOURCE_TPU, Container,
                                              PodTemplateSpec, ServingSpec,
                                              TPUJobSpec)
from mpi_operator_tpu_torch.api.validation import ValidationError, validate_spec
from mpi_operator_tpu_torch.cluster.apiserver import InMemoryAPIServer
from mpi_operator_tpu_torch.cluster.serialize import from_manifest, to_manifest
from mpi_operator_tpu_torch.controller import TPUJobController

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEPLOY = ROOT / "mpi_operator_tpu_torch" / "deploy"
EXAMPLES = sorted((DEPLOY / "examples").glob("*.yaml"))
#: the workloads the port trains, and the CLI each example runs
WORKLOADS = {"gpt2": "lm_benchmark", "bert": "lm_benchmark",
             "llama": "lm_benchmark", "moe": "lm_benchmark",
             "resnet": "benchmark", "vit": "lm_benchmark"}
#: resource types to try against the validation: the three it accepts
#: and some it must refuse
CANDIDATE_TYPES = (RESOURCE_GPU, RESOURCE_CPU, RESOURCE_TPU, "amd.com/gpu",
                   "nvidia.com/mig-1g.10gb", "google.com/tpu-v5p", "gpu")


def _load(path):
    with open(path) as f:
        return yaml.safe_load(f)


def _spec_schema(path=DEPLOY / "0-crd.yaml"):
    crd = _load(path)
    return crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"][
        "properties"]["spec"]


def _accepted(rtype) -> bool:
    try:
        validate_spec(TPUJobSpec(processing_units=8,
                                 processing_units_per_worker=8,
                                 processing_resource_type=rtype))
    except ValidationError as exc:
        assert "processingResourceType" in str(exc)
        return False
    return True


# ---------------------------------------------------------------------------
# the CRD
# ---------------------------------------------------------------------------

def test_crd_enum_equals_the_validation_set():
    enum = _spec_schema()["properties"]["processingResourceType"]["enum"]
    assert len(enum) == len(set(enum))
    assert set(enum) == {t for t in CANDIDATE_TYPES if _accepted(t)} == {
        RESOURCE_GPU, RESOURCE_CPU, RESOURCE_TPU}
    # the JAX package's CRD refuses the port's GPU spelling (the fault
    # this CRD closes); its own file stays as it is
    jax_enum = _spec_schema(ROOT / "deploy" / "0-crd.yaml")[
        "properties"]["processingResourceType"]["enum"]
    assert RESOURCE_GPU not in jax_enum


def test_crd_keeps_every_cel_rule_of_the_jax_crd_and_adds_one():
    port = _spec_schema()["x-kubernetes-validations"]
    ref = _spec_schema(ROOT / "deploy" / "0-crd.yaml")[
        "x-kubernetes-validations"]
    for rule in ref:
        assert rule in port, rule["rule"]
    (added,) = [r for r in port if r not in ref]
    assert "self.tpus" in added["rule"]
    assert "'nvidia.com/gpu'" in added["rule"]
    assert "processingUnits or spec.replicas" in added["message"]
    rules = "\n".join(r["rule"] for r in port)
    # every invariant family api/validation.py enforces is represented
    for family in ("numSlices", "tpusPerWorker", "processingUnitsPerWorker",
                   "sliceTopology", "elastic", "minTpus"):
        assert family in rules, family
    for r in port:
        assert r.get("message"), r["rule"]
    assert _spec_schema()["oneOf"] == _spec_schema(
        ROOT / "deploy" / "0-crd.yaml")["oneOf"]


def _cel(rule: str, spec: dict) -> bool:
    """The subset of CEL the tpus + nvidia.com/gpu rule uses (has(), !,
    ||, &&, ==, != over strings and fields), evaluated on a manifest's
    spec."""
    expr = re.sub(r"has\(self\.(\w+)\)", r"('\1' in spec)", rule)
    expr = re.sub(r"self\.(\w+)", r"spec['\1']", expr)
    expr = expr.replace("||", " or ").replace("&&", " and ")
    expr = re.sub(r"!(?!=)", " not ", expr)
    return bool(eval(expr, {}, {"spec": spec}))   # noqa: S307


@pytest.mark.parametrize("kw", [
    dict(tpus=8, processing_resource_type=RESOURCE_GPU),
    dict(tpus=8, processing_resource_type=RESOURCE_TPU),
    dict(tpus=8, processing_resource_type=RESOURCE_CPU),
    dict(tpus=8),
    dict(processing_units=16, processing_resource_type=RESOURCE_GPU),
    dict(processing_units=16),
], ids=["tpus-gpu", "tpus-tpu", "tpus-cpu", "tpus", "units-gpu", "units"])
def test_tpus_gpu_rule_agrees_with_the_validation(kw):
    """The new CEL rule refuses exactly the specs the validation refuses
    for mixing the tpus mode with nvidia.com/gpu."""
    spec = TPUJobSpec(**kw)
    (rule,) = [r["rule"] for r in _spec_schema()["x-kubernetes-validations"]
               if "'nvidia.com/gpu'" in r["rule"]]
    try:
        validate_spec(spec)
        valid = True
    except ValidationError as exc:
        assert "spec.tpus is the TPU sizing mode" in str(exc)
        valid = False
    manifest = to_manifest_spec(spec)
    assert _cel(rule, manifest) == valid
    assert valid == (kw.get("processing_resource_type") != RESOURCE_GPU
                     or "tpus" not in kw)


def to_manifest_spec(spec: TPUJobSpec) -> dict:
    from mpi_operator_tpu_torch.api.types import ObjectMeta, TPUJob
    job = TPUJob(metadata=ObjectMeta(name="x", namespace="d"), spec=spec)
    return to_manifest(job)["spec"]


def test_crd_lists_every_spec_field_the_serializer_writes():
    """A structural schema prunes unknown fields: every field the port's
    serializer writes must be a property, progressDeadlineSeconds (the
    observatory's lease) among them, and it round-trips."""
    spec = TPUJobSpec(tpus=16, tpus_per_worker=4, slots_per_worker=1,
                      slice_topology="4x4", num_slices=1,
                      launcher_on_master=True, backoff_limit=3,
                      active_deadline_seconds=600,
                      progress_deadline_seconds=120, gang_scheduling=True,
                      clean_pod_policy="All", restart_policy="OnFailure",
                      elastic=True, min_tpus=4, resize=8, priority=2,
                      template=PodTemplateSpec(containers=[
                          Container(name="t", image="i")]))
    written = to_manifest_spec(spec)
    props = _spec_schema()["properties"]
    assert set(written) <= set(props), set(written) - set(props)
    assert props["progressDeadlineSeconds"] == {"type": "integer",
                                                "minimum": 1}
    from mpi_operator_tpu_torch.api.types import ObjectMeta, TPUJob
    back = from_manifest(to_manifest(TPUJob(
        metadata=ObjectMeta(name="x", namespace="d"), spec=spec)))
    assert back.spec.progress_deadline_seconds == 120
    # the serving and pack specs (ROADMAP.md Queue 3, O4) are written,
    # listed by the CRD with their types, and round-trip
    from mpi_operator_tpu_torch.api.types import ServingSLO
    for extra in (dict(pack_group="g"),
                  dict(serving=ServingSpec(prefill_replicas=2,
                                           decode_replicas=3)),
                  dict(serving=ServingSpec(decode_replicas=2, slo=ServingSLO(
                      ttft_p99_seconds=0.5, queue_depth=4.0,
                      min_decode_replicas=1, max_decode_replicas=4,
                      breach_seconds=30.0)))):
        spec = TPUJobSpec(tpus=8, **extra)
        written = to_manifest_spec(spec)
        assert set(written) <= set(props), set(written) - set(props)
        for key in written.get("serving", {}):
            assert key in props["serving"]["properties"], key
        for key in written.get("serving", {}).get("slo", {}):
            assert key in props["serving"]["properties"]["slo"][
                "properties"], key
        back = from_manifest(to_manifest(TPUJob(
            metadata=ObjectMeta(name="x", namespace="d"), spec=spec)))
        assert back.spec.pack_group == spec.pack_group
        assert back.spec.serving == spec.serving
    assert props["packGroup"] == {"type": "string"}
    assert props["serving"]["properties"]["decodeReplicas"] == {
        "type": "integer", "minimum": 1}


# ---------------------------------------------------------------------------
# the GPU example jobs
# ---------------------------------------------------------------------------

class _Parsed(Exception):
    pass


def _parses(module: str, args, monkeypatch) -> argparse.Namespace:
    """Parse `args` with the CLI `module`.main builds, stopping before
    it runs anything."""
    import importlib
    real = argparse.ArgumentParser.parse_args

    def parse(self, argv=None, namespace=None):
        raise _Parsed(real(self, argv, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    mod = importlib.import_module(f"mpi_operator_tpu_torch.examples.{module}")
    with pytest.raises(_Parsed) as got:
        mod.main(list(args))
    return got.value.args[0]


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_gpu_example_validates_and_runs_the_ports_cli(path, monkeypatch):
    job = from_manifest(_load(path))
    validate_spec(job.spec, default_resource_type=RESOURCE_GPU)
    if job.spec.processing_resource_type is not None:
        enum = _spec_schema()["properties"]["processingResourceType"]["enum"]
        assert job.spec.processing_resource_type in enum
    ctrl = TPUJobController(InMemoryAPIServer())
    alloc = ctrl.allocate_processing_units(job, False)
    assert alloc.resource_type == RESOURCE_GPU
    assert alloc.worker_replicas >= 1
    c = job.spec.template.main_container()
    assert c.image == "tpu-bench-torch:latest"
    assert c.command[:2] == ["python", "-m"]
    module = c.command[2].rsplit(".", 1)[1]
    assert c.command[2] == f"mpi_operator_tpu_torch.examples.{module}"
    workload = path.stem.rsplit("-", 1)[1]
    assert WORKLOADS[workload] == module
    args = _parses(module, c.args, monkeypatch)
    if workload in ("gpt2", "bert", "llama", "vit"):
        assert args.workload == workload
    if workload == "moe":
        assert args.moe_experts > 0
    if workload == "resnet":
        assert args.model.startswith("resnet")


def test_examples_cover_every_workload_in_both_spellings():
    spellings = {}
    for path in EXAMPLES:
        spec = from_manifest(_load(path)).spec
        units = spec.processing_units is not None
        if units:
            assert spec.processing_resource_type == RESOURCE_GPU
        else:
            assert spec.replicas is not None
            limits = spec.template.main_container().limits
            assert limits.get(RESOURCE_GPU, 0) >= 1
        spellings[path.stem.rsplit("-", 1)[1]] = units
    assert set(spellings) == set(WORKLOADS)
    assert set(spellings.values()) == {True, False}


# ---------------------------------------------------------------------------
# the operator's Deployment, namespace and RBAC
# ---------------------------------------------------------------------------

def test_deployment_args_parse_with_the_ports_cli():
    from mpi_operator_tpu_torch.__main__ import build_parser
    dep = _load(DEPLOY / "3-gpu-operator.yaml")
    (c,) = dep["spec"]["template"]["spec"]["containers"]
    assert c["image"] == "tpu-operator-torch:latest"
    args = build_parser().parse_args(c["args"])
    assert args.processing_resource_type == RESOURCE_GPU
    assert args.processing_units_per_worker == 8
    assert args.metrics_port == 8080
    # the observatory stays off by default, as in the JAX Deployment
    assert args.worker_metrics_port == 0 and args.events_dir is None
    assert c["livenessProbe"]["httpGet"] == {"path": "/healthz",
                                             "port": "metrics"}
    assert c["ports"] == [{"name": "metrics", "containerPort": 8080}]
    assert dep["metadata"]["namespace"] == _load(
        DEPLOY / "1-namespace.yaml")["metadata"]["name"]
    assert dep["spec"]["template"]["spec"]["serviceAccountName"] == \
        "tpu-operator"


def test_namespace_and_rbac_are_the_jax_packages_plus_pods():
    assert _load(DEPLOY / "1-namespace.yaml") == _load(
        ROOT / "deploy" / "1-namespace.yaml")
    with open(DEPLOY / "2-rbac.yaml") as f:
        port = list(yaml.safe_load_all(f))
    with open(ROOT / "deploy" / "2-rbac.yaml") as f:
        ref = list(yaml.safe_load_all(f))
    assert [d["kind"] for d in port] == [d["kind"] for d in ref]
    role, ref_role = port[1], ref[1]
    for rule in ref_role["rules"]:
        assert rule in role["rules"]
    (extra,) = [r for r in role["rules"] if r not in ref_role["rules"]]
    # the stuck lease, resizes and migration delete worker pods
    assert extra == {"apiGroups": [""], "resources": ["pods"],
                     "verbs": ["get", "list", "watch", "delete"]}


# ---------------------------------------------------------------------------
# the images
# ---------------------------------------------------------------------------

#: the modules the operator image must import with torch and jax poisoned
OPERATOR_MODULES = ("__main__", "cluster.kubeclient", "controller",
                    "controller.chaos", "telemetry.collector",
                    "postmortem")


def _poison_check() -> str:
    text = (DEPLOY / "Dockerfile.operator").read_text()
    m = re.search(r"RUN python - <<'PY'\n(.*?)\nPY\n", text, re.S)
    assert m, "no import-poison check in Dockerfile.operator"
    return m.group(1)


def test_operator_image_poison_check_names_every_control_plane_module():
    check = _poison_check()
    assert "sys.modules['torch'] = None" in check
    assert "sys.modules['jax'] = None" in check
    imported = re.findall(r"^import mpi_operator_tpu_torch\.(\S+)", check,
                          re.M)
    assert sorted(imported) == sorted(OPERATOR_MODULES)
    text = (DEPLOY / "Dockerfile.operator").read_text()
    assert 'ENTRYPOINT ["python", "-m", "mpi_operator_tpu_torch"]' in text
    assert "COPY mpi_operator_tpu_torch/ mpi_operator_tpu_torch/" in text
    assert not re.search(r"mpi_operator_tpu(?!_torch)", text)
    # the check passes on this tree, as the image build runs it
    out = subprocess.run([sys.executable, "-c", check], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "operator imports load neither torch nor jax" in out.stdout


def test_worker_image_names_its_base_and_builds_every_kernel():
    text = (DEPLOY / "Dockerfile.worker").read_text()
    (base,) = re.findall(r"^FROM (\S+)", text, re.M)
    assert base.startswith("nvcr.io/nvidia/pytorch:")
    built = re.search(r"_build\.build\(\[(.*?)\]\)", text, re.S).group(1)
    sources = sorted(p.stem for p in (ROOT / "mpi_operator_tpu_torch" /
                                      "ops" / "csrc").glob("*.cu"))
    assert sorted(re.findall(r"'(\w+)'", built)) == sources
    assert "COPY mpi_operator_tpu_torch /app/mpi_operator_tpu_torch" in text
