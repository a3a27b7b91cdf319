"""The PyTorch port stands alone: it never imports JAX, flax or the JAX
package (not even that package's framework-free modules), and its entry
points run on the CUDA card unless the caller asks for the CPU by name.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.models import create_lm, generate
from mpi_operator_tpu_torch.serve import ServingEngine

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "mpi_operator_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mpi_operator_tpu")
#: the serving fleet's own modules (ROADMAP step 9)
FLEET_MODULES = ("mpi_operator_tpu_torch.serve.transfer",
                 "mpi_operator_tpu_torch.serve.router",
                 "mpi_operator_tpu_torch.telemetry.collector")
#: the sweeps and elasticity slice (ROADMAP step 10e)
SWEEP_MODULES = ("mpi_operator_tpu_torch.train.hfta",
                 "mpi_operator_tpu_torch.examples.elastic_benchmark",
                 "mpi_operator_tpu_torch.examples.sched_benchmark")
#: the operator's control plane (ROADMAP step 8a), which loads no torch
CONTROL_PLANE = ("mpi_operator_tpu_torch.__main__",
                 "mpi_operator_tpu_torch.api.types",
                 "mpi_operator_tpu_torch.api.validation",
                 "mpi_operator_tpu_torch.cluster.apiserver",
                 "mpi_operator_tpu_torch.cluster.chaos",
                 "mpi_operator_tpu_torch.cluster.informers",
                 "mpi_operator_tpu_torch.cluster.kubeclient",
                 "mpi_operator_tpu_torch.cluster.resources",
                 "mpi_operator_tpu_torch.cluster.serialize",
                 "mpi_operator_tpu_torch.cluster.workqueue",
                 "mpi_operator_tpu_torch.controller",
                 "mpi_operator_tpu_torch.controller.autoscale",
                 "mpi_operator_tpu_torch.controller.chaos",
                 "mpi_operator_tpu_torch.controller.metrics",
                 "mpi_operator_tpu_torch.controller.packing",
                 "mpi_operator_tpu_torch.controller.scheduler",
                 "mpi_operator_tpu_torch.postmortem",
                 "mpi_operator_tpu_torch.telemetry.chaos")
#: the telemetry modules the control plane imports
CONTROL_TELEMETRY = ("mpi_operator_tpu_torch.telemetry.events",
                     "mpi_operator_tpu_torch.telemetry.core",
                     "mpi_operator_tpu_torch.telemetry.prometheus",
                     "mpi_operator_tpu_torch.telemetry.collector",
                     "mpi_operator_tpu_torch.telemetry.drain")
#: the one function of the control plane that imports torch, lazily: the
#: chaos soak's engine legs build their model through it, and the soak
#: runs them only where torch can load (controller/chaos.py)
LAZY_TORCH = {"controller/chaos.py": ("_test_lm",)}
#: a fresh interpreter in which importing torch or jax raises, as in an
#: operator image that holds neither (Dockerfile:14-23)
NO_DATA_PLANE = ("import sys\n"
                 "for m in ('torch', 'jax', 'jaxlib', 'triton'):\n"
                 "    sys.modules[m] = None\n")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _python(code, *args):
    return subprocess.run([sys.executable, *args, "-c", code], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_importing_the_port_loads_no_jax():
    """In a fresh interpreter, importing every module of the port adds
    neither JAX nor the JAX package to sys.modules."""
    def module(path):
        parts = path.relative_to(ROOT).with_suffix("").parts
        return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)
    mods = sorted(module(p) for p in PORT.rglob("*.py"))
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for m in FLEET_MODULES + SWEEP_MODULES + (
            "mpi_operator_tpu_torch.serve.engine",):
        assert m in loaded, m
    assert not [m for m in loaded if _forbidden(m)]


def test_no_source_of_the_port_imports_jax():
    """An AST scan of the package and of chip_smoke.py: no import of
    JAX, flax or the JAX package, at any depth of any function."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{f.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert len(files) > 10
    for m in FLEET_MODULES + SWEEP_MODULES + CONTROL_PLANE:
        path = ROOT / (m.replace(".", "/") + ".py")
        if not path.exists():
            path = ROOT / m.replace(".", "/") / "__init__.py"
        assert path in files, m
    assert not bad, bad


def test_the_control_plane_loads_neither_torch_nor_jax():
    """In a fresh interpreter where importing torch or jax raises, the
    operator's modules and the telemetry they use import, and none of
    them is the JAX package; an AST scan finds no torch import in their
    sources at any depth."""
    mods = CONTROL_PLANE + CONTROL_TELEMETRY
    out = _python(NO_DATA_PLANE + (
        "import importlib, json\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k, v in sys.modules.items()\n"
        "                        if v is not None)))\n"))
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if _forbidden(m)]
    files = [f for pkg in ("api", "cluster", "controller")
             for f in (PORT / pkg).rglob("*.py")]
    files += [PORT / "postmortem.py"] + [
        PORT / "telemetry" / f"{m}.py" for m in (
            "chaos", "collector", "drain", "events", "core", "prometheus",
            "trace")]
    lazy = 0
    for f in files:
        tree = ast.parse(f.read_text(), str(f))
        allowed = set()
        for node in ast.walk(tree):
            if (isinstance(node, ast.FunctionDef) and node.name in
                    LAZY_TORCH.get(str(f.relative_to(PORT)), ())):
                allowed |= {id(n) for n in ast.walk(node)}
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            torch_names = [n for n in names
                           if n.split(".")[0] in ("torch", "triton")]
            if torch_names and id(node) in allowed:
                lazy += 1
                continue
            assert not torch_names, f
    assert lazy == 1


def test_the_operator_cli_runs_without_torch():
    """`python -m mpi_operator_tpu_torch --help` exits 0, and --demo
    drives a GPU job to completion, with torch and jax unimportable."""
    out = subprocess.run([sys.executable, "-m", "mpi_operator_tpu_torch",
                          "--help"], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "nvidia.com/gpu" in out.stdout
    run = ("import runpy\n"
           "sys.argv = ['mpi_operator_tpu_torch'] + {argv!r}\n"
           "runpy.run_module('mpi_operator_tpu_torch', run_name='__main__',"
           " alter_sys=True)\n")
    out = _python(NO_DATA_PLANE + run.format(argv=["--help"]))
    assert out.returncode == 0, out.stderr
    out = _python(NO_DATA_PLANE + run.format(argv=["--demo"]))
    assert out.returncode == 0, out.stderr
    assert "submitted TPUJob demo (nvidia.com/gpu: 2 workers x 8)" in (
        out.stderr)
    assert "demo lifecycle complete" in out.stderr


def test_the_chaos_soak_runs_without_torch():
    """`python -m mpi_operator_tpu_torch.controller.chaos` in the
    operator's image: with torch and jax unimportable the control-plane
    soak and its GPU soak run to their oracles, and the engine legs are
    found unloadable (the full soak reports them skipped there)."""
    run = ("import json, runpy\n"
           "from mpi_operator_tpu_torch.controller import chaos\n"
           "assert not chaos.engine_legs_importable()\n"
           "sys.argv = ['chaos', '--seed', '7', '--lifecycles', '5',\n"
           "            '--no-scheduler', '--no-data-plane']\n"
           "runpy.run_module('mpi_operator_tpu_torch.controller.chaos',\n"
           "                 run_name='__main__', alter_sys=True)\n")
    out = _python(NO_DATA_PLANE + run)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["completed"] == 5 and report["gpu"]["completed"] == 4
    assert report["crashes"] > 0 and report["total_faults"] > 0


def test_span_still_loads_for_the_data_plane():
    """telemetry's `span` (which needs torch) loads on first use."""
    from mpi_operator_tpu_torch import telemetry
    from mpi_operator_tpu_torch.telemetry import span
    from mpi_operator_tpu_torch.telemetry.spans import span as direct
    assert span is direct and telemetry.span is direct
    with span("test.region"):
        pass
    with pytest.raises(AttributeError):
        telemetry.no_such_name


def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    """With no CUDA device and no explicit device="cpu", create_lm,
    generate and ServingEngine raise; they never fall back to the CPU."""
    model = create_lm("gpt2-test", device="cpu", vocab_size=64, max_len=32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_lm("gpt2-test", vocab_size=64, max_len=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(model, np.zeros((1, 4), np.int64), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_lm("gpt2-test", device="cuda", vocab_size=64, max_len=32)
    # the explicit opt-in works
    out = generate(model, np.zeros((1, 4), np.int64), 2, device="cpu")
    assert out.tokens.shape == (1, 6)


def test_fleet_entry_points_refuse_to_run_without_a_card(monkeypatch):
    """DisaggEngine and the fleet legs of the serving benchmark run on
    the card unless asked for the CPU: without a card they raise."""
    from mpi_operator_tpu_torch.examples import serve_benchmark as sb
    from mpi_operator_tpu_torch.serve import DisaggEngine, EngineConfig
    model = create_lm("gpt2-test", device="cpu", vocab_size=64, max_len=32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DisaggEngine(model, EngineConfig(paged=True, page_size=8))
    for leg in ("disagg", "router", "livescale"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(sb, f"run_{leg}_benchmark")(size="test")
    disagg = DisaggEngine(model, EngineConfig(paged=True, page_size=8,
                                              chunk_buckets=(8, 16)),
                          devices=("cpu", "cpu"))
    assert disagg.devices == (torch.device("cpu"),) * 2
