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

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "mpi_operator_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mpi_operator_tpu")
#: the serving fleet's own modules (ROADMAP step 9)
FLEET_MODULES = ("mpi_operator_tpu_torch.serve.transfer",
                 "mpi_operator_tpu_torch.serve.router",
                 "mpi_operator_tpu_torch.telemetry.collector")


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
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for m in FLEET_MODULES + ("mpi_operator_tpu_torch.serve.engine",):
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
    for m in FLEET_MODULES:
        assert ROOT / (m.replace(".", "/") + ".py") in files, m
    assert not bad, bad


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
