"""The port's elastic gang-resize benchmark
(examples/elastic_benchmark.py) end to end on the CPU at the reference's
defaults: 4 -> 2 -> 4 ranks, SIGTERM at steps 5 and 10, the resharded
restores, the resize ledger's drain / restore / recompile split, the
goodput, and the final loss against the straight-through oracle
(rel_tol 1e-3, abs_tol 1e-4)."""
import importlib
import json
import os

import pytest
import torch

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

elastic = importlib.import_module(
    "mpi_operator_tpu_torch.examples.elastic_benchmark")


def test_elastic_benchmark_holds_every_gate(tmp_path):
    out = tmp_path / "elastic"
    logs = []
    result = elastic.run_elastic_benchmark(out_dir=str(out), device="cpu",
                                          log=logs.append)
    assert result["ok"], (result.get("failures"), logs)
    assert [(p["devices"], p["batch_per_device"], p["rc"])
            for p in result["phases"]] == [(4, 2, 215), (2, 4, 215),
                                           (4, 2, 0)]
    assert len(result["resize_seconds"]) == 2
    for r in result["resizes"]:
        assert r["kind"] == "gang_resize"
        for key in ("drain_seconds", "restore_seconds",
                    "recompile_seconds", "total_seconds"):
            assert r[key] >= 0, key
    assert [r["workers"] for r in result["resizes"]] == [2, 4]
    assert result["resharded_restores"] >= 2
    assert 0 < result["goodput"] <= 1 and result["useful_steps"] == 14
    assert result["elastic_token_identical"] is True
    assert abs(result["final_loss"] - result["oracle_final_loss"]) <= max(
        1e-4, 1e-3 * abs(result["oracle_final_loss"]))
    with open(result["metrics"]) as f:
        assert "tpu_job_resize_seconds" in f.read()
    with open(os.path.join(out, "timeline.jsonl")) as f:
        events = [json.loads(line)["event"] for line in f]
    assert events.count("gang_resize") == 2
    assert "checkpoint_restore" in events and "first_resume_step" in events


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]])
def test_elastic_benchmark_needs_a_card_unless_asked_for_the_cpu(argv):
    """The default is the card: without one the benchmark raises before
    it starts a phase."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elastic.main(argv + ["--no-oracle"])
    with pytest.raises(ValueError, match="device must be"):
        elastic.run_elastic_benchmark(device="tpu")
