"""The port's fleet-scheduler benchmark (examples/sched_benchmark.py)
end to end on the CPU at the reference's defaults: the port's
FleetScheduler preempts lo 4 -> 2 ranks to admit hi (2 ranks), then
grows lo back to 4 once hi is done; lo and hi against their solo
oracles, the sched_* records and the postmortem's "scheduler actions:"
section."""
import importlib

import pytest
import torch

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

sched = importlib.import_module(
    "mpi_operator_tpu_torch.examples.sched_benchmark")


def test_sched_benchmark_holds_every_gate(tmp_path):
    logs = []
    result = sched.run_sched_benchmark(out_dir=str(tmp_path / "sched"),
                                       device="cpu", log=logs.append)
    assert result["ok"], (result.get("failures"), logs)
    assert result["plan1"] == {"action": "preempt", "victim": "default/lo",
                               "beneficiary": "default/hi", "to_chips": 2}
    assert result["plan2"] == {"action": "grow_back", "to_chips": 4}
    assert [(p["job"], p["devices"], p["rc"]) for p in result["phases"]] \
        == [("lo", 4, 215), ("lo", 2, 215), ("hi", 2, 0), ("lo", 4, 0)]
    assert len(result["resize_seconds"]) == 2
    assert result["resharded_restores"] >= 2
    for need in ("sched_queue", "sched_preempt", "sched_admit",
                 "sched_grow_back"):
        assert need in result["scheduler_actions"]
    assert result["lo_token_identical"] is True
    assert result["hi_token_identical"] is True
    with open(result["postmortem"]) as f:
        assert "scheduler actions:" in f.read()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_sched_benchmark_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    """The default is the card: without one the benchmark raises before
    it plans or starts a phase."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sched.run_sched_benchmark(out_dir=str(tmp_path / "sched"))
    assert not (tmp_path / "sched").exists()
