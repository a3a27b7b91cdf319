"""The legs of the port's chaos soak (controller/chaos.py) that the
reference's suite runs only inside its out-of-process soak, in process:
scrape bursts against the serving lease, live decode-pool scaling with
the controller killed at each scalingReplica marker, the fleet
scheduler's anti-thrash gate and degraded-rank migration, and the four
engine legs (request timeouts, router failover, trace completeness,
live-scale engines) on device="cpu". The engine legs' router results
must be token for token the port's single-engine greedy oracle (each leg
checks it and raises otherwise; that oracle is held to the JAX engine by
tests/test_torch_router.py), and without a card each leg's default
device raises instead of falling back. 13 cases.
"""
import pytest
import torch

from mpi_operator_tpu_torch.controller import chaos as chaos_mod

pytestmark = pytest.mark.chaos

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)



# ---------------------------------------------------------------------------
# the soak's other legs, in process: scrape bursts, live scaling, the
# fleet scheduler's gate and migration
# ---------------------------------------------------------------------------

def test_scrape_bursts_neither_trip_nor_disarm_the_lease():
    report = chaos_mod.data_plane_scrape_bursts(seed=0)
    assert report["burst_windows_hit"] >= 2
    assert report["burst_faults_injected"] > 0
    assert report["burst_false_positive_restarts"] == 0
    assert report["burst_real_stall_detected"] == 1


def test_live_scale_survives_a_crash_at_each_marker():
    report = chaos_mod.data_plane_live_scale(seed=0)
    assert report["live_scale_marker_crashes"] == 2
    assert report["live_scale_ledger_records"] == 2
    assert report["live_scale_double_records"] == 0
    assert report["live_scale_gang_entries"] == 0
    assert report["live_scale_in_replicas"] == 1


def test_scheduler_thrash_gate_refuses_and_records():
    report = chaos_mod.scheduler_thrash(seed=0)
    assert report["sched_skips_recorded"] >= 1
    assert report["sched_thrash_resizes"] == 0


def test_scheduler_migrates_a_dark_rank_once():
    assert chaos_mod.scheduler_migration(seed=0) == {
        "sched_migrations": 1, "sched_migration_restarts": 0,
        "sched_migrations_per_window_max": 1}


# ---------------------------------------------------------------------------
# the engine legs on the CPU, and their refusal without a card
# ---------------------------------------------------------------------------

def test_request_timeout_leg_on_the_cpu():
    assert chaos_mod.data_plane_request_timeouts(seed=0, device="cpu") == {
        "request_timeouts": 5, "leaked_pages": 0, "leaked_slots": 0}


def test_router_failover_leg_matches_the_single_engine_oracle():
    report = chaos_mod.data_plane_router_failover(seed=0, device="cpu")
    assert report["router_failover_lost"] == 0
    assert report["router_resubmitted"] > 0
    assert report["router_dead_replicas"] == 1


def test_trace_complete_leg_on_the_cpu():
    report = chaos_mod.data_plane_trace_complete(seed=0, device="cpu")
    assert report["trace_complete_requests"] == 6
    assert report["trace_complete_orphans"] == 0
    assert report["trace_complete_failover_roots"] > 0
    assert report["trace_complete_shed_roots"] > 0


def test_live_scale_engines_leg_matches_the_single_engine_oracle():
    report = chaos_mod.data_plane_live_scale_engines(seed=0, device="cpu")
    assert report["live_scale_lost"] == 0
    assert report["live_scale_token_mismatches"] == 0
    assert report["live_scale_leaked_pages"] == 0
    assert (report["live_scale_attaches"],
            report["live_scale_detaches"]) == (1, 1)


def test_engine_legs_seeded_weights_are_the_generators():
    """The legs' model is create_lm's gpt2-test from the same seed: the
    weights come from a seeded torch.Generator, the same on every call,
    and another seed draws others."""
    from mpi_operator_tpu_torch.models import create_lm
    a, b = chaos_mod._test_lm(3, "cpu"), chaos_mod._test_lm(3, "cpu")
    ref = create_lm("gpt2-test", device="cpu", seed=3, vocab_size=64,
                    max_len=64, dtype=torch.float32, attention="dense")
    for (name, p), q, r in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               ref.state_dict().values()):
        assert torch.equal(p, q) and torch.equal(p, r), name
    assert a.config.vocab_size == 64 and a.config.max_len == 64
    other = chaos_mod._test_lm(4, "cpu")
    assert not torch.equal(a.wte.weight, other.wte.weight)


@pytest.mark.parametrize("leg", ["data_plane_request_timeouts",
                                 "data_plane_router_failover",
                                 "data_plane_trace_complete",
                                 "data_plane_live_scale_engines"])
def test_engine_legs_raise_without_a_card(leg, monkeypatch):
    """Each engine leg runs on the card unless asked for the CPU; with
    no card it raises, and never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(chaos_mod, leg)(seed=0)

