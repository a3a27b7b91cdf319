"""The port's serving benchmark (examples/serve_benchmark.py) against
the JAX one, on the CPU at a tiny size: gpt2-test, f32, two slots, four
requests, contiguous (with the sequential baseline and the sync A/B),
paged with a shared prefix, and speculative with the spec A/B. Both
report the same keys under the same names (the host gap, the tracer's
hop fields and trace completeness included), besides the port's own
(captures, the device, the A/B runs); the programs stay within the
no-recompile contract; the sequential generate() baseline produces the
engine's greedy tokens; /metrics serves the engine's live series while
the trace replays; the hooks A/B and the event log count what they
should; `profile_dir` writes one trace of the measured replay.
"""
import json
import re
import urllib.request

import numpy as np
import pytest
import torch

from mpi_operator_tpu.examples.serve_benchmark import (
    run_serving_benchmark as jax_run_serving_benchmark)
from mpi_operator_tpu_torch.examples import serve_benchmark as sb
from mpi_operator_tpu_torch.serve import ServingEngine

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

SMALL = dict(size="test", slots=2, num_requests=4, prompt_grid=(4, 8),
             new_grid=(3, 5), chunk_buckets=(4, 8), dtype_name="float32")
LEGS = {"contiguous": dict(baseline=True, compare_sync=True),
        "paged": dict(baseline=False, paged=True, page_size=8,
                      shared_prefix_len=8),
        "spec": dict(baseline=False, speculative="ngram",
                     compare_spec=True)}
PORT_ONLY = {"serving_step_captures", "serving_prefill_captures",
             "serving_cuda_graphs", "serving_device",
             "serving_verify_captures", "serving_spec_verify_steps",
             "serving_spec_runs", "serving_nospec_runs"}


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_report_keys_contract_and_baseline(leg, monkeypatch):
    seq_tokens, engine_results = {}, []
    generate = sb.generate

    def recording_generate(model, prompt, n, **kw):
        out = generate(model, prompt, n, **kw)
        seq_tokens[tuple(prompt[0])] = out.tokens[0, len(prompt[0]):].tolist()
        return out
    run = ServingEngine.run

    def recording_run(self, requests=(), on_token=None):
        results = run(self, requests, on_token)
        engine_results.append((list(requests), results))
        return results
    monkeypatch.setattr(sb, "generate", recording_generate)
    monkeypatch.setattr(ServingEngine, "run", recording_run)
    ours = sb.run_serving_benchmark(**SMALL, **LEGS[leg], device="cpu",
                                    log=lambda s: None)
    theirs = jax_run_serving_benchmark(**SMALL, **LEGS[leg],
                                       log=lambda s: None)
    assert set(ours) - PORT_ONLY == set(theirs)
    assert ours["serving_trace_complete"] is True
    assert ours["serving_host_gap_p50_ms"] >= 0
    assert 0 <= ours["serving_trace_max_gap_ms"] < 1.0
    assert ours["serving_no_recompile"] is True
    assert ours["serving_step_compiles"] == 1            # all greedy
    assert ours["serving_prefill_compiles"] <= 2
    assert ours["serving_step_captures"] == 0            # the CPU
    assert ours["serving_device"] == "cpu"
    assert ours["serving_total_new_tokens"] == \
        theirs["serving_total_new_tokens"]
    for key in ("serving_tokens_per_sec", "serving_tpot_p50_ms",
                "serving_ttft_p99_ms"):
        assert np.isfinite(ours[key]) and ours[key] > 0
    if leg == "paged":
        assert ours["serving_prefix_hit_requests"] > 0
        assert ours["serving_pages_in_use_peak"] > 0
    elif leg == "spec":
        assert 1 <= ours["serving_verify_compiles"] <= 2
        assert ours["serving_verify_captures"] == 0      # the CPU
        assert ours["serving_spec_greedy_identical"] is True
        assert ours["serving_spec_speedup"] > 0
        assert len(ours["serving_spec_runs"]) == 2
        assert len(ours["serving_nospec_runs"]) == 2
    else:
        assert ours["serving_async_greedy_identical"] is True
        trace, measured = next((reqs, res) for reqs, res in engine_results
                               if len(reqs) == SMALL["num_requests"])
        assert len(seq_tokens) == len(trace)
        for r in trace:
            assert measured[r.id].tokens == seq_tokens[tuple(r.prompt)]


def test_graphs_ab_on_the_cpu_runs_the_same_programs():
    """compare_graphs re-runs the trace with cuda_graphs off: on the CPU
    both arms are eager, and every token, sampled ones included, is
    identical (both start from the same generator state)."""
    m = sb.run_serving_benchmark(**SMALL, temperature=0.8, baseline=False,
                                 compare_graphs=True, device="cpu",
                                 log=lambda s: None)
    assert m["serving_graphs_tokens_identical"] is True
    assert m["serving_eager_tokens_per_sec"] > 0
    for arm in ("graphs", "eager"):
        assert len(m[f"serving_{arm}_runs"]) == 2
        assert all(run["run_tpot_p50_ms"] > 0 for run in
                   m[f"serving_{arm}_runs"])


@pytest.mark.parametrize("kw,step", [
    (dict(profile_dir="trace"), 6)])
def test_later_slices_raise(kw, step, tmp_path):
    """Every argument of the single-engine legs is ported now: the
    profiler window (ROADMAP step 6) writes a chrome trace of the
    measured replay — one trace, the warm-up and reruns outside it — and
    stops before the report; what still raises is an inconsistent
    request (compare_spec without speculative)."""
    kw = {k: str(tmp_path / v) for k, v in kw.items()}
    logs = []
    m = sb.run_serving_benchmark(**SMALL, device="cpu", baseline=False,
                                 log=logs.append, **kw)
    traces = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(traces) == 1, traces
    names = {e.get("name") for e in
             json.loads(traces[0].read_text())["traceEvents"]}
    assert "serve.decode_step" in names or "serve.prefill" in names
    assert any("profiler trace written" in line for line in logs)
    assert m["serving_tokens_per_sec"] > 0
    with pytest.raises(ValueError, match="compare_spec requires"):
        sb.run_serving_benchmark(**SMALL, device="cpu", compare_spec=True)


def test_metrics_port_serves_the_live_engine(monkeypatch):
    """metrics_port=0 starts /metrics on a free port: scraped on
    localhost right after the measured run, it shows the engine's
    tpu_worker_* series with that run's counts."""
    scraped = []
    port = []
    run = ServingEngine.run

    def scraping_run(self, requests=(), on_token=None):
        results = run(self, requests, on_token)
        if len(requests) == SMALL["num_requests"] and not scraped:
            url = f"http://127.0.0.1:{port[0]}/metrics"
            with urllib.request.urlopen(url, timeout=10) as resp:
                scraped.append(resp.read().decode())
        return results
    monkeypatch.setattr(ServingEngine, "run", scraping_run)

    def log(line):
        m = re.search(r"listening on port (\d+)", line)
        if m:
            port.append(int(m.group(1)))
    out = sb.run_serving_benchmark(**SMALL, baseline=False, metrics_port=0,
                                   device="cpu", log=log)
    assert port and scraped
    text = scraped[0]
    warm = len(set(SMALL["prompt_grid"]))
    assert (f"tpu_worker_requests_total {SMALL['num_requests'] + warm}"
            in text)
    assert "tpu_worker_ttft_seconds_bucket" in text
    assert "tpu_worker_host_gap_seconds_count" in text
    assert out["serving_trace_complete"] is True


def test_hooks_ab_and_event_log(tmp_path):
    """compare_hooks runs the trace through an engine with no hooks as
    well (alternated, best of two): greedy tokens identical; the event
    log holds one slot_admit and one slot_retire a measured request."""
    path = tmp_path / "events.jsonl"
    m = sb.run_serving_benchmark(**SMALL, baseline=False, compare_hooks=True,
                                 events_path=str(path), device="cpu",
                                 log=lambda s: None)
    assert m["serving_hooks_greedy_identical"] is True
    assert m["serving_events_logged"] == 2 * SMALL["num_requests"]
    assert m["serving_nohooks_tokens_per_sec"] > 0
    assert len(m["serving_hooks_runs"]) == len(m["serving_nohooks_runs"]) \
        == 2
    kinds = [json.loads(line)["event"]
             for line in path.read_text().splitlines()]
    assert set(kinds) == {"slot_admit", "slot_retire"}


def test_cache_length_rounds_as_the_reference():
    assert sb.serving_max_len((32, 64, 128), (32, 64)) == 256
    assert sb.serving_max_len((32, 64, 128), (32, 64), 128, True, 64) == 384
    assert sb.serving_max_len((8, 16, 24), (16, 32), 16, True, 16) == 80
    assert sb.serving_max_len((4,), (3,)) == 7


FLEET = dict(size="test", slots=2, dtype_name="float32", page_size=8,
             num_requests=4, new_grid=(3,))
# one replica a fleet (the keys do not depend on the count; each JAX
# engine compiles its own programs, which is most of these tests' time)
TENANTS = dict(prompt_grid=(8,), chunk_buckets=(8, 32), shared_prefix_len=16,
               num_tenants=2, arrival_gap=0.05, replicas=1)
FLEET_LEGS = {
    "disagg": dict(prompt_grid=(8, 24), chunk_buckets=(8, 16)),
    "router": TENANTS,
    "livescale": dict(TENANTS, scale_up_at=0.1, scale_down_at=0.2),
}
#: the port's additions to the fleet legs' reports
FLEET_PORT_ONLY = {
    "disagg": {"disagg_capture_counts", "disagg_transfer_widths",
               "disagg_transfer_width_cap", "disagg_kv_handoff_ops_a_move",
               "disagg_kv_page_bytes", "disagg_arm_launches",
               "disagg_arm_decode_steps", "disagg_devices",
               "disagg_kv_handoff_cached_pages", "disagg_pages_in_use_after",
               "disagg_trace_max_gap_ms"},
    "router": {"router_arm_launches", "router_arm_decode_steps",
               "router_device", "router_noaffinity_tokens_per_sec",
               "router_single_tokens_per_sec", "router_single_wall_seconds",
               "router_single_ttft_p50_ms", "router_single_ttft_p99_ms",
               "router_single_tpot_p50_ms", "router_single_tpot_p99_ms",
               "router_single_token_identical", "router_pages_in_use_after",
               "router_token_divergences", "router_dead_replicas"},
    "livescale": {"livescale_arm_launches", "livescale_arm_decode_steps",
                  "livescale_device", "livescale_pages_in_use_after",
                  "livescale_token_divergences", "livescale_dead_replicas"},
}


@pytest.mark.parametrize("leg", sorted(FLEET_LEGS))
def test_fleet_legs_report_the_jax_keys(leg):
    """Each fleet leg reports the JAX leg's keys (the hop fields of its
    traces included) plus the port's own, and holds its gates that do
    not rest on wall time on the CPU: tokens identical to the oracle,
    pins held, traces complete, no request dropped, no replica lost to
    failover; each arm ran decode steps (the CPU launches no kernel)."""
    from mpi_operator_tpu.examples import serve_benchmark as jsb
    ours = getattr(sb, f"run_{leg}_benchmark")(
        **FLEET, **FLEET_LEGS[leg], device="cpu", log=lambda s: None)
    theirs = getattr(jsb, f"run_{leg}_benchmark")(
        **FLEET, **FLEET_LEGS[leg], log=lambda s: None)
    assert set(ours) - FLEET_PORT_ONLY[leg] == set(theirs)
    assert FLEET_PORT_ONLY[leg] <= set(ours)
    steps = ours[f"{leg}_arm_decode_steps"]
    assert steps and all(n > 0 for n in steps.values())
    assert all(sum(v.values()) == 0
               for v in ours[f"{leg}_arm_launches"].values())
    assert ours[f"{leg}_pages_in_use_after"] == 0
    if leg == "disagg":
        for key in ("disagg_token_identical", "disagg_pool_pins_held",
                    "disagg_trace_complete"):
            assert ours[key] is True, key
        assert ours["disagg_devices"] == ["cpu", "cpu"]
        assert ours["disagg_two_devices"] is False
        assert (ours["disagg_kv_handoff_pages_total"]
                == theirs["disagg_kv_handoff_pages_total"]
                == ours["disagg_trace_handoff_pages"] > 0)
        assert ours["disagg_transfer_widths"] <= \
            ours["disagg_transfer_width_cap"]
        assert ours["disagg_kv_handoff_ops_a_move"] == 2 * 2 * 2  # 2 layers
    elif leg == "router":
        # (whether the late recovery wave finds the burst drained is a
        # matter of time, which a loaded CPU does not keep: chip_smoke
        # holds it on the card)
        for key in ("router_token_identical", "router_compile_pins_held",
                    "router_trace_complete", "router_single_token_identical"):
            assert ours[key] is True, key
        assert ours["router_shed_low_load"] == 0
        assert ours["router_burst_sheds"] == theirs["router_burst_sheds"] > 0
        assert ours["router_burst_recovered"] == 1
        assert ours["router_token_divergences"] == []
        assert ours["router_dead_replicas"] == {
            "affinity": [], "noaffinity": [], "burst": []}
    else:
        # (the ledger against the restart compares wall times: chip_smoke
        # holds it on the card)
        for key in ("livescale_token_identical",
                    "livescale_gang_token_identical",
                    "livescale_compile_pins_held",
                    "livescale_trace_complete"):
            assert ours[key] is True, key
        assert ours["livescale_ledger_total_seconds"] > 0
        assert ours["livescale_dropped"] == ours["livescale_sheds"] == 0
        assert ours["livescale_detached_replicas"] == [0]
        assert ours["livescale_attaches"] == ours["livescale_detaches"] == 1
        assert ours["livescale_token_divergences"] == []
        assert ours["livescale_dead_replicas"] == {"live": [], "gang": []}


def test_fleet_cli_prints_the_leg(capsys):
    """`--livescale` (as `--router` and `--disagg`) runs its leg and
    prints one JSON record headed by the leg's tokens/s."""
    assert sb.main(["--livescale", "--size", "test", "--device", "cpu",
                    "--dtype", "float32", "--slots", "2", "--page-size", "8",
                    "--num-requests", "4", "--shared-prefix-len", "16",
                    "--scale-up-at", "0.1", "--scale-down-at", "0.2"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "livescale_tokens_per_sec"
    assert rec["livescale_dropped"] == 0
    assert rec["livescale_token_identical"] is True


def test_divergences_name_the_first_token_and_its_margins():
    """The fleet legs' `*_token_divergences`: a request whose arm tokens
    leave the oracle's at index i reports i and the dense path's margins
    there (the oracle's greedy token its argmax: want_gap 0); a request
    that matches reports nothing; one missing from the arm reports index
    None."""
    import types
    import torch
    from mpi_operator_tpu_torch.models import create_lm
    from mpi_operator_tpu_torch.serve import Request
    model = create_lm("gpt2-test", device="cpu", vocab_size=64, max_len=32,
                      seed=0)
    rs = np.random.RandomState(0)
    trace = [Request(i, rs.randint(0, 64, (6,)).tolist(), 3)
             for i in range(3)]

    def logp_after(seq):
        with torch.no_grad():
            logits = model(torch.tensor([seq]), cache=model.new_cache(1))
        return torch.log_softmax(logits[0, -1].float(), -1)

    oracle = {}
    for r in trace:
        seq = list(r.prompt)
        for _ in range(3):
            seq.append(int(logp_after(seq).argmax()))
        oracle[r.id] = seq[len(r.prompt):]
    swapped = list(oracle[1])
    swapped[1] = (swapped[1] + 1) % 64
    arm = {0: types.SimpleNamespace(tokens=list(oracle[0])),
           1: types.SimpleNamespace(tokens=swapped)}
    div = sb._divergences(model, trace, oracle, {"a": arm})
    assert [(d["arm"], d["request"], d["index"]) for d in div] == [
        ("a", 1, 1), ("a", 2, None)]
    d = div[0]
    logp = logp_after(trace[1].prompt + oracle[1][:1])
    assert d["want_gap"] == pytest.approx(0.0, abs=1e-5)
    assert d["gap"] == pytest.approx(
        float(logp.max() - logp[swapped[1]]), abs=1e-5)
    assert 0.0 <= d["margin"] <= d["gap"] + 1e-6
