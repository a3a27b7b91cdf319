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

from mpi_operator_tpu.examples.serve_benchmark import (
    run_serving_benchmark as jax_run_serving_benchmark)
from mpi_operator_tpu_torch.examples import serve_benchmark as sb
from mpi_operator_tpu_torch.serve import ServingEngine

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
