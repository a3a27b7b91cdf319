"""The port's serving benchmark (examples/serve_benchmark.py) against
the JAX one, on the CPU at a tiny size: gpt2-test, f32, two slots, four
requests, contiguous (with the sequential baseline and the sync A/B)
and paged with a shared prefix. Both report the same keys under the
same names, except the ones whose slices are not ported yet (the host
gap and the tracer's fields; none is emitted with a made-up value) and
the port's own (captures, the device, the graphs A/B); the programs
stay within the no-recompile contract; the sequential generate()
baseline produces the engine's greedy tokens; the arguments of later
slices raise NotImplementedError.
"""
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
                      shared_prefix_len=8)}
#: keys of slices still to port (telemetry and tracing: ROADMAP step 5)
WAITING = ("serving_host_gap_", "serving_hop_", "serving_trace_")
PORT_ONLY = {"serving_step_captures", "serving_prefill_captures",
             "serving_cuda_graphs", "serving_device"}


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
    kept = {k for k in theirs if not k.startswith(WAITING)}
    assert set(ours) - PORT_ONLY == kept
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
    (dict(speculative="ngram"), 4), (dict(compare_spec=True), 4),
    (dict(metrics_port=0), 5), (dict(profile_dir="/nonexistent"), 6)])
def test_later_slices_raise(kw, step):
    with pytest.raises(NotImplementedError, match=f"step {step}"):
        sb.run_serving_benchmark(**SMALL, device="cpu", **kw)


def test_cache_length_rounds_as_the_reference():
    assert sb.serving_max_len((32, 64, 128), (32, 64)) == 256
    assert sb.serving_max_len((32, 64, 128), (32, 64), 128, True, 64) == 384
    assert sb.serving_max_len((8, 16, 24), (16, 32), 16, True, 16) == 80
    assert sb.serving_max_len((4,), (3,)) == 7
