"""Serving benchmark on one card: continuous batching against sequential
generate().

The single-engine legs of the reference's
`mpi_operator_tpu/examples/serve_benchmark.py::run_serving_benchmark`
and of its CLI. It replays a seeded mixed-length request trace through
the serving engine (serve/engine.py) and reports what a serving front
end cares about, under the reference's `serving_*` key names:

- aggregate new tokens/s over the whole trace;
- time to first token (TTFT) p50/p99, arrival to first sampled token,
  queueing included (every request waits at t=0: a loaded server);
- time per output token (TPOT) p50/p99, the gaps between a request's
  tokens;
- the no-recompile contract: the engine's program counts after the
  measured trace (step <= the 3 sample_slots modes, prefill <= the
  bucket count), and beside them the CUDA graphs captured;
- in paged mode, the prefix cache (hit rate, cold and hit TTFT from
  admission) and page peaks.

The baseline is generate() run trace-sequentially (batch 1, one request
to completion before the next), every (prompt, budget, sampling) shape
warmed first. `compare_sync` re-runs the trace with the drain-every-step
loop and `compare_graphs` with the engine's programs run eagerly
(`EngineConfig.cuda_graphs=False`), each on the same engine settings,
runs alternated and best-of-2 an arm. The report names the device it
ran on; on the CPU (`device="cpu"`) its times are the CPU's.

Not here yet, each raising NotImplementedError: speculative decoding
and `compare_spec` (ROADMAP step 4), `metrics_port` with the tracer's
hop fields and the host-gap series (step 5), `profile_dir` (step 6);
the fleet legs (router, live scaling, disaggregation: step 9) have no
arguments here.

    python -m mpi_operator_tpu_torch.examples.serve_benchmark --paged \\
        --shared-prefix-len 128 --no-baseline
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import create_lm, generate
from ..serve import EngineConfig, Request, ServingEngine
from ..utils.device import DeviceLike, resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _percentiles(xs, ps=(50, 99)):
    if not xs:
        return {p: None for p in ps}
    return {p: float(np.percentile(np.asarray(xs), p)) for p in ps}


def _ms(v):
    return None if v is None else v * 1e3


def _latency_fields(results, prefix="serving"):
    """TTFT/TPOT p50/p99 in ms; a ttft of -1.0 (no token before a
    timeout) is left out, and an empty set gives None."""
    ttft = _percentiles([r.ttft for r in results if r.ttft >= 0.0])
    tpot = _percentiles([dt for r in results
                         for dt in np.diff(r.token_times)])
    return {f"{prefix}_ttft_p50_ms": _ms(ttft[50]),
            f"{prefix}_ttft_p99_ms": _ms(ttft[99]),
            f"{prefix}_tpot_p50_ms": _ms(tpot[50]),
            f"{prefix}_tpot_p99_ms": _ms(tpot[99])}


def serving_max_len(prompt_grid: Sequence[int], new_grid: Sequence[int],
                    shared_prefix_len: int = 0, paged: bool = False,
                    page_size: int = 64) -> int:
    """The cache length the reference sizes for a trace: the longest
    request, rounded up to a multiple of 128 past 128, and to a whole
    number of pages in paged mode."""
    need = shared_prefix_len + max(prompt_grid) + max(new_grid)
    max_len = need if need <= 128 else -(-need // 128) * 128
    if paged and max_len % page_size:
        max_len = -(-max_len // page_size) * page_size
    return max_len


def serving_trace(vocab: int, num_requests: int, prompt_grid: Sequence[int],
                  new_grid: Sequence[int], temperature: float = 0.0,
                  shared_prefix_len: int = 0, seed: int = 0,
                  ) -> Tuple[List[Request], Callable[..., Request]]:
    """The reference's seeded trace: one system prompt of
    `shared_prefix_len` tokens, then per request a random tail of a
    length drawn from `prompt_grid` and a budget from `new_grid`; with
    `temperature` > 0 odd ids sample at it with top_k 40. Returns the
    trace and its request maker (for the warm-up requests, which draw
    from the same stream, as the reference's do)."""
    rs = np.random.RandomState(seed)
    system_prompt = rs.randint(0, vocab, (shared_prefix_len,)).tolist()

    def make_request(i, p, n):
        temp = temperature if temperature > 0 and i % 2 == 1 else 0.0
        return Request(
            id=i, prompt=system_prompt + rs.randint(0, vocab, (p,)).tolist(),
            max_new_tokens=n, temperature=temp,
            top_k=40 if temp > 0 else 0)

    trace = [make_request(i, int(rs.choice(prompt_grid)),
                          int(rs.choice(new_grid)))
             for i in range(num_requests)]
    return trace, make_request


def run_serving_benchmark(
    size: Optional[str] = None,
    family: str = "gpt2",
    slots: int = 8,
    num_requests: int = 32,
    prompt_grid: Sequence[int] = (32, 64, 128),
    new_grid: Sequence[int] = (32, 64),
    chunk_buckets: Tuple[int, ...] = (32, 128),
    dtype_name: str = "bfloat16",
    temperature: float = 0.0,
    kv_cache_dtype: Optional[str] = None,
    decode_kernel: Optional[bool] = None,
    paged: bool = False,
    page_size: int = 64,
    num_pages: Optional[int] = None,
    shared_prefix_len: int = 0,
    speculative: Optional[str] = None,
    draft_k: int = 4,
    baseline: bool = True,
    compare_sync: bool = False,
    compare_spec: bool = False,
    seed: int = 0,
    profile_dir: Optional[str] = None,
    metrics_port: Optional[int] = None,
    compare_graphs: bool = False,
    device: DeviceLike = None,
    log: Callable[[str], None] = print,
) -> Dict[str, object]:
    """A flat dict of serving metrics (see the module docstring), on the
    CUDA card unless `device="cpu"`. The reference's arguments keep their
    meaning; `size=None` is gpt2-medium (llama-1b for `family="llama"`),
    as `create_lm`'s default. `decode_kernel=None` runs the decode
    kernels on the card and their plain versions elsewhere. The port
    adds `compare_graphs` (re-run the trace through an engine with
    EngineConfig.cuda_graphs=False, same settings: eager tokens/s and
    TPOT, the speedup, and whether every token, sampled ones included,
    is identical) and `device`."""
    waiting = {"speculative": (speculative is not None, 4),
               "compare_spec": (compare_spec, 4),
               "metrics_port": (metrics_port is not None, 5),
               "profile_dir": (profile_dir is not None, 6)}
    for name, (asked, step) in waiting.items():
        if asked:
            raise NotImplementedError(
                f"{name}: not in the PyTorch port yet (ROADMAP.md Queue 1, "
                f"step {step})")
    if dtype_name not in _DTYPES:
        raise ValueError(f"dtype_name={dtype_name!r}; expected one of "
                         f"{sorted(_DTYPES)}")
    dev = resolve_device(device)
    if decode_kernel is None:
        decode_kernel = dev.type == "cuda"
    max_len = serving_max_len(prompt_grid, new_grid, shared_prefix_len,
                              paged, page_size)
    name = f"{family}-{size}" if size else family
    model = create_lm(name, device=dev, seed=0, dtype=_DTYPES[dtype_name],
                      kv_cache_dtype=kv_cache_dtype,
                      decode_kernel=decode_kernel, max_len=max_len)
    trace, make_request = serving_trace(
        model.config.vocab_size, num_requests, prompt_grid, new_grid,
        temperature, shared_prefix_len, seed)
    config = EngineConfig(
        slots=slots, chunk_buckets=tuple(chunk_buckets),
        decode_kernel=decode_kernel, rng_seed=seed, paged=paged,
        page_size=page_size, num_pages=num_pages)
    engine = ServingEngine(model, config, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed_run(eng):
        eng.reset()
        sync()
        t0 = time.perf_counter()
        out = eng.run(trace)
        sync()
        return out, time.perf_counter() - t0

    # warm-up: one request per distinct prompt length (every prefill
    # bucket the trace can hit) and the step program; then reset, so the
    # measured trace is all steady state
    warm = [make_request(10_000 + j, p, 2)
            for j, p in enumerate(sorted(set(int(r) for r in prompt_grid)))]
    engine.run(warm)
    results, wall = timed_run(engine)
    total_new = sum(len(r.tokens) for r in results.values())
    tps = total_new / wall
    counts = engine.compile_counts()
    captures = engine.capture_counts()
    no_recompile = (counts["step"] <= 3
                    and counts["prefill"] <= len(chunk_buckets))
    out: Dict[str, object] = {
        "serving_tokens_per_sec": tps,
        "serving_requests": num_requests,
        "serving_slots": slots,
        "serving_total_new_tokens": total_new,
        "serving_wall_seconds": wall,
        **_latency_fields(results.values()),
        "serving_step_compiles": counts["step"],
        "serving_prefill_compiles": counts["prefill"],
        "serving_no_recompile": bool(no_recompile),
        "serving_step_captures": captures["step"],
        "serving_prefill_captures": captures["prefill"],
        "serving_cuda_graphs": engine.cuda_graphs,
        "serving_decode_kernel": bool(decode_kernel),
        "serving_async_decode": bool(engine.config.async_decode),
        "serving_paged": bool(paged),
        "serving_device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
    }
    if paged:
        # the allocator as the measured trace left it, before any rerun
        alloc = engine.page_allocator
        lookups = alloc.hits + alloc.misses

        def adm(r):         # a prefix hit skips prefill, not the queue
            return r.token_times[0] - r.admitted_at
        cold = _percentiles([adm(r) for r in results.values()
                             if r.cached_tokens == 0 and r.token_times])
        hit = _percentiles([adm(r) for r in results.values()
                            if r.cached_tokens > 0 and r.token_times])
        out.update({
            "serving_page_size": page_size,
            "serving_pages_total": alloc.usable,
            "serving_pages_in_use_peak": engine.pages_in_use_peak,
            "serving_occupancy_peak": engine.occupancy_peak,
            "serving_prefix_hit_rate": (alloc.hits / lookups if lookups
                                        else 0.0),
            "serving_prefix_hit_pages": alloc.hits,
            "serving_prefix_miss_pages": alloc.misses,
            "serving_prefix_hit_requests": sum(
                1 for r in results.values() if r.cached_tokens > 0),
            "serving_ttft_cold_p50_ms": _ms(cold[50]),
            "serving_ttft_cold_p99_ms": _ms(cold[99]),
            "serving_ttft_hit_p50_ms": _ms(hit[50]),
            "serving_ttft_hit_p99_ms": _ms(hit[99]),
        })
        log(f"paged KV: {alloc.usable} pages x {page_size} tokens, peak "
            f"{engine.pages_in_use_peak} pages / {engine.occupancy_peak} "
            f"slots in use; prefix hit rate {out['serving_prefix_hit_rate']}"
            f" ({out['serving_prefix_hit_requests']} hit requests)")
    log(f"serving {name} on {out['serving_device']}: {num_requests} "
        f"requests over {slots} slots: {tps:.1f} new tokens/s, TTFT "
        f"p50/p99 {out['serving_ttft_p50_ms']}/{out['serving_ttft_p99_ms']}"
        f" ms, TPOT p50/p99 {out['serving_tpot_p50_ms']}/"
        f"{out['serving_tpot_p99_ms']} ms, recompile-free={no_recompile}, "
        f"captures {captures}")

    if compare_graphs:
        # the same settings with the programs run eagerly; runs
        # alternated (eager, graphs, eager) and best-of-2 an arm, the
        # measured run above being the graphs arm's first
        eager = ServingEngine(model, dataclasses.replace(
            config, cuda_graphs=False), device=dev)
        eager.run(warm)
        eager_results, eager_wall = timed_run(eager)
        runs = {"graphs": [(results, wall)], "eager": [(eager_results,
                                                        eager_wall)]}
        runs["graphs"].append(timed_run(engine))
        runs["eager"].append(timed_run(eager))
        for arm, pair in runs.items():
            out[f"serving_{arm}_runs"] = [
                {"wall_seconds": w, "tokens_per_sec": total_new / w,
                 **_latency_fields(res.values(), "run")} for res, w in pair]
        best = min(w for _, w in runs["graphs"])
        best_eager = min(w for _, w in runs["eager"])
        out.update({
            "serving_eager_tokens_per_sec": total_new / best_eager,
            "serving_eager_wall_seconds": best_eager,
            "serving_graphs_speedup": best_eager / best,
            "serving_graphs_tokens_identical": all(
                results[r.id].tokens == eager_results[r.id].tokens
                for r in trace),
        })
        log(f"graphs A/B (best-of-2 each): {total_new / best:.1f} with "
            f"graphs vs {total_new / best_eager:.1f} eager new tokens/s -> "
            f"{out['serving_graphs_speedup']:.3f}x, tokens identical="
            f"{out['serving_graphs_tokens_identical']}")
        del eager

    if compare_sync:
        # the double-buffered loop against dispatch-then-drain on the
        # same engine and programs, alternated (sync, async, sync),
        # best-of-2 a mode; the measured run is async's first
        def run_mode(mode):
            engine.config.async_decode = mode
            return timed_run(engine)
        sync_results, sync_wall = run_mode(False)
        _, async_wall2 = run_mode(True)
        _, sync_wall2 = run_mode(False)
        engine.config.async_decode = True
        best_sync = min(sync_wall, sync_wall2)
        sync_tps = sum(len(r.tokens) for r in sync_results.values()) \
            / best_sync
        async_tps = total_new / min(wall, async_wall2)
        out.update({
            "serving_sync_tokens_per_sec": sync_tps,
            "serving_sync_wall_seconds": best_sync,
            "serving_async_speedup": async_tps / sync_tps,
            "serving_async_greedy_identical": all(
                results[r.id].tokens == sync_results[r.id].tokens
                for r in trace if r.temperature == 0.0),
        })
        log(f"sync-decode A/B (best-of-2 each): {sync_tps:.1f} sync vs "
            f"{async_tps:.1f} async new tokens/s -> "
            f"{out['serving_async_speedup']:.3f}x")

    if baseline:
        # trace-sequential generate(): one warm run per (P, N, sampled)
        # shape class, then the identical trace one request at a time
        def run_one(req):
            gen = None
            if req.temperature > 0:
                gen = torch.Generator(device=dev).manual_seed(req.id)
            return generate(model, [list(req.prompt)], req.max_new_tokens,
                            temperature=req.temperature,
                            top_k=req.top_k or None, generator=gen,
                            device=dev)

        shapes = {(len(r.prompt), r.max_new_tokens, r.temperature > 0): r
                  for r in trace}
        for r in shapes.values():
            run_one(r)
        sync()
        t0 = time.perf_counter()
        for r in trace:
            run_one(r)
        sync()
        base_wall = time.perf_counter() - t0
        base_tps = sum(r.max_new_tokens for r in trace) / base_wall
        out.update({
            "sequential_tokens_per_sec": base_tps,
            "sequential_wall_seconds": base_wall,
            "serving_vs_sequential": tps / base_tps,
        })
        log(f"sequential generate() baseline: {base_tps:.1f} new tokens/s "
            f"-> continuous batching {tps / base_tps:.2f}x")
    return out


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(prog="serving-benchmark")
    parser.add_argument("--size", default=None)
    parser.add_argument("--family", default="gpt2", choices=["gpt2", "llama"])
    parser.add_argument("--slots", type=int, default=8)
    parser.add_argument("--num-requests", type=int, default=32)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--kv-cache-dtype", default=None,
                        choices=[None, "int8"])
    parser.add_argument("--paged", action="store_true",
                        help="serve through the paged KV cache (page "
                             "tables + prefix caching)")
    parser.add_argument("--page-size", type=int, default=64)
    parser.add_argument("--num-pages", type=int, default=None,
                        help="physical KV pages (default: the contiguous "
                             "layout's bytes)")
    parser.add_argument("--shared-prefix-len", type=int, default=0,
                        help="one seeded system prompt of this many tokens "
                             "before every request (the prefix-cache "
                             "trace)")
    parser.add_argument("--speculative", default=None, choices=[None, "ngram"])
    parser.add_argument("--draft-k", type=int, default=4)
    parser.add_argument("--compare-spec", action="store_true")
    parser.add_argument("--no-baseline", action="store_true")
    parser.add_argument("--compare-sync", action="store_true",
                        help="re-run the trace with async_decode=False "
                             "and report the async speedup")
    parser.add_argument("--compare-graphs", action="store_true",
                        help="re-run the trace with the programs run "
                             "eagerly and report the graphs' speedup")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile-dir", default=None)
    parser.add_argument("--metrics-port", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="'cpu' to run on the CPU (default: the card)")
    args = parser.parse_args(argv)
    metrics = run_serving_benchmark(
        size=args.size, family=args.family, slots=args.slots,
        num_requests=args.num_requests, dtype_name=args.dtype,
        temperature=args.temperature, kv_cache_dtype=args.kv_cache_dtype,
        paged=args.paged, page_size=args.page_size,
        num_pages=args.num_pages, shared_prefix_len=args.shared_prefix_len,
        speculative=args.speculative, draft_k=args.draft_k,
        baseline=not args.no_baseline, compare_sync=args.compare_sync,
        compare_spec=args.compare_spec, seed=args.seed,
        profile_dir=args.profile_dir, metrics_port=args.metrics_port,
        compare_graphs=args.compare_graphs, device=args.device)
    print(json.dumps({"metric": "serving_tokens_per_sec",
                      "value": metrics["serving_tokens_per_sec"],
                      "unit": "tokens/sec", **metrics}))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
