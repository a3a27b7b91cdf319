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
  admission) and page peaks;
- the host gap (p50/p99 of the host's blocking wait on the device a
  step, from the engine's ServeTelemetry) and, from a Tracer over the
  measured run, the per-hop latency breakdown (`serving_hop_*`) and
  whether every request's hops tile its end-to-end time
  (`serving_trace_complete`, `serving_trace_max_gap_ms`): the engine
  always runs with both attached, as the reference's benchmark does;
- with `speculative`, the acceptance rate, effective tokens a row-step
  and the verify programs (held to the no-recompile contract too).

The baseline is generate() run trace-sequentially (batch 1, one request
to completion before the next), every (prompt, budget, sampling) shape
warmed first. `compare_spec` re-runs the trace with speculation off,
`compare_sync` with the drain-every-step loop, `compare_hooks` through
an engine without telemetry, tracer or event log, and `compare_graphs`
with the engine's programs run eagerly (`EngineConfig.cuda_graphs=
False`), each on the same engine settings, runs alternated and best-of-2
an arm. `metrics_port` serves the engine's live series on /metrics
while the trace replays. The report names the device it ran on; on the
CPU (`device="cpu"`) its times are the CPU's.

`profile_dir` writes a torch.profiler chrome trace of the measured
trace's replay (utils/profiling.py), stopped after the closing
timestamp. Not here yet: the fleet legs (router, live scaling,
disaggregation: ROADMAP step 9) have no arguments here.

    python -m mpi_operator_tpu_torch.examples.serve_benchmark --paged \\
        --shared-prefix-len 128 --no-baseline --speculative ngram \\
        --compare-spec
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import create_lm, generate
from ..serve import EngineConfig, Request, ServingEngine
from ..telemetry import EventLog, WorkerTelemetry, read_events
from ..telemetry.trace import (Tracer, build_trees, hop_percentiles,
                               trace_sum_gap)
from ..utils.device import DeviceLike, resolve_device
from ..utils.profiling import WindowProfiler

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


def _runs(pairs, total_new):
    """One record a timed run: its wall, tokens/s and TTFT/TPOT."""
    return [{"wall_seconds": w, "tokens_per_sec": total_new / w,
             **_latency_fields(res.values(), "run")} for res, w in pairs]


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
    compare_hooks: bool = False,
    events_path: Optional[str] = None,
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
    is identical), `compare_hooks` (the same through an engine with no
    telemetry, tracer or event log: what the hooks cost), `events_path`
    (an EventLog there receives the engine's events; the report counts
    them) and `device`."""
    if compare_spec and speculative is None:
        raise ValueError("compare_spec requires speculative")
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
        page_size=page_size, num_pages=num_pages, speculative=speculative,
        draft_k=draft_k)
    events = EventLog(events_path) if events_path else None
    wtel = WorkerTelemetry(events=events)
    # an in-memory ring (no sink file): the hop breakdown and the
    # completeness check read it after the measured run
    tracer = Tracer(sample=1.0)
    engine = ServingEngine(model, config, device=dev,
                           telemetry=wtel.serving, events=events,
                           tracer=tracer)
    if metrics_port is not None:
        log(f"worker /metrics listening on port "
            f"{wtel.serve(port=metrics_port).port}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed_run(eng, profiler=None):
        eng.reset()
        sync()
        if profiler is not None:
            profiler.start()
        t0 = time.perf_counter()
        out = eng.run(trace)
        sync()
        wall = time.perf_counter() - t0
        if profiler is not None:
            # AFTER the closing timestamp: the trace export is real I/O
            # and must never be charged to serving throughput
            profiler.stop_if_active()
        return out, wall

    # warm-up: one request per distinct prompt length (every prefill
    # bucket the trace can hit) and the step program; then reset, so the
    # measured trace is all steady state
    warm = [make_request(10_000 + j, p, 2)
            for j, p in enumerate(sorted(set(int(r) for r in prompt_grid)))]
    # the /metrics server, if any, and the event log stay up for every
    # run below (the hooks arm pays for them in each of its runs)
    profiler = WindowProfiler(profile_dir, log, dev)
    try:
        engine.run(warm)
        results, wall = timed_run(engine, profiler)
        total_new = sum(len(r.tokens) for r in results.values())
        tps = total_new / wall
        counts = engine.compile_counts()
        captures = engine.capture_counts()
        no_recompile = (counts["step"] <= 3
                        and counts["prefill"] <= len(chunk_buckets))
        # the host gap and the traces, before any rerun below adds to them:
        # every measured request must have one root whose hops tile its
        # end-to-end latency
        gap = wtel.serving.host_gap_seconds
        gap50 = _ms(gap.percentile(50)) if gap.count else None
        gap99 = _ms(gap.percentile(99)) if gap.count else None
        trace_spans = list(tracer.ring)
        trees = build_trees(trace_spans)
        req_trees = [trees.get(r.id) for r in trace]
        trace_complete = all(
            t is not None and t["root"] is not None
            and t["root"]["status"] == "ok" for t in req_trees)
        gaps = [trace_sum_gap(t) for t in req_trees
                if t is not None and t["root"] is not None]
        gaps = [g for g in gaps if g is not None]
        out: Dict[str, object] = {
            "serving_tokens_per_sec": tps,
            "serving_requests": num_requests,
            "serving_slots": slots,
            "serving_total_new_tokens": total_new,
            "serving_wall_seconds": wall,
            **_latency_fields(results.values()),
            "serving_host_gap_p50_ms": gap50,
            "serving_host_gap_p99_ms": gap99,
            **{f"serving_hop_{k}": v
               for k, v in hop_percentiles(trace_spans).items()},
            "serving_trace_complete": bool(trace_complete),
            "serving_trace_max_gap_ms": _ms(max(gaps)) if gaps else None,
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
        if events is not None:
            # the measured trace's records (the warm-up's have other ids)
            ids = {r.id for r in trace}
            out["serving_events_logged"] = sum(
                1 for e in read_events(events_path) if e.get("request") in ids)
        if speculative is not None:
            # before any rerun resets the engine's counters; verify pins as
            # step does: <= 2 widths a sampling mode, <= 3 modes
            spec = engine.spec_stats()
            out["serving_no_recompile"] = bool(
                no_recompile and counts["verify"] <= 2 * 3)
            out.update({
                "serving_speculative": speculative,
                "serving_spec_draft_k": draft_k,
                "serving_spec_proposed": int(spec["proposed"]),
                "serving_spec_accepted": int(spec["accepted"]),
                "serving_spec_acceptance_rate": spec["acceptance_rate"],
                "serving_spec_effective_tokens_per_step":
                    spec["effective_tokens_per_step"],
                "serving_spec_verify_steps": int(spec["verify_steps"]),
                "serving_verify_compiles": counts["verify"],
                "serving_verify_captures": captures["verify"],
            })
            log(f"speculative ({speculative}, k={draft_k}): acceptance "
                f"{spec['acceptance_rate']:.4f} ({spec['accepted']}/"
                f"{spec['proposed']} drafts), "
                f"{spec['effective_tokens_per_step']:.3f} effective tokens/"
                f"row-step over {spec['verify_steps']} verify steps, "
                f"{counts['verify']} verify programs")
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
                f"slots in use; prefix hit rate "
                f"{out['serving_prefix_hit_rate']} "
                f"({out['serving_prefix_hit_requests']} hit requests)")
        log(f"serving {name} on {out['serving_device']}: {num_requests} "
            f"requests over {slots} slots: {tps:.1f} new tokens/s, TTFT "
            f"p50/p99 {out['serving_ttft_p50_ms']}/"
            f"{out['serving_ttft_p99_ms']} ms, TPOT p50/p99 "
            f"{out['serving_tpot_p50_ms']}/"
            f"{out['serving_tpot_p99_ms']} ms, host gap p50 {gap50} ms, "
            f"recompile-free={out['serving_no_recompile']}, captures "
            f"{captures}, trace complete={trace_complete}")

        if compare_spec:
            # speculation off on the same engine (same programs; the verify
            # programs sit unused), runs alternated (no-spec, spec, no-spec)
            # and best-of-2 an arm, the measured run being spec's first.
            # Greedy tokens are compared; sampled ones may differ (a verify
            # step and a plain step draw from the generator in other orders)
            def run_spec(on):
                engine.config.speculative = speculative if on else None
                try:
                    return timed_run(engine)
                finally:
                    engine.config.speculative = speculative
            runs = {"spec": [(results, wall)], "nospec": [run_spec(False)]}
            runs["spec"].append(run_spec(True))
            runs["nospec"].append(run_spec(False))
            base_results = runs["nospec"][0][0]
            best = min(w for _, w in runs["spec"])
            best_base = min(w for _, w in runs["nospec"])
            best_nospec = min(runs["nospec"], key=lambda rw: rw[1])[0]
            base_tpot = _percentiles([dt for r in best_nospec.values()
                                      for dt in np.diff(r.token_times)])
            for arm, pairs in runs.items():
                out[f"serving_{arm}_runs"] = _runs(pairs, total_new)
            out.update({
                "serving_nospec_tokens_per_sec": total_new / best_base,
                "serving_nospec_wall_seconds": best_base,
                "serving_nospec_tpot_p50_ms": _ms(base_tpot[50]),
                "serving_nospec_tpot_p99_ms": _ms(base_tpot[99]),
                "serving_spec_speedup": best_base / best,
                "serving_spec_greedy_identical": all(
                    results[r.id].tokens == base_results[r.id].tokens
                    for r in trace if r.temperature == 0.0),
            })
            log(f"spec A/B (best-of-2 each): {total_new / best:.1f} spec vs "
                f"{total_new / best_base:.1f} no-spec new tokens/s -> "
                f"{out['serving_spec_speedup']:.3f}x, greedy token-identical="
                f"{out['serving_spec_greedy_identical']}")

        if compare_hooks:
            # the same settings with no telemetry, tracer or event log; runs
            # alternated (no hooks, hooks, no hooks) and best-of-2 an arm
            bare = ServingEngine(model, config, device=dev)
            bare.run(warm)
            runs = {"hooks": [(results, wall)], "nohooks": [timed_run(bare)]}
            runs["hooks"].append(timed_run(engine))
            runs["nohooks"].append(timed_run(bare))
            for arm, pairs in runs.items():
                out[f"serving_{arm}_runs"] = _runs(pairs, total_new)
            best = min(w for _, w in runs["hooks"])
            best_bare = min(w for _, w in runs["nohooks"])
            out.update({
                "serving_nohooks_tokens_per_sec": total_new / best_bare,
                "serving_hooks_cost": best / best_bare - 1.0,
                "serving_hooks_greedy_identical": all(
                    results[r.id].tokens == runs["nohooks"][0][0][r.id].tokens
                    for r in trace if r.temperature == 0.0),
            })
            log(f"hooks A/B (best-of-2 each): {total_new / best:.1f} with "
                f"telemetry and tracer vs {total_new / best_bare:.1f} without "
                f"new tokens/s")
            del bare

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
            for arm, pairs in runs.items():
                out[f"serving_{arm}_runs"] = _runs(pairs, total_new)
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
                f"graphs vs {total_new / best_eager:.1f} eager new "
                f"tokens/s -> {out['serving_graphs_speedup']:.3f}x, "
                f"tokens identical="
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
    finally:
        profiler.stop_if_active()
        wtel.close()


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
    parser.add_argument("--speculative", default=None, choices=[None, "ngram"],
                        help="speculative decoding: greedy rows draft by "
                             "prompt lookup, one verify pass scores them")
    parser.add_argument("--draft-k", type=int, default=4,
                        help="drafted tokens a row a verify step")
    parser.add_argument("--compare-spec", action="store_true",
                        help="re-run the trace with speculation off and "
                             "report the no-spec throughput and TPOT")
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
