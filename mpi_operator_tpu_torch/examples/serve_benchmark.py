"""Serving benchmark: continuous batching against sequential generate(),
and the serving fleet.

The legs of the reference's `mpi_operator_tpu/examples/serve_benchmark.py`
and of its CLI. `run_serving_benchmark`, the single-engine leg, replays
a seeded mixed-length request trace through the serving engine
(serve/engine.py) and reports what a serving front end cares about,
under the reference's `serving_*` key names:

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
timestamp.

The fleet legs, each under the reference's key names, each arm's kernel
launches and decode steps added:

- `run_disagg_benchmark` (`--disagg`): a DisaggEngine against the
  colocated paged engine on one long-prompt trace (TTFT/TPOT of both,
  the paged-KV handoff's host time and pages, token identity, the pool
  pins);
- `run_router_benchmark` (`--router`): replicas behind the Router,
  prefix affinity on and off, on a multi-tenant trace, and an overload
  burst (hit rates, sheds, tokens against one engine);
- `run_livescale_benchmark` (`--livescale`): a live +1/-1 replica cycle
  against a gang restart (drops, the resize ledger's live total against
  the restart's).

    python -m mpi_operator_tpu_torch.examples.serve_benchmark --paged \\
        --shared-prefix-len 128 --no-baseline --speculative ngram \\
        --compare-spec
    python -m mpi_operator_tpu_torch.examples.serve_benchmark --disagg
    python -m mpi_operator_tpu_torch.examples.serve_benchmark --router
    python -m mpi_operator_tpu_torch.examples.serve_benchmark --livescale
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import create_lm, generate
from ..models.generate import cast_params, decode_model
from ..ops import attention as ops
from ..serve import (DisaggEngine, EngineConfig, PageTransfer, Request,
                     ServingEngine)
from ..telemetry import EventLog, WorkerTelemetry, read_events
from ..telemetry.trace import (Tracer, build_trees, hop_percentiles,
                               orphan_spans, trace_sum_gap)
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


# ---------------------------------------------------------------------------
# the fleet legs: disaggregated serving, the router, live scaling
# ---------------------------------------------------------------------------

def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _fleet_model(size, family, dtype_name, decode_kernel, max_len, device,
                 kv_cache_dtype=None):
    """(model, device, decode_kernel, name) of a fleet leg: the named
    model's random weights from seed 0 on the card unless
    `device="cpu"`, cast once to the compute dtype so that every engine
    of the leg (replicas, pools, oracles) reads the same weights;
    decode_kernel None runs the kernels on the card."""
    if dtype_name not in _DTYPES:
        raise ValueError(f"dtype_name={dtype_name!r}; expected one of "
                         f"{sorted(_DTYPES)}")
    dev = resolve_device(device)
    if decode_kernel is None:
        decode_kernel = dev.type == "cuda"
    name = f"{family}-{size}" if size else family
    model = create_lm(name, device=dev, seed=0, dtype=_DTYPES[dtype_name],
                      kv_cache_dtype=kv_cache_dtype,
                      decode_kernel=decode_kernel, max_len=max_len)
    return cast_params(model, model.config.dtype), dev, decode_kernel, name


def _counted(fn):
    """(fn(), the kernel launches it made): a delta of the wrappers'
    counters (ops.attention.launch_counts), replays of captured steps
    included."""
    before = dict(ops.launch_counts)
    out = fn()
    return out, {k: ops.launch_counts[k] - before[k] for k in before}


def _divergences(model, trace, oracle, arms):
    """Each request whose tokens in an arm (name -> results) differ from
    the oracle's: the arm, the request, the first index i where they do,
    and, in nats, the dense path's top-2 margin there (teacher-forced on
    the prompt and the oracle's tokens before i) and how far below its
    argmax the arm's and the oracle's tokens lie. A difference that
    rounding makes (a prefill of another width, a batch of another
    shape) shows at a near tie, where all three are small; a fault shows
    off one. A request missing from an arm, or of another length, gets
    index None."""
    dense = decode_model(model, decode_kernel=False)
    out = []
    for arm, results in arms.items():
        for req in trace:
            want = oracle[req.id]
            res = results.get(req.id)
            got = None if res is None else res.tokens
            if got == want:
                continue
            i = None if got is None else next(
                (j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                None)
            if i is None:
                out.append(dict(arm=arm, request=req.id, index=None))
                continue
            seq = list(req.prompt) + want[:i]
            with torch.no_grad():
                logits = dense(torch.tensor([seq], device=dense.device),
                               positions=np.arange(len(seq))[None],
                               cache=dense.new_cache(1))
            logp = torch.log_softmax(logits[0, -1].float(), -1)
            top2 = torch.topk(logp, 2).values
            out.append(dict(arm=arm, request=req.id, index=i,
                            margin=float(top2[0] - top2[1]),
                            gap=float(top2[0] - logp[got[i]]),
                            want_gap=float(top2[0] - logp[want[i]])))
    return out


def _pages_in_use(engines):
    """Pages still held across `engines` after their runs, each
    allocator audited first (PageAllocator.check raises on a broken
    refcount or free list)."""
    total = 0
    for e in engines:
        e.page_allocator.check()
        total += e.page_allocator.in_use
    return total


def _device_name(dev):
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _tenant_trace(vocab, rs, num_requests, num_tenants, shared_prefix_len,
                  prompt_grid, new_grid, arrival_gap):
    """The reference's multi-tenant trace: `num_tenants` seeded system
    prompts taken round-robin, each request a random tail and budget,
    arrivals `arrival_gap` apart; returns (trace, request maker)."""
    tenants = [rs.randint(0, vocab, (shared_prefix_len,)).tolist()
               for _ in range(num_tenants)]

    def make_request(i, arrival):
        # consecutive same-tenant arrivals sit num_tenants * arrival_gap
        # apart: the first has time to publish its prefix pages before
        # the second one's dispatch probes for them
        p, n = int(rs.choice(prompt_grid)), int(rs.choice(new_grid))
        return Request(id=i, prompt=tenants[i % num_tenants]
                       + rs.randint(0, vocab, (p,)).tolist(),
                       max_new_tokens=n, arrival=arrival)

    return ([make_request(i, i * arrival_gap) for i in range(num_requests)],
            make_request)


def _fresh(reqs, shift=0.0):
    return [Request(r.id, list(r.prompt), r.max_new_tokens,
                    arrival=max(0.0, r.arrival - shift)) for r in reqs]


def _trace_check(spans, trace):
    """(complete, max gap s, per-request trees): every request one root
    with status ok whose hops tile its end-to-end time (gap within
    max(5 ms, 2%)), and no orphan span."""
    trees = build_trees(spans)
    gaps, complete = [], not orphan_spans(spans)
    for r in trace:
        t = trees.get(r.id)
        if t is None or t["root"] is None or t["root"]["status"] != "ok":
            complete = False
            continue
        gap = trace_sum_gap(t)
        if gap is None or gap > max(0.005, 0.02 * t["root"]["seconds"]):
            complete = False
        if gap is not None:
            gaps.append(gap)
    return complete, (max(gaps) if gaps else None), trees


def run_disagg_benchmark(
    size: Optional[str] = None,
    family: str = "gpt2",
    slots: int = 8,
    num_requests: int = 24,
    prompt_grid: Sequence[int] = (64, 256, 384),
    new_grid: Sequence[int] = (16, 32),
    chunk_buckets: Tuple[int, ...] = (64, 128),
    dtype_name: str = "bfloat16",
    kv_cache_dtype: Optional[str] = None,
    decode_kernel: Optional[bool] = None,
    page_size: int = 64,
    num_pages: Optional[int] = None,
    seed: int = 0,
    device: DeviceLike = None,
    log: Callable[[str], None] = print,
) -> Dict[str, object]:
    """Disaggregated prefill/decode against the colocated paged engine:
    the same long-prompt-heavy greedy trace through a colocated paged
    ServingEngine and a DisaggEngine from the same model and config,
    each warmed and reset first. The reference's `disagg_*` and
    `coloc_*` keys: TTFT/TPOT p50/p99 of both, kv_handoff p50/p99 (host
    time from the install to the copy enqueued), pages moved, every
    request's prefill -> kv_handoff -> decode trace, token identity and
    the pool pins. The port adds each arm's kernel launches and decode
    steps (`disagg_arm_launches`, `disagg_arm_decode_steps`), the graphs
    captured, the transfer's widths and their cap, the operations a move
    enqueues and the bytes of one page. On the card the pools sit on
    cuda:0 and cuda:1 with two cards and share cuda:0 with one
    (`device=` puts both on that device)."""
    from ..telemetry.trace import hop_name
    max_len = serving_max_len(prompt_grid, new_grid, 0, True, page_size)
    model, dev, decode_kernel, name = _fleet_model(
        size, family, dtype_name, decode_kernel, max_len, device,
        kv_cache_dtype)
    vocab = model.config.vocab_size
    rs = np.random.RandomState(seed)

    def make_request(i, p, n):
        return Request(id=i, prompt=rs.randint(0, vocab, (p,)).tolist(),
                       max_new_tokens=n)

    trace = [make_request(i, int(rs.choice(prompt_grid)),
                          int(rs.choice(new_grid)))
             for i in range(num_requests)]
    cfg = EngineConfig(
        slots=slots, chunk_buckets=tuple(chunk_buckets),
        decode_kernel=decode_kernel, rng_seed=seed,
        paged=True, page_size=page_size, num_pages=num_pages)
    coloc = ServingEngine(model, cfg, device=dev)
    tracer = Tracer(sample=1.0)
    disagg = DisaggEngine(model, cfg, tracer=tracer,
                          devices=None if device is None else (dev, dev))
    warm = [make_request(10_000 + j, p, 2)
            for j, p in enumerate(sorted(set(int(r) for r in prompt_grid)))]

    def timed(engine):
        engine.run(warm)
        engine.reset()
        _sync(dev)
        t0 = time.perf_counter()
        results, launches = _counted(lambda: engine.run(trace))
        for d in set(getattr(engine, "devices", (dev,))):
            _sync(d)
        return results, time.perf_counter() - t0, launches

    coloc_results, coloc_wall, coloc_launches = timed(coloc)
    disagg_results, disagg_wall, disagg_launches = timed(disagg)
    identical = all(coloc_results[r.id].tokens == disagg_results[r.id].tokens
                    for r in trace)
    counts = disagg.compile_counts()
    pre, dec = counts["prefill_pool"], counts["decode_pool"]
    pins = (pre["step"] == 0 and pre["prefill"] <= len(chunk_buckets)
            and dec["prefill"] == 0 and dec["step"] <= 3)
    cap = math.ceil(math.log2(max(2, disagg.decode.page_allocator.usable))) + 1
    handoff = _percentiles([dt for dt, _, _ in disagg.handoff_log])
    idset = {r.id for r in trace}
    spans = [s for s in tracer.ring if s["trace"] in idset]
    trace_complete, max_gap, trees = _trace_check(spans, trace)
    trace_handoff_pages = 0
    for r in trace:
        t = trees.get(r.id)
        if t is None:
            continue
        hops = [hop_name(s) for s in t["spans"]
                if s.get("parent") is not None]
        if not ("prefill" in hops and "kv_handoff" in hops
                and "decode" in hops):
            trace_complete = False
        for s in t["spans"]:
            if s.get("parent") is not None and hop_name(s) == "kv_handoff":
                trace_handoff_pages += int(
                    (s.get("attrs") or {}).get("pages", 0))
    total_new = sum(len(r.tokens) for r in disagg_results.values())
    out: Dict[str, object] = {
        "disagg_tokens_per_sec": total_new / disagg_wall,
        "disagg_wall_seconds": disagg_wall,
        **_latency_fields(disagg_results.values(), "disagg"),
        "coloc_tokens_per_sec": sum(len(r.tokens) for r in
                                    coloc_results.values()) / coloc_wall,
        "coloc_wall_seconds": coloc_wall,
        **_latency_fields(coloc_results.values(), "coloc"),
        "disagg_kv_handoff_p50_ms": _ms(handoff[50]),
        "disagg_kv_handoff_p99_ms": _ms(handoff[99]),
        "disagg_kv_handoff_pages_total": disagg.transfer.pages_moved,
        "disagg_kv_handoff_cached_pages": sum(c for _, _, c in
                                              disagg.handoff_log),
        "disagg_handoffs": len(disagg.handoff_log),
        **{f"disagg_hop_{k}": v for k, v in hop_percentiles(spans).items()},
        "disagg_trace_complete": bool(trace_complete),
        "disagg_trace_max_gap_ms": _ms(max_gap),
        "disagg_trace_handoff_pages": trace_handoff_pages,
        "disagg_token_identical": bool(identical),
        "disagg_pool_pins_held": bool(pins),
        "disagg_prefill_pool_prefill_compiles": pre["prefill"],
        "disagg_prefill_pool_step_compiles": pre["step"],
        "disagg_decode_pool_step_compiles": dec["step"],
        "disagg_decode_pool_prefill_compiles": dec["prefill"],
        "disagg_capture_counts": disagg.capture_counts(),
        "disagg_transfer_widths": counts["transfer"]["gather"],
        "disagg_transfer_width_cap": cap,
        "disagg_kv_handoff_ops_a_move": disagg.transfer.last_ops,
        "disagg_kv_page_bytes": PageTransfer.page_bytes(
            disagg.decode.cache, disagg.decode.page_allocator.num_pages),
        "disagg_arm_launches": {"coloc": coloc_launches,
                                "disagg": disagg_launches},
        "disagg_arm_decode_steps": {"coloc": coloc.steps_dispatched,
                                    "disagg": disagg.steps_dispatched},
        "disagg_pages_in_use_after": _pages_in_use(
            (coloc, disagg.prefill, disagg.decode)),
        "disagg_requests": num_requests,
        "disagg_slots": slots,
        "disagg_page_size": page_size,
        "disagg_devices": [_device_name(d) for d in disagg.devices],
        "disagg_two_devices": disagg.devices[0] != disagg.devices[1],
    }
    log(f"disagg {name} on {out['disagg_devices']}: {num_requests} reqs, "
        f"TTFT p50/p99 {out['disagg_ttft_p50_ms']}/"
        f"{out['disagg_ttft_p99_ms']} ms vs coloc "
        f"{out['coloc_ttft_p50_ms']}/{out['coloc_ttft_p99_ms']} ms; TPOT "
        f"p50/p99 {out['disagg_tpot_p50_ms']}/{out['disagg_tpot_p99_ms']} "
        f"vs {out['coloc_tpot_p50_ms']}/{out['coloc_tpot_p99_ms']} ms; "
        f"kv_handoff p50/p99 {out['disagg_kv_handoff_p50_ms']}/"
        f"{out['disagg_kv_handoff_p99_ms']} ms over "
        f"{out['disagg_handoffs']} handoffs "
        f"({out['disagg_kv_handoff_pages_total']} pages); "
        f"token-identical={identical}, pool-pins={pins}")
    return out


def _fleet_setup(size, family, dtype_name, decode_kernel, page_size,
                 shared_prefix_len, prompt_grid, new_grid, num_requests,
                 num_tenants, arrival_gap, slots, chunk_buckets, num_pages,
                 seed, device):
    """What the router and live-scaling legs share: the model, the
    multi-tenant trace and its request maker, a warmed-and-reset engine
    maker, and the single-engine greedy oracle's tokens (one engine over
    the whole trace, all requests waiting: continuous batching is
    token-exact whatever the batch, so it holds for every fleet)."""
    max_len = serving_max_len(prompt_grid, new_grid, shared_prefix_len, True,
                              page_size)
    model, dev, decode_kernel, name = _fleet_model(
        size, family, dtype_name, decode_kernel, max_len, device)
    vocab = model.config.vocab_size
    rs = np.random.RandomState(seed)
    trace, make_request = _tenant_trace(
        vocab, rs, num_requests, num_tenants, shared_prefix_len,
        prompt_grid, new_grid, arrival_gap)
    # warm every prefill width the trace reaches through each fresh
    # replica, then reset, so that measured traffic is steady state (on
    # the card a width first met mid-trace is a graph capture): a wave
    # of one request a prompt length behind a shared prefix, cold, then
    # a second wave behind the same prefix, whose tails prefill in the
    # narrower windows of a request that finds its tenant prefix cached
    prefix = rs.randint(0, vocab, (shared_prefix_len,)).tolist()
    lens = sorted(set(int(v) for v in prompt_grid))
    warm = [[Request(10_000 + 100 * k + j,
                     prefix + rs.randint(0, vocab, (p,)).tolist(), 2)
             for j, p in enumerate(lens)] for k in range(2)]
    config = EngineConfig(
        slots=slots, chunk_buckets=tuple(chunk_buckets),
        decode_kernel=decode_kernel, rng_seed=seed, paged=True,
        page_size=page_size, num_pages=num_pages)

    def mk_engine():
        e = ServingEngine(model, config, device=dev)
        for wave in warm:
            e.run(_fresh(wave))
        e.reset()
        return e

    oracle_engine = mk_engine()
    oracle, oracle_launches = _counted(lambda: oracle_engine.run(
        [Request(r.id, list(r.prompt), r.max_new_tokens) for r in trace]))
    oracle = {rid: res.tokens for rid, res in oracle.items()}
    return dict(model=model, dev=dev, name=name, trace=trace,
                make_request=make_request, mk_engine=mk_engine,
                oracle=oracle, oracle_launches=oracle_launches,
                oracle_engine=oracle_engine,
                oracle_steps=oracle_engine.steps_dispatched)


def _pins_held(router, buckets):
    return all(rep.engine.compile_counts()["step"] <= 3
               and rep.engine.compile_counts()["prefill"] <= buckets
               for rep in router.replicas)


def _fleet_steps(router):
    return sum(rep.engine.steps_dispatched for rep in router.replicas)


def _fleet_engines(*routers):
    return [rep.engine for r in routers for rep in r.replicas]


def run_router_benchmark(
    size: Optional[str] = None,
    family: str = "gpt2",
    replicas: int = 2,
    slots: int = 4,
    num_requests: int = 24,
    prompt_grid: Sequence[int] = (16, 32),
    new_grid: Sequence[int] = (8, 16),
    chunk_buckets: Tuple[int, ...] = (16, 64),
    dtype_name: str = "bfloat16",
    decode_kernel: Optional[bool] = None,
    page_size: int = 16,
    num_pages: Optional[int] = None,
    shared_prefix_len: int = 32,
    num_tenants: int = 4,
    max_inflight: int = 8,
    arrival_gap: float = 0.15,
    seed: int = 0,
    device: DeviceLike = None,
    log: Callable[[str], None] = print,
) -> Dict[str, object]:
    """The front-door A/B: the same seeded multi-tenant trace through
    `replicas` paged engine replicas behind the Router, affinity on and
    off (pure load-aware), then an overload burst on a fresh fleet with
    a tight in-flight cap and a late recovery wave. The reference's
    `router_*` keys: tokens against the single-engine greedy oracle in
    both modes, the replica-measured prefix hit rate of each mode, the
    low-load sheds (0 expected), the burst's sheds and clean recovery,
    every replica's program pins, and the affinity arm's traces (one
    root a request, hops tiling it). The port adds each arm's kernel
    launches and decode steps (`router_arm_launches`,
    `router_arm_decode_steps`: the oracle, both modes, the burst and one
    engine alone), the no-affinity arm's tokens/s, one engine's tokens/s
    and latencies on the same timed trace (`router_single_*`: the same
    offered rate without the router), where an arm's tokens differ from
    the oracle's, each first divergence with its margins
    (`router_token_divergences`), the replicas each router arm lost to
    failover (`router_dead_replicas`), and the pages still in use after
    every run (every allocator audited). Every replica is a
    ServingEngine on the one device (the card unless `device="cpu"`)."""
    from ..serve import Router, RouterConfig
    fs = _fleet_setup(size, family, dtype_name, decode_kernel, page_size,
                      shared_prefix_len, prompt_grid, new_grid, num_requests,
                      num_tenants, arrival_gap, slots, chunk_buckets,
                      num_pages, seed, device)
    trace, oracle, mk_engine = fs["trace"], fs["oracle"], fs["mk_engine"]
    dev = fs["dev"]

    def replica_hit_rate(router):
        hits = sum(rep.engine.page_allocator.hits for rep in router.replicas)
        miss = sum(rep.engine.page_allocator.misses
                   for rep in router.replicas)
        return hits / (hits + miss) if hits + miss else 0.0, hits

    def fleet_run(affinity, tracer=None):
        router = Router([mk_engine() for _ in range(replicas)],
                        RouterConfig(max_inflight=max_inflight,
                                     affinity=affinity), tracer=tracer)
        _sync(dev)
        t0 = time.perf_counter()
        results, launches = _counted(lambda: router.run(_fresh(trace)))
        _sync(dev)
        return router, results, time.perf_counter() - t0, launches

    on_tracer = Tracer(sample=1.0)
    on_router, on_results, on_wall, on_launches = fleet_run(True, on_tracer)
    off_router, off_results, off_wall, off_launches = fleet_run(False)
    # one engine at the same offered rate: what the replicas add
    single = mk_engine()
    _sync(dev)
    t0 = time.perf_counter()
    single_results, single_launches = _counted(
        lambda: single.run(_fresh(trace)))
    _sync(dev)
    single_wall = time.perf_counter() - t0
    ids = {r.id for r in trace}
    spans = [s for s in on_tracer.ring if s["trace"] in ids
             or s["trace"] < 0]
    trace_complete, max_gap, _ = _trace_check(spans, trace)

    def adm_ttft_p50(results):
        return _percentiles([r.token_times[0] - r.admitted_at
                             for r in results.values() if r.token_times])[50]

    identical = all(on_results[r.id].tokens == oracle[r.id]
                    and off_results[r.id].tokens == oracle[r.id]
                    for r in trace)
    divergences = _divergences(fs["model"], trace, oracle, {
        "affinity": on_results, "noaffinity": off_results,
        "single": single_results})
    on_rate, on_hits = replica_hit_rate(on_router)
    off_rate, _ = replica_hit_rate(off_router)
    on_p50, off_p50 = adm_ttft_p50(on_results), adm_ttft_p50(off_results)
    ttft_ok = (on_p50 is not None and off_p50 is not None
               and on_p50 <= off_p50 * 1.2)
    total_new = sum(len(r.tokens) for r in on_results.values())

    # overload: every burst request due at once, so dispatch fills
    # replicas x cap and sheds the rest at the front door; the late
    # recovery wave lands on drained replicas
    burst_cap = 2
    burst_n = replicas * burst_cap + 4
    make_request = fs["make_request"]
    burst = [make_request(1_000 + i, 0.0) for i in range(burst_n)]
    recovery = [make_request(2_000 + i, 2.5) for i in range(replicas)]
    burst_router = Router([mk_engine() for _ in range(replicas)],
                          RouterConfig(max_inflight=burst_cap))
    burst_results, burst_launches = _counted(
        lambda: burst_router.run(_fresh(burst + recovery)))
    burst_sheds = sum(1 for r in burst
                      if burst_results[r.id].finish_reason == "shed")
    recovery_clean = all(burst_results[r.id].finish_reason
                         in ("eos", "length") for r in recovery)
    out: Dict[str, object] = {
        "router_replicas": replicas,
        "router_requests": num_requests,
        "router_slots": slots,
        "router_max_inflight": max_inflight,
        "router_page_size": page_size,
        "router_shared_prefix_len": shared_prefix_len,
        "router_num_tenants": num_tenants,
        "router_tokens_per_sec": total_new / on_wall,
        "router_wall_seconds": on_wall,
        "router_offered_rps": 1.0 / arrival_gap,
        **_latency_fields(on_results.values(), "router"),
        "router_token_identical": bool(identical),
        "router_token_divergences": divergences,
        "router_dispatch_counts": on_router.dispatch_counts(),
        "router_shed_low_load": on_router.shed_count()
                                + off_router.shed_count(),
        "router_affinity_hit_rate": on_rate,
        "router_noaffinity_hit_rate": off_rate,
        "router_affinity_nonzero": bool(on_rate > 0.0),
        "router_affinity_hit_gain": bool(on_rate > off_rate),
        "router_replica_prefix_hit_pages": on_hits,
        "router_predicted_hit_pages": on_router.affinity_hit_pages,
        "router_affinity_adm_ttft_p50_ms": _ms(on_p50),
        "router_noaffinity_adm_ttft_p50_ms": _ms(off_p50),
        "router_affinity_ttft_ok": bool(ttft_ok),
        "router_noaffinity_wall_seconds": off_wall,
        "router_noaffinity_tokens_per_sec": sum(
            len(r.tokens) for r in off_results.values()) / off_wall,
        "router_burst_requests": burst_n,
        "router_burst_sheds": burst_sheds,
        "router_burst_recovered": len(recovery),
        "router_burst_recovery_clean": bool(recovery_clean),
        "router_dead_replicas": {"affinity": on_router.dead_replicas(),
                                 "noaffinity": off_router.dead_replicas(),
                                 "burst": burst_router.dead_replicas()},
        "router_compile_pins_held": bool(
            _pins_held(on_router, len(chunk_buckets))
            and _pins_held(off_router, len(chunk_buckets))
            and _pins_held(burst_router, len(chunk_buckets))),
        **{f"router_hop_{k}": v for k, v in hop_percentiles(spans).items()},
        "router_trace_complete": bool(trace_complete),
        "router_trace_max_gap_ms": _ms(max_gap),
        "router_single_tokens_per_sec": sum(
            len(r.tokens) for r in single_results.values()) / single_wall,
        "router_single_wall_seconds": single_wall,
        **_latency_fields(single_results.values(), "router_single"),
        "router_single_token_identical": all(
            single_results[r.id].tokens == oracle[r.id] for r in trace),
        "router_arm_launches": {"oracle": fs["oracle_launches"],
                                "affinity": on_launches,
                                "noaffinity": off_launches,
                                "single": single_launches,
                                "burst": burst_launches},
        "router_arm_decode_steps": {"oracle": fs["oracle_steps"],
                                    "affinity": _fleet_steps(on_router),
                                    "noaffinity": _fleet_steps(off_router),
                                    "single": single.steps_dispatched,
                                    "burst": _fleet_steps(burst_router)},
        "router_pages_in_use_after": _pages_in_use(
            [fs["oracle_engine"], single] + _fleet_engines(
                on_router, off_router, burst_router)),
        "router_device": _device_name(dev),
    }
    log(f"router {fs['name']} on {out['router_device']}: {num_requests} "
        f"reqs over {replicas}x{slots} slots at "
        f"{out['router_offered_rps']} req/s offered: "
        f"{out['router_tokens_per_sec']} new tokens/s, TTFT p99 "
        f"{out['router_ttft_p99_ms']} ms; hit rate {on_rate} (affinity) vs "
        f"{off_rate} (load only); dispatch {out['router_dispatch_counts']}, "
        f"{out['router_shed_low_load']} low-load sheds; burst {burst_n} -> "
        f"{burst_sheds} sheds, recovery clean={recovery_clean}; "
        f"token-identical={identical}, pins={out['router_compile_pins_held']}")
    return out


def run_livescale_benchmark(
    size: Optional[str] = None,
    family: str = "gpt2",
    replicas: int = 2,
    slots: int = 4,
    num_requests: int = 12,
    prompt_grid: Sequence[int] = (16, 32),
    new_grid: Sequence[int] = (8, 16),
    chunk_buckets: Tuple[int, ...] = (16, 64),
    dtype_name: str = "bfloat16",
    decode_kernel: Optional[bool] = None,
    page_size: int = 16,
    num_pages: Optional[int] = None,
    shared_prefix_len: int = 32,
    num_tenants: int = 4,
    max_inflight: int = 8,
    arrival_gap: float = 0.15,
    scale_up_at: float = 0.3,
    scale_down_at: float = 0.8,
    seed: int = 0,
    device: DeviceLike = None,
    log: Callable[[str], None] = print,
) -> Dict[str, object]:
    """Live decode-pool scaling against a gang restart, the same seeded
    trace both ways. LIVE: a `replicas`-wide fleet takes a +1 step (an
    engine built and warmed outside the trace clock attaches at
    `scale_up_at`) and a -1 step (replica 0 drains at `scale_down_at`:
    queued requests fail over, residents finish in place, pages and
    slots audited). GANG: the same +1 decision as the old way — the fleet
    finishes what arrived by `scale_up_at`, then every engine is rebuilt
    one wider with construction and warm-up in band, and later arrivals
    wait for it. The reference's `livescale_*` keys: drops and sheds (0
    expected), token identity against the single-engine oracle in both
    arms, the pins, the live steps priced through resize_ledger against
    the gang's drain + rebuild, and the live arm's traces. The port adds
    each arm's kernel launches and decode steps
    (`livescale_arm_launches`, `livescale_arm_decode_steps`), each first
    divergence from the oracle with its margins
    (`livescale_token_divergences`), the replicas each arm lost to
    failover (`livescale_dead_replicas`), and the pages still in use
    after every run (every allocator audited)."""
    from ..serve import Router, RouterConfig
    from ..telemetry.collector import resize_ledger
    from ..telemetry.events import LIVE_SCALE
    fs = _fleet_setup(size, family, dtype_name, decode_kernel, page_size,
                      shared_prefix_len, prompt_grid, new_grid, num_requests,
                      num_tenants, arrival_gap, slots, chunk_buckets,
                      num_pages, seed, device)
    trace, oracle, mk_engine = fs["trace"], fs["oracle"], fs["mk_engine"]
    dev = fs["dev"]
    cfg = RouterConfig(max_inflight=max_inflight)

    # LIVE arm: the +1 engine is built and warmed out of the trace clock;
    # only its measured cost rides into the ledger as the warmup phase
    warm_t0 = time.perf_counter()
    newcomer = mk_engine()
    _sync(dev)
    attach_warmup = time.perf_counter() - warm_t0
    live_tracer = Tracer(sample=1.0)
    live_router = Router([mk_engine() for _ in range(replicas)], cfg,
                         tracer=live_tracer)
    live_router.schedule_attach(scale_up_at, newcomer,
                                warmup_seconds=attach_warmup)
    live_router.schedule_detach(scale_down_at, 0)
    _sync(dev)
    t0 = time.perf_counter()
    live_results, live_launches = _counted(
        lambda: live_router.run(_fresh(trace)))
    _sync(dev)
    live_wall = time.perf_counter() - t0
    live_dropped = [r.id for r in trace if r.id not in live_results
                    or live_results[r.id].finish_reason == "shed"]
    live_identical = not live_dropped and all(
        live_results[r.id].tokens == oracle[r.id] for r in trace)
    live_tokens = sum(len(r.tokens) for r in live_results.values())
    ids = {r.id for r in trace}
    live_spans = [s for s in live_tracer.ring if s["trace"] in ids
                  or s["trace"] < 0]
    live_complete, live_gap, _ = _trace_check(live_spans, trace)
    live_entries = resize_ledger(
        [{"event": LIVE_SCALE, "ts": e["ts"], "action": e["action"],
          "drain_seconds": e["drain_seconds"],
          "warmup_seconds": e["warmup_seconds"]}
         for e in live_router.live_scale_log])
    live_totals = [e["total_seconds"] for e in live_entries]

    # GANG arm: the same +1 decision as a restart
    gang_results: Dict[int, object] = {}
    pre = [r for r in trace if r.arrival <= scale_up_at]
    post = [r for r in trace if r.arrival > scale_up_at]
    gang_a = Router([mk_engine() for _ in range(replicas)], cfg)
    _sync(dev)
    g0 = time.perf_counter()
    res_a, launches_a = _counted(lambda: gang_a.run(_fresh(pre)))
    gang_results.update(res_a)
    _sync(dev)
    drain_done = time.perf_counter()
    # the restart window: every engine rebuilt from scratch in band
    gang_b_engines = [mk_engine() for _ in range(replicas + 1)]
    _sync(dev)
    restart_done = time.perf_counter()
    gang_shift = restart_done - g0
    gang_b = Router(gang_b_engines, cfg)
    res_b, launches_b = _counted(
        lambda: gang_b.run(_fresh(post, shift=gang_shift)))
    gang_results.update(res_b)
    _sync(dev)
    gang_wall = time.perf_counter() - g0
    gang_drain = max(0.0, (drain_done - g0) - scale_up_at)
    gang_restore = restart_done - drain_done
    gang_total = gang_drain + gang_restore
    gang_dropped = [r.id for r in trace if r.id not in gang_results
                    or gang_results[r.id].finish_reason == "shed"]
    gang_identical = not gang_dropped and all(
        gang_results[r.id].tokens == oracle[r.id] for r in trace)
    # the second router's TTFTs re-anchored to the original arrivals:
    # waiting at a dead front door is real latency
    gang_ttfts = [gang_results[r.id].ttft for r in pre
                  if gang_results[r.id].ttft >= 0.0]
    for r in post:
        res = gang_results[r.id]
        if res.token_times:
            gang_ttfts.append((gang_shift + res.token_times[0]) - r.arrival)
    gang_tokens = sum(len(r.tokens) for r in gang_results.values())
    ledger_ok = bool(live_totals) and max(live_totals) < gang_total
    buckets = len(chunk_buckets)
    out: Dict[str, object] = {
        "livescale_replicas_start": replicas,
        "livescale_requests": num_requests,
        "livescale_slots": slots,
        "livescale_page_size": page_size,
        "livescale_scale_up_at": scale_up_at,
        "livescale_scale_down_at": scale_down_at,
        "livescale_attaches": sum(1 for e in live_router.live_scale_log
                                  if e["action"] == "attach"),
        "livescale_detaches": sum(1 for e in live_router.live_scale_log
                                  if e["action"] == "detach"),
        "livescale_detached_replicas": live_router.detached_replicas(),
        "livescale_dropped": len(live_dropped),
        "livescale_sheds": live_router.shed_count(),
        "livescale_token_identical": bool(live_identical),
        "livescale_token_divergences": _divergences(
            fs["model"], trace, oracle,
            {"live": live_results, "gang": gang_results}),
        "livescale_dead_replicas": {
            "live": live_router.dead_replicas(),
            "gang": gang_a.dead_replicas() + gang_b.dead_replicas()},
        "livescale_tokens_per_sec": live_tokens / live_wall,
        "livescale_wall_seconds": live_wall,
        "livescale_ttft_p99_ms": _ms(_percentiles(
            [r.ttft for r in live_results.values() if r.ttft >= 0.0])[99]),
        "livescale_attach_warmup_seconds": attach_warmup,
        "livescale_detach_drain_seconds": next(
            (e["drain_seconds"] for e in live_router.live_scale_log
             if e["action"] == "detach"), 0.0),
        "livescale_ledger_total_seconds": (max(live_totals)
                                           if live_totals else None),
        "livescale_compile_pins_held": bool(_pins_held(live_router,
                                                       buckets)),
        "livescale_gang_dropped": len(gang_dropped),
        "livescale_gang_token_identical": bool(gang_identical),
        "livescale_gang_tokens_per_sec": gang_tokens / gang_wall,
        "livescale_gang_wall_seconds": gang_wall,
        "livescale_gang_ttft_p99_ms": _ms(_percentiles(gang_ttfts)[99]),
        "livescale_gang_stall_seconds": gang_restore,
        "livescale_gang_total_seconds": gang_total,
        "livescale_ledger_vs_gang_ok": ledger_ok,
        "livescale_lost_throughput_pct": (100.0 * (1.0 - live_wall /
                                                   gang_wall)
                                          if gang_wall else None),
        **{f"livescale_hop_{k}": v
           for k, v in hop_percentiles(live_spans).items()},
        "livescale_trace_complete": bool(live_complete),
        "livescale_trace_max_gap_ms": _ms(live_gap),
        "livescale_arm_launches": {
            "oracle": fs["oracle_launches"], "live": live_launches,
            "gang": {k: launches_a[k] + launches_b[k] for k in launches_a}},
        "livescale_arm_decode_steps": {
            "oracle": fs["oracle_steps"], "live": _fleet_steps(live_router),
            "gang": _fleet_steps(gang_a) + _fleet_steps(gang_b)},
        "livescale_pages_in_use_after": _pages_in_use(
            [fs["oracle_engine"]] + _fleet_engines(live_router, gang_a,
                                                   gang_b)),
        "livescale_device": _device_name(dev),
    }
    log(f"livescale {fs['name']} on {out['livescale_device']}: "
        f"{num_requests} reqs, +1@{scale_up_at}s / -1@{scale_down_at}s: "
        f"live TTFT p99 {out['livescale_ttft_p99_ms']} ms vs gang "
        f"{out['livescale_gang_ttft_p99_ms']} ms; "
        f"{out['livescale_tokens_per_sec']} vs "
        f"{out['livescale_gang_tokens_per_sec']} tokens/s; ledger "
        f"{out['livescale_ledger_total_seconds']} s live vs "
        f"{gang_total} s gang (ok={ledger_ok}); "
        f"dropped={out['livescale_dropped']}, "
        f"sheds={out['livescale_sheds']}, "
        f"token-identical={live_identical}/{gang_identical}, "
        f"pins={out['livescale_compile_pins_held']}")
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
    parser.add_argument("--disagg", action="store_true",
                        help="disaggregated prefill/decode against the "
                             "colocated paged engine on one greedy trace")
    parser.add_argument("--router", action="store_true",
                        help="replicas behind the prefix-affinity router, "
                             "affinity on and off, and an overload burst")
    parser.add_argument("--livescale", action="store_true",
                        help="a live +1/-1 replica cycle against a gang "
                             "restart on one trace")
    parser.add_argument("--replicas", type=int, default=2,
                        help="engine replicas behind the router")
    parser.add_argument("--max-inflight", type=int, default=8,
                        help="per-replica in-flight cap (the router's "
                             "shed threshold)")
    parser.add_argument("--scale-up-at", type=float, default=0.3,
                        help="trace time of the +1 attach (--livescale)")
    parser.add_argument("--scale-down-at", type=float, default=0.8,
                        help="trace time of the -1 drain (--livescale)")
    args = parser.parse_args(argv)
    fleet = dict(size=args.size, family=args.family, slots=args.slots,
                 num_requests=args.num_requests, dtype_name=args.dtype,
                 page_size=args.page_size, num_pages=args.num_pages,
                 seed=args.seed, device=args.device)
    router = dict(replicas=args.replicas,
                  shared_prefix_len=args.shared_prefix_len or 32,
                  max_inflight=args.max_inflight)
    for flag, leg, fn, kw in (
            ("livescale", "livescale", run_livescale_benchmark,
             dict(router, scale_up_at=args.scale_up_at,
                  scale_down_at=args.scale_down_at)),
            ("router", "router", run_router_benchmark, router),
            ("disagg", "disagg", run_disagg_benchmark,
             dict(kv_cache_dtype=args.kv_cache_dtype))):
        if getattr(args, flag):
            metrics = fn(**fleet, **kw)
            print(json.dumps({"metric": f"{leg}_tokens_per_sec",
                              "value": metrics[f"{leg}_tokens_per_sec"],
                              "unit": "tokens/sec", **metrics}))
            return 0
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
