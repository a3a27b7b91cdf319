#!/usr/bin/env python3
"""Run chip_smoke.py's profiled serving window many times and account for
every decode-attention kernel record the profiler returns.

    python3 scripts/profile_window_loop.py --windows 120 \\
        --json chiprun_out/profile_window_loop.json      # on an H100

The engine is chip_smoke's `[bench]` `serving` leg with CUDA graphs on
(gpt2-medium at full width, bf16, decode_kernel=True, 8 slots, chunk
buckets (32, 128), every program built), and each window is
`chip_smoke.profile_window`: the leg's 8-request trace prefilled, then 20
loop iterations under torch.profiler (one captured step graph replayed
per iteration), then drained. For every window it records:

- the decode steps and the wrappers' launch count over the window (each
  replay adds the launches its capture made);
- the profiler's K4 device records, counted as chip_smoke counts them
  (FunctionEvents grouped by name) and again from the raw Kineto events,
  grouped by the correlation id of the host call that launched them (one
  cudaGraphLaunch a step);
- whether the window's tokens equal those of an unprofiled run of the
  same trace (a step whose layer skipped K4 would change them).

For a window whose profiler count falls short it prints which graph
launch lacks records and which kernel names that launch is missing
against a complete one (a dropped record) or holds extra (a renamed
one). Then `--planted` windows of the same engine with one layer's K4
replaced by its plain version (chip_smoke.SkipOneLayer): each must fail
chip_smoke.profile_run's launch check.
"""
import argparse
import collections
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

K4 = "K4 decode_attention"


def kineto_records(prof):
    """(K4 records by the correlation id of the host call that launched
    them, every device record's group by that id, host runtime calls by
    correlation id). A device record names its host call through its own
    correlation id or its linked one, depending on the profiler's
    version: the one that names the most host calls is used."""
    dev, host = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((e.correlation_id(), e.linked_correlation_id(),
                        cs.kernel_group(e.name())))
        elif e.name().startswith("cu"):
            host[e.correlation_id()] = e.name()
    own = sum(c in host for c, _, _ in dev)
    linked = sum(c in host for _, c, _ in dev)
    k4 = collections.Counter()
    names = collections.defaultdict(collections.Counter)
    for c, lc, g in dev:
        key = c if own >= linked else lc
        names[key][g] += 1
        if g == K4:
            k4[key] += 1
    return k4, names, host


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--windows", type=int, default=120)
    p.add_argument("--ticks", type=int, default=20)
    p.add_argument("--planted", type=int, default=3)
    p.add_argument("--json", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_window_loop: no CUDA device", file=sys.stderr)
        return 2
    from mpi_operator_tpu_torch.examples.serve_benchmark import (
        serving_max_len, serving_trace)
    from mpi_operator_tpu_torch.models import create_lm
    from mpi_operator_tpu_torch.ops import _build
    from mpi_operator_tpu_torch.serve import EngineConfig, ServingEngine

    cs.log(f"[device] {cs.device_line()} torch {torch.__version__}")
    _build.build(["decode_attention"])
    grids = (32, 64, 128), (32, 64)
    model = create_lm("gpt2-medium", seed=0, dtype=torch.bfloat16,
                      decode_kernel=True, max_len=serving_max_len(*grids))
    trace, _ = serving_trace(model.config.vocab_size, 8, *grids)
    config = EngineConfig(slots=8, chunk_buckets=(32, 128))
    engine = ServingEngine(model, config)
    cs.build_every_program(engine)
    engine.reset()
    want_tokens = {i: r.tokens for i, r in engine.run(trace).items()}
    layers = model.config.num_layers

    rows, short = [], []
    t0 = time.perf_counter()
    for w in range(args.windows):
        prof, wall_us, steps, verify, launched, results = cs.profile_window(
            engine, trace, args.ticks)
        groups, runtime = cs.device_groups(prof)
        seen = groups.get(K4, [0.0, 0])[1]
        try:
            k4, names, host = kineto_records(prof)
        except Exception as e:          # keep the chip_smoke counts
            cs.log(f"  window {w}: Kineto events unreadable: {e!r}")
            k4, names, host = collections.Counter(), {}, {}
        graph_launches = sorted(c for c, n in host.items()
                                if n == "cudaGraphLaunch")
        per_launch = [k4.get(c, 0) for c in graph_launches]
        row = dict(window=w, steps=steps, verify=verify,
                   wrapper_launches=launched["decode_attention"],
                   want=layers * (steps - verify), profiler_records=seen,
                   kineto_records=sum(k4.values()),
                   graph_launches=len(graph_launches),
                   k4_per_graph_launch=sorted(collections.Counter(
                       per_launch).items()),
                   k4_unlinked=sum(n for c, n in k4.items()
                                   if c not in host),
                   tokens_equal=all(results[i].tokens == want_tokens[i]
                                    for i in want_tokens))
        if seen != row["want"] or row["kineto_records"] != row["want"]:
            full = next((names[c] for c, n in zip(graph_launches, per_launch)
                         if n == layers), collections.Counter())
            for c, n in zip(graph_launches, per_launch):
                if n != layers:
                    got = names[c]
                    row.setdefault("short_launches", []).append(dict(
                        index=graph_launches.index(c), k4=n,
                        records=sum(got.values()),
                        complete_records=sum(full.values()),
                        missing=dict(full - got), extra=dict(got - full)))
            short.append(row)
            cs.log(f"  window {w}: SHORT {json.dumps(row)}")
        rows.append(row)
        if w % 10 == 9:
            cs.log(f"  {w + 1} windows, {len(short)} short, "
                   f"{time.perf_counter() - t0:.1f} s")
    planted = cs.planted_skip_check(model, config, trace, "decode_attention",
                                    windows=args.planted)
    summary = dict(
        device=cs.device_line(), windows=len(rows), short=len(short),
        deterministic_equal=sum(r["wrapper_launches"] == r["want"]
                                for r in rows),
        tokens_equal=sum(r["tokens_equal"] for r in rows),
        profiler_records=sorted(collections.Counter(
            r["profiler_records"] for r in rows).items()),
        kineto_records=sorted(collections.Counter(
            r["kineto_records"] for r in rows).items()),
        planted_failures=len(planted), planted_windows=args.planted,
        seconds=time.perf_counter() - t0)
    cs.log(f"[loop] {json.dumps(summary)}")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(summary=summary, short=short, rows=rows), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
