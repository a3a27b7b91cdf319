#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mpi_operator_tpu_torch).

    python3 chip_smoke.py        # from the repo root, on one NVIDIA H100

It drives the port only: it imports neither JAX nor the JAX package.
Phases, each of which fails the run (non-zero exit, no result line):

1. Device: the card's name and power limit, as nvidia-smi reports them.
2. Build: every hand-written kernel of the serving path, from the
   sources in ops/csrc/, one nvcc per source, all started together
   (K4 and K5 share one source).
3. Kernel K4 (decode attention) against its plain PyTorch version on
   the card, for the gpt2-medium (H=KV=16) and llama-1b (H=32, KV=8)
   head layouts, D=64, bf16 and int8 caches, B=8, L=1024, ragged
   per-row cursors with the cache past every cursor poisoned. Times the
   kernel, the plain version and one scaled_dot_product_attention call
   (a yardstick only: the port never calls it) with L2 flushed between
   launches, beside the least time the card could take (bytes bound).
4. Kernel K5 (paged decode attention) against its plain version and,
   bit for bit, against K4 on the same logical cache gathered
   contiguous: both head layouts, bf16 and int8, pages of 64 and 16
   positions, logical L=1024, the pool a seeded permutation with the
   trash page and one never-mapped page poisoned, two rows sharing their
   first pages, the cache past every cursor poisoned; cursors at the
   edges (0, 1, 15, 16, 17, 63, 64, 65, 1022, 1023: one row each) and
   the serving depths (B=8). Times K5, K4 on the gathered cache (the
   cost of the indirection) and the plain version, beside the bytes
   bound. No single PyTorch call reads a paged cache: library time null.
5. Serving, contiguous: ServingEngine.run on gpt2-medium at full width
   and depth, bf16, decode_kernel=True, 8 slots, chunk buckets (32,
   128), 24 seeded requests (prompts of 32/64/128 tokens, 32 or 64 new
   tokens; odd ids sample at temperature 0.8 with top_k=40). K4's launch
   count must equal layers x decode steps, K5's must be 0; greedy tokens
   are teacher-forced through the dense path (decode_kernel=False) and
   must agree with it modulo bf16 near-ties. Then 20 decode steps of 8
   requests under torch.profiler give the device's idle share and device
   time by kernel group.
6. Llama: the same engine on llama-1b at full width, 2 layers, int8 KV
   cache — GQA, RoPE and int8 through K4.
7. Serving, paged (this slice's main path, the JAX bench's
   serving_paged leg): gpt2-medium at full width and depth, bf16,
   max_len 384, 8 slots, chunk buckets (32, 128), paged=True,
   page_size 64, the default pool (49 pages); 32 greedy requests, each
   one seeded 128-token system prompt plus 32/64/128 user tokens, 32 or
   64 new tokens. K5's launch count must equal layers x decode steps and
   K4's must be 0; every request ends "length"; tokens agree with the
   dense path as above; at least one request reports 128 cached tokens
   and none anything but 0 or 128; the allocator is empty and passes its
   audit afterwards. Then a profiled window as in phase 5, and an A/B
   on the same trace: the contiguous engine and the paged engine in
   turns (contiguous, paged, paged, contiguous), throughput, TTFT and
   TPOT of each run.
8. Llama, paged: llama-1b at full width, 2 layers, int8 KV, page_size
   16, a 32-token shared prefix (the router bench's settings), 12
   requests — GQA, paged int8 scales and tiles that span pages.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# NVIDIA H100 SXM data-sheet peaks (dense): HBM bandwidth and the bf16
# tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12

# K4 against its plain version: the kernel's online softmax rounds p to
# bf16 against a running max, the plain version against the row max, so
# bf16 outputs differ by a few bf16 ulps (2^-8 relative) at |out| ~ 1
KERNEL_ATOL, KERNEL_RTOL = 2e-2, 2e-2
# engine logprobs against the teacher-forced dense path, in nats: the two
# run different kernels and GEMM shapes in bf16 through every layer, so
# logits (std ~0.6 at random init) differ by a few bf16 ulps
LOGPROB_TOL = 0.1
POISON = 1e4
B_KERNEL, L_KERNEL, D_KERNEL = 8, 1024, 64
LAYOUTS = {"gpt2-medium": (16, 16), "llama-1b": (32, 8)}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg):
    print(msg, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# the kernel phase
# ---------------------------------------------------------------------------

def poisoned_cache(H, KV, cache, curs, gen, dev):
    """q [B,H,D] bf16 and a [B,KV,L,D] cache (bf16, or int8 + f32
    scales) filled up to each row's cursor and POISONed past it; B is
    the number of cursors."""
    B, L, D = curs.shape[0], L_KERNEL, D_KERNEL
    q = torch.randn(B, H, D, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, KV, L, D, generator=gen, device=dev)
    v = torch.randn(B, KV, L, D, generator=gen, device=dev)
    dead = (torch.arange(L, device=dev)[None, :]
            > curs[:, None])[:, None, :]                      # [B, 1, L]
    if cache == "bf16":
        k = torch.where(dead[..., None], POISON, k).bfloat16()
        v = torch.where(dead[..., None], POISON, v).bfloat16()
        return q, k, v, None, None
    out = []
    for x in (k, v):
        s = torch.clamp(x.abs().amax(-1) / 127.0, min=1e-8)
        x8 = torch.clamp(torch.round(x / s[..., None]), -127, 127)
        out.append((torch.where(dead[..., None], 127.0, x8).to(torch.int8),
                    torch.where(dead, POISON, s)))
    (k8, ks), (v8, vs) = out
    return q, k8, v8, ks, vs


def time_ms(fn, iters, flush) -> float:
    """Median device time of one call, from CUDA events around each call
    with the 50 MB L2 flushed before it (the serving step reaches each
    layer's cache cold, after the other layers' weights)."""
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for e0, e1 in ev:
        flush.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return float(np.median([e0.elapsed_time(e1) for e0, e1 in ev]))


def bound(H, KV, cache, curs, page_size=None):
    """(bound_ms, bound_by): the larger of the bytes K4 must move — the
    filled prefix of k and v (plus 8 bytes a position for int8 scales),
    q, the cursors and the output, each once — over HBM bandwidth, and
    its multiply-adds (q.k and p.v, 4 ops a position, head and element)
    over the bf16 tensor-core rate. With `page_size` (K5), plus the
    4-byte page-table entries the cursors reach."""
    B, D = curs.shape[0], D_KERNEL
    last = (curs.long() + 1).clamp(max=L_KERNEL)
    positions = int(last.sum())
    elt = 1 if cache == "int8" else 2
    nbytes = positions * KV * (2 * D * elt + (8 if cache == "int8" else 0))
    nbytes += 2 * B * H * D * 2 + B * 4
    if page_size is not None:
        nbytes += int(((last - 1).clamp(min=0) // page_size + 1).sum()) * 4
    ops = positions * H * D * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_phase(k4, dev):
    """K4 vs its plain version at the main path's head layouts; returns
    (max_abs_err over every check, the timing row of the main path's
    layout: gpt2-medium, bf16 cache)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB
    rs = np.random.RandomState(0)
    cursor_sets = {
        "edges": [0, 1, 63, 64, 65, 511, 1022, 1023],
        # the serving phase's depths: prompt (<= 128) + new (<= 64)
        "serving": sorted(rs.randint(32, 192, B_KERNEL).tolist()),
    }
    worst, main_row = 0.0, None
    for layout, (H, KV) in LAYOUTS.items():
        for cache in ("bf16", "int8"):
            for cname, cl in cursor_sets.items():
                curs = torch.tensor(cl, dtype=torch.int32, device=dev)
                q, k, v, ks, vs = poisoned_cache(H, KV, cache, curs, gen, dev)
                out = k4.decode_attention(q, k, v, curs, ks, vs)
                torch.cuda.synchronize()
                ref = k4.decode_attention_ref(q, k, v, curs, ks, vs)
                err = float((out.float() - ref.float()).abs().max())
                check(torch.isfinite(out).all().item(),
                      f"K4 {layout} {cache} {cname}: non-finite output")
                check(torch.allclose(out.float(), ref.float(),
                                     atol=KERNEL_ATOL, rtol=KERNEL_RTOL),
                      f"K4 {layout} {cache} {cname}: max |kernel - plain| "
                      f"= {err} beyond atol {KERNEL_ATOL} rtol "
                      f"{KERNEL_RTOL}")
                worst = max(worst, err)
                if cname != "serving":
                    log(f"  K4 {layout:11s} {cache:4s} {cname:7s} "
                        f"max_abs_err {err:.3e}")
                    continue
                ms = time_ms(lambda: k4.decode_attention(q, k, v, curs, ks,
                                                         vs), 50, flush)
                plain_ms = time_ms(lambda: k4.decode_attention_ref(
                    q, k, v, curs, ks, vs), 10, flush)
                library_ms = None
                if cache == "bf16":
                    mask = (torch.arange(L_KERNEL, device=dev)[None, :]
                            <= curs[:, None])[:, None, None, :]
                    q4 = q[:, :, None]
                    library_ms = time_ms(
                        lambda: F.scaled_dot_product_attention(
                            q4, k, v, attn_mask=mask, enable_gqa=H != KV),
                        50, flush)
                bound_ms, bound_by = bound(H, KV, cache, curs)
                log(f"  K4 {layout:11s} {cache:4s} {cname:7s} "
                    f"max_abs_err {err:.3e}  kernel {ms:.4f} ms  plain "
                    f"{plain_ms:.4f} ms  sdpa {library_ms} ms  bound "
                    f"{bound_ms:.4f} ms ({bound_by}) cursors {cl}")
                if layout == "gpt2-medium" and cache == "bf16":
                    main_row = dict(ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    library_ms=library_ms)
    del flush
    return worst, main_row


def paged_pool(k, v, ks, vs, curs, ps, gen):
    """The logical [B,KV,L,D] cache (and [B,KV,L] scales) scattered into
    a pool of B*nblk + 2 pages through a seeded permutation of pages
    1..NP-2: the trash page 0 and the never-mapped page NP-1 hold
    POISON. The two rows with the largest cursors share their first
    pages (up to 2, all below both cursors), as a prefix hit does; the
    logical cache of the second is made to match. Returns the pool
    tensors, the int32 [B, nblk] table and the (possibly edited) logical
    cache."""
    B, KV, L, D = k.shape
    nblk = L // ps
    NP = B * nblk + 2
    table = (torch.randperm(NP - 2, generator=gen, device=k.device)
             + 1).reshape(B, nblk)
    i, j = torch.sort(curs, stable=True).indices[-2:].tolist()
    n = min(2, (int(curs[i]) + 1) // ps, nblk)
    table[j, :n] = table[i, :n]
    logical = [None if x is None else x.clone() for x in (k, v, ks, vs)]
    for x in logical:
        if x is not None:
            x[j, :, :n * ps] = x[i, :, :n * ps]
    flat = table.reshape(-1)

    def pool(x, fill):
        out = torch.full((NP, KV, ps) + tuple(x.shape[3:]), fill,
                         dtype=x.dtype, device=x.device)
        blocks = x.reshape(B, KV, nblk, ps, *x.shape[3:]).transpose(1, 2)
        out[flat] = blocks.reshape(B * nblk, KV, ps, *x.shape[3:])
        return out
    dead = 127 if k.dtype == torch.int8 else POISON
    pools = [pool(logical[0], dead), pool(logical[1], dead)]
    pools += [None, None] if ks is None else [pool(logical[2], POISON),
                                              pool(logical[3], POISON)]
    return pools, table.to(torch.int32), logical


def paged_kernel_phase(ops, dev):
    """K5 vs its plain version and vs K4 on the gathered cache; returns
    (max_abs_err over every check, the timing row of the main path's
    layout: gpt2-medium, bf16 pool, pages of 64)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB
    rs = np.random.RandomState(0)
    cursor_sets = {
        "edges": [0, 1, 15, 16, 17, 63, 64, 65, 1022, 1023],
        "serving": sorted(rs.randint(32, 192, B_KERNEL).tolist()),
    }
    worst, main_row = 0.0, None
    for layout, (H, KV) in LAYOUTS.items():
        for cache in ("bf16", "int8"):
            for ps in (64, 16):
                for cname, cl in cursor_sets.items():
                    curs = torch.tensor(cl, dtype=torch.int32, device=dev)
                    q, k, v, ks, vs = poisoned_cache(H, KV, cache, curs,
                                                     gen, dev)
                    (kp, vp, ksp, vsp), pt, (k, v, ks, vs) = paged_pool(
                        k, v, ks, vs, curs, ps, gen)
                    tag = f"K5 {layout:11s} {cache:4s} ps {ps:2d} {cname:7s}"
                    out = ops.paged_decode_attention(q, kp, vp, curs, pt,
                                                     ksp, vsp)
                    torch.cuda.synchronize()
                    ref = ops.paged_decode_attention_ref(q, kp, vp, curs, pt,
                                                         ksp, vsp)
                    err = float((out.float() - ref.float()).abs().max())
                    check(torch.isfinite(out).all().item(),
                          f"{tag}: non-finite output")
                    check(torch.allclose(out.float(), ref.float(),
                                         atol=KERNEL_ATOL, rtol=KERNEL_RTOL),
                          f"{tag}: max |kernel - plain| = {err} beyond "
                          f"atol {KERNEL_ATOL} rtol {KERNEL_RTOL}")
                    k4_out = ops.decode_attention(q, k, v, curs, ks, vs)
                    diff = float((out.float() - k4_out.float()).abs().max())
                    check(torch.equal(out, k4_out),
                          f"{tag}: K5 differs from K4 on the gathered cache "
                          f"by {diff}")
                    worst = max(worst, err)
                    if cname != "serving":
                        log(f"  {tag} max_abs_err {err:.3e}  == K4")
                        continue
                    ms = time_ms(lambda: ops.paged_decode_attention(
                        q, kp, vp, curs, pt, ksp, vsp), 50, flush)
                    k4_ms = time_ms(lambda: ops.decode_attention(
                        q, k, v, curs, ks, vs), 50, flush)
                    plain_ms = time_ms(lambda: ops.paged_decode_attention_ref(
                        q, kp, vp, curs, pt, ksp, vsp), 10, flush)
                    bound_ms, bound_by = bound(H, KV, cache, curs, ps)
                    log(f"  {tag} max_abs_err {err:.3e}  == K4  kernel "
                        f"{ms:.4f} ms  K4 on the gathered cache {k4_ms:.4f} "
                        f"ms  plain {plain_ms:.4f} ms  bound {bound_ms:.5f} "
                        f"ms ({bound_by}) cursors {cl}")
                    if (layout == "gpt2-medium" and cache == "bf16"
                            and ps == 64):
                        main_row = dict(ms=ms, plain_ms=plain_ms,
                                        bound_ms=bound_ms, bound_by=bound_by,
                                        library_ms=None)
    del flush
    return worst, main_row


# ---------------------------------------------------------------------------
# the serving phases
# ---------------------------------------------------------------------------

def make_paged_trace(vocab, n, seed, shared_len, prompt_grid, new_grid):
    """The JAX bench's shared-system-prompt trace: one seeded system
    prompt of `shared_len` tokens, then per request a random tail from
    `prompt_grid` and a new-token budget from `new_grid`; all greedy,
    all waiting at t=0."""
    from mpi_operator_tpu_torch.serve import Request
    rs = np.random.RandomState(seed)
    system = rs.randint(0, vocab, shared_len).tolist()
    return [Request(id=i, prompt=system + rs.randint(
        0, vocab, int(rs.choice(prompt_grid))).tolist(),
        max_new_tokens=int(rs.choice(new_grid))) for i in range(n)]


def make_trace(vocab, n, seed):
    """The serving benchmark's trace shape: prompts of 32/64/128 random
    tokens, 32 or 64 new tokens, odd ids sampled (temperature 0.8,
    top_k 40), even ids greedy; every request waiting at t=0."""
    from mpi_operator_tpu_torch.serve import Request
    rs = np.random.RandomState(seed)
    trace = []
    for i in range(n):
        p, new = int(rs.choice((32, 64, 128))), int(rs.choice((32, 64)))
        temp = 0.8 if i % 2 == 1 else 0.0
        trace.append(Request(id=i, prompt=rs.randint(0, vocab, p).tolist(),
                             max_new_tokens=new, temperature=temp,
                             top_k=40 if temp > 0 else 0))
    return trace


@torch.inference_mode()
def teacher_forced_logp(dense, req, tokens):
    """log_softmax of the dense path's logits at the positions that
    chose each new token: [n, V] f32."""
    seq = list(req.prompt) + tokens[:-1]
    toks = torch.tensor([seq], dtype=torch.int64, device=dense.device)
    logits = dense(toks, positions=np.arange(len(seq))[None],
                   cache=dense.new_cache(1))
    return torch.log_softmax(logits[0, len(req.prompt) - 1:].float(), -1)


def check_results(engine, trace, results, name):
    """Every request complete with finite logprobs; greedy tokens agree
    with the dense path modulo near-ties; sampled tokens inside their
    top_k. Returns (greedy positions checked, positions where the engine
    chose the dense argmax exactly, worst logprob deviation)."""
    from mpi_operator_tpu_torch.models import decode_model
    dense = decode_model(engine.dmodel, decode_kernel=False)
    check(len(results) == len(trace), f"{name}: {len(results)} results for "
          f"{len(trace)} requests")
    n_pos = n_exact = 0
    worst = 0.0
    for req in trace:
        r = results[req.id]
        check(r.finish_reason == "length"
              and len(r.tokens) == req.max_new_tokens,
              f"{name}: request {req.id} ended {r.finish_reason} after "
              f"{len(r.tokens)}/{req.max_new_tokens} tokens")
        lp = np.asarray(r.logprobs)
        check(np.isfinite(lp).all() and (lp <= 1e-3).all(),
              f"{name}: request {req.id} has bad logprobs")
        logp = teacher_forced_logp(dense, req, r.tokens)
        idx = torch.tensor(r.tokens, device=logp.device)
        chosen = logp.gather(-1, idx[:, None])[:, 0].cpu()
        dev_lp = float((chosen - torch.from_numpy(lp).float()).abs().max())
        worst = max(worst, dev_lp)
        check(dev_lp <= LOGPROB_TOL,
              f"{name}: request {req.id} logprob differs from the dense "
              f"path by {dev_lp} > {LOGPROB_TOL}")
        if req.temperature == 0.0:
            gap = (logp.max(-1).values.cpu() - chosen)
            check(float(gap.max()) <= LOGPROB_TOL,
                  f"{name}: greedy request {req.id} chose a token "
                  f"{float(gap.max())} nats below the dense argmax")
            n_pos += len(r.tokens)
            n_exact += int((gap == 0).sum())
        else:
            kth = torch.topk(logp, req.top_k, -1).values[:, -1].cpu()
            check(bool((chosen >= kth - LOGPROB_TOL).all()),
                  f"{name}: sampled request {req.id} left its top_k")
    return n_pos, n_exact, worst


def kernel_group(name: str) -> str:
    if "decode_attention" in name:
        return ("K5 paged_decode_attention" if "PagedRows" in name
                else "K4 decode_attention")
    if any(s in name.lower() for s in ("gemm", "xmma", "cutlass", "gemv")):
        return "GEMM (cuBLAS)"
    return name[:70]


def profile_run(engine, trace, ticks=20):
    """Where a serving run's time goes: the engine takes `trace` again
    (after the measured run, so launch counts are untouched), runs until
    every request has finished prefilling, then `ticks` loop iterations
    (one decode step each) under torch.profiler. Prints the device's
    busy and idle share of that window and device time by kernel group.
    Kernels run on one stream and do not overlap, so their summed time
    is the busy time."""
    from torch.profiler import ProfilerActivity, profile
    engine.reset()
    engine.start()
    for r in trace:
        engine.submit(r)
    engine.tick()                                     # admits the trace
    while engine.scheduler.next_prefill() is not None:
        engine.tick()
    steps0 = engine.steps_dispatched
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.tick()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    steps = engine.steps_dispatched - steps0
    while engine.active:
        engine.tick()
    engine.finish()
    groups = {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.is_user_annotation):
            continue
        g = groups.setdefault(kernel_group(e.name), [0.0, 0])
        g[0] += e.time_range.elapsed_us()
        g[1] += 1
    busy = sum(g[0] for g in groups.values())
    log(f"  profile: {steps} decode steps, wall {wall_us / 1e3:.2f} ms "
        f"({wall_us / 1e3 / max(steps, 1):.3f} ms a step), device busy "
        f"{busy / 1e3:.2f} ms ({busy / 1e3 / max(steps, 1):.3f} ms a step), "
        f"idle share {1 - busy / wall_us:.3f}")
    for name, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  profile: {us / 1e3:8.3f} ms {us / max(busy, 1e-9):6.1%} "
            f"{n:5d} launches  {name}")


def serve_phase(name, model, trace, ops, config, kernel,
                profile_requests=0, shared_len=0):
    """Warm the engine on two requests, reset, then drive `trace` with
    every kernel count zeroed just before and read just after: `kernel`
    must have launched once a layer a decode step, every other kernel
    never. A paged `config` also checks the prefix cache (every request
    reports 0 or `shared_len` cached tokens, at least one the latter)
    and that the allocator is empty afterwards. Then, with
    `profile_requests`, profile a run of that many requests."""
    from mpi_operator_tpu_torch.serve import ServingEngine
    num_layers = model.config.num_layers
    engine = ServingEngine(model, config)
    engine.run(trace[:2])
    engine.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = engine.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    launches = counts[kernel]
    steps = engine.steps_dispatched
    check(steps > 0 and launches == num_layers * steps,
          f"{name}: {kernel} launched {launches} times over {steps} decode "
          f"steps of {num_layers} layers")
    check(all(n == 0 for k, n in counts.items() if k != kernel),
          f"{name}: other kernels launched: {counts}")
    n_pos, n_exact, worst = check_results(engine, trace, results, name)
    new_tokens = sum(len(r.tokens) for r in results.values())
    ttft = [r.ttft for r in results.values()]
    tpot = [dt for r in results.values() for dt in np.diff(r.token_times)]
    pct = lambda xs, p: float(np.percentile(xs, p)) * 1e3  # noqa: E731
    stats = dict(requests=len(trace), new_tokens=new_tokens,
                 wall_s=wall, tokens_per_s=new_tokens / wall,
                 ttft_p50_ms=pct(ttft, 50), ttft_p99_ms=pct(ttft, 99),
                 tpot_p50_ms=pct(tpot, 50), tpot_p99_ms=pct(tpot, 99),
                 decode_steps=steps, launches={kernel: launches},
                 greedy_positions=n_pos, greedy_exact_argmax=n_exact,
                 max_logprob_dev=worst,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    if config.paged:
        alloc = engine.page_allocator
        cached = sorted({r.cached_tokens for r in results.values()})
        check(set(cached) <= {0, shared_len} and shared_len in cached,
              f"{name}: cached_tokens {cached}, expected 0 or {shared_len} "
              f"with at least one hit")
        check(alloc.in_use == 0, f"{name}: {alloc.in_use} pages still in "
              f"use after the run")
        alloc.check()
        adm = {c: [(r.token_times[0] - r.admitted_at) for r in
                   results.values() if r.cached_tokens == c] for c in cached}
        stats.update(
            prefix_hit_requests=len(adm.get(shared_len, [])),
            prefix_hit_rate=alloc.hits / max(alloc.hits + alloc.misses, 1),
            ttft_from_admission_cold_p50_ms=pct(adm[0], 50) if 0 in adm
            else None,
            ttft_from_admission_hit_p50_ms=pct(adm[shared_len], 50),
            pages_in_use_peak=engine.pages_in_use_peak,
            pages_usable=alloc.usable, occupancy_peak=engine.occupancy_peak)
    log(f"  {name}: {json.dumps(stats)}")
    if profile_requests:
        profile_run(engine, trace[:profile_requests])
    return launches


def ab_runs(model, trace, configs):
    """Serve `trace` once with each (name, EngineConfig) in turn, after
    a two-request warm-up of each engine; prints and returns each run's
    throughput and TTFT/TPOT p50. No checks: the phases before it check
    these paths."""
    from mpi_operator_tpu_torch.serve import ServingEngine
    engines = {}
    out = []
    for name, config in configs:
        if name not in engines:
            engines[name] = ServingEngine(model, config)
            engines[name].run(trace[:2])
        engine = engines[name]
        engine.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        new = sum(len(r.tokens) for r in results.values())
        tpot = [dt for r in results.values() for dt in np.diff(r.token_times)]
        row = dict(engine=name, tokens_per_s=new / wall,
                   ttft_p50_ms=float(np.percentile(
                       [r.ttft for r in results.values()], 50)) * 1e3,
                   tpot_p50_ms=float(np.percentile(tpot, 50)) * 1e3,
                   decode_steps=engine.steps_dispatched)
        log(f"  A/B: {json.dumps(row)}")
        out.append(row)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from mpi_operator_tpu_torch.models import create_lm
    from mpi_operator_tpu_torch.ops import _build
    from mpi_operator_tpu_torch.ops import attention as ops
    from mpi_operator_tpu_torch.serve import EngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    log(f"[device] {device_line()}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.build(["decode_attention"])
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    t0 = time.perf_counter()
    log("[kernel] K4 decode_attention vs decode_attention_ref")
    err, row = kernel_phase(ops, dev)
    log(f"[kernel] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[kernel] K5 paged_decode_attention vs paged_decode_attention_ref "
        "and vs K4 on the gathered cache")
    err5, row5 = paged_kernel_phase(ops, dev)
    log(f"[kernel] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[serve] gpt2-medium, bf16, decode_kernel=True, contiguous")
    gpt2 = create_lm("gpt2-medium", seed=0, dtype=torch.bfloat16,
                     decode_kernel=True)
    launches = serve_phase(
        "gpt2-medium", gpt2, make_trace(gpt2.config.vocab_size, 24, seed=0),
        ops, EngineConfig(slots=8, chunk_buckets=(32, 128)),
        "decode_attention", profile_requests=8)
    del gpt2
    torch.cuda.empty_cache()
    log(f"[serve] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[llama] llama-1b (2 layers), bf16, int8 KV, decode_kernel=True")
    llama = create_lm("llama-1b", seed=1, dtype=torch.bfloat16,
                      num_layers=2, kv_cache_dtype="int8",
                      decode_kernel=True)
    serve_phase("llama-1b-2l-int8", llama,
                make_trace(llama.config.vocab_size, 12, seed=1), ops,
                EngineConfig(slots=8, chunk_buckets=(32, 128)),
                "decode_attention")
    del llama
    torch.cuda.empty_cache()
    log(f"[llama] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[paged] gpt2-medium, bf16, decode_kernel=True, paged, page_size "
        "64, 128-token shared prefix")
    gpt2 = create_lm("gpt2-medium", seed=0, dtype=torch.bfloat16,
                     decode_kernel=True, max_len=384)
    trace = make_paged_trace(gpt2.config.vocab_size, 32, 2, 128,
                             (32, 64, 128), (32, 64))
    paged = EngineConfig(slots=8, chunk_buckets=(32, 128), paged=True,
                         page_size=64)
    launches5 = serve_phase(
        "gpt2-medium-paged", gpt2, trace, ops, paged,
        "paged_decode_attention", profile_requests=8, shared_len=128)
    contiguous = EngineConfig(slots=8, chunk_buckets=(32, 128))
    ab_runs(gpt2, trace, [("contiguous", contiguous), ("paged", paged),
                          ("paged", paged), ("contiguous", contiguous)])
    del gpt2
    torch.cuda.empty_cache()
    log(f"[paged] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[paged-llama] llama-1b (2 layers), bf16, int8 KV, paged, "
        "page_size 16, 32-token shared prefix")
    llama = create_lm("llama-1b", seed=1, dtype=torch.bfloat16,
                      num_layers=2, kv_cache_dtype="int8",
                      decode_kernel=True, max_len=80)
    serve_phase("llama-1b-2l-int8-paged", llama,
                make_paged_trace(llama.config.vocab_size, 12, 3, 32,
                                 (16, 32), (8, 16)),
                ops, EngineConfig(slots=4, chunk_buckets=(16, 64),
                                  paged=True, page_size=16),
                "paged_decode_attention", shared_len=32)
    log(f"[paged-llama] {time.perf_counter() - t0:.1f} s")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    source = "mpi_operator_tpu_torch/ops/csrc/decode_attention.cu"
    print(json.dumps({"kernels": [
        dict(name="decode_attention", route="cuda", source=source,
             replaces="mpi_operator_tpu/ops/attention.py:458",
             launches=launches, max_abs_err=err, **row),
        dict(name="paged_decode_attention", route="cuda", source=source,
             replaces="mpi_operator_tpu/ops/attention.py:724",
             launches=launches5, max_abs_err=err5, **row5)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
