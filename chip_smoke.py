#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mpi_operator_tpu_torch).

    python3 chip_smoke.py        # from the repo root, on one NVIDIA H100

It drives the port only: it imports neither JAX nor the JAX package.
Phases, each of which fails the run (non-zero exit, no result line):

1. Device: the card's name and power limit, as nvidia-smi reports them.
2. Build: every hand-written kernel of the serving and training paths,
   from the sources in ops/csrc/, one nvcc per source, all started
   together (K4 and K5 share one source, K1-K3 another); ptxas'
   registers, shared memory and spills printed for each kernel, and
   K1-K3 (warp specialised, setmaxnreg 40/232) must read 168 registers
   and no spills.
3. Kernel K4 (decode attention) against its plain PyTorch version on
   the card, for the gpt2-medium (H=KV=16) and llama-1b (H=32, KV=8)
   head layouts, D=64, bf16 and int8 caches, B=8, L=1024, ragged
   per-row cursors with the cache past every cursor poisoned: edge
   cursors, the split edges of the split length the wrapper picks
   (length - 1, + 0, + 1, twice it, 1022, 1023, and a short row whose
   later splits lie past its cursor), the serving depths and a long set
   (896..1023). Times the kernel, the plain version and one
   scaled_dot_product_attention call (a yardstick only: the port never
   calls it) with L2 flushed between launches, beside the least time
   the card could take (bytes bound), at the serving and long sets.
4. Kernel K5 (paged decode attention) against its plain version and,
   bit for bit, against K4 on the same logical cache gathered
   contiguous: both head layouts, bf16 and int8, pages of 64 and 16
   positions, logical L=1024, the pool a seeded permutation with the
   trash page and one never-mapped page poisoned, two rows sharing their
   first pages, the cache past every cursor poisoned; cursors at the
   edges (0, 1, 15, 16, 17, 63, 64, 65, 1022, 1023: one row each), the
   split edges, the serving depths and the long set (B=8), and the
   paged serving phase's own shape (logical L=384, cursors in 160..319).
   Times K5, K4 on the gathered cache (the cost of the indirection) and
   the plain version, beside the bytes bound, at the serving, long and
   paged serving sets; the kernels line's K5 row is the paged serving
   set's, pages of 64. No single PyTorch call reads a paged cache:
   library time null.
5. Serving, contiguous: ServingEngine.run on gpt2-medium at full width
   and depth, bf16, decode_kernel=True, 8 slots, chunk buckets (32,
   128), 24 seeded requests (prompts of 32/64/128 tokens, 32 or 64 new
   tokens; odd ids sample at temperature 0.8 with top_k=40). The engine
   runs its decode steps and prefill chunks as CUDA graphs (the
   default): every program is captured once, at most 3 step programs
   and one prefill program a bucket. K4's launch count (replays
   counted) must equal layers x decode steps, K5's must be 0; greedy
   tokens are teacher-forced through the dense path (decode_kernel=
   False) and must agree with it modulo bf16 near-ties. Then 20 decode
   steps of 8 requests under torch.profiler give the device's idle
   share, device time by kernel group and the host's runtime calls a
   step, and the profiler's own count of K4 launches must equal layers
   x steps.
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
9. Kernels K1-K3 (flash attention forward, dq, dk/dv) against their
   plain versions in bf16: the training shape (B=16, S=512, gpt2-medium
   heads H=16, D=64, causal), bert-large's (the same, non-causal) with
   and without a key mask (row 0 padded after 3/4), llama-1b's heads
   after the K/V repeat (H=32), a [B, S] key mask with one fully masked
   row (non-causal and causal), a ragged S=500, S=129 (one past K1's
   128-row tiles), and D=128 (two 64-column boxes a tile). K2/K3 get
   the plain forward's lse and delta. Each output is held to a relative
   error limit, and at the training shape each limit must fail planted
   faults made from the plain versions (a skipped tile; for K2/K3 ds
   left unrounded). Times each kernel at the training shape and at both
   bert-large shapes with L2 flushed beside its bound (the bytes, or the
   products over this input's visible pairs), its plain version, and
   one scaled_dot_product_attention call with the same causality and
   mask, forward and backward through autograd (yardsticks only: the
   port never calls SDPA), and prints K1 over SDPA's forward and K2 + K3
   over SDPA's backward, ratios taken in the same call.
10. Training, gpt2-medium (this slice's main path, the JAX bench's gpt2
   leg): run_lm_benchmark(workload="gpt2", size="medium",
   batch_per_device=16, seq_len=512), bf16 compute over f32 masters,
   attention="flash", AdamW with warmup, 3 warmup steps then 3 windows
   of 10 steps. K1, K2 and K3 must each launch num_layers x steps times
   (the decode kernels never); every step's loss finite and no update
   skipped by the guard. Then one step's gradients from the same weights
   and batch through attention="flash" and "dense" must agree (cosine >=
   0.999 per parameter tensor, global norm within 1%), and two profiled
   steps give K1-K3's share of device time and the idle share.
11. Training, llama-1b at full width, 2 layers, batch 8 x 512: RoPE, GQA
   through the repeat, SwiGLU and RMSNorm in training, with the same
   launch and finiteness checks.
12. (Run after 8.) The serving benchmark (examples/serve_benchmark.py)
   at bench.py's
   `serving` leg (gpt2-medium, 8 slots, 32 requests, prompts 32/64/128,
   32/64 new tokens, buckets (32, 128), the sequential generate()
   baseline and the sync A/B), the same leg with odd ids sampled, and
   the `serving_paged` leg (pages of 64, a 128-token shared prefix).
   Each: serving_no_recompile, every program captured once, and a
   graphs-on/graphs-off A/B on the same trace and settings (runs
   alternated, best of two an arm) whose tokens, greedy and sampled,
   must be identical; tokens/s and TPOT p50/p99 of both arms, and
   whether they moved beyond the arms' run-to-run spread. For the two
   bench legs, with graphs on and off: every program built (a request
   in each sampling mode, prompts reaching both buckets) and the memory
   the engine reserved, then a profiled window of 20 steps: device time
   a step, idle share, host launch calls a step, and the profiler's
   K4/K5 count against layers x steps. The engine runs with its
   telemetry and a tracer attached, as the benchmark always runs it:
   every request's trace complete (hops tiling its end-to-end time) and
   the host gap printed; the `serving` leg also logs its events to a
   temporary directory (one slot_admit and one slot_retire a request)
   and runs a hooks A/B (no telemetry, tracer or event log; alternated,
   best of two an arm, greedy tokens identical).
13. (Run after 12.) Speculative serving, the JAX bench's `serving_spec`
   leg at full size through run_serving_benchmark: gpt2-medium, bf16,
   decode_kernel=True, 8 slots, 32 greedy requests with a 128-token
   shared prefix, buckets (32, 128), speculative="ngram", draft_k=4,
   paged (pages of 64) and then contiguous (the trash row takes the
   verify step's padded columns). Each: acceptance rate, effective
   tokens a row-step, verify steps; tokens/s and TPOT p50/p99 with
   speculation and without (alternated, best of two an arm) and whether
   they moved beyond the arms' spread; at most len(_verify_buckets)
   verify programs, each captured once; both arms' tokens and logprobs
   against the teacher-forced dense path; every token where the arms
   differ a near tie of the dense path (SPEC_MARGIN: the arms run other
   kernels and GEMM shapes in bf16), and a planted fault (a draft token
   accepted past the match) caught by that check; K4/K5 launched once a
   layer a plain step and never in a verify step; profiled windows with
   speculation on and off (device time a verify step against a plain
   step, idle share). Then a contiguous f32 run with decode_kernel=False
   (16 requests) whose greedy tokens must be identical between the arms.
14. (Run after 11.) BERT: run_lm_benchmark(workload="bert", size=
   "large", batch_per_device=16, seq_len=512), the JAX bench's bert leg
   (MLM rate 0.15, the MaskedLM's attention non-causal through K1-K3),
   3 warmup steps and 30 timed: K1-K3 launches 24 x steps each, losses
   finite, no skipped update; tokens/s, step p50/p99, MFU (attention
   FLOPs not halved) and peak memory. Then one step's gradients through
   flash and dense from the same weights and an MLM batch under a key
   mask padding two rows (cosine >= 0.999 a tensor), and two profiled
   steps.
15. MoE: gpt2-small with 8 experts (top-2, capacity factor 1.25, MoE on
   every second block), 16 x 512, the bench's moe leg, 33 steps: K2/K3
   launches 12 x steps, K1 12 x (steps + 1) (the drop-rate probe's
   forward), finite losses, no skip, the drop rate in [0, 0.5]; two
   profiled steps; then 4 layers dropless for 5 steps, drop rate 0.
16. Remat: gpt2-medium, 16 x 512, 12 steps each with remat off, "none"
   and "dots", one seed and one stream: the params of both remat arms
   equal remat off's bit for bit; K1 launches 2 x 24 x steps under
   remat, K2/K3 24 x steps; peak memory and step p50 of each arm.
17. Generate: run_generate_benchmark for gpt2-medium and llama-1b,
   bf16 and int8 KV, batch 8, prompt 128, 128 new tokens, greedy,
   decode_kernel=True, 2 timed calls after a warm one: K4 launches
   layers x 127 decode steps x calls (the prefill runs the dense path),
   no other kernel; the last call's tokens against decode_kernel=False
   on the same model, each row's first divergence a near tie of the
   dense path; tokens/s and MBU against 3.35 TB/s. Every phase from 14
   on prints the card's name and power limit beside its numbers.
18. (Run last.) Training that survives preemption, gpt2-medium at
   full width, bf16, attention="flash", 16 x 512, through
   run_lm_benchmark's resilient path in a temporary directory (at least
   20 GB free, or the phase fails): periodic async checkpoints every 12
   steps keeping 2 (torch.distributed.checkpoint). A and A': two
   uninterrupted runs to step 25, compared bit for bit (params, mu,
   nu, losses). B1: TPU_FAULT_INJECT=sigterm-at-step:18 must end in
   Preempted (exit code 215) with step_18 committed and preemption_drain
   then emergency_checkpoint in events.jsonl. B2: stop_at_step=25
   resumes from step_18 (checkpoint_restore and first_resume_step
   logged) and must end equal to A — params, mu, nu and opt.count bit
   for bit and the losses of the steps it ran — or, if A and A' differ,
   within twice their difference. Each run's K1-K3 launches equal 24 x
   the steps it executed (warmup included). Prints, with the card's name
   and power limit: the emergency save's seconds and bytes, step time
   in windows holding a periodic save against windows without one, the
   device clone against a pinned host copy of the state, restore and
   first-resumed-step seconds, the writer's thread count. Then the CLI
   at 2 layers: sigterm-at-step:5 exits 215 with step_5, and the resume
   with --stop-at-step 8 exits 0 with step_8.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
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

# K1-K3 against their plain versions in bf16, read as the relative error
# ||kernel - plain|| / ||plain|| of each output tensor (out; dq; dk and
# dv), so the limit scales with the outputs (|dq| is ~0.05 at the
# training shape, far under an absolute 2e-2). K1 rounds p to bf16
# against a running max, the plain version against the row max, so most
# p differ by up to half a bf16 ulp. K2/K3 round ds as the plain version
# does, after f32 sums in another order: their outputs differ only where
# a sum lands across a bf16 rounding boundary. Each limit lies between
# the sound kernel's reading and the smallest reading of a planted fault
# (`planted_faults`), which the run checks. lse (f32) within f32 sums
# over up to 512 terms.
FLASH_REL = {"flash_fwd": 4e-3, "flash_dq": 4e-4, "flash_dkv": 4e-4}
LSE_ATOL = 1e-3
# the tile each kernel walks at D <= 64, the unit a skipped-tile fault
# drops: K1's and K2's k-tiles of 128 keys (under 128-query CTAs), K3's
# q-tiles of 64 (under 128-key CTAs)
FLASH_TILE = {"flash_fwd": 128, "flash_dq": 128, "flash_dkv": 64}
# (name, B, S, H, D, causal, mask): the training shape first; the
# bert-large cases are the [train-bert] phase's non-causal shape, without
# and with a key mask (row 0 padded after 3/4 of S)
FLASH_CASES = [
    ("gpt2-medium", 16, 512, 16, 64, True, None),
    ("bert-large", 16, 512, 16, 64, False, None),
    ("bert-large-pad", 16, 512, 16, 64, False, "pad"),
    ("llama-1b", 8, 512, 32, 64, True, None),
    ("masked", 4, 512, 16, 64, False, "empty"),
    ("masked-causal", 4, 512, 16, 64, True, "pad"),
    ("ragged", 16, 500, 16, 64, True, None),
    # one row past K1's 128-row q-tile and k-tile and K3's key tile
    ("tile-edge", 16, 129, 16, 64, True, None),
    # D=128: two 64-column boxes a tile; K1 and K2 walk 64-key tiles, K3
    # 32-query tiles
    ("unequal-tiles", 4, 512, 16, 128, True, None),
]
# one step's gradients, flash against dense, same weights and batch: both
# bf16; dense rounds its scores to bf16 (the reference's einsum does) and
# its probabilities after an f32 softmax, flash rounds p against a running
# max, so entries differ by a few bf16 ulps that average out over the
# 8192 tokens of a batch. The key bias is left out of the cosine: it
# shifts a row's scores uniformly, so its exact gradient is 0 and both
# sides hold rounding noise (checked to be under 1e-3 of the global norm)
GRAD_COSINE, GRAD_NORM_RTOL, NOISE_NORM = 0.999, 0.01, 1e-3


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg):
    print(msg, flush=True)


@functools.lru_cache(maxsize=None)
def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# the kernel phase
# ---------------------------------------------------------------------------

def poisoned_cache(H, KV, cache, curs, gen, dev, L=L_KERNEL):
    """q [B,H,D] bf16 and a [B,KV,L,D] cache (bf16, or int8 + f32
    scales) filled up to each row's cursor and POISONed past it; B is
    the number of cursors."""
    B, D = curs.shape[0], D_KERNEL
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


def bound(H, KV, cache, curs, page_size=None, L=L_KERNEL):
    """(bound_ms, bound_by): the larger of the bytes K4 must move — the
    filled prefix of k and v (plus 8 bytes a position for int8 scales),
    q, the cursors and the output, each once — over HBM bandwidth, and
    its multiply-adds (q.k and p.v, 4 ops a position, head and element)
    over the bf16 tensor-core rate. With `page_size` (K5), plus the
    4-byte page-table entries the cursors reach."""
    B, D = curs.shape[0], D_KERNEL
    last = (curs.long() + 1).clamp(max=L)
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


# the decode cursor sets that are timed beside their bound
TIMED_CURSORS = ("serving", "long", "paged-serving")
# the paged serving phase's logical cache length (its max_len)
L_PAGED = 384


def decode_cursor_sets(ops, KV, edges, dev):
    """The decode phases' B=8 cursor sets for one head layout: `edges`;
    the split edges of the split length the wrappers pick at this layout
    (length - 1, + 0, + 1, twice the length, 1022, 1023, and a short row
    whose later splits lie wholly past its cursor); the serving phase's
    depths (prompt <= 128 + new <= 64); and a long set, 896..1023."""
    rs = np.random.RandomState(0)
    c = ops.decode_split_len(L_KERNEL, B_KERNEL * KV,
                             torch.cuda.get_device_properties(
                                 dev).multi_processor_count,
                             ops.decode_tile(torch.bfloat16))
    return {
        "edges": edges,
        "split-edges": [c - 1, c, c + 1, 2 * c - 1, 2 * c, 1022, 1023, 5],
        "serving": sorted(rs.randint(32, 192, B_KERNEL).tolist()),
        "long": sorted(np.random.RandomState(1).randint(
            896, 1024, B_KERNEL).tolist()),
    }


def kernel_phase(k4, dev):
    """K4 vs its plain version at the main path's head layouts; returns
    (max_abs_err over every check, the timing row of the main path's
    layout: gpt2-medium, bf16 cache, serving cursors)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB
    worst, main_row = 0.0, None
    for layout, (H, KV) in LAYOUTS.items():
        cursor_sets = decode_cursor_sets(
            k4, KV, [0, 1, 63, 64, 65, 511, 1022, 1023], dev)
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
                if cname not in TIMED_CURSORS:
                    log(f"  K4 {layout:11s} {cache:4s} {cname:11s} "
                        f"max_abs_err {err:.3e} cursors {cl}")
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
                log(f"  K4 {layout:11s} {cache:4s} {cname:11s} "
                    f"max_abs_err {err:.3e}  kernel {ms:.4f} ms  plain "
                    f"{plain_ms:.4f} ms  sdpa {library_ms} ms  bound "
                    f"{bound_ms:.4f} ms ({bound_by}) cursors {cl}")
                if (layout == "gpt2-medium" and cache == "bf16"
                        and cname == "serving"):
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
    shape: gpt2-medium, bf16 pool, pages of 64, the paged serving
    phase's L and cursor depths)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB
    worst, main_row = 0.0, None
    for layout, (H, KV) in LAYOUTS.items():
        cursor_sets = decode_cursor_sets(
            ops, KV, [0, 1, 15, 16, 17, 63, 64, 65, 1022, 1023], dev)
        # the paged serving phase's own shape: L = max_len 384, a
        # 128-token prefix plus 32..128 prompt and up to 64 new tokens
        cursor_sets["paged-serving"] = sorted(np.random.RandomState(
            2).randint(160, 320, B_KERNEL).tolist())
        for cache in ("bf16", "int8"):
            for ps in (64, 16):
                for cname, cl in cursor_sets.items():
                    L = L_PAGED if cname == "paged-serving" else L_KERNEL
                    curs = torch.tensor(cl, dtype=torch.int32, device=dev)
                    q, k, v, ks, vs = poisoned_cache(H, KV, cache, curs,
                                                     gen, dev, L)
                    (kp, vp, ksp, vsp), pt, (k, v, ks, vs) = paged_pool(
                        k, v, ks, vs, curs, ps, gen)
                    tag = (f"K5 {layout:11s} {cache:4s} ps {ps:2d} "
                           f"{cname:11s}")
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
                    if cname not in TIMED_CURSORS:
                        log(f"  {tag} max_abs_err {err:.3e}  == K4 cursors "
                            f"{cl}")
                        continue
                    ms = time_ms(lambda: ops.paged_decode_attention(
                        q, kp, vp, curs, pt, ksp, vsp), 50, flush)
                    k4_ms = time_ms(lambda: ops.decode_attention(
                        q, k, v, curs, ks, vs), 50, flush)
                    plain_ms = time_ms(lambda: ops.paged_decode_attention_ref(
                        q, kp, vp, curs, pt, ksp, vsp), 10, flush)
                    bound_ms, bound_by = bound(H, KV, cache, curs, ps, L)
                    log(f"  {tag} max_abs_err {err:.3e}  == K4  kernel "
                        f"{ms:.4f} ms  K4 on the gathered cache {k4_ms:.4f} "
                        f"ms  plain {plain_ms:.4f} ms  bound {bound_ms:.5f} "
                        f"ms ({bound_by}) cursors {cl}")
                    if (layout == "gpt2-medium" and cache == "bf16"
                            and ps == 64 and cname == "paged-serving"):
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
    for kernel, group in (("flash_fwd_kernel", "K1 flash_fwd"),
                          ("flash_dq_kernel", "K2 flash_dq"),
                          ("flash_dkv_kernel", "K3 flash_dkv")):
        if kernel in name:
            return group
    if any(s in name.lower() for s in ("gemm", "xmma", "cutlass", "gemv",
                                       "nvjet")):
        return "GEMM (cuBLAS)"
    return name[:70]


KERNEL_GROUPS = {"decode_attention": "K4 decode_attention",
                 "paged_decode_attention": "K5 paged_decode_attention"}


def profile_run(engine, trace, kernel=None, ticks=20):
    """Where a serving run's time goes: the engine takes `trace` again
    (after the measured run, so launch counts are untouched), runs until
    every request has finished prefilling, then `ticks` loop iterations
    (one decode step each) under torch.profiler. Prints the device's
    busy and idle share of that window, device time by kernel group and
    the host's CUDA runtime calls a step (launch calls: kernels and
    graphs). Kernels run on one stream and do not overlap, so their
    summed time is the busy time. A speculative engine's window mixes
    verify steps (counted apart) with plain decode steps. With `kernel`,
    the profiler's own count of its launches in the window (graph
    replays included) must equal layers x plain decode steps: a count
    that does not rest on the wrappers' host counters. Returns the
    window's numbers."""
    from torch.profiler import ProfilerActivity, profile
    engine.reset()
    engine.start()
    for r in trace:
        engine.submit(r)
    engine.tick()                                     # admits the trace
    while engine.scheduler.next_prefill() is not None:
        engine.tick()
    steps0, verify0 = engine.steps_dispatched, engine.spec_steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.tick()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    steps = engine.steps_dispatched - steps0
    verify = engine.spec_steps - verify0
    while engine.active:
        engine.tick()
    engine.finish()
    groups, runtime = {}, {}
    for e in prof.events():
        if e.is_user_annotation:
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            g = groups.setdefault(kernel_group(e.name), [0.0, 0])
            g[0] += e.time_range.elapsed_us()
            g[1] += 1
        elif re.match(r"cu(da)?[A-Z]", e.name):
            runtime[e.name] = runtime.get(e.name, 0) + 1
    busy = sum(g[0] for g in groups.values())
    n = max(steps, 1)
    launch_calls = sum(c for name, c in runtime.items() if "Launch" in name)
    stats = dict(steps=steps, verify_steps=verify,
                 device_busy_ms=busy / 1e3, wall_ms_per_step=wall_us / 1e3 / n,
                 device_ms_per_step=busy / 1e3 / n,
                 idle_share=1 - busy / wall_us,
                 launch_calls_per_step=launch_calls / n,
                 runtime_calls_per_step=sum(runtime.values()) / n)
    log(f"  profile: {steps} decode steps ({verify} of them verify "
        f"steps), wall {wall_us / 1e3:.2f} ms "
        f"({stats['wall_ms_per_step']:.3f} ms a step), device busy "
        f"{busy / 1e3:.2f} ms ({stats['device_ms_per_step']:.3f} ms a "
        f"step), idle share {stats['idle_share']:.3f}, host launch calls "
        f"{stats['launch_calls_per_step']:.1f} a step (CUDA runtime calls "
        f"{stats['runtime_calls_per_step']:.1f})")
    for name, (us, c) in sorted(groups.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  profile: {us / 1e3:8.3f} ms {us / max(busy, 1e-9):6.1%} "
            f"{c:5d} launches  {name}")
    for name, c in sorted(runtime.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  profile host: {c / n:8.1f} calls a step  {name}")
    if kernel is not None:
        seen = groups.get(KERNEL_GROUPS[kernel], [0.0, 0])[1]
        layers = engine.model_config.num_layers
        check(steps > 0 and seen == layers * (steps - verify),
              f"the profiler saw {seen} {kernel} launches over "
              f"{steps - verify} plain decode steps of {layers} layers")
        stats["profiled_kernel_launches"] = seen
    return stats


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
    programs = engine.compile_counts()
    captured = engine.capture_counts()
    check(programs["step"] <= 3
          and programs["prefill"] <= len(config.chunk_buckets)
          and captured == {k: programs[k] for k in captured},
          f"{name}: programs {programs}, CUDA graphs {captured}")
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
                 max_logprob_dev=worst, programs=programs, graphs=captured,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                 reserved_gib=torch.cuda.memory_reserved() / 2**30)
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
        profile_run(engine, trace[:profile_requests], kernel)
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


# the serving benchmark's legs (bench.py's `serving` and `serving_paged`
# at full size), and a sampled variant of the first for the graphs A/B
BENCH_COMMON = dict(size="medium", slots=8, num_requests=32,
                    prompt_grid=(32, 64, 128), new_grid=(32, 64),
                    chunk_buckets=(32, 128), compare_graphs=True)
BENCH_LEGS = [
    ("serving", dict(compare_sync=True, compare_hooks=True),
     "decode_attention"),
    ("serving-sampled", dict(temperature=0.8, baseline=False),
     "decode_attention"),
    ("serving_paged", dict(paged=True, page_size=64, shared_prefix_len=128,
                           baseline=False), "paged_decode_attention"),
]


def build_every_program(engine):
    """Serve one request a sampling mode (greedy; bounded: top_k 40;
    full: top_k 0), each alone, with prompts that reach both chunk
    buckets, so the engine builds all its programs: 3 step programs and
    one prefill program a bucket, each captured once with graphs on."""
    from mpi_operator_tpu_torch.serve import Request
    rs = np.random.RandomState(5)
    vocab = engine.model_config.vocab_size
    small, big = engine.config.chunk_buckets[0], engine.config.chunk_buckets[-1]
    for i, (p, temp, top_k) in enumerate([(big + small // 2 + 1, 0.0, 0),
                                          (small // 2 + 1, 0.8, 40),
                                          (small // 2 + 1, 0.8, 0)]):
        engine.run([Request(900 + i, rs.randint(0, vocab, p).tolist(), 4,
                            temperature=temp, top_k=top_k)])
    want = {"step": 3, "prefill": len(engine.config.chunk_buckets),
            "verify": 0}
    got = engine.compile_counts()
    check({k: got[k] for k in want} == want
          and engine.capture_counts() == (want if engine.cuda_graphs else
                                          dict.fromkeys(want, 0)),
          f"programs {got}, graphs {engine.capture_counts()}; expected "
          f"{want}")


def moved(runs, key, higher_is_better, arms=("graphs", "eager")):
    """(best of the first arm, best of the second, spread, verdict) of
    `key`: the best of each arm's two runs, the larger of the two arms'
    run-to-run spreads, and whether the arms' bests differ by more than
    that."""
    on = [r[key] for r in runs[arms[0]]]
    off = [r[key] for r in runs[arms[1]]]
    pick = max if higher_is_better else min
    spread = max(max(on) - min(on), max(off) - min(off))
    diff = pick(on) - pick(off)
    return pick(on), pick(off), spread, abs(diff) > spread


def ab_verdicts(m, arms):
    """moved() of tokens/s and TPOT p50/p99 over the report's
    serving_<arm>_runs of the two `arms`."""
    runs = {arm: m[f"serving_{arm}_runs"] for arm in arms}
    out = {}
    for metric, key, higher in (("tokens_per_s", "tokens_per_sec", True),
                                ("tpot_p50_ms", "run_tpot_p50_ms", False),
                                ("tpot_p99_ms", "run_tpot_p99_ms", False)):
        a, b, spread, beyond = moved(runs, key, higher, arms)
        out[metric] = {arms[0]: a, arms[1]: b, "spread": spread,
                       "moved_beyond_spread": beyond}
    return out


def bench_phase():
    """run_serving_benchmark at each BENCH_LEGS leg, graphs A/B included:
    the programs within the no-recompile contract and every one captured
    once, every token of the graphs arm equal to the eager arm's (greedy
    and sampled), the sync A/B's greedy tokens equal. Prints tokens/s and
    TPOT p50/p99 of both arms and whether they moved beyond the arms'
    run-to-run spread. The engine runs with ServeTelemetry and a
    Tracer(sample=1.0) attached, as the benchmark always runs it: every
    measured request's trace must be complete (its hops tile its
    end-to-end time), and the host gap p50 is printed. The `serving` leg
    also logs events to a temporary directory (a slot_admit and a
    slot_retire a request) and runs the hooks A/B (the same settings with
    no telemetry, tracer or event log, runs alternated, best of two an
    arm). Then, for the two bench legs, with graphs on and
    off: every program built (`build_every_program`) and the memory the
    engine reserved, and a profiled window of 20 decode steps of 8
    requests: device time a step, idle share, host launch calls a step,
    and the profiler's count of K4/K5 launches (layers x steps).
    Returns {leg: report}."""
    from mpi_operator_tpu_torch.examples.serve_benchmark import (
        run_serving_benchmark, serving_max_len, serving_trace)
    from mpi_operator_tpu_torch.models import create_lm
    from mpi_operator_tpu_torch.serve import EngineConfig, ServingEngine
    out = {}
    for leg, kw, kernel in BENCH_LEGS:
        with tempfile.TemporaryDirectory() as tmp:
            events = (os.path.join(tmp, "events.jsonl")
                      if kw.get("compare_hooks") else None)
            m = run_serving_benchmark(**BENCH_COMMON, **kw,
                                      events_path=events,
                                      log=lambda line: log(f"  {line}"))
        check(m["serving_trace_complete"]
              and m["serving_host_gap_p50_ms"] is not None,
              f"{leg}: trace complete {m['serving_trace_complete']}, host "
              f"gap p50 {m['serving_host_gap_p50_ms']}")
        log(f"  [{leg}] hooks: host gap p50/p99 "
            f"{m['serving_host_gap_p50_ms']}/{m['serving_host_gap_p99_ms']}"
            f" ms, trace max gap {m['serving_trace_max_gap_ms']} ms, hops "
            f"{json.dumps({k: v for k, v in m.items() if '_hop_' in k})}")
        if kw.get("compare_hooks"):
            n = BENCH_COMMON["num_requests"]
            check(m["serving_events_logged"] == 2 * n
                  and m["serving_hooks_greedy_identical"],
                  f"{leg}: {m['serving_events_logged']} events for {n} "
                  f"requests, tokens identical with and without hooks "
                  f"{m['serving_hooks_greedy_identical']}")
            m["hooks_ab"] = ab_verdicts(m, ("hooks", "nohooks"))
            log(f"  [{leg}] hooks A/B: {json.dumps(m['hooks_ab'])}, cost "
                f"{m['serving_hooks_cost']:.4f} of the hooks arm's wall")
        check(m["serving_no_recompile"]
              and m["serving_step_captures"] == m["serving_step_compiles"]
              and m["serving_prefill_captures"]
              == m["serving_prefill_compiles"],
              f"{leg}: programs {m['serving_step_compiles']} / "
              f"{m['serving_prefill_compiles']}, graphs "
              f"{m['serving_step_captures']} / "
              f"{m['serving_prefill_captures']}")
        check(m["serving_graphs_tokens_identical"],
              f"{leg}: graphs and eager arms gave different tokens")
        check(m.get("serving_async_greedy_identical", True),
              f"{leg}: sync and async loops gave different greedy tokens")
        m["graphs_ab"] = ab_verdicts(m, ("graphs", "eager"))
        log(f"  [{leg}] graphs A/B: {json.dumps(m['graphs_ab'])}")
        if leg != "serving-sampled":
            paged = kw.get("paged", False)
            shared = kw.get("shared_prefix_len", 0)
            page_size = kw.get("page_size", 64)
            grids = BENCH_COMMON["prompt_grid"], BENCH_COMMON["new_grid"]
            model = create_lm(f"gpt2-{BENCH_COMMON['size']}", seed=0,
                              dtype=torch.bfloat16, decode_kernel=True,
                              max_len=serving_max_len(*grids, shared, paged,
                                                      page_size))
            trace, _ = serving_trace(model.config.vocab_size,
                                     BENCH_COMMON["slots"], *grids,
                                     shared_prefix_len=shared)
            for graphs in (True, False):
                # engines are freed by the cycle collector (their
                # programs hold bound methods): collect them before the
                # memory baseline, so the delta is this engine's alone
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved()
                engine = ServingEngine(model, EngineConfig(
                    slots=BENCH_COMMON["slots"],
                    chunk_buckets=BENCH_COMMON["chunk_buckets"],
                    paged=paged, page_size=page_size, cuda_graphs=graphs))
                build_every_program(engine)
                torch.cuda.synchronize()
                engine_gib = (torch.cuda.memory_reserved() - reserved) / 2**30
                log(f"  [{leg}] graphs {graphs}: programs "
                    f"{engine.compile_counts()}, graphs "
                    f"{engine.capture_counts()}; memory reserved by the "
                    f"engine (cache, programs, pools) {engine_gib:.3f} GiB")
                m[f"profile_graphs_{graphs}"] = dict(
                    profile_run(engine, trace, kernel),
                    engine_reserved_gib=engine_gib)
                del engine
            del model
            torch.cuda.empty_cache()
        keys = ("serving_tokens_per_sec", "serving_tpot_p50_ms",
                "serving_tpot_p99_ms", "serving_ttft_p50_ms",
                "serving_ttft_p99_ms", "serving_eager_tokens_per_sec",
                "serving_graphs_speedup", "serving_step_compiles",
                "serving_prefill_compiles", "serving_no_recompile",
                "sequential_tokens_per_sec", "serving_vs_sequential",
                "serving_async_speedup", "serving_prefix_hit_rate",
                "serving_ttft_cold_p50_ms", "serving_ttft_hit_p50_ms",
                "serving_pages_in_use_peak", "serving_host_gap_p50_ms",
                "serving_host_gap_p99_ms", "serving_trace_complete",
                "serving_nohooks_tokens_per_sec", "serving_hooks_cost",
                "profile_graphs_True", "profile_graphs_False")
        log(f"  [{leg}] {json.dumps({k: m[k] for k in keys if k in m})}")
        out[leg] = m
    return out


# ---------------------------------------------------------------------------
# the speculative serving phase
# ---------------------------------------------------------------------------

# the JAX bench's serving_spec leg at full size (bench.py:558-583): the
# paged serving leg with prompt-lookup drafting, then the same contiguous
SPEC_COMMON = dict(size="medium", slots=8, num_requests=32,
                   prompt_grid=(32, 64, 128), new_grid=(32, 64),
                   chunk_buckets=(32, 128), shared_prefix_len=128,
                   decode_kernel=True, speculative="ngram", draft_k=4,
                   compare_spec=True, baseline=False)
SPEC_LEGS = [
    ("spec_paged", dict(paged=True, page_size=64), "paged_decode_attention"),
    ("spec_contiguous", {}, "decode_attention"),
]
# where the spec and no-spec arms choose different greedy tokens, in
# nats of the dense path's log-softmax: the verify step runs dense
# attention and a W-row GEMM, the plain step K4/K5 and a 1-row GEMM, all
# in bf16, and each arm stays within LOGPROB_TOL of the dense path
# (check_results). So two tokens can differ only where the dense path's
# top-2 margin is under that tolerance, and both must lie within it of
# its argmax. A token accepted without a match lies far below it.
SPEC_MARGIN = LOGPROB_TOL


@contextlib.contextmanager
def recorded_runs():
    """Record every ServingEngine.run in the block as (engine, requests,
    results, speculative)."""
    from mpi_operator_tpu_torch.serve import ServingEngine
    runs = []
    run = ServingEngine.run

    def recording(self, requests=(), on_token=None):
        results = run(self, requests, on_token)
        runs.append((self, list(requests), results,
                     self.config.speculative))
        return results
    ServingEngine.run = recording
    try:
        yield runs
    finally:
        ServingEngine.run = run


def first_divergences(dense, trace, got, want):
    """For each greedy request whose tokens differ between the runs
    `got` and `want`: the first index i where they do, the dense path's
    top-2 margin at it (given the prompt and want's tokens before i) and
    how far below the dense argmax each run's token lies, in nats."""
    out = []
    for req in trace:
        if req.temperature > 0:
            continue
        a, b = got[req.id].tokens, want[req.id].tokens
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        logp = teacher_forced_logp(dense, req, b[:i + 1])[-1]
        top2 = torch.topk(logp, 2).values
        out.append(dict(request=req.id, index=i,
                        margin=float(top2[0] - top2[1]),
                        gap=float(top2[0] - logp[a[i]]),
                        want_gap=float(top2[0] - logp[b[i]])))
    return out


def near_tie(d) -> bool:
    return max(d["margin"], d["gap"], d["want_gap"]) <= SPEC_MARGIN


def planted_fault_engine():
    """A ServingEngine whose greedy acceptance takes one draft token more
    than matched: the fault the identity check must catch. `planted`
    counts the verify rows where the fault changed what was accepted."""
    from mpi_operator_tpu_torch.serve import ServingEngine

    class AcceptOneMore(ServingEngine):
        planted = 0

        def _accepted(self, draft, targets):
            n = ServingEngine._accepted(draft, targets)
            if n < len(draft):
                self.planted += 1
                return n + 1
            return n
    return AcceptOneMore


def spec_phase(ops):
    """run_serving_benchmark at each SPEC_LEGS leg, the spec A/B included
    (no-spec, spec, no-spec after the measured spec run; best of two an
    arm). Prints the acceptance rate, effective tokens a row-step, verify
    steps, tokens/s and TPOT p50/p99 of both arms and whether they moved
    beyond the arms' spread. Checks: the no-recompile contract with at
    most len(_verify_buckets) verify programs (one sampling mode: the
    trace is greedy), each captured once; both arms' tokens and logprobs
    against the teacher-forced dense path (check_results); every token
    where the arms differ a near tie (SPEC_MARGIN), and a planted fault
    (one draft token accepted past the match) caught by that check; K4 /
    K5 launched layers x plain decode steps in a spec run, no other
    kernel. Then profiled windows with speculation on and off: device
    time a verify step against a plain step, and the idle share. Last, a
    decode_kernel=False contiguous run in f32 (16 requests) must give
    the same greedy tokens with speculation and without."""
    from mpi_operator_tpu_torch.examples.serve_benchmark import (
        run_serving_benchmark)
    from mpi_operator_tpu_torch.models import decode_model
    out = {}
    n = SPEC_COMMON["num_requests"]
    for leg, kw, kernel in SPEC_LEGS:
        with recorded_runs() as runs:
            m = run_serving_benchmark(**SPEC_COMMON, **kw,
                                      log=lambda line: log(f"  {line}"))
        measured = [r for r in runs if len(r[1]) == n]
        engine, trace, spec_res, _ = next(r for r in measured if r[3])
        nospec_res = next(r for r in measured if r[3] is None)[2]
        del runs, measured
        counts, caps = engine.compile_counts(), engine.capture_counts()
        check(m["serving_no_recompile"]
              and 1 <= counts["verify"] <= len(engine._verify_buckets)
              and caps == {k: counts[k] for k in caps},
              f"{leg}: programs {counts}, CUDA graphs {caps}")
        stats = {k: m[f"serving_spec_{k}"] for k in (
            "acceptance_rate", "effective_tokens_per_step", "verify_steps",
            "proposed", "accepted")}
        m["spec_ab"] = ab_verdicts(m, ("spec", "nospec"))
        log(f"  [{leg}] speculation: {json.dumps(stats)}; programs "
            f"{counts}, graphs {caps}")
        log(f"  [{leg}] spec A/B: {json.dumps(m['spec_ab'])}, spec over "
            f"no-spec {m['serving_spec_speedup']:.4f}x in tokens/s, "
            f"greedy tokens identical {m['serving_spec_greedy_identical']}")
        dense = decode_model(engine.dmodel, decode_kernel=False)
        for arm, res in (("spec", spec_res), ("nospec", nospec_res)):
            n_pos, n_exact, worst = check_results(engine, trace, res,
                                                  f"{leg}-{arm}")
            log(f"  [{leg}] {arm} arm against the dense path: {n_exact} "
                f"of {n_pos} greedy tokens its argmax, worst logprob "
                f"deviation {worst:.4f}")
        div = first_divergences(dense, trace, spec_res, nospec_res)
        bad = [d for d in div if not near_tie(d)]
        check(not bad, f"{leg}: spec and no-spec arms diverge off a near "
              f"tie: {bad}")
        log(f"  [{leg}] arms diverge in {len(div)} of {n} requests, each "
            f"at a near tie (margins "
            f"{sorted(round(d['margin'], 4) for d in div)})")
        # the main path's launches: K4/K5 in the plain steps only
        layers = engine.model_config.num_layers
        engine.reset()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        engine.run(trace)
        torch.cuda.synchronize()
        launched = dict(ops.launch_counts)
        steps, verify = engine.steps_dispatched, engine.spec_steps
        check(verify > 0 and launched[kernel] == layers * (steps - verify)
              and all(c == 0 for k, c in launched.items() if k != kernel),
              f"{leg}: launches {launched} over {steps} steps, {verify} of "
              f"them verify steps, {layers} layers")
        m["launches"] = {kernel: launched[kernel], "steps": steps,
                         "verify_steps": verify}
        log(f"  [{leg}] a spec run: {kernel} launched {launched[kernel]} "
            f"times = {layers} layers x {steps - verify} plain steps "
            f"({verify} verify steps run no kernel)")
        # where a verify step's time goes: windows with speculation on
        # (verify and plain steps) and off (plain steps only)
        prof_spec = profile_run(engine, trace[:8], kernel)
        engine.config.speculative = None
        prof_plain = profile_run(engine, trace[:8], kernel)
        engine.config.speculative = SPEC_COMMON["speculative"]
        plain_ms = prof_plain["device_ms_per_step"]
        v = prof_spec["verify_steps"]
        verify_ms = ((prof_spec["device_busy_ms"] - plain_ms
                      * (prof_spec["steps"] - v)) / v if v else None)
        m["profile"] = dict(spec=prof_spec, nospec=prof_plain,
                            verify_device_ms=verify_ms,
                            plain_device_ms=plain_ms)
        log(f"  [{leg}] device time a verify step {verify_ms} ms against "
            f"{plain_ms:.4f} ms a plain step; idle share "
            f"{prof_spec['idle_share']:.3f} with speculation, "
            f"{prof_plain['idle_share']:.3f} without")
        # the planted fault must fail the divergence check
        fault = planted_fault_engine()(engine.dmodel, engine.config)
        fault.run(trace[:2])
        fault.reset()
        fault_div = first_divergences(dense, trace, fault.run(trace),
                                      nospec_res)
        caught = [d for d in fault_div if not near_tie(d)]
        check(fault.planted and caught, f"{leg}: a planted fault (one "
              f"draft token accepted past the match, {fault.planted} "
              f"times) passed the identity check: {fault_div}")
        log(f"  [{leg}] planted fault ({fault.planted} rows accepted one "
            f"draft token past the match) caught: {len(caught)} requests "
            f"diverge off a near tie (first: {caught[0]})")
        del fault, engine, dense, spec_res, nospec_res
        torch.cuda.empty_cache()
        keys = ("serving_tokens_per_sec", "serving_nospec_tokens_per_sec",
                "serving_spec_speedup", "serving_tpot_p50_ms",
                "serving_tpot_p99_ms", "serving_nospec_tpot_p50_ms",
                "serving_nospec_tpot_p99_ms", "serving_ttft_p50_ms",
                "serving_host_gap_p50_ms", "serving_verify_compiles",
                "serving_verify_captures", "serving_step_compiles",
                "serving_prefill_compiles", "serving_no_recompile",
                "serving_trace_complete", "serving_prefix_hit_rate",
                "launches", "profile")
        log(f"  [{leg}] {json.dumps({k: m[k] for k in keys if k in m})}")
        out[leg] = m
    m = run_serving_benchmark(**dict(SPEC_COMMON, num_requests=16,
                                     dtype_name="float32",
                                     decode_kernel=False),
                              log=lambda line: log(f"  {line}"))
    check(m["serving_spec_greedy_identical"],
          "f32, decode_kernel=False: spec and no-spec arms gave different "
          "greedy tokens")
    log(f"  [spec_f32_dense] greedy tokens identical between the arms; "
        f"acceptance {m['serving_spec_acceptance_rate']:.4f}")
    out["spec_f32_dense"] = m
    return out


# ---------------------------------------------------------------------------
# the training phases: K1-K3 alone, then LM training through them
# ---------------------------------------------------------------------------

def flash_inputs(B, S, H, D, mask, gen, dev):
    """bf16 q, k, v, do [B, S, H, D] and an optional [B, S] bool key mask:
    row 0 padded after 3/4 of S; with "empty", row 1 masked everywhere."""
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen, device=dev)
                   .bfloat16() for _ in range(4))
    m = None
    if mask is not None:
        m = torch.ones(B, S, dtype=torch.bool, device=dev)
        m[0, (3 * S) // 4:] = False
        if mask == "empty":
            m[1] = False
    return q, k, v, do, m


def flash_bound(name, B, S, H, D, causal, mask=None):
    """(bound_ms, bound_by) of one flash kernel: the bytes it must move
    (each bf16 [B, S, H, D] input and output once, f32 [B, H, S] lse and
    delta once, the uint8 [B, S] mask once) over HBM bandwidth, against
    its products over this input's visible (query, key) pairs (2*D flops
    a pair and product: K1 q.k and p.v, K2 adds do.v and ds.k for 3, K3
    q.k, do.v, p.do, ds.q for 4) over the bf16 tensor-core rate. A
    valid key j is seen by S - j queries when causal, by all S when
    not."""
    t, stat = B * S * H * D * 2, B * H * S * 4
    keys = (torch.ones(B, S, dtype=torch.long) if mask is None
            else mask.cpu().long())
    seen = (S - torch.arange(S)) if causal else torch.full((S,), S)
    pairs = H * int((keys * seen).sum())
    nbytes, products = {"flash_fwd": (4 * t + stat, 2),
                        "flash_dq": (5 * t + 2 * stat, 3),
                        "flash_dkv": (6 * t + 2 * stat, 4)}[name]
    nbytes += 0 if mask is None else B * S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = products * 2 * D * pairs / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| over the whole tensor, in f32."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def planted_faults(ops, q, k, v, do, lse, delta, causal, want):
    """What the relative error would read for a kernel with a planted
    fault, made from the plain versions and held against the sound plain
    outputs `want` {"flash_fwd": out, "flash_dq": dq, "flash_dkv": (dk,
    dv)}: one tile skipped (the smallest reading over every tile: a
    k-tile's keys masked for K1/K2, a q-tile's do and delta zeroed for
    K3), and ds left unrounded (the plain versions on f32 copies of
    the inputs, the output rounded to bf16). Returns [(kernel, fault,
    reading)]."""
    B, S = q.shape[:2]

    def tiles(name):
        return [slice(j, j + FLASH_TILE[name])
                for j in range(0, S, FLASH_TILE[name])]

    def keys_off(t):
        m = torch.ones(B, S, dtype=torch.bool, device=q.device)
        m[:, t] = False
        return m

    def rows_off(t):
        d, dl = do.clone(), delta.clone()
        d[:, t], dl[:, :, t] = 0, 0
        return ops.flash_dkv_ref(q, k, v, d, lse, dl, causal)

    dk, dv = want["flash_dkv"]
    f32 = [x.float() for x in (q, k, v, do)]
    return [
        ("flash_fwd", "skipped k-tile", min(
            rel_err(ops.flash_fwd_ref(q, k, v, causal, keys_off(t))[0],
                    want["flash_fwd"]) for t in tiles("flash_fwd"))),
        ("flash_dq", "skipped k-tile", min(
            rel_err(ops.flash_dq_ref(q, k, v, do, lse, delta, causal,
                                     keys_off(t)), want["flash_dq"])
            for t in tiles("flash_dq"))),
        ("flash_dkv", "skipped q-tile", min(
            max(rel_err(a, dk), rel_err(b, dv))
            for a, b in map(rows_off, tiles("flash_dkv")))),
        ("flash_dq", "unrounded ds", rel_err(
            ops.flash_dq_ref(*f32, lse, delta, causal).bfloat16(),
            want["flash_dq"])),
        ("flash_dkv", "unrounded ds", rel_err(
            ops.flash_dkv_ref(*f32, lse, delta, causal)[0].bfloat16(), dk)),
    ]


def flash_kernel_phase(ops, dev):
    """K1-K3 against their plain versions over FLASH_CASES, and the
    planted faults' readings at the training shape against the limits;
    returns ({kernel: max abs error}, {timed case: {kernel: timing
    row}})."""
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    worst_rel = dict(worst)
    rows = {}
    for name, B, S, H, D, causal, mask in FLASH_CASES:
        q, k, v, do, m = flash_inputs(B, S, H, D, mask, gen, dev)
        out, lse = ops.flash_fwd(q, k, v, causal, m)
        torch.cuda.synchronize()
        ref_out, ref_lse = ops.flash_fwd_ref(q, k, v, causal, m)
        delta = ops.flash_delta(ref_out, do)
        dq = ops.flash_dq(q, k, v, do, ref_lse, delta, causal, m)
        dk, dv = ops.flash_dkv(q, k, v, do, ref_lse, delta, causal, m)
        torch.cuda.synchronize()
        ref_dq = ops.flash_dq_ref(q, k, v, do, ref_lse, delta, causal, m)
        ref_dk, ref_dv = ops.flash_dkv_ref(q, k, v, do, ref_lse, delta,
                                           causal, m)
        lse_err = float((lse - ref_lse).abs().max())
        check(lse_err <= LSE_ATOL, f"K1 {name}: lse differs from the plain "
              f"version by {lse_err} > {LSE_ATOL}")
        errs, rels = {}, {}
        for kname, got, want in (("flash_fwd", out, ref_out),
                                 ("flash_dq", dq, ref_dq),
                                 ("flash_dkv", dk, ref_dk),
                                 ("flash_dkv", dv, ref_dv)):
            err = float((got.float() - want.float()).abs().max())
            rel = rel_err(got, want)
            check(torch.isfinite(got).all().item(),
                  f"{kname} {name}: non-finite output")
            check(rel <= FLASH_REL[kname],
                  f"{kname} {name}: ||kernel - plain|| / ||plain|| = {rel} "
                  f"> {FLASH_REL[kname]} (max abs error {err})")
            errs[kname] = max(errs.get(kname, 0.0), err)
            rels[kname] = max(rels.get(kname, 0.0), rel)
            worst[kname] = max(worst[kname], err)
            worst_rel[kname] = max(worst_rel[kname], rel)
        if mask == "empty":      # the row with no valid key: no gradient
            check(not dq[1].any() and not dk[1].any() and not dv[1].any(),
                  f"{name}: gradients flow from the fully masked row")
        log(f"  K1-K3 {name:13s} B={B} S={S} H={H} D={D} causal={causal} "
            f"mask={mask}: relative error fwd {rels['flash_fwd']:.3e} dq "
            f"{rels['flash_dq']:.3e} dkv {rels['flash_dkv']:.3e}; max abs "
            f"error fwd {errs['flash_fwd']:.3e} dq {errs['flash_dq']:.3e} "
            f"dkv {errs['flash_dkv']:.3e}; lse {lse_err:.3e}")
        if name == "gpt2-medium":
            faults = planted_faults(ops, q, k, v, do, ref_lse, delta,
                                    causal, {"flash_fwd": ref_out,
                                             "flash_dq": ref_dq,
                                             "flash_dkv": (ref_dk, ref_dv)})
            for kname, fault, reading in faults:
                log(f"  planted fault {kname} {fault}: relative error "
                    f"{reading:.3e} against the limit "
                    f"{FLASH_REL[kname]:.1e}")
                check(reading > FLASH_REL[kname],
                      f"{kname}: the limit {FLASH_REL[kname]} passes a "
                      f"kernel with a {fault} ({reading})")
        if name in TIMED_FLASH_CASES:
            rows[name] = time_flash(ops, name, q, k, v, do, causal, m, dev)
    torch.cuda.empty_cache()
    log(f"  K1-K3 worst relative error over the cases: "
        + ", ".join(f"{n} {worst_rel[n]:.3e} (limit {FLASH_REL[n]:.1e})"
                    for n in worst_rel))
    return worst, rows


FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
# the cases timed beside SDPA: the gpt2 training shape (the kernels
# line's rows) and bert-large's, without and with its key mask
TIMED_FLASH_CASES = ("gpt2-medium", "bert-large", "bert-large-pad")


def time_flash(ops, name, q, k, v, do, causal, m, dev):
    """K1-K3 at one case's inputs, L2 flushed, beside their bounds, their
    plain versions and one scaled_dot_product_attention call (same
    causality and key mask; a yardstick the port never calls) forward
    and backward. Returns {kernel: timing row}."""
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    m8 = None if m is None else ops._mask_u8(m, dev)
    out, lse = ops.flash_fwd(q, k, v, causal, m8)
    delta = ops.flash_delta(out, do)
    calls = {
        "flash_fwd": (lambda: ops.flash_fwd(q, k, v, causal, m8),
                      lambda: ops.flash_fwd_ref(q, k, v, causal, m8)),
        "flash_dq": (lambda: ops.flash_dq(q, k, v, do, lse, delta, causal,
                                          m8),
                     lambda: ops.flash_dq_ref(q, k, v, do, lse, delta,
                                              causal, m8)),
        "flash_dkv": (lambda: ops.flash_dkv(q, k, v, do, lse, delta, causal,
                                            m8),
                      lambda: ops.flash_dkv_ref(q, k, v, do, lse, delta,
                                                causal, m8)),
    }
    # SDPA's [B, H, S, D] views of the same inputs, the key mask as a
    # [B, 1, 1, S] boolean (True = attend); its cotangent made contiguous
    # once, outside the timing
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    am = None if m is None else m[:, None, None, :]
    backend = torch._fused_sdp_choice(qt, kt, vt, attn_mask=am,
                                      is_causal=causal)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am,
                                              is_causal=causal)
    sdpa_fwd = time_ms(sdpa, 20, flush)
    so = sdpa()
    dot = do.transpose(1, 2).contiguous()
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        so, (qt, kt, vt), dot, retain_graph=True), 20, flush)
    log(f"  {name}: SDPA (is_causal={causal}, mask={m is not None}, "
        f"yardstick; backend choice {backend}): forward {sdpa_fwd:.4f} ms, "
        f"backward (dq, dk, dv in one call) {sdpa_bwd:.4f} ms")
    rows = {}
    B, S, H, D = q.shape
    for kname, (kernel, plain) in calls.items():
        ms = time_ms(kernel, 20, flush)
        plain_ms = time_ms(plain, 5, flush)
        bound_ms, bound_by = flash_bound(kname, B, S, H, D, causal, m)
        lib = sdpa_fwd if kname == "flash_fwd" else sdpa_bwd
        rows[kname] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=lib)
        log(f"  {name}: {kname:9s} kernel {ms:.4f} ms  plain {plain_ms:.4f} "
            f"ms  bound {bound_ms:.4f} ms ({bound_by})  SDPA "
            f"{'forward' if kname == 'flash_fwd' else 'backward'} "
            f"{lib:.4f} ms")
    log(f"  {name}: ratios in this call: K1 / SDPA forward "
        f"{rows['flash_fwd']['ms'] / sdpa_fwd:.3f}, (K2 + K3) / SDPA "
        f"backward "
        f"{(rows['flash_dq']['ms'] + rows['flash_dkv']['ms']) / sdpa_bwd:.3f}")
    return rows


def train_phase(name, ops, **kw):
    """run_lm_benchmark(**kw) with every kernel count zeroed just before
    and read just after: K2 and K3 must each have launched once a layer
    a step, K1 once a layer a step and a forward (twice under remat: the
    backward recomputes it; one more forward for the MoE drop-rate probe
    after training), the decode kernels never; every timed step's loss
    finite and no update skipped by the guard. Returns (state, metrics,
    counts)."""
    from mpi_operator_tpu_torch.examples.lm_benchmark import run_lm_benchmark
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    state, m = run_lm_benchmark(log=lambda line: log(f"  {line}"), **kw)
    torch.cuda.synchronize()
    counts = dict(ops.launch_counts)
    layers, steps = state.model.config.num_layers, state.step
    forwards = steps * (2 if kw.get("remat") else 1) \
        + (1 if kw.get("moe_experts") else 0)
    want = {"flash_fwd": layers * forwards, "flash_dq": layers * steps,
            "flash_dkv": layers * steps}
    check(all(counts[k] == want[k] for k in FLASH_KERNELS),
          f"{name}: flash launches {counts} over {steps} steps of {layers} "
          f"layers; expected {want}")
    check(all(n == 0 for k, n in counts.items() if k not in FLASH_KERNELS),
          f"{name}: other kernels launched: {counts}")
    losses = m["step_losses"]
    check(all(math.isfinite(x) for x in losses)
          and math.isfinite(m["final_loss"]),
          f"{name}: non-finite loss among {losses}")
    check(int(state.opt.count) == steps,
          f"{name}: the guard skipped {steps - int(state.opt.count)} updates")
    stats = {k: m[k] for k in ("tokens_per_sec", "step_time_p50_ms",
                               "step_time_p99_ms", "host_gap_p50_ms",
                               "mfu", "tflops_per_sec_per_device",
                               "flops_per_step", "final_loss",
                               "moe_drop_rate") if k in m}
    stats.update(steps=steps, launches={k: counts[k] for k in FLASH_KERNELS},
                 first_loss=losses[0], last_loss=losses[-1],
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                 card=device_line())
    log(f"  {name}: {json.dumps(stats)}")
    return state, m, counts


def padded_rows(B, S, dev):
    """The [B, S] key mask of the BERT gradient check: row 0 padded after
    3/4 of S, row 1 after 1/4, the others whole. (A row with no valid
    key is left out: there dense and flash differ by design — the dense
    softmax passes a gradient through its uniform row, flash none.)"""
    pad = torch.ones(B, S, dtype=torch.bool, device=dev)
    pad[0, (3 * S) // 4:] = False
    pad[1, S // 4:] = False
    return pad


def masked_loss_and_grads(state, batch, attention_mask):
    """(MLM loss, flat f32 gradients in param_shapes order) of a MaskedLM
    under a key-padding mask (LMTrainer.loss_and_grads passes none, as
    the reference trainer does)."""
    from mpi_operator_tpu_torch.models.transformer import param_shapes
    from mpi_operator_tpu_torch.train import lm_loss
    toks, tgts, mask = batch
    model = state.model
    loss = lm_loss(model(toks, attention_mask=attention_mask), tgts, mask)
    loss.backward()
    params = [model.get_parameter(n) for n in param_shapes(model.config)]
    g = torch.cat([p.grad.reshape(-1) for p in params])
    for p in params:
        p.grad = None
    return loss.detach(), g


@contextlib.contextmanager
def exact_dense_attention():
    """The model's dense attention computed in f32 from its bf16 q, k and
    v (scores, softmax, its backward and both products unrounded), the
    output cast back: the attention flash approximates, with no bf16
    rounding of scores or of their gradients."""
    from mpi_operator_tpu_torch.models import transformer as tt
    dense = tt.dense_attention

    def exact(q, k, v, mask=None, causal=True, dtype=torch.float32):
        return dense(q.float(), k.float(), v.float(), mask, causal,
                     torch.float32).to(q.dtype)
    tt.dense_attention = exact
    try:
        yield
    finally:
        tt.dense_attention = dense


@contextlib.contextmanager
def f32_delta():
    """The flash backward (K2, K3) with delta = rowsum(dO * O) taken from
    the f32 output of the plain forward on the same q, k, v instead of
    K1's bf16 output (the reference's convention, `_flash_bwd`). Where
    the values share a large common component, O's bf16 rounding moves
    every delta_i, each such error shifts row i's dq by a multiple of its
    mean key, and those shifts add up in the query bias's gradient."""
    from mpi_operator_tpu_torch.ops import attention as ops
    backward = ops.FlashAttention.backward

    def exact_delta(ctx, do):
        q, k, v, out, lse, mask = ctx.saved_tensors
        do = do.contiguous()
        o32, _ = ops.flash_fwd_ref(q.float(), k.float(), v.float(),
                                   ctx.causal, mask)
        delta = ops.flash_delta(o32, do)
        dq = ops.flash_dq(q, k, v, do, lse, delta, ctx.causal, mask)
        dk, dv = ops.flash_dkv(q, k, v, do, lse, delta, ctx.causal, mask)
        return dq, dk, dv, None, None
    ops.FlashAttention.backward = staticmethod(exact_delta)
    try:
        yield
    finally:
        ops.FlashAttention.backward = backward


def compare_grads(mcfg, name, ga, gb):
    """(worst cosine, its parameter) of two flat gradients over every
    parameter tensor but the key biases, whose exact gradient is 0 and
    which must hold rounding noise only (under NOISE_NORM of the global
    norm); the global norms within GRAD_NORM_RTOL. Logs and checks."""
    from mpi_operator_tpu_torch.models.transformer import param_shapes
    (la, a_all), (lb, b_all) = ga, gb
    norm_a, norm_b = float(a_all.norm()), float(b_all.norm())
    worst, off = (1.0, ""), 0
    for pname, shape in param_shapes(mcfg).items():
        n = math.prod(shape)
        a, b = a_all[off:off + n], b_all[off:off + n]
        off += n
        if pname.endswith("attn.key.bias"):
            check(float(a.norm()) <= NOISE_NORM * norm_a
                  and float(b.norm()) <= NOISE_NORM * norm_b,
                  f"{pname}: gradient {float(a.norm())} / {float(b.norm())} "
                  f"is not rounding noise")
            continue
        cos = float(torch.dot(a, b) / (a.norm() * b.norm()).clamp(min=1e-30))
        worst = min(worst, (cos, pname))
    log(f"  grads {name}: loss {la:.6f} vs {lb:.6f}, global norm "
        f"{norm_a:.6f} vs {norm_b:.6f}, worst cosine {worst[0]:.6f} "
        f"({worst[1]})")
    return worst, abs(norm_a - norm_b) <= GRAD_NORM_RTOL * norm_b


def grads_agree(tcfg, mcfg, dev, attention_mask=None):
    """One step's gradients from the same weights and batch through
    attention="flash" and "dense"; returns the flash trainer and state
    for profiling. For BERT (the MLM stream's batch under
    `attention_mask`) the reference is the dense path with its attention
    computed in f32 (`exact_dense_attention`), and what is held to it
    is the flash path with delta from an f32 output (`f32_delta`): with
    delta from K1's bf16 output, as the reference's flash backward takes
    it, BERT's query-bias gradients read a cosine of ~0.998 against the
    f32 attention, where the bf16 dense path reads 0.9997 (a chip run of
    this check), which is the rounding of delta and not K1-K3's
    arithmetic. The flash path as shipped and the bf16 dense path are
    printed against the f32 one."""
    from mpi_operator_tpu_torch.data import TokenStream
    from mpi_operator_tpu_torch.train import LMTrainer
    batch = TokenStream(tcfg.global_batch_size, tcfg.seq_len,
                        mcfg.vocab_size, seed=1, device=dev,
                        masked_lm=not mcfg.causal).batch(0)
    impls = ("dense", "flash") if mcfg.causal else (
        "exact", "dense", "flash-f32-delta", "flash")
    contexts = {"exact": exact_dense_attention, "flash-f32-delta": f32_delta}
    grads = {}
    for impl in impls:
        attention = "flash" if impl.startswith("flash") else "dense"
        trainer = LMTrainer(dataclasses.replace(mcfg, attention=attention),
                            tcfg, device=dev)
        state = trainer.init_state(0)
        with contexts.get(impl, contextlib.nullcontext)():
            if attention_mask is None:
                loss, g, _ = trainer.loss_and_grads(state, *batch)
            else:
                loss, g = masked_loss_and_grads(state, batch,
                                                attention_mask)
        grads[impl] = (float(loss), g)
        if impl != "flash":
            del trainer, state
            torch.cuda.empty_cache()
    got, ref = ("flash", "dense") if mcfg.causal else ("flash-f32-delta",
                                                        "exact")
    (cos, pname), norms_ok = compare_grads(
        mcfg, f"{got} vs {ref}", grads[got], grads[ref])
    if not mcfg.causal:
        for a, b in (("flash", "exact"), ("dense", "exact"),
                     ("flash", "dense")):
            compare_grads(mcfg, f"{a} vs {b} (printed)", grads[a], grads[b])
    check(cos >= GRAD_COSINE, f"gradient cosine {cos} < {GRAD_COSINE} for "
          f"{pname} ({got} vs {ref})")
    check(norms_ok, f"global gradient norms of {got} and {ref} beyond "
          f"{GRAD_NORM_RTOL:.0%}")
    return trainer, state, batch


def profile_train(trainer, state, batch, step_ms, steps=2):
    """Where a training step's time goes: `steps` train steps under
    torch.profiler after one unprofiled step; device busy per step
    against the profiled wall time and against `step_ms`, the unprofiled
    benchmark's step time (the profiler's own host cost inflates the
    former), device time by kernel group, K1-K3's share, and the host
    ops that take the most CPU time."""
    from torch.profiler import ProfilerActivity, profile
    trainer.train_step(state, *batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(state, *batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.is_user_annotation):
            continue
        g = groups.setdefault(kernel_group(e.name), [0.0, 0])
        g[0] += e.time_range.elapsed_us()
        g[1] += 1
    busy = sum(g[0] for g in groups.values())
    flash = sum(groups.get(k, [0.0])[0] for k in
                ("K1 flash_fwd", "K2 flash_dq", "K3 flash_dkv"))
    busy_ms = busy / 1e3 / steps
    log(f"  profile: {steps} train steps, wall {wall_us / 1e3:.2f} ms "
        f"({wall_us / 1e3 / steps:.2f} ms a step), device busy "
        f"{busy_ms:.2f} ms a step, idle share {1 - busy / wall_us:.3f} "
        f"profiled, {1 - busy_ms / step_ms:.3f} against the unprofiled "
        f"step of {step_ms:.2f} ms; K1-K3 {flash / max(busy, 1e-9):.1%} of "
        f"device time")
    for name, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"  profile: {us / 1e3 / steps:8.3f} ms a step "
            f"{us / max(busy, 1e-9):6.1%} {n // steps:5d} launches a step  "
            f"{name}")
    log("  profile: K1 / K2 / K3 " + " / ".join(
        f"{groups.get(k, [0.0])[0] / 1e3 / steps:.3f}" for k in
        ("K1 flash_fwd", "K2 flash_dq", "K3 flash_dkv")) + " ms a step")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in host[:8]:
        log(f"  profile host: {e.self_cpu_time_total / 1e3 / steps:8.3f} ms "
            f"a step self CPU, {e.count // steps:5d} calls a step  {e.key[:60]}")


# ---------------------------------------------------------------------------
# the train-resume phase
# ---------------------------------------------------------------------------

# gpt2-medium at the bench's gpt2 leg, through run_lm_benchmark's
# resilient path: uninterrupted to RESUME_T twice (A, A'), then SIGTERM
# at RESUME_KILL (between the periodic saves at 12 and 24) and a resume
# to RESUME_T. Windows of 10 timed steps after 3 warmup steps cover
# global steps 4-13 (the save at 12) and 14-23 (none).
RESUME_T, RESUME_KILL, RESUME_EVERY, RESUME_KEEP = 25, 18, 12, 2
RESUME_COMMON = dict(workload="gpt2", size="medium", batch_per_device=16,
                     seq_len=512, warmup_steps=3, attention="flash",
                     ckpt_every=RESUME_EVERY, ckpt_keep=RESUME_KEEP)
# a run writes up to keep + 2 checkpoints of ~4.25 GB (keep_last, the
# in-flight periodic write, the final or emergency save)
RESUME_DISK_BYTES = 20e9


def resumed_run(name, ops, train_dir, resumed_from=0, **kw):
    """One run_lm_benchmark of the drill with the kernel counts zeroed
    just before and read just after: K1-K3 each once a layer for every
    step THIS run executed (warmup included), the decode kernels never,
    and every update applied (opt.count == step). Returns (state,
    metrics or the Preempted, log lines)."""
    from mpi_operator_tpu_torch.examples.lm_benchmark import run_lm_benchmark
    from mpi_operator_tpu_torch.models.transformer import lm_config
    from mpi_operator_tpu_torch.train.resilience import Preempted
    lines = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state = None
    try:
        state, out = run_lm_benchmark(train_dir=train_dir, log=lines.append,
                                      **RESUME_COMMON, **kw)
        end = state.step
        check(int(state.opt.count) == end,
              f"{name}: opt.count {int(state.opt.count)} != step {end}")
    except Preempted as p:      # the state stays inside the run
        out, end = p.with_traceback(None), p.step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    layers = lm_config(f"{RESUME_COMMON['workload']}-"
                       f"{RESUME_COMMON['size']}").num_layers
    ran = end - resumed_from
    check(all(counts[k] == layers * ran for k in FLASH_KERNELS),
          f"{name}: flash launches {counts} over the {ran} steps "
          f"({resumed_from} -> {end}) of {layers} layers it ran")
    check(all(n == 0 for k, n in counts.items() if k not in FLASH_KERNELS),
          f"{name}: other kernels launched: {counts}")
    log(f"  {name}: steps {resumed_from} -> {end} in {wall:.2f} s, "
        f"K1-K3 {counts['flash_fwd']} launches each = {layers} x {ran}")
    return state, out, lines


def window_step_ms(lines, base, every, tokens_per_step):
    """(window's last global step, ms a step, holds a save dispatch) for
    each window line of a benchmark log ("<i>\ttokens/sec: <tps>\t...");
    `base` is the global step before the first timed step."""
    out, prev = [], 0
    for line in lines:
        m = re.match(r"(\d+)\ttokens/sec: (\d+)", line)
        if m:
            i, tps = int(m.group(1)), float(m.group(2))
            lo, hi = base + prev + 1, base + i
            out.append((hi, tokens_per_step / tps * 1e3,
                        any(s % every == 0 for s in range(lo, hi + 1))))
            prev = i
    return out


def flat_state(state):
    return {"params": state.params, "mu": state.opt.mu, "nu": state.opt.nu}


def max_diff(a, b):
    return {k: float((a[k] - b[k]).abs().max()) for k in a}


def snapshot_costs(state):
    """What a save's snapshot costs the training stream, the two designs
    timed on the same 4.25 GB: a device clone (kept) against a copy into
    pinned host memory on the critical path, CUDA events, after one
    untimed pass of each."""
    tensors = list(flat_state(state).values())
    pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
              for t in tensors]
    costs = {}
    for name, fn in (("clone", lambda: [t.clone() for t in tensors]),
                     ("pinned", lambda: [h.copy_(t, non_blocking=True)
                                         for h, t in zip(pinned, tensors)])):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        got = fn()
        end.record()
        torch.cuda.synchronize()
        costs[name] = start.elapsed_time(end)
        del got
    del pinned
    torch.cuda.empty_cache()
    return costs


def cli_leg(train_dir, fault=None, *extra):
    """python -m mpi_operator_tpu_torch.examples.lm_benchmark as the
    controller starts a worker: gpt2-medium width, 2 layers, 16 x 512."""
    env = dict(os.environ)
    env.pop("TPU_FAULT_INJECT", None)
    if fault:
        env["TPU_FAULT_INJECT"] = fault
    cmd = [sys.executable, "-m", "mpi_operator_tpu_torch.examples."
           "lm_benchmark", "--size", "medium", "--num-layers", "2",
           "--batch-per-device", "16", "--seq-len", "512", "--attention",
           "flash", "--warmup-steps", "1", "--num-steps", "20",
           "--train-dir", train_dir, *extra]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         env=env)
    return out, time.perf_counter() - t0


def train_resume_phase(ops):
    """The preemption drill at full gpt2-medium width on the card: A and
    A' uninterrupted (bit-equal, or the op that is not deterministic is
    named and the resume held to their difference), B1 preempted by
    TPU_FAULT_INJECT=sigterm-at-step:RESUME_KILL (Preempted with step_k
    committed, preemption_drain then emergency_checkpoint logged), B2
    resumed to RESUME_T (first_resume_step logged; params, mu, nu,
    opt.count and its losses equal A's); each run's launch counts are
    layers x its own steps. Then the CLI pair at 2 layers: 215 with
    step_5, 0 with step_8. Prints the save, restore and first-step
    seconds with the card's name and power limit."""
    import shutil
    from mpi_operator_tpu_torch.telemetry import read_events
    from mpi_operator_tpu_torch.train import checkpoint as ck
    from mpi_operator_tpu_torch.train.resilience import (
        PREEMPTED_EXIT, Preempted, drain_latency_from_events)

    root = tempfile.mkdtemp(prefix="train-resume-")
    try:
        free = shutil.disk_usage(root).free
        check(free >= RESUME_DISK_BYTES,
              f"[train-resume] needs {RESUME_DISK_BYTES / 1e9:.0f} GB free "
              f"under {root} for its checkpoints, has {free / 1e9:.1f} GB")
        log(f"  {device_line()}; {free / 1e9:.1f} GB free under the temp "
            f"dir; DCP FileSystemWriter thread_count {ck.WRITER_THREADS}")
        tokens_per_step = (RESUME_COMMON["batch_per_device"]
                           * RESUME_COMMON["seq_len"])
        runs, windows = {}, []
        for name in ("A", "A'"):
            d = os.path.join(root, name.replace("'", "2"))
            state, m, lines = resumed_run(
                name, ops, d, num_steps=RESUME_T - 3)
            check(state.step == RESUME_T, f"{name}: ended at {state.step}")
            windows += window_step_ms(lines, 3, RESUME_EVERY,
                                      tokens_per_step)
            info = ck.last_save_info()
            log(f"  {name}: final save {info['bytes']} bytes, to host "
                f"{info['to_host_seconds']:.3f} s, write "
                f"{info['write_seconds']:.3f} s; periodic saves "
                f"{[l for l in lines if 'async checkpoint' in l]}")
            runs[name] = ({k: v.clone() for k, v in flat_state(state).items()},
                          m["step_losses"])
            if name == "A":
                costs = snapshot_costs(state)
                log(f"  snapshot of {info['bytes']} bytes: device clone "
                    f"{costs['clone']:.3f} ms, pinned host copy "
                    f"{costs['pinned']:.3f} ms (CUDA events)")
            del state
            shutil.rmtree(d, ignore_errors=True)
            torch.cuda.empty_cache()
        (fa, la), (fa2, la2) = runs["A"], runs["A'"]
        det = all(torch.equal(fa[k], fa2[k]) for k in fa) and la == la2
        diff_aa = max_diff(fa, fa2)
        log(f"  A vs A': bit-equal {det}; max |A - A'| {diff_aa}; losses "
            f"equal {la == la2}")
        with_save = [ms for _, ms, s in windows if s]
        without = [ms for _, ms, s in windows if not s]
        log(f"  periodic async save: step time {with_save} ms in windows "
            f"holding a save dispatch, {without} ms in windows without "
            f"one ({device_line()})")

        d = os.path.join(root, "B")
        os.environ["TPU_FAULT_INJECT"] = f"sigterm-at-step:{RESUME_KILL}"
        try:
            state, p, lines = resumed_run(
                "B1", ops, d, num_steps=RESUME_T - 3)
        finally:
            del os.environ["TPU_FAULT_INJECT"]
        check(isinstance(p, Preempted) and p.step == RESUME_KILL
              and p.exit_code == PREEMPTED_EXIT,
              f"B1: expected Preempted at {RESUME_KILL}, got {p!r}")
        check(ck.latest_checkpoint(d).endswith(f"step_{RESUME_KILL}"),
              f"B1: newest checkpoint {ck.latest_checkpoint(d)}")
        kinds = [e["event"] for e in read_events(
            os.path.join(d, "events.jsonl"))]
        check(kinds[-2:] == ["preemption_drain", "emergency_checkpoint"],
              f"B1: events {kinds}")
        info = ck.last_save_info()
        drain, _ = drain_latency_from_events(os.path.join(d, "events.jsonl"))
        log(f"  B1: blocking emergency save of step {info['step']}: "
            f"{drain:.3f} s drain (preemption_drain -> emergency_checkpoint),"
            f" {info['bytes']} bytes, to host {info['to_host_seconds']:.3f} "
            f"s, write {info['write_seconds']:.3f} s ({device_line()})")
        ck.reset_saved_state()

        state, m, lines = resumed_run(
            "B2", ops, d, resumed_from=RESUME_KILL, num_steps=100,
            stop_at_step=RESUME_T)
        check(any(f"resumed from" in l and f"step_{RESUME_KILL}" in l
                  for l in lines), "B2 did not resume from the drill's step")
        events = read_events(os.path.join(d, "events.jsonl"))
        restore = [e for e in events if e["event"] == "checkpoint_restore"]
        first = [e for e in events if e["event"] == "first_resume_step"]
        check(restore and first, f"B2: events {[e['event'] for e in events]}")
        got = flat_state(state)
        diff = max_diff(got, fa)
        ran = m["step_losses"]
        want = la[-len(ran):]
        if det:
            check(all(torch.equal(got[k], fa[k]) for k in fa)
                  and int(state.opt.count) == RESUME_T and ran == want,
                  f"B2 differs from A: max |B - A| {diff}, losses {ran} "
                  f"vs {want}")
        else:
            check(all(diff[k] <= 2 * diff_aa[k] for k in diff),
                  f"B2 vs A {diff} beyond twice A vs A' {diff_aa}")
        log(f"  B2: resumed from step {restore[0]['step']}, restore "
            f"{restore[0]['seconds']:.3f} s ({restore[0]['leaves']} leaves, "
            f"{ck.last_restore_info()['bytes']} bytes), first resumed step "
            f"{first[0]['step']} after {first[0]['seconds']:.3f} s; final "
            f"state vs A bit-equal {all(diff[k] == 0 for k in diff)}, max "
            f"|B - A| {diff}; losses of steps {RESUME_T - len(ran) + 1}-"
            f"{RESUME_T} equal A's {ran == want} ({device_line()})")
        del state, runs, fa, fa2, got
        shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()

        d = os.path.join(root, "cli")
        out, secs = cli_leg(d, "sigterm-at-step:5")
        check(out.returncode == PREEMPTED_EXIT
              and os.path.isdir(os.path.join(d, "step_5")),
              f"CLI preempted leg: rc {out.returncode}\n{out.stdout[-1500:]}"
              f"\n{out.stderr[-1500:]}")
        out2, secs2 = cli_leg(d, None, "--stop-at-step", "8")
        check(out2.returncode == 0 and os.path.isdir(os.path.join(d, "step_8"))
              and "step_5" in out2.stdout,
              f"CLI resume leg: rc {out2.returncode}\n{out2.stdout[-1500:]}"
              f"\n{out2.stderr[-1500:]}")
        log(f"  CLI (2 layers): sigterm-at-step:5 exit {out.returncode} with "
            f"step_5 in {secs:.1f} s; --stop-at-step 8 exit 0 with step_8 in "
            f"{secs2:.1f} s; {out2.stdout.strip().splitlines()[-1]}")
    finally:
        ck.wait_for_checkpoints()
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# BERT, MoE and remat training; the generate leg
# ---------------------------------------------------------------------------

# the JAX bench's bert leg (bench.py:835): bert-large, 16 x 512, MLM 0.15
BERT_COMMON = dict(workload="bert", size="large", batch_per_device=16,
                   seq_len=512, attention="flash")
# the moe leg (bench.py:862-865): gpt2-small, 8 experts, top-2, capacity
# factor 1.25, MoE on every second block, 16 x 512
MOE_COMMON = dict(workload="gpt2", size="small", batch_per_device=16,
                  seq_len=512, attention="flash", moe_experts=8)
# a capacity factor of 1.25 admits 1.25x the balanced load an expert;
# past half the routes dropped the router has collapsed onto few experts
MOE_DROP_MAX = 0.5
REMAT_COMMON = dict(workload="gpt2", size="medium", batch_per_device=16,
                    seq_len=512, attention="flash", num_steps=10,
                    warmup_steps=2)
REMAT_ARMS = [("off", {}), ("none", dict(remat=True, remat_policy="none")),
              ("dots", dict(remat=True, remat_policy="dots"))]
# the generate leg (bench.py:382 decode_leg): batch 8, prompt 128, 128
# new tokens, greedy, decode_kernel=True; timed calls cut to 2
GEN_COMMON = dict(batch=8, prompt_len=128, new_tokens=128, num_iters=2,
                  decode_kernel=True)
GEN_LEGS = [("gpt2", "medium", None), ("gpt2", "medium", "int8"),
            ("llama", "1b", None), ("llama", "1b", "int8")]


def train_bert_phase(ops, dev):
    """bert-large through run_lm_benchmark (K1-K3 non-causal), then its
    gradients through flash and dense at a padded batch, and two
    profiled steps. Returns the run's launch counts."""
    from mpi_operator_tpu_torch.train import LMTrainerConfig
    state, m, counts = train_phase("bert-large-train", ops, num_steps=30,
                                   warmup_steps=3, **BERT_COMMON)
    mcfg = state.model.config
    del state
    torch.cuda.empty_cache()
    B, S = BERT_COMMON["batch_per_device"], BERT_COMMON["seq_len"]
    trainer, tstate, batch = grads_agree(
        LMTrainerConfig(global_batch_size=B, seq_len=S, masked_lm=True),
        mcfg, dev, attention_mask=padded_rows(B, S, dev))
    profile_train(trainer, tstate, batch, m["step_time_p50_ms"])
    del trainer, tstate, batch
    torch.cuda.empty_cache()
    return counts


def train_moe_phase(ops, dev):
    """gpt2-small with 8 experts through run_lm_benchmark: launches,
    finite losses, no skipped update, the drop rate a fraction under
    MOE_DROP_MAX; two profiled steps; then 4 layers dropless, whose drop
    rate must be 0."""
    from mpi_operator_tpu_torch.data import TokenStream
    from mpi_operator_tpu_torch.train import LMTrainer, LMTrainerConfig
    state, m, counts = train_phase("gpt2-small-moe8-train", ops,
                                   num_steps=30, warmup_steps=3,
                                   **MOE_COMMON)
    rate = m["moe_drop_rate"]
    check(0.0 <= rate <= MOE_DROP_MAX,
          f"moe drop rate {rate} outside [0, {MOE_DROP_MAX}]")
    B, S = MOE_COMMON["batch_per_device"], MOE_COMMON["seq_len"]
    mcfg = state.model.config
    trainer = LMTrainer(mcfg, LMTrainerConfig(global_batch_size=B,
                                              seq_len=S), device=dev)
    batch = TokenStream(B, S, mcfg.vocab_size, seed=1, device=dev).batch(0)
    profile_train(trainer, state, batch, m["step_time_p50_ms"])
    del state, trainer, batch
    torch.cuda.empty_cache()
    _, m, _ = train_phase("gpt2-small-moe8-dropless-4l", ops, num_steps=4,
                          warmup_steps=1, num_layers=4, moe_dropless=True,
                          **MOE_COMMON)
    check(m["moe_drop_rate"] == 0.0,
          f"dropless drop rate {m['moe_drop_rate']}")
    torch.cuda.empty_cache()
    return counts


def train_remat_phase(ops):
    """gpt2-medium with remat off, "none" and "dots" from the same seed
    and batches: the params after the run must equal remat off's bit for
    bit; train_phase holds K1 at 2 x layers a step under remat and K2/K3
    at layers a step. Prints each arm's peak memory and step p50, and
    profiles two steps of each."""
    from mpi_operator_tpu_torch.data import TokenStream
    from mpi_operator_tpu_torch.train import LMTrainer, LMTrainerConfig
    B, S = REMAT_COMMON["batch_per_device"], REMAT_COMMON["seq_len"]
    arms = {}
    for label, kw in REMAT_ARMS:
        state, m, counts = train_phase(f"gpt2-medium-remat-{label}", ops,
                                       **REMAT_COMMON, **kw)
        peak = torch.cuda.max_memory_allocated() / 2**30
        trainer = LMTrainer(state.model.config, LMTrainerConfig(
            global_batch_size=B, seq_len=S), device=state.params.device)
        batch = TokenStream(B, S, state.model.config.vocab_size, seed=1,
                            device=state.params.device).batch(0)
        profile_train(trainer, state, batch, m["step_time_p50_ms"])
        del trainer, batch
        arms[label] = dict(
            params=state.params.clone(), counts=counts,
            step_time_p50_ms=m["step_time_p50_ms"],
            tokens_per_sec=m["tokens_per_sec"], peak_mem_gib=peak)
        del state
        torch.cuda.empty_cache()
    base = arms["off"]
    for label in ("none", "dots"):
        arm = arms[label]
        same = torch.equal(arm["params"], base["params"])
        diff = float((arm["params"] - base["params"]).abs().max())
        check(same, f"remat {label}: params differ from remat off by up to "
              f"{diff}")
    summary = {label: {k: v for k, v in arm.items() if k != "params"}
               for label, arm in arms.items()}
    log(f"  remat ({device_line()}): {json.dumps(summary)}")
    for label in ("none", "dots"):
        log(f"  remat {label} against off: peak memory "
            f"{arms[label]['peak_mem_gib']:.3f} / "
            f"{base['peak_mem_gib']:.3f} GiB, step p50 "
            f"{arms[label]['step_time_p50_ms']:.2f} / "
            f"{base['step_time_p50_ms']:.2f} ms; params bit-equal")
    del arms
    torch.cuda.empty_cache()


def profile_generate(model, prompt, n_new=32):
    """Where a generate() call's time goes: one call of `n_new` tokens
    under torch.profiler after an unprofiled one; device busy against
    wall time a token step (the prefill included), K4's share, and the
    host ops that take the most CPU time."""
    from torch.profiler import ProfilerActivity, profile

    from mpi_operator_tpu_torch import models
    n_new = min(n_new, model.config.max_len - prompt.shape[1])
    models.generate(model, prompt, n_new, device=model.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        models.generate(model, prompt, n_new, device=model.device)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = k4 = 0.0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation):
            busy += e.time_range.elapsed_us()
            if kernel_group(e.name) == "K4 decode_attention":
                k4 += e.time_range.elapsed_us()
    log(f"  profile: generate {n_new} tokens, wall {wall_us / 1e3:.2f} ms "
        f"({wall_us / 1e3 / n_new:.3f} ms a token step), device busy "
        f"{busy / 1e3:.2f} ms ({busy / 1e3 / n_new:.3f} ms a step), idle "
        f"share {1 - busy / wall_us:.3f}, K4 {k4 / max(busy, 1e-9):.1%} "
        f"of device time")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in host[:6]:
        log(f"  profile host: {e.self_cpu_time_total / 1e3 / n_new:8.3f} ms "
            f"a step self CPU, {e.count / n_new:7.1f} calls a step  "
            f"{e.key[:60]}")


def generate_phase(ops):
    """run_generate_benchmark at the generate leg's shape for each of
    GEN_LEGS, every kernel count zeroed just before and read just after:
    K4 must have launched once a layer a decode step of every generate()
    call (the warm call and the timed ones; the prefill runs the dense
    path), no other kernel. The last call's greedy tokens against the
    same model's decode_kernel=False run: where a row first differs, a
    near tie of the dense path (SPEC_MARGIN). Prints tokens/s and MBU
    against HBM_BYTES_PER_S, and profiles a call of each bf16 leg.
    Returns the K4 launches of the last leg."""
    import types

    from mpi_operator_tpu_torch import models
    from mpi_operator_tpu_torch.examples.lm_benchmark import \
        run_generate_benchmark
    gen = models.generate
    n_new = GEN_COMMON["new_tokens"]
    launches = 0
    for family, size, kv in GEN_LEGS:
        name = f"{family}-{size}{'-int8' if kv else ''}"
        calls = []

        def recording(model, prompt, n, **kw):
            out = gen(model, prompt, n, **kw)
            calls.append((model, prompt, out.tokens))
            return out
        models.generate = recording
        try:
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            m = run_generate_benchmark(
                size=size, family=family, kv_cache_dtype=kv,
                log=lambda line: log(f"  {line}"), **GEN_COMMON)
            torch.cuda.synchronize()
            counts = dict(ops.launch_counts)
        finally:
            models.generate = gen
        model, prompt, got = calls[-1]
        layers = model.config.num_layers
        want = layers * (n_new - 1) * len(calls)
        check(counts["decode_attention"] == want
              and all(n == 0 for k, n in counts.items()
                      if k != "decode_attention"),
              f"{name}: launches {counts}; K4 expected {want} (layers x "
              f"{n_new - 1} decode steps x {len(calls)} calls)")
        launches = counts["decode_attention"]
        want_tok = gen(model, prompt, n_new, decode_kernel=False,
                       device=model.device).tokens
        P = prompt.shape[1]
        dense = models.decode_model(model, decode_kernel=False)
        rows = [types.SimpleNamespace(id=b, prompt=prompt[b].tolist(),
                                      temperature=0.0)
                for b in range(prompt.shape[0])]

        def results(toks):
            return {b: types.SimpleNamespace(tokens=toks[b, P:].tolist())
                    for b in range(toks.shape[0])}
        divs = first_divergences(dense, rows, results(got),
                                 results(want_tok))
        for d in divs:
            check(near_tie(d), f"{name}: row {d['request']} leaves the "
                  f"dense path at token {d['index']} with no near tie: {d}")
        stats = dict(card=device_line(), calls=len(calls),
                     launches=launches,
                     rows_identical=prompt.shape[0] - len(divs),
                     first_divergences=divs,
                     decode_tokens_per_sec=m["decode_tokens_per_sec"],
                     mbu=m["mbu"], hbm_bytes_per_s=HBM_BYTES_PER_S,
                     decode_bytes_per_step=m["decode_bytes_per_step"],
                     wall_seconds=m["wall_seconds"],
                     peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(f"  generate {name}: {json.dumps(stats)}")
        if kv is None:
            profile_generate(model, prompt)
        del model, prompt, dense, calls
        torch.cuda.empty_cache()
    return launches


# the warp-specialised flash kernels: 384 threads at 168 registers fill
# the register file, which setmaxnreg splits 40/232 between the producer
# and the consumer warpgroups
WS_KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")
WS_REGISTERS = 168


def decode_types(args):
    """The compute and cache dtypes at the head of a mangled decode
    kernel's template arguments (bf16 is a named type, f32 `f`, int8
    `a`; a repeat of bf16 is a substitution `S..._`); [] for the flash
    kernels, whose only argument is an int."""
    if not args.startswith("I") or args.startswith("ILi"):
        return []
    rest, out = args[1:], []
    for _ in range(2):
        if rest.startswith("13__nv_bfloat16"):
            out.append("bf16")
            rest = rest[len("13__nv_bfloat16"):]
        elif rest[:1] in ("f", "a"):
            out.append("f32" if rest[0] == "f" else "int8")
            rest = rest[1:]
        elif rest.startswith("S"):
            out.append(out[-1] if out else "?")
            rest = rest[rest.index("_") + 1:]
    return out


def ptxas_report(log_text):
    """[(kernel, "N registers, M bytes smem, spill stores/loads")] from
    `nvcc -Xptxas -v` output: each entry function's name (demangled down
    to the kernel and its template arguments) and what ptxas used."""
    out, kernel, spills = [], None, ""
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            for name in ("flash_fwd_kernel", "flash_dq_kernel",
                         "flash_dkv_kernel", "wgmma_probe_kernel",
                         "decode_attention_kernel"):
                if name in mangled:
                    args = mangled.split(name, 1)[1]
                    kernel = name + "<" + ",".join(
                        decode_types(args) + re.findall(r"Li(\d+)E", args)
                        + [t for t in ("Contiguous", "Paged")
                           if f"{t}Rows" in args]) + ">"
                    break
            else:
                kernel = mangled[:60]
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and kernel:
            used = line.split("Used", 1)[1].strip()
            out.append((kernel, f"{used}; {spills}"))
            kernel = None
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
    _build.build(["decode_attention", "flash_attention"])
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        seen = set()
        for kernel, report in ptxas_report(text):
            log(f"[build] {name}: {kernel}: {report}")
            base = kernel.split("<")[0]
            if base in WS_KERNELS:
                seen.add(base)
                check(report.startswith(f"{WS_REGISTERS} registers")
                      and "0 bytes spill stores, 0 bytes spill loads"
                      in report, f"{kernel}: ptxas reports {report}; the "
                      f"40/232 setmaxnreg split needs {WS_REGISTERS} "
                      f"registers and no spills")
        check(name != "flash_attention" or seen == set(WS_KERNELS),
              f"ptxas reported {sorted(seen)} of {WS_KERNELS}")

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
    log("[kernel] K1-K3 flash_fwd / flash_dq / flash_dkv vs their plain "
        "versions")
    flash_err, flash_rows = flash_kernel_phase(ops, dev)
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
    del llama
    torch.cuda.empty_cache()
    log(f"[paged-llama] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[bench] run_serving_benchmark: the serving and serving_paged legs "
        "at full size, CUDA graphs on and off")
    bench_phase()
    log(f"[bench] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[spec] run_serving_benchmark: the serving_spec leg at full size "
        "(ngram drafts, draft_k 4), paged and contiguous, against no-spec")
    spec_phase(ops)
    log(f"[spec] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train] gpt2-medium, bf16 over f32 masters, attention=flash, "
        "batch 16 x 512, AdamW with warmup")
    state, train_metrics, train_counts = train_phase(
        "gpt2-medium-train", ops, workload="gpt2", size="medium",
        batch_per_device=16, seq_len=512, num_steps=30, warmup_steps=3,
        attention="flash")
    mcfg = state.model.config
    del state
    torch.cuda.empty_cache()
    from mpi_operator_tpu_torch.train import LMTrainerConfig
    trainer, tstate, batch = grads_agree(
        LMTrainerConfig(global_batch_size=16, seq_len=512), mcfg, dev)
    profile_train(trainer, tstate, batch, train_metrics["step_time_p50_ms"])
    del trainer, tstate, batch
    torch.cuda.empty_cache()
    log(f"[train] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train-llama] llama-1b (2 layers), bf16, attention=flash, batch "
        "8 x 512")
    train_phase("llama-1b-2l-train", ops, workload="llama", size="1b",
                batch_per_device=8, seq_len=512, num_layers=2, num_steps=10,
                warmup_steps=2, attention="flash")
    log(f"[train-llama] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train-bert] bert-large, bf16 over f32 masters, attention=flash "
        "(non-causal), batch 16 x 512, MLM rate 0.15")
    train_bert_phase(ops, dev)
    log(f"[train-bert] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train-moe] gpt2-small, 8 experts, top-2, capacity factor 1.25, "
        "MoE every 2nd block, batch 16 x 512; then 4 layers dropless")
    train_moe_phase(ops, dev)
    log(f"[train-moe] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train-remat] gpt2-medium, batch 16 x 512, remat off / none / "
        "dots from one seed and one stream")
    train_remat_phase(ops)
    log(f"[train-remat] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[generate] run_generate_benchmark: gpt2-medium and llama-1b, "
        "batch 8, prompt 128, 128 new tokens, bf16 and int8 KV, "
        "decode_kernel=True")
    generate_phase(ops)
    log(f"[generate] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[train-resume] gpt2-medium, bf16, attention=flash, 16 x 512: "
        f"uninterrupted to step {RESUME_T} twice, SIGTERM at step "
        f"{RESUME_KILL}, resume; the CLI pair at 2 layers")
    train_resume_phase(ops)
    log(f"[train-resume] {time.perf_counter() - t0:.1f} s")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    source = "mpi_operator_tpu_torch/ops/csrc/decode_attention.cu"
    flash_source = "mpi_operator_tpu_torch/ops/csrc/flash_attention.cu"
    flash_lines = {"flash_fwd": 137, "flash_dq": 305, "flash_dkv": 344}
    print(json.dumps({"kernels": [
        dict(name="decode_attention", route="cuda", source=source,
             replaces="mpi_operator_tpu/ops/attention.py:621",
             launches=launches, max_abs_err=err, **row),
        dict(name="paged_decode_attention", route="cuda", source=source,
             replaces="mpi_operator_tpu/ops/attention.py:724",
             launches=launches5, max_abs_err=err5, **row5)] + [
        dict(name=name, route="cuda", source=flash_source,
             replaces=f"mpi_operator_tpu/ops/attention.py:{line}",
             launches=train_counts[name], max_abs_err=flash_err[name],
             **flash_rows["gpt2-medium"][name])
        for name, line in flash_lines.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
