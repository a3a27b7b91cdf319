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
   heads H=16, D=64, causal), llama-1b's heads after the K/V repeat
   (H=32), a [B, S] key mask with one fully masked row (non-causal and
   causal), a ragged S=500, S=129 (one past K1's 128-row tiles), and
   D=128 (two 64-column boxes a tile). K2/K3 get the plain forward's
   lse and delta. Each output is held to a relative error limit, and at
   the training shape each limit must fail planted faults made from the
   plain versions (a skipped tile; for K2/K3 ds left unrounded). Times
   each kernel at the training shape with L2 flushed beside its bound,
   its plain version, and one scaled_dot_product_attention(is_causal=
   True) forward and its backward through autograd (yardsticks only:
   the port never calls SDPA), and prints K1 over SDPA's forward and
   K2 + K3 over SDPA's backward, ratios taken in the same call.
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
   K4/K5 count against layers x steps.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
import dataclasses
import json
import math
import re
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
# (name, B, S, H, D, causal, mask): the training shape first
FLASH_CASES = [
    ("gpt2-medium", 16, 512, 16, 64, True, None),
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
    summed time is the busy time. With `kernel`, the profiler's own count
    of its launches in the window (graph replays included) must equal
    layers x decode steps: a count that does not rest on the wrappers'
    host counters. Returns the window's numbers."""
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
    stats = dict(steps=steps, wall_ms_per_step=wall_us / 1e3 / n,
                 device_ms_per_step=busy / 1e3 / n,
                 idle_share=1 - busy / wall_us,
                 launch_calls_per_step=launch_calls / n,
                 runtime_calls_per_step=sum(runtime.values()) / n)
    log(f"  profile: {steps} decode steps, wall {wall_us / 1e3:.2f} ms "
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
        check(steps > 0 and seen == layers * steps,
              f"the profiler saw {seen} {kernel} launches over {steps} "
              f"decode steps of {layers} layers")
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
    ("serving", dict(compare_sync=True), "decode_attention"),
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
    want = {"step": 3, "prefill": len(engine.config.chunk_buckets)}
    got = engine.compile_counts()
    check({k: got[k] for k in want} == want
          and engine.capture_counts() == (want if engine.cuda_graphs else
                                          {"step": 0, "prefill": 0}),
          f"programs {got}, graphs {engine.capture_counts()}; expected "
          f"{want}")


def moved(runs, key, higher_is_better):
    """(best with graphs, best eager, spread, verdict) of `key`: the best
    of each arm's two runs, the larger of the two arms' run-to-run
    spreads, and whether the arms' bests differ by more than that."""
    on = [r[key] for r in runs["graphs"]]
    off = [r[key] for r in runs["eager"]]
    pick = max if higher_is_better else min
    spread = max(max(on) - min(on), max(off) - min(off))
    diff = pick(on) - pick(off)
    return pick(on), pick(off), spread, abs(diff) > spread


def bench_phase():
    """run_serving_benchmark at each BENCH_LEGS leg, graphs A/B included:
    the programs within the no-recompile contract and every one captured
    once, every token of the graphs arm equal to the eager arm's (greedy
    and sampled), the sync A/B's greedy tokens equal. Prints tokens/s and
    TPOT p50/p99 of both arms and whether they moved beyond the arms'
    run-to-run spread. Then, for the two bench legs, with graphs on and
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
        m = run_serving_benchmark(**BENCH_COMMON, **kw,
                                  log=lambda line: log(f"  {line}"))
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
        runs = {arm: m[f"serving_{arm}_runs"] for arm in ("graphs", "eager")}
        verdicts = {}
        for metric, key, higher in (("tokens_per_s", "tokens_per_sec", True),
                                    ("tpot_p50_ms", "run_tpot_p50_ms", False),
                                    ("tpot_p99_ms", "run_tpot_p99_ms",
                                     False)):
            on, off, spread, beyond = moved(runs, key, higher)
            verdicts[metric] = dict(graphs=on, eager=off, spread=spread,
                                    moved_beyond_spread=beyond)
        m["graphs_ab"] = verdicts
        log(f"  [{leg}] graphs A/B: {json.dumps(verdicts)}")
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
                "serving_pages_in_use_peak", "profile_graphs_True",
                "profile_graphs_False")
        log(f"  [{leg}] {json.dumps({k: m[k] for k in keys if k in m})}")
        out[leg] = m
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


def flash_bound(name, B, S, H, D, causal):
    """(bound_ms, bound_by) of one flash kernel: the bytes it must move
    (each bf16 [B, S, H, D] input and output once, f32 [B, H, S] lse and
    delta once) over HBM bandwidth, against its products over the
    visible (query, key) pairs (2*D flops a pair and product: K1 q.k and
    p.v, K2 adds do.v and ds.k for 3, K3 q.k, do.v, p.do, ds.q for 4)
    over the bf16 tensor-core rate."""
    t, stat = B * S * H * D * 2, B * H * S * 4
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    nbytes, products = {"flash_fwd": (4 * t + stat, 2),
                        "flash_dq": (5 * t + 2 * stat, 3),
                        "flash_dkv": (6 * t + 2 * stat, 4)}[name]
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
    returns ({kernel: max abs error}, {kernel: timing row at the
    training shape})."""
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
        if name != "gpt2-medium":
            continue
        faults = planted_faults(ops, q, k, v, do, ref_lse, delta, causal, {
            "flash_fwd": ref_out, "flash_dq": ref_dq,
            "flash_dkv": (ref_dk, ref_dv)})
        for kname, fault, reading in faults:
            log(f"  planted fault {kname} {fault}: relative error "
                f"{reading:.3e} against the limit {FLASH_REL[kname]:.1e}")
            check(reading > FLASH_REL[kname],
                  f"{kname}: the limit {FLASH_REL[kname]} passes a "
                  f"kernel with a {fault} ({reading})")
        flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
        out, lse = ops.flash_fwd(q, k, v, causal)
        delta = ops.flash_delta(out, do)
        calls = {
            "flash_fwd": (lambda: ops.flash_fwd(q, k, v, causal),
                          lambda: ops.flash_fwd_ref(q, k, v, causal)),
            "flash_dq": (lambda: ops.flash_dq(q, k, v, do, lse, delta,
                                              causal),
                         lambda: ops.flash_dq_ref(q, k, v, do, lse, delta,
                                                  causal)),
            "flash_dkv": (lambda: ops.flash_dkv(q, k, v, do, lse, delta,
                                                causal),
                          lambda: ops.flash_dkv_ref(q, k, v, do, lse, delta,
                                                    causal)),
        }
        # SDPA's [B, H, S, D] views of the same inputs; its cotangent made
        # contiguous once, outside the timing
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        backend = torch._fused_sdp_choice(qt, kt, vt, is_causal=True)
        sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 20, flush)
        so = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2).contiguous()
        sdpa_bwd = time_ms(lambda: torch.autograd.grad(
            so, (qt, kt, vt), dot, retain_graph=True), 20, flush)
        log(f"  SDPA (is_causal, yardstick; backend choice {backend}): "
            f"forward {sdpa_fwd:.4f} ms, backward (dq, dk, dv in one call) "
            f"{sdpa_bwd:.4f} ms")
        for kname, (kernel, plain) in calls.items():
            ms = time_ms(kernel, 20, flush)
            plain_ms = time_ms(plain, 5, flush)
            bound_ms, bound_by = flash_bound(kname, B, S, H, D, causal)
            lib = sdpa_fwd if kname == "flash_fwd" else sdpa_bwd
            rows[kname] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, library_ms=lib)
            log(f"  {kname:9s} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                f"bound {bound_ms:.4f} ms ({bound_by})  SDPA "
                f"{'forward' if kname == 'flash_fwd' else 'backward'} "
                f"{lib:.4f} ms")
        log(f"  ratios in this call: K1 / SDPA forward "
            f"{rows['flash_fwd']['ms'] / sdpa_fwd:.3f}, (K2 + K3) / SDPA "
            f"backward {(rows['flash_dq']['ms'] + rows['flash_dkv']['ms']) / sdpa_bwd:.3f}")
        del flush, so, qt, kt, vt
    torch.cuda.empty_cache()
    log(f"  K1-K3 worst relative error over the cases: "
        + ", ".join(f"{n} {worst_rel[n]:.3e} (limit {FLASH_REL[n]:.1e})"
                    for n in worst_rel))
    return worst, rows


FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def train_phase(name, ops, **kw):
    """run_lm_benchmark(**kw) with every kernel count zeroed just before
    and read just after: K1-K3 must each have launched once a layer a
    step, the decode kernels never; every timed step's loss finite and
    no update skipped by the guard. Returns (state, metrics, counts)."""
    from mpi_operator_tpu_torch.examples.lm_benchmark import run_lm_benchmark
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    state, m = run_lm_benchmark(log=lambda line: log(f"  {line}"), **kw)
    torch.cuda.synchronize()
    counts = dict(ops.launch_counts)
    layers, steps = state.model.config.num_layers, state.step
    check(all(counts[k] == layers * steps for k in FLASH_KERNELS),
          f"{name}: flash launches {counts} over {steps} steps of {layers} "
          f"layers")
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
                               "flops_per_step", "final_loss")}
    stats.update(steps=steps, launches={k: counts[k] for k in FLASH_KERNELS},
                 first_loss=losses[0], last_loss=losses[-1],
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"  {name}: {json.dumps(stats)}")
    return state, m, counts


def grads_agree(tcfg, mcfg, dev):
    """One step's gradients from the same weights and batch through
    attention="flash" and "dense"; returns the flash trainer and state
    for profiling."""
    from mpi_operator_tpu_torch.data import TokenStream
    from mpi_operator_tpu_torch.models.transformer import param_shapes
    from mpi_operator_tpu_torch.train import LMTrainer
    batch = TokenStream(tcfg.global_batch_size, tcfg.seq_len,
                        mcfg.vocab_size, seed=1, device=dev).batch(0)
    grads = {}
    for impl in ("dense", "flash"):
        trainer = LMTrainer(dataclasses.replace(mcfg, attention=impl), tcfg,
                            device=dev)
        state = trainer.init_state(0)
        loss, g, _ = trainer.loss_and_grads(state, *batch)
        grads[impl] = (float(loss), g)
        if impl == "dense":
            del trainer, state
            torch.cuda.empty_cache()
    (ld, gd), (lf, gf) = grads["dense"], grads["flash"]
    norm_d, norm_f = float(gd.norm()), float(gf.norm())
    worst, off = (1.0, ""), 0
    for pname, shape in param_shapes(mcfg).items():
        n = math.prod(shape)
        a, b = gf[off:off + n], gd[off:off + n]
        off += n
        if pname.endswith("attn.key.bias"):
            check(float(a.norm()) <= NOISE_NORM * norm_f
                  and float(b.norm()) <= NOISE_NORM * norm_d,
                  f"{pname}: gradient {float(a.norm())} / {float(b.norm())} "
                  f"is not rounding noise")
            continue
        cos = float(torch.dot(a, b) / (a.norm() * b.norm()).clamp(min=1e-30))
        worst = min(worst, (cos, pname))
    log(f"  grads flash vs dense: loss {lf:.6f} vs {ld:.6f}, global norm "
        f"{norm_f:.6f} vs {norm_d:.6f}, worst cosine {worst[0]:.6f} "
        f"({worst[1]})")
    check(worst[0] >= GRAD_COSINE, f"gradient cosine {worst[0]} < "
          f"{GRAD_COSINE} for {worst[1]}")
    check(abs(norm_f - norm_d) <= GRAD_NORM_RTOL * norm_d,
          f"global gradient norm {norm_f} vs {norm_d} beyond "
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
    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    source = "mpi_operator_tpu_torch/ops/csrc/decode_attention.cu"
    flash_source = "mpi_operator_tpu_torch/ops/csrc/flash_attention.cu"
    flash_lines = {"flash_fwd": 137, "flash_dq": 305, "flash_dkv": 344}
    print(json.dumps({"kernels": [
        dict(name="decode_attention", route="cuda", source=source,
             replaces="mpi_operator_tpu/ops/attention.py:458",
             launches=launches, max_abs_err=err, **row),
        dict(name="paged_decode_attention", route="cuda", source=source,
             replaces="mpi_operator_tpu/ops/attention.py:724",
             launches=launches5, max_abs_err=err5, **row5)] + [
        dict(name=name, route="cuda", source=flash_source,
             replaces=f"mpi_operator_tpu/ops/attention.py:{line}",
             launches=train_counts[name], max_abs_err=flash_err[name],
             **flash_rows[name])
        for name, line in flash_lines.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
