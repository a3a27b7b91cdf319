#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's hand-written kernels against other
builds of their sources, in one process on one card: an earlier
commit's sources (`--parent`) and copies of the committed sources with
one text edit each (VARIANTS).

    mkdir -p _parent && for f in flash_attention decode_attention; do
      git show <commit>:mpi_operator_tpu_torch/ops/csrc/$f.cu > _parent/$f.cu
    done
    python3 scripts/kernel_ab.py --parent _parent               # on an H100
    python3 scripts/kernel_ab.py --flash-variants --decode-variants --sweep

Every source is built with the port's own nvcc flags into
`ops/_build/variants/` (one nvcc each, all started together). Each of its
`extern "C" int` entry points is bound from the parameter list read out
of that same source, and called with its arguments by parameter name: an
earlier commit's entry points get their own signature, and a parameter
this script does not know is refused, never guessed.

Sections, each launch timed with CUDA events after the 50 MB L2 is
flushed (by writing 256 MB, as chip_smoke.py does), the median printed:

- `--parent`: K2 at the training shape (B=16, S=512, H=16, D=64, causal,
  bf16) beside K3, SDPA's backward and the byte bound; K4 and K5 at the
  DECODE_AB shapes (both head layouts; bf16, int8 and f32 caches; the
  serving, long and paged-serving cursor sets; one llama-1b row at a
  4096-position cache) beside the byte bound; then yardsticks for K4 at
  gpt2-medium's heads: one tiny launch and one PyTorch sum over the same
  bytes, under this flush and under a read-only one. Parent and change
  take turns: parent, change, change, parent. Outputs of each pair are
  compared (K2 by its relative error against the plain version).
- `--flash-variants`: K1, K2 and K3 of every flash_attention.cu VARIANT
  at the training shape, committed source first and last (committed,
  variants..., variants reversed, committed), beside their relative
  errors (an ablation's error is large by design).
- `--decode-variants`: K4 of every decode_attention.cu VARIANT at
  gpt2-medium's serving and long sets, in the same mirrored order.
- `--sweep`: K4 at every power-of-two split length from one tile to the
  whole cache, and at the lengths that aiming at 1, 2, 3 or 4 CTAs an SM
  gives, over the SWEEP shapes (few to many (row, kv head) pairs, caches
  of 384, 1024 and 4096 positions, serving and long cursors), beside the
  length `ops.attention.decode_split_len` picks; then, for each aim, its
  time over the best length's, as a geometric mean and worst case over
  the shapes.
"""
import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

HBM_BYTES_PER_S = 3.35e12
LAYOUTS = {"gpt2-medium": (16, 16), "llama-1b": (32, 8)}
# name: (source in ops/csrc, [(text in it, its replacement), ...])
VARIANTS = {
    "k1_ring1": ("flash_attention", [("constexpr int kFwdStages = 2;",
                                      "constexpr int kFwdStages = 1;")]),
    "k1_ring3": ("flash_attention", [("constexpr int kFwdStages = 2;",
                                      "constexpr int kFwdStages = 3;")]),
    "k3_ring1": ("flash_attention", [("constexpr int kDkvStages = 3;",
                                      "constexpr int kDkvStages = 1;")]),
    "k3_ring2": ("flash_attention", [("constexpr int kDkvStages = 3;",
                                      "constexpr int kDkvStages = 2;")]),
    "k2_ring1": ("flash_attention", [("constexpr int kDqStages = 2;",
                                      "constexpr int kDqStages = 1;")]),
    "k2_ring3": ("flash_attention", [("constexpr int kDqStages = 2;",
                                      "constexpr int kDqStages = 3;")]),
    # K2 at D <= 64 with k-tiles of 64 keys instead of 128
    "k2_bk64": ("flash_attention", [(
        "static constexpr int kDqK = PD == 64 ? 128 : 64;",
        "static constexpr int kDqK = 64;")]),
    # K1 without its exponentials (p = the exponent), its p.v products,
    # or its output stores
    "k1_no_exp": ("flash_attention", [(
        "const float e = ex2(fmaf(s[n][j], c2, -mb[j >> 1]));",
        "const float e = fmaf(s[n][j], c2, -mb[j >> 1]);")]),
    "k1_no_pv": ("flash_attention", [(
        "    wgmma_rs(o, pa[kk], mnmajor(vt, BK, kk), 1);",
        "    if (a.B < 0) wgmma_rs(o, pa[kk], mnmajor(vt, BK, kk), 1);")]),
    "k1_no_store": ("flash_attention", [(
        "          if (n8 * 8 < a.D)\n"
        "            *reinterpret_cast<uint32_t*>(orow",
        "          if (n8 * 8 < a.D && a.B < 0)\n"
        "            *reinterpret_cast<uint32_t*>(orow")]),
    "threads256": ("decode_attention", [("constexpr int kThreads = 128;",
                                         "constexpr int kThreads = 256;")]),
    "ring3": ("decode_attention", [("constexpr int kStages = 2;",
                                    "constexpr int kStages = 3;")]),
    "ring4": ("decode_attention", [("constexpr int kStages = 2;",
                                    "constexpr int kStages = 4;")]),
    # the tile math taken out (loads, splits and combine kept)
    "no_math": ("decode_attention", [(
        "    for (int j0 = 0; j0 < P; j0 += PG) {",
        "    for (int j0 = 0; j0 < (w.H < 0 ? P : 0); j0 += PG) {")]),
    # every split writes the output itself: no partials, tickets or
    # combine (wrong for rows with several live splits)
    "no_combine": ("decode_attention", [
        ("    if (live == 1) {\n      ob[i]",
         "    if (live >= 1) {\n      ob[i]"),
        ("  if (live == 1) return;", "  if (live >= 1) return;")]),
}
# (layout, cache, B, L, cursor set, page sizes for K5): parent vs change
DECODE_AB = [
    ("gpt2-medium", "bf16", 8, 1024, "serving", (64, 16)),
    ("gpt2-medium", "bf16", 8, 1024, "long", (64, 16)),
    ("gpt2-medium", "bf16", 8, 384, "paged-serving", (64,)),
    ("gpt2-medium", "int8", 8, 1024, "serving", (64,)),
    ("gpt2-medium", "int8", 8, 1024, "long", (64,)),
    ("gpt2-medium", "f32", 8, 1024, "serving", (64,)),
    ("gpt2-medium", "f32", 8, 1024, "long", (64,)),
    ("llama-1b", "bf16", 8, 1024, "serving", (64,)),
    ("llama-1b", "bf16", 8, 1024, "long", (64,)),
    ("llama-1b", "int8", 8, 1024, "serving", (64, 16)),
    ("llama-1b", "int8", 8, 1024, "long", (64, 16)),
    ("llama-1b", "bf16", 1, 4096, "long", (64,)),
    ("llama-1b", "int8", 1, 4096, "long", (64,)),
]
# (layout, cache, B, L): K4 at every split length
SWEEP = ([("gpt2-medium", "bf16", B, L) for L in (1024, 4096)
          for B in (1, 2, 4, 8)]
         + [("llama-1b", "bf16", B, L) for L in (1024, 4096)
            for B in (1, 2, 4, 8, 16)]
         + [("llama-1b", "int8", B, L) for B in (1, 8) for L in (1024, 4096)]
         + [("gpt2-medium", "f32", B, 4096) for B in (1, 8)]
         + [("gpt2-medium", "bf16", 8, 384)])
# the sweep also times the split length that aiming at c CTAs an SM
# gives, for each c here
SWEEP_CTAS_PER_SM = (1, 2, 3, 4)
_DTYPE_CODE = {"f32": 0, "bf16": 1, "int8": 2}
_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def split_len_at(L, bkv, sms, tile, ctas_per_sm):
    """The split length that gives ceil(ctas_per_sm * sms / bkv) splits
    (at most one a tile), the tiles shared out evenly."""
    n_tiles = -(-L // tile)
    splits = min(n_tiles, -(-ctas_per_sm * sms // bkv))
    return -(-n_tiles // splits) * tile


def cursor_set(name, B, L):
    """chip_smoke.py's cursor sets: serving depths (prompt <= 128 + new
    <= 64), the paged serving phase's (128-token prefix + up to 128 +
    64), and the last 128 positions of the cache."""
    lo, hi, seed = {"serving": (32, 192, 0), "paged-serving": (160, 320, 2),
                    "long": (L - 128, L, 1)}[name]
    return sorted(np.random.RandomState(seed).randint(lo, hi, B).tolist())


class Entries:
    """The `extern "C" int` entry points of one built source, each bound
    from its parameter list in that source and called by name:
    `lib.call("decode_attention_launch", q=..., B=..., ...)`. Names the
    entry does not take are ignored; a parameter with no value raises."""

    def __init__(self, lib, source_text):
        self.params = {}
        for name, plist in _ENTRY.findall(source_text):
            names, types = [], []
            for p in plist.split(","):
                p = " ".join(p.split())
                names.append(re.findall(r"\w+", p)[-1])
                types.append(ctypes.c_void_p if "*" in p else
                             ctypes.c_float if p.startswith("float") else
                             ctypes.c_int)
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = types, ctypes.c_int
            self.params[name] = (fn, names)

    def takes(self, name, param):
        return param in self.params[name][1]

    def call(self, name, **kw):
        fn, names = self.params[name]
        missing = [n for n in names if n not in kw]
        if missing:
            raise TypeError(f"{name} takes {missing}, which this script "
                            f"does not supply")
        rc = fn(*(kw[n] for n in names))
        if rc != 0 and name.endswith("_launch"):
            raise RuntimeError(f"{name} returned {rc}")
        return rc


def build_all(ops_build, texts, out_dir):
    """{name: Entries} for {name: source text}, one nvcc each, started
    together."""
    started = {}
    for name, text in texts.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        lib = out_dir / f"lib{name}.so"
        started[name] = (subprocess.Popen(
            [ops_build.find_nvcc(), *ops_build.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib)
    libs = {}
    for name, (proc, lib) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} did not build:\n{log[-3000:]}")
        libs[name] = Entries(ctypes.CDLL(str(lib)), texts[name])
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="directory with an earlier commit's .cu files")
    ap.add_argument("--flash-variants", action="store_true")
    ap.add_argument("--decode-variants", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--json", default=None,
                    help="also write every time measured to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from mpi_operator_tpu_torch.ops import _build
    from mpi_operator_tpu_torch.ops import attention as ops
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    texts = {f"change_{s}": (_build.CSRC / f"{s}.cu").read_text()
             for s in ("flash_attention", "decode_attention")}
    if args.parent:
        for s in ("flash_attention", "decode_attention"):
            texts[f"parent_{s}"] = (Path(args.parent) / f"{s}.cu").read_text()
    chosen = {n: v for n, v in VARIANTS.items()
              if (v[0] == "flash_attention" and args.flash_variants)
              or (v[0] == "decode_attention" and args.decode_variants)}
    for name, (source, edits) in chosen.items():
        text = texts[f"change_{source}"]
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: its edit matches the "
                                   f"source {text.count(old)} times")
            text = text.replace(old, new)
        texts[f"variant_{name}"] = text
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build_all(_build, texts, out_dir)

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def time_ms(fn, iters=args.iters, dirty=True):
        for _ in range(3):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for e0, e1 in ev:
            if dirty:
                flush.zero_()
            else:
                flush.max()
            e0.record()
            fn()
            e1.record()
        torch.cuda.synchronize()
        return float(np.median([e0.elapsed_time(e1) for e0, e1 in ev]))

    def turns(label, fns, bound_ms=None):
        """fns {"parent": f, "change": f}, timed parent, change, change,
        parent."""
        ts = [(who, time_ms(fns[who])) for who in
              ("parent", "change", "change", "parent")]
        results[label] = ts
        par = [t for w, t in ts if w == "parent"]
        chg = [t for w, t in ts if w == "change"]
        extra = "" if bound_ms is None else f"  bound {bound_ms:.5f} ms"
        print(f"{label:44s} parent {par[0]:.4f} / {par[1]:.4f} ms  change "
              f"{chg[0]:.4f} / {chg[1]:.4f} ms  change / parent "
              f"{sum(chg) / sum(par):.3f}{extra}", flush=True)
        return float(np.mean(chg)), float(np.mean(par))

    def rel(got, want):
        return float((got.float() - want.float()).norm()
                     / want.float().norm())

    # ---- flash attention at the training shape
    B, S, H, D = 16, 512, 16, 64
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen, device=dev)
                   .bfloat16() for _ in range(4))
    ref_out, lse = ops.flash_fwd_ref(q, k, v, True)
    delta = ops.flash_delta(ref_out, do)
    ref_dq = ops.flash_dq_ref(q, k, v, do, lse, delta, True)
    ref_dk, ref_dv = ops.flash_dkv_ref(q, k, v, do, lse, delta, True)
    out, lse_out = torch.empty_like(q), torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    flash_args = dict(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                      dout=do.data_ptr(), lse=lse.data_ptr(),
                      delta=delta.data_ptr(), mask=0, out=out.data_ptr(),
                      dq_out=dq.data_ptr(), dk_out=dk.data_ptr(),
                      dv_out=dv.data_ptr(), B=B, S=S, H=H, D=D, causal=1,
                      scale=1.0 / math.sqrt(D), stream=stream)

    def flash(lib, entry):
        a = dict(flash_args, lse=lse_out.data_ptr()) \
            if entry == "flash_fwd_launch" else flash_args
        return lambda: lib.call(entry, **a)

    if args.parent:
        k2 = {w: flash(libs[f"{w}_flash_attention"], "flash_dq_launch")
              for w in ("parent", "change")}
        for who, fn in k2.items():
            fn()
            torch.cuda.synchronize()
            print(f"K2 {who}: relative error against the plain version "
                  f"{rel(dq, ref_dq):.3e}", flush=True)
        t = B * S * H * D * 2
        k2_chg, k2_par = turns("K2 flash_dq training shape", k2,
                               (5 * t + 2 * B * H * S * 4)
                               / HBM_BYTES_PER_S * 1e3)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        so = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2).contiguous()
        sdpa_bwd = time_ms(lambda: torch.autograd.grad(
            so, (qt, kt, vt), dot, retain_graph=True))
        k3_ms = time_ms(flash(libs["change_flash_attention"],
                              "flash_dkv_launch"))
        print(f"K3 {k3_ms:.4f} ms  SDPA backward {sdpa_bwd:.4f} ms  (K2 + "
              f"K3) / SDPA backward: change {(k2_chg + k3_ms) / sdpa_bwd:.3f}"
              f", parent {(k2_par + k3_ms) / sdpa_bwd:.3f}", flush=True)
        results["K3, SDPA backward"] = (k3_ms, sdpa_bwd)
        del qt, kt, vt, so, dot

    if args.flash_variants:
        names = ["change_flash_attention"] + [
            f"variant_{n}" for n, (s, _) in chosen.items()
            if s == "flash_attention"]
        for name in names + names[::-1]:
            lib = libs[name]
            fns = [flash(lib, e) for e in ("flash_fwd_launch",
                                           "flash_dq_launch",
                                           "flash_dkv_launch")]
            for fn in fns:
                fn()
            torch.cuda.synchronize()
            errs = (rel(out, ref_out), rel(dq, ref_dq), rel(dk, ref_dk),
                    rel(dv, ref_dv))
            ts = [time_ms(fn, 30) for fn in fns]
            results.setdefault("flash variants", []).append((name, ts, errs))
            print(f"{name:28s} K1 {ts[0]:.4f} ms  K2 {ts[1]:.4f} ms  K3 "
                  f"{ts[2]:.4f} ms  relative error out {errs[0]:.2e} dq "
                  f"{errs[1]:.2e} dk {errs[2]:.2e} dv {errs[3]:.2e}",
                  flush=True)
    del q, k, v, do, out, dq, dk, dv, flash_args
    torch.cuda.empty_cache()

    # ---- decode attention
    def decode_case(layout, cache, B, L, curs_list):
        """Inputs and named arguments of one decode shape; the split
        length is the policy's unless the caller passes chunk=."""
        H, KV = LAYOUTS[layout]
        D = 64
        cdt = {"f32": torch.float32}.get(cache, torch.bfloat16)
        x = dict(q=torch.randn(B, H, D, generator=gen, device=dev).to(cdt))
        if cache == "int8":
            for n in ("k", "v"):
                x[n] = torch.randint(-127, 128, (B, KV, L, D), generator=gen,
                                     device=dev, dtype=torch.int8)
                x[n + "s"] = torch.rand(B, KV, L, generator=gen,
                                        device=dev) / 64
        else:
            for n in ("k", "v"):
                x[n] = torch.randn(B, KV, L, D, generator=gen,
                                   device=dev).to(cdt)
        x["cur"] = torch.tensor(curs_list, dtype=torch.int32, device=dev)
        x["out"] = torch.empty_like(x["q"])
        tile = libs["change_decode_attention"].call(
            "decode_tile_rows", cache_dtype=_DTYPE_CODE[cache])
        ws, tickets = ops.decode_workspace(dev, B, KV, -(-L // tile),
                                           H // KV, D)
        named = {n: (t.data_ptr() if t is not None else 0)
                 for n, t in x.items()}
        named.setdefault("ks", 0)
        named.setdefault("vs", 0)
        named.update(ws=ws.data_ptr(), tickets=tickets.data_ptr(), B=B, H=H,
                     KV=KV, L=L, D=D, q_dtype=_DTYPE_CODE[
                         "f32" if cache == "f32" else "bf16"],
                     cache_dtype=_DTYPE_CODE[cache],
                     chunk=ops.decode_split_len(L, B * KV, sms, tile),
                     sm_scale=1.0 / math.sqrt(D), stream=stream)
        positions = sum(c + 1 for c in curs_list)
        elt = {"f32": 4, "bf16": 2, "int8": 1}[cache]
        nbytes = (positions * KV * (2 * D * elt + (8 if cache == "int8"
                                                   else 0))
                  + 2 * B * H * D * (4 if cache == "f32" else 2) + B * 4)
        return x, named, nbytes, tile

    def paged(x, named, ps):
        """K5's pool and named arguments for the logical cache of x:
        B * nblk pages + 1 (page 0 unmapped), a seeded permutation."""
        B, KV, L, D = x["k"].shape
        nblk = L // ps
        NP = B * nblk + 1
        table = (torch.randperm(NP - 1, generator=gen, device=dev) + 1
                 ).reshape(B, nblk).to(torch.int32)
        flat = table.reshape(-1).long()
        pools = {}
        for n in ("k", "v", "ks", "vs"):
            if n not in x:
                continue
            t = x[n]
            pool = torch.zeros((NP, KV, ps) + tuple(t.shape[3:]),
                               dtype=t.dtype, device=dev)
            pool[flat] = t.reshape(B, KV, nblk, ps, *t.shape[3:]).transpose(
                1, 2).reshape(B * nblk, KV, ps, *t.shape[3:])
            pools[n] = pool
        pn = dict(named, pt=table.data_ptr(), NP=NP, ps=ps, nblk=nblk,
                  **{n: p.data_ptr() for n, p in pools.items()})
        return pn, (pools, table)

    def decode_fn(lib, entry, named, **over):
        a = dict(named, **over)
        return lambda: lib.call(entry, **a)

    if args.parent:
        for layout, cache, B, L, cname, page_sizes in DECODE_AB:
            curs = cursor_set(cname, B, L)
            x, named, nbytes, _ = decode_case(layout, cache, B, L, curs)
            tag = f"{layout} {cache} B={B} L={L} {cname}"
            outs = {}
            for who in ("parent", "change"):
                decode_fn(libs[f"{who}_decode_attention"],
                          "decode_attention_launch", named)()
                torch.cuda.synchronize()
                outs[who] = x["out"].clone()
            diff = float((outs["change"].float()
                          - outs["parent"].float()).abs().max())
            print(f"K4 {tag}: cursors {curs}; chunk {named['chunk']}; max "
                  f"|change - parent| {diff:.3e}", flush=True)
            turns(f"K4 {tag}", {w: decode_fn(
                libs[f"{w}_decode_attention"], "decode_attention_launch",
                named) for w in ("parent", "change")},
                nbytes / HBM_BYTES_PER_S * 1e3)
            for ps in page_sizes:
                pn, keep = paged(x, named, ps)
                entries = sum(c // ps + 1 for c in curs)
                turns(f"K5 {tag} pages of {ps}", {w: decode_fn(
                    libs[f"{w}_decode_attention"],
                    "paged_decode_attention_launch", pn)
                    for w in ("parent", "change")},
                    (nbytes + 4 * entries) / HBM_BYTES_PER_S * 1e3)
                del keep
            if (layout, cache, B, L) == ("gpt2-medium", "bf16", 8, 1024):
                k4 = decode_fn(libs["change_decode_attention"],
                               "decode_attention_launch", named)
                kv = torch.ones(nbytes // 2, dtype=torch.bfloat16, device=dev)
                tiny = torch.zeros(1, device=dev)
                yard = {f"{what} {'dirty' if dirty else 'clean'} L2":
                        time_ms(fn, dirty=dirty)
                        for dirty in (True, False)
                        for what, fn in (("one tiny launch", tiny.zero_),
                                         (f"sum over {nbytes} B", kv.sum),
                                         ("K4", k4))}
                results[f"yardsticks {cname}"] = yard
                print(f"yardsticks {cname}: " + ", ".join(
                    f"{k_} {v_:.4f} ms" for k_, v_ in yard.items()),
                    flush=True)
                del kv
            del x

    if args.decode_variants:
        names = ["change_decode_attention"] + [
            f"variant_{n}" for n, (s, _) in chosen.items()
            if s == "decode_attention"]
        for cname in ("serving", "long"):
            curs = cursor_set(cname, 8, 1024)
            x, named, _, _ = decode_case("gpt2-medium", "bf16", 8, 1024, curs)
            for name in names + names[::-1]:
                t = time_ms(decode_fn(libs[name], "decode_attention_launch",
                                      named))
                results.setdefault(f"K4 {cname} variants", []).append(
                    (name, t))
                print(f"K4 {cname} {name:30s} {t:.4f} ms", flush=True)
            del x

    if args.sweep:
        lib = libs["change_decode_attention"]
        ratios = {}
        for layout, cache, B, L in SWEEP:
            for cname in ("serving", "long"):
                curs = cursor_set(cname, B, L)
                x, named, nbytes, tile = decode_case(layout, cache, B, L,
                                                     curs)
                KV = LAYOUTS[layout][1]
                cands = {c: split_len_at(L, B * KV, sms, tile, c)
                         for c in SWEEP_CTAS_PER_SM}
                chunks = sorted({tile * 2**i for i in range(16)
                                 if tile * 2**i < L}
                                | {L, named["chunk"], *cands.values()})
                # each length twice, in mirrored order, and the mean kept
                ts = {c: [] for c in chunks}
                for c in chunks + chunks[::-1]:
                    ts[c].append(time_ms(decode_fn(
                        lib, "decode_attention_launch", named, chunk=c), 30))
                ts = {c: float(np.mean(t)) for c, t in ts.items()}
                tag = f"{layout} {cache} B={B} BKV={B * KV} L={L} {cname}"
                t_best = min(ts.values())
                for c, ch in cands.items():
                    ratios.setdefault((c, cname), []).append(ts[ch] / t_best)
                results[f"sweep {tag}"] = dict(policy=named["chunk"],
                                               by_ctas_per_sm=cands,
                                               bound_ms=nbytes
                                               / HBM_BYTES_PER_S * 1e3,
                                               ms=ts)
                best = min(ts, key=ts.get)
                print(f"sweep {tag}: policy {named['chunk']} "
                      f"({ts[named['chunk']]:.4f} ms), "
                      f"best {best} ({ts[best]:.4f} ms), bound "
                      f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms | "
                      + ", ".join(f"{c}: {t:.4f}" for c, t in ts.items()),
                      flush=True)
                del x
        for (c, cname), r in sorted(ratios.items()):
            print(f"sweep: aiming at {c} CTAs an SM, {cname} cursors: time "
                  f"over the best split length, geometric mean "
                  f"{float(np.exp(np.mean(np.log(r)))):.3f}, worst "
                  f"{max(r):.3f} over {len(r)} shapes", flush=True)
            results[f"sweep summary {c} CTAs an SM {cname}"] = r
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {k_: v_ for k_, v_ in results.items()}, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
