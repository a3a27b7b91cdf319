"""Decode attention — the single-query KV-cache step, on Hopper: K4 over
a contiguous cache and K5 over a page pool.

The counterparts of `mpi_operator_tpu/ops/attention.py::decode_attention`
and `paged_decode_attention`, and of their one Pallas `_decode_kernel`.
One call attends each row's query heads against that row's filled cache
prefix:

  q            [B, H, D]         this step's queries (RoPE applied)
  cache_index  scalar or [B]     row b attends positions <= its cursor
  K4, `decode_attention`:
  k/v cache    [B, KV, L, D]     kv-head-major; bf16/f32, or int8 with
  k/v scale    [B, KV, L]        f32 per-(position, kv-head) scales
  K5, `paged_decode_attention`:
  k/v pages    [NP, KV, ps, D]   a pool of NP pages of ps positions
  k/v scale    [NP, KV, ps]      f32 scales of an int8 pool
  page_table   int32 [B, nblk]   logical position t of row b lives in
                                 page page_table[b, t // ps], slot t % ps

Query head h reads kv head h // (H // KV) — GQA is native, the repeated
[B, H, L, D] cache never exists.

Two implementations of each function live here:

- the hand-written CUDA kernel (`csrc/decode_attention.cu`: one kernel
  body, two address policies, built with `nvcc` for sm_90a at first use,
  bound with ctypes), which the wrapper launches for every CUDA tensor —
  or raises: a CUDA tensor never takes another path;
- the plain PyTorch version of the same arithmetic (`*_ref`), which the
  wrapper runs for a CPU tensor (the CPU tests) and which chip_smoke.py
  holds the kernel against on the card. The paged one gathers the pool
  through the table into the contiguous layout and runs K4's.

`launch_counts[name]` counts kernel launches (and nothing else), so a
run can show that its decode steps went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

NEG_INF = -1e30

#: kernel launches per wrapper since the last reset_launch_counts()
launch_counts: Dict[str, int] = {"decode_attention": 0,
                                 "paged_decode_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_GROUP = 8          # query heads per kv head the kernel holds
_MAX_HEAD_DIM = 128


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def decode_block_k(max_len: int, block_k: Optional[int] = None) -> int:
    """The k-tile of the reference's Pallas decode kernel for a cache of
    `max_len` positions. Kept for parity with the reference API; the
    CUDA kernel picks its own tile (64 rows for bf16, 32 for f32) and
    takes any cache length, so nothing in the port gates on it."""
    return min(block_k or 128, max_len)


def _cursors(cache_index, B: int, device) -> torch.Tensor:
    """Scalar or [B] cursor → int32 [B] on `device`."""
    cur = torch.as_tensor(cache_index, dtype=torch.int32, device=device)
    if cur.ndim == 0:
        return cur.reshape(1).expand(B).contiguous()
    if tuple(cur.shape) != (B,):
        raise ValueError(f"cache_index must be scalar or [B]={B}, got "
                         f"shape {tuple(cur.shape)}")
    return cur.contiguous()


def _check_shapes(q, k_cache, v_cache, k_scale, v_scale):
    if q.ndim != 3 or k_cache.ndim != 4:
        raise ValueError(f"q must be [B, H, D] and the cache [B, KV, L, D]; "
                         f"got {tuple(q.shape)} and {tuple(k_cache.shape)}")
    B, H, D = q.shape
    Bk, KV, L, Dk = k_cache.shape
    if (Bk, Dk) != (B, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if H % KV:
        raise ValueError(f"H={H} must be a multiple of KV={KV}")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("k_scale and v_scale come together")
    if quantized:
        if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
            raise ValueError("scales given but the cache is not int8")
        for s in (k_scale, v_scale):
            if tuple(s.shape) != (B, KV, L):
                raise ValueError(f"scales must be [B, KV, L]={(B, KV, L)}, "
                                 f"got {tuple(s.shape)}")
    elif k_cache.dtype == torch.int8:
        raise ValueError("an int8 cache needs k_scale and v_scale")
    return B, H, KV, L, D, quantized


def decode_attention_ref(q, k_cache, v_cache, cache_index,
                         k_scale=None, v_scale=None):
    """The plain PyTorch version of the kernel's function: dequantize
    cast-then-scale in the compute dtype, f32 scores scaled by 1/sqrt(D),
    columns past each row's cursor masked with -1e30, f32 softmax whose
    probabilities are rounded to the value dtype before the p.v product,
    output divided by max(l, 1e-30) and cast to q's dtype."""
    B, H, KV, L, D, quantized = _check_shapes(q, k_cache, v_cache,
                                              k_scale, v_scale)
    G = H // KV
    dt = q.dtype
    cur = _cursors(cache_index, B, q.device).long()
    if quantized:
        k = k_cache.to(dt) * k_scale[..., None].to(dt)
        v = v_cache.to(dt) * v_scale[..., None].to(dt)
    else:
        k, v = k_cache, v_cache
    q4 = q.reshape(B, KV, G, D).float()
    s = torch.einsum("bhgd,bhld->bhgl", q4, k.float()) * (1.0 / math.sqrt(D))
    visible = torch.arange(L, device=q.device)[None, :] <= cur[:, None]
    s = torch.where(visible[:, None, None, :], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhgl,bhld->bhgd", p.to(v.dtype).float(), v.float())
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(dt).reshape(B, H, D)


def _entry(name: str, n_ptr: int, n_int: int):
    """The C entry point `name` of the kernel library, its argument
    types set: `n_ptr` tensor pointers, `n_int` ints, then the softmax
    scale and the stream."""
    from ._build import load
    fn = getattr(load("decode_attention"), name)
    if fn.argtypes is None:
        P = ctypes.c_void_p
        fn.argtypes = ([P] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float, P])
        fn.restype = ctypes.c_int
    return fn


def _check_launchable(name, q, tensors, cache_dtype, quantized, scales,
                      H, KV, D):
    """What the kernel takes, checked on the host: one device, contiguous
    16-byte-aligned tensors, the dtype pairs it was built for, G <= 8 and
    D a multiple of 16 up to 128."""
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors "
                             f"only")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned "
                             f"(16-byte vector loads)")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: q dtype {q.dtype}; the kernel computes in "
                        f"bf16 or f32")
    if not quantized and cache_dtype != q.dtype:
        raise TypeError(f"{name}: cache dtype {cache_dtype} must match q "
                        f"({q.dtype}) or be int8")
    if quantized and any(s.dtype != torch.float32 for s in scales):
        raise TypeError(f"{name}: int8 scales must be float32")
    if H // KV > _MAX_GROUP:
        raise ValueError(f"{name}: {H // KV} query heads per kv head; the "
                         f"kernel holds at most {_MAX_GROUP}")
    if D % 16 or not 16 <= D <= _MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D}; the kernel takes "
                         f"multiples of 16 up to {_MAX_HEAD_DIM}")


def _launch(q, k_cache, v_cache, cur, k_scale, v_scale):
    B, H, KV, L, D, quantized = _check_shapes(q, k_cache, v_cache,
                                              k_scale, v_scale)
    scales = [k_scale, v_scale] if quantized else []
    _check_launchable("decode_attention", q,
                      [q, k_cache, v_cache, cur] + scales, k_cache.dtype,
                      quantized, scales, H, KV, D)
    out = torch.empty_like(q)
    null = 0
    rc = _entry("decode_attention_launch", 7, 7)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quantized else null,
        v_scale.data_ptr() if quantized else null,
        cur.data_ptr(), out.data_ptr(), B, H, KV, L, D,
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype],
        1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed "
                           f"(code {rc})")
    launch_counts["decode_attention"] += 1
    return out


def decode_attention(q, k_cache, v_cache, cache_index,
                     k_scale=None, v_scale=None):
    """Single-step KV-cache attention (see the module docstring for the
    shapes). A CUDA `q` launches the hand-written kernel or raises; a CPU
    `q` runs `decode_attention_ref`. Returns [B, H, D] in q's dtype."""
    if q.device.type == "cuda":
        cur = _cursors(cache_index, q.shape[0], q.device)
        return _launch(q, k_cache, v_cache, cur, k_scale, v_scale)
    if q.device.type != "cpu":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return decode_attention_ref(q, k_cache, v_cache, cache_index,
                                k_scale, v_scale)


def _check_paged_shapes(q, k_pages, v_pages, page_table, k_scale,
                        v_scale):
    if q.ndim != 3 or k_pages.ndim != 4:
        raise ValueError(f"q must be [B, H, D] and the pool [NP, KV, ps, "
                         f"D]; got {tuple(q.shape)} and "
                         f"{tuple(k_pages.shape)}")
    B, H, D = q.shape
    NP, KV, ps, Dk = k_pages.shape
    if Dk != D or v_pages.shape != k_pages.shape:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if H % KV:
        raise ValueError(f"H={H} must be a multiple of KV={KV}")
    if (not isinstance(page_table, torch.Tensor) or page_table.ndim != 2
            or page_table.shape[0] != B or page_table.shape[1] < 1):
        raise ValueError(f"page_table must be [B={B}, nblk], got "
                         f"{getattr(page_table, 'shape', page_table)}")
    if page_table.dtype != torch.int32:
        raise TypeError(f"page_table must be int32, got {page_table.dtype}")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("k_scale and v_scale come together")
    if quantized:
        if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
            raise ValueError("scales given but the pool is not int8")
        for s in (k_scale, v_scale):
            if tuple(s.shape) != (NP, KV, ps):
                raise ValueError(f"scales must be [NP, KV, ps]="
                                 f"{(NP, KV, ps)}, got {tuple(s.shape)}")
    elif k_pages.dtype == torch.int8:
        raise ValueError("an int8 pool needs k_scale and v_scale")
    return B, H, KV, NP, ps, page_table.shape[1], D, quantized


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor):
    """[NP, KV, ps(, D)] pool -> the logical [B, KV, nblk*ps(, D)] cache
    of each row of the [B, nblk] table."""
    g = pool[page_table.long()]                 # [B, nblk, KV, ps(, D)]
    B, nblk, KV, ps = g.shape[:4]
    return g.transpose(1, 2).reshape(B, KV, nblk * ps, *g.shape[4:])


def paged_decode_attention_ref(q, k_pages, v_pages, cache_index,
                               page_table, k_scale=None, v_scale=None):
    """The plain PyTorch version of K5: gather the pool through the table
    into the logical [B, KV, L, D] / [B, KV, L] layout (L = nblk * ps),
    then `decode_attention_ref`'s arithmetic."""
    _check_paged_shapes(q, k_pages, v_pages, page_table, k_scale, v_scale)
    gs = [None if s is None else gather_pages(s, page_table)
          for s in (k_scale, v_scale)]
    return decode_attention_ref(q, gather_pages(k_pages, page_table),
                                gather_pages(v_pages, page_table),
                                cache_index, *gs)


def _launch_paged(q, k_pages, v_pages, cur, page_table, k_scale, v_scale):
    B, H, KV, NP, ps, nblk, D, quantized = _check_paged_shapes(
        q, k_pages, v_pages, page_table, k_scale, v_scale)
    if nblk * ps >= 2**31:
        raise ValueError(f"paged_decode_attention: logical length "
                         f"{nblk * ps} does not fit in 32 bits")
    scales = [k_scale, v_scale] if quantized else []
    _check_launchable("paged_decode_attention", q,
                      [q, k_pages, v_pages, cur, page_table] + scales,
                      k_pages.dtype, quantized, scales, H, KV, D)
    out = torch.empty_like(q)
    null = 0
    rc = _entry("paged_decode_attention_launch", 8, 9)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else null,
        v_scale.data_ptr() if quantized else null,
        cur.data_ptr(), page_table.data_ptr(), out.data_ptr(),
        B, H, KV, NP, ps, nblk, D,
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype],
        1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed "
                           f"(code {rc})")
    launch_counts["paged_decode_attention"] += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, cache_index, page_table,
                           k_scale=None, v_scale=None):
    """Single-step attention over a paged cache (see the module docstring
    for the shapes). A CUDA `q` launches the hand-written kernel or
    raises; a CPU `q` runs `paged_decode_attention_ref`. Table entries
    past a row's cursor are never read; the others must name pages of the
    pool (the kernel gives NaN for a row that names one outside it).
    Returns [B, H, D] in q's dtype."""
    if q.device.type == "cuda":
        cur = _cursors(cache_index, q.shape[0], q.device)
        return _launch_paged(q, k_pages, v_pages, cur, page_table,
                             k_scale, v_scale)
    if q.device.type != "cpu":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    return paged_decode_attention_ref(q, k_pages, v_pages, cache_index,
                                      page_table, k_scale, v_scale)


__all__ = ["decode_attention", "decode_attention_ref", "decode_block_k",
           "gather_pages", "launch_counts", "paged_decode_attention",
           "paged_decode_attention_ref", "reset_launch_counts"]
