"""Attention on Hopper: the decode kernels K4 and K5 of the serving path
and the flash-attention kernels K1-K3 of the training path.

Decode — the counterparts of `mpi_operator_tpu/ops/attention.py::
decode_attention` and `paged_decode_attention`, and of their one Pallas
`_decode_kernel`. One call attends each row's query heads against that
row's filled cache prefix:

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
[B, H, L, D] cache never exists. The kernel splits each row's positions
over CTAs (`decode_split_len`, from L, B·KV and the SM count, never the
cursors) and combines the splits in the same launch through a workspace
cached per device (`decode_workspace`).

Flash attention — the counterpart of `flash_attention` and of its three
Pallas kernels, reached through the `_flash_core` custom_vjp: K1
`_fwd_kernel` (`flash_fwd`), K2 `_dq_kernel` (`flash_dq`) and K3
`_dkv_kernel` (`flash_dkv`). `flash_attention(q, k, v, causal, mask)`
takes the reference's public layout:

  q, k, v      [B, S, H, D]      equal head counts (a GQA model repeats
                                 K/V first, as the reference does)
  mask         [B, S] or None    key-padding mask, > 0 = attend
  lse, delta   [B, H, S] f32     the softmax statistics the backward
                                 kernels take as explicit operands

and is a `torch.autograd.Function` that saves only q, k, v, out, lse and
the mask, as the custom_vjp does. The backward's delta = rowsum(dO * O)
is one PyTorch reduction, as it is plain jnp in the reference.

Two implementations of each function live here:

- the hand-written CUDA kernel (`csrc/decode_attention.cu`: K4 and K5,
  one kernel body over two address policies; `csrc/flash_attention.cu`:
  K1-K3 warp-specialised with TMA and wgmma),
  built with `nvcc` for sm_90a at first use and bound with ctypes, which
  the wrapper launches for every CUDA tensor — or raises: a CUDA tensor
  never takes another path;
- the plain PyTorch version of the same arithmetic (`*_ref`), which the
  wrapper runs for a CPU tensor (the CPU tests) and which chip_smoke.py
  holds the kernel against on the card. The paged one gathers the pool
  through the table into the contiguous layout and runs K4's.

`launch_counts[name]` counts kernel launches (and nothing else), so a
run can show that its decode steps and its training steps went through
the kernels. A wrapper counts on the host as it launches; a CUDA graph
that holds launches adds them again at each replay and takes back what
its capture counted, since a capture launches nothing
(serve/programs.py).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

NEG_INF = -1e30

#: kernel launches per wrapper since the last reset_launch_counts()
launch_counts: Dict[str, int] = {"decode_attention": 0,
                                 "paged_decode_attention": 0,
                                 "flash_fwd": 0, "flash_dq": 0,
                                 "flash_dkv": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_GROUP = 8          # query heads per kv head the kernel holds
_MAX_HEAD_DIM = 128
#: the decode split aims at this many CTAs an SM over the whole cache,
#: and gives a split at least DECODE_MIN_SPLIT_TILES tiles, or
#: DECODE_TILES_PER_COVER tiles for each CTA an SM that the unsplit grid
#: already has if that is more (chosen by `scripts/kernel_ab.py --sweep`
#: on an H100, PERF.md)
DECODE_CTAS_PER_SM = 2
DECODE_MIN_SPLIT_TILES = 2
DECODE_TILES_PER_COVER = 8


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def decode_block_k(max_len: int, block_k: Optional[int] = None) -> int:
    """The k-tile of the reference's Pallas decode kernel for a cache of
    `max_len` positions. Kept for parity with the reference API; the
    CUDA kernel picks its own tile (`decode_tile`) and takes any cache
    length, so nothing in the port gates on it."""
    return min(block_k or 128, max_len)


_tile_rows: Dict[torch.dtype, int] = {}


def decode_tile(cache_dtype: torch.dtype) -> int:
    """Rows of one tile of the decode kernel for a cache dtype, as the
    kernel library reports it (`decode_tile_rows` in
    decode_attention.cu, which owns the number): a split length is a
    multiple of it. Loads (and at first use builds) the library."""
    if cache_dtype not in _tile_rows:
        from ._build import load
        fn = load("decode_attention").decode_tile_rows
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        rows = fn(_DTYPE_CODE.get(cache_dtype, -1))
        if rows < 1:
            raise TypeError(f"the decode kernel takes no {cache_dtype} "
                            f"cache")
        _tile_rows[cache_dtype] = rows
    return _tile_rows[cache_dtype]


def decode_split_len(L: int, bkv: int, sms: int, tile: int) -> int:
    """The decode kernel's split length in positions, a multiple of
    `tile`: positions [s * len, (s + 1) * len) of a row go to split s.
    It depends on the logical cache length `L`, the (batch row, kv head)
    pairs `bkv` and the card's SM count only, never on the cursors (they
    may live on the device, and reading them would sync the host).

    The split is there to fill the card: with few (row, kv head) pairs
    one CTA each leaves most SMs idle and each walks its whole cache
    alone. So the splits are as many as give DECODE_CTAS_PER_SM CTAs an
    SM, but no split gets fewer than `decode_min_split_tiles` tiles:
    the combine costs about as much as walking a few tiles, and the more
    of the card the unsplit grid already covers, the less a split adds.
    The tiles are shared out evenly. A row whose cursor ends early
    leaves its later splits idle, and they exit at once."""
    if min(L, bkv, sms, tile) < 1:
        raise ValueError(f"decode_split_len: L={L}, bkv={bkv}, sms={sms}, "
                         f"tile={tile} must all be >= 1")
    n_tiles = -(-L // tile)
    splits = max(1, min(-(-DECODE_CTAS_PER_SM * sms // bkv),
                        n_tiles // decode_min_split_tiles(bkv, sms)))
    return -(-n_tiles // splits) * tile


def decode_min_split_tiles(bkv: int, sms: int) -> int:
    """The fewest tiles `decode_split_len` gives a split when it splits:
    DECODE_MIN_SPLIT_TILES, or DECODE_TILES_PER_COVER for each CTA an SM
    the unsplit grid (`bkv` CTAs over `sms` SMs) already has."""
    return max(DECODE_MIN_SPLIT_TILES,
               -(-DECODE_TILES_PER_COVER * bkv // sms))


_sm_counts: Dict[int, int] = {}
_workspaces: Dict[int, tuple] = {}


def _device_index(device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def _sm_count(device) -> int:
    idx = _device_index(device)
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def decode_workspace(device, B: int, KV: int, splits: int, G: int,
                     D: int):
    """(partials, tickets) of the decode kernel on `device`: f32 room for
    B * KV * splits * G * (D + 2) values and B * KV int32 tickets, zero
    at first. One pair a device, cached and grown only when a larger
    shape arrives, so its addresses stay fixed from one decode step to
    the next (what a CUDA graph of the step needs). The kernel leaves the
    tickets at 0 after every launch; launches that share the workspace
    run in order on one stream.

    Growing it inside a CUDA graph capture raises: the new pair would be
    zeroed only when the graph replays. A graph holds the pair it
    captured (`current_workspace`), so a later, larger launch that grows
    the cache's pair leaves the graph's own pair alive."""
    idx = _device_index(device)
    n_part, n_tick = B * KV * splits * G * (D + 2), B * KV
    ws = _workspaces.get(idx)
    if ws is None or ws[0].numel() < n_part or ws[1].numel() < n_tick:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "decode_workspace: a launch inside a CUDA graph capture "
                "needs a larger workspace; run the same launch eagerly "
                "before capturing it")
        old = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = (torch.zeros(max(n_part, old[0]), dtype=torch.float32,
                          device=device),
              torch.zeros(max(n_tick, old[1]), dtype=torch.int32,
                          device=device))
        _workspaces[idx] = ws
    return ws


def current_workspace(device) -> Optional[tuple]:
    """The decode workspace pair `device` has now (None before its first
    decode launch): what a CUDA graph captured over it keeps alive."""
    if device.type != "cuda":
        return None
    return _workspaces.get(_device_index(device))


def _decode_plan(q, L, B, KV, H, D, cache_dtype):
    """(chunk, partials, tickets) of one decode launch."""
    tile = decode_tile(cache_dtype)
    chunk = decode_split_len(L, B * KV, _sm_count(q.device), tile)
    splits = -(-L // chunk)
    ws, tickets = decode_workspace(q.device, B, KV, splits, H // KV, D)
    return chunk, ws, tickets


def _cursors(cache_index, B: int, device) -> torch.Tensor:
    """Scalar or [B] cursor → int32 [B] on `device`. Inside a CUDA graph
    capture the cursor must already live on `device`: a host value would
    be a host-to-device copy frozen into the graph."""
    on_device = (isinstance(cache_index, torch.Tensor)
                 and cache_index.device == device)
    if (device.type == "cuda" and not on_device
            and torch.cuda.is_current_stream_capturing()):
        raise ValueError("cache_index must be a tensor on the device "
                         "inside a CUDA graph capture")
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


def _entry(name: str, n_ptr: int, n_int: int,
           library: str = "decode_attention", scale: bool = True):
    """The C entry point `name` of a kernel library, its argument types
    set: `n_ptr` tensor pointers, `n_int` ints, then the softmax scale
    (unless `scale` is False) and the stream."""
    from ._build import load
    fn = getattr(load(library), name)
    if fn.argtypes is None:
        P = ctypes.c_void_p
        fn.argtypes = ([P] * n_ptr + [ctypes.c_int] * n_int
                       + ([ctypes.c_float] if scale else []) + [P])
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
    chunk, ws, tickets = _decode_plan(q, L, B, KV, H, D, k_cache.dtype)
    null = 0
    rc = _entry("decode_attention_launch", 9, 8)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quantized else null,
        v_scale.data_ptr() if quantized else null,
        cur.data_ptr(), out.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
        B, H, KV, L, D, _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype],
        chunk, 1.0 / math.sqrt(D),
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
    chunk, ws, tickets = _decode_plan(q, nblk * ps, B, KV, H, D,
                                      k_pages.dtype)
    null = 0
    rc = _entry("paged_decode_attention_launch", 10, 10)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else null,
        v_scale.data_ptr() if quantized else null,
        cur.data_ptr(), page_table.data_ptr(), out.data_ptr(),
        ws.data_ptr(), tickets.data_ptr(),
        B, H, KV, NP, ps, nblk, D,
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype],
        chunk, 1.0 / math.sqrt(D),
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


# ---------------------------------------------------------------------------
# flash attention (training): K1 forward, K2 dq, K3 dk/dv
# ---------------------------------------------------------------------------

_FLASH_LIB = "flash_attention"
_ENCODE_FAILED = -2      # flash_attention.cu's code for a refused TMA map


def _check_flash_shapes(q, k, v, mask):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must be [B, S, H, D] of one shape "
                         f"(a GQA model repeats K/V first); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S = q.shape[:2]
    if S < 1:
        raise ValueError("flash attention needs S >= 1")
    if mask is not None and tuple(mask.shape) != (B, S):
        raise ValueError(f"mask must be [B, S]={(B, S)}, got "
                         f"{tuple(mask.shape)}")


def _visible(S: int, causal: bool, mask, device) -> Optional[torch.Tensor]:
    """[B or 1, 1, S, S] bool: query i may attend key j (None: all)."""
    vis = None
    if causal:
        idx = torch.arange(S, device=device)
        vis = (idx[:, None] >= idx[None, :])[None, None]
    if mask is not None:
        keys = (mask > 0)[:, None, None, :]
        vis = keys if vis is None else vis & keys
    return vis


def _scores(q, k):
    """f32 scores [B, H, S, S] times 1/sqrt(D): bf16 products are exact
    in f32, so this is the kernels' f32-accumulated dot product."""
    D = q.shape[-1]
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(D))


def _recomputed_p(q, k, lse, causal, mask):
    """p = exp(s - lse), re-masked explicitly (`_masked_p` of the
    reference): 0 wherever the key is masked, whatever the row's lse."""
    s = _scores(q, k)
    keep = s > NEG_INF / 2
    vis = _visible(q.shape[1], causal, mask, q.device)
    if vis is not None:
        keep = keep & vis
    return torch.where(keep, torch.exp(s - lse[..., None]), 0.0), s


def flash_fwd_ref(q, k, v, causal: bool = True, mask=None):
    """The plain PyTorch version of K1: f32 scores times 1/sqrt(D),
    masked keys at -1e30, softmax over the row (the kernel's online
    softmax over one tile), p rounded to v's dtype before p.v while l
    sums the unrounded p, l clamped at 1e-30, lse = m + log(l).
    Returns (out [B, S, H, D] in q's dtype, lse [B, H, S] f32)."""
    _check_flash_shapes(q, k, v, mask)
    s = _scores(q, k)
    vis = _visible(q.shape[1], causal, mask, q.device)
    if vis is not None:
        s = torch.where(vis, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    out = (acc / l).transpose(1, 2).to(q.dtype)
    return out, (m + torch.log(l))[..., 0]


def flash_dq_ref(q, k, v, do, lse, delta, causal: bool = True, mask=None):
    """The plain PyTorch version of K2: p recomputed from lse (re-masked),
    dp = do.v^T in f32, ds = p*(dp - delta)*scale rounded to k's dtype,
    dq = ds.k accumulated in f32, returned in q's dtype."""
    _check_flash_shapes(q, k, v, mask)
    p, _ = _recomputed_p(q, k, lse, causal, mask)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * (1.0 / math.sqrt(q.shape[-1]))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def flash_dkv_ref(q, k, v, do, lse, delta, causal: bool = True, mask=None):
    """The plain PyTorch version of K3: dv = p^T.do with p unrounded in
    f32 (the reference casts do to f32), dk = ds^T.q with ds rounded to
    q's dtype; both accumulated in f32. Returns (dk, dv) in k's and v's
    dtypes."""
    _check_flash_shapes(q, k, v, mask)
    p, _ = _recomputed_p(q, k, lse, causal, mask)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * (1.0 / math.sqrt(q.shape[-1]))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _mask_u8(mask, device) -> Optional[torch.Tensor]:
    """The [B, S] key mask as the kernels read it: uint8, 1 = attend."""
    if mask is None:
        return None
    return (mask > 0).to(device=device, dtype=torch.uint8).contiguous()


def _check_flash_launchable(name, tensors, stats):
    """What the flash kernels take, checked on the host: bf16 [B, S, H,
    D] tensors and f32 [B, H, S] statistics, all contiguous, 16-byte
    aligned and on one device; D a multiple of 16 up to 128."""
    q = tensors[0]
    B, S, H, D = q.shape
    for t in list(tensors) + list(stats):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors "
                             f"only")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned "
                             f"(16-byte vector loads)")
    for t in tensors:
        if t.dtype != torch.bfloat16 or tuple(t.shape) != (B, S, H, D):
            raise TypeError(f"{name}: the kernel takes bf16 [B, S, H, D] "
                            f"tensors; got {t.dtype} {tuple(t.shape)}")
    for t in stats:
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, S):
            raise TypeError(f"{name}: lse and delta must be f32 [B, H, S]"
                            f"={(B, H, S)}; got {t.dtype} "
                            f"{tuple(t.shape)}")
    if D % 16 or not 16 <= D <= _MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D}; the kernel takes "
                         f"multiples of 16 up to {_MAX_HEAD_DIM}")
    if B > 65535 or H > 65535:
        raise ValueError(f"{name}: B={B} and H={H} must be <= 65535")


def _flash_call(name, entry, n_ptr, ptrs, q, causal):
    B, S, H, D = q.shape
    rc = _entry(entry, n_ptr, 5, _FLASH_LIB)(
        *ptrs, B, S, H, D, int(bool(causal)), 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        why = ": the driver refused a TMA map" if rc == _ENCODE_FAILED else ""
        raise RuntimeError(f"{name} kernel launch failed (code {rc}{why})")
    launch_counts[name] += 1


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _on_card(q, fn) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{fn}: unsupported device {q.device}")
    return q.device.type == "cuda"


def flash_fwd(q, k, v, causal: bool = True, mask=None):
    """K1: (out [B, S, H, D], lse [B, H, S] f32). A CUDA `q` launches the
    kernel or raises; a CPU `q` runs `flash_fwd_ref`."""
    if not _on_card(q, "flash_fwd"):
        return flash_fwd_ref(q, k, v, causal, mask)
    _check_flash_shapes(q, k, v, mask)
    _check_flash_launchable("flash_fwd", (q, k, v), ())
    m8 = _mask_u8(mask, q.device)
    B, S, H, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _flash_call("flash_fwd", "flash_fwd_launch", 6,
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(m8),
                 out.data_ptr(), lse.data_ptr()), q, causal)
    return out, lse


def flash_dq(q, k, v, do, lse, delta, causal: bool = True, mask=None):
    """K2: dq [B, S, H, D]. A CUDA `q` launches the kernel or raises; a
    CPU `q` runs `flash_dq_ref`."""
    if not _on_card(q, "flash_dq"):
        return flash_dq_ref(q, k, v, do, lse, delta, causal, mask)
    _check_flash_shapes(q, k, v, mask)
    _check_flash_launchable("flash_dq", (q, k, v, do), (lse, delta))
    m8 = _mask_u8(mask, q.device)
    dq = torch.empty_like(q)
    _flash_call("flash_dq", "flash_dq_launch", 8,
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), _ptr(m8), dq.data_ptr()),
                q, causal)
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal: bool = True, mask=None):
    """K3: (dk, dv) [B, S, H, D]. A CUDA `q` launches the kernel or
    raises; a CPU `q` runs `flash_dkv_ref`."""
    if not _on_card(q, "flash_dkv"):
        return flash_dkv_ref(q, k, v, do, lse, delta, causal, mask)
    _check_flash_shapes(q, k, v, mask)
    _check_flash_launchable("flash_dkv", (q, k, v, do), (lse, delta))
    m8 = _mask_u8(mask, q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _flash_call("flash_dkv", "flash_dkv_launch", 9,
                (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), _ptr(m8), dk.data_ptr(),
                 dv.data_ptr()), q, causal)
    return dk, dv


def wgmma_probe(q, k, v):
    """The layout probe built beside K1 and K3 (no training or serving
    path calls it): one warpgroup loads q [1, 64, 1, D] and k, v [1, BK,
    1, D] bf16 (BK = 128 for D <= 64, 64 above) through K1's TMA maps,
    computes s = q.k^T with both operands K-major and o = bf16(s).v with
    v MN-major through K1's wgmma wrappers, and returns (s [64, BK], o
    [64, D]) in f32. The cuda tests hold both against torch.matmul."""
    D = q.shape[-1]
    bk = 128 if D <= 64 else 64
    if (tuple(q.shape) != (1, 64, 1, D) or tuple(k.shape) != (1, bk, 1, D)
            or v.shape != k.shape):
        raise ValueError(f"wgmma_probe: q [1, 64, 1, D] and k, v [1, {bk}, "
                         f"1, D]; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _check_flash_launchable("wgmma_probe", (q,), ())
    _check_flash_launchable("wgmma_probe", (k, v), ())
    pd = 64 if D <= 64 else 128
    s = torch.empty((64, bk), dtype=torch.float32, device=q.device)
    o = torch.empty((64, pd), dtype=torch.float32, device=q.device)
    rc = _entry("flash_wgmma_probe_launch", 5, 1, _FLASH_LIB,
                scale=False)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(),
        o.data_ptr(), D, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wgmma_probe kernel launch failed (code {rc})")
    return s, o[:, :D]


def flash_delta(out, do):
    """delta = rowsum(dO * O) in f32, as [B, H, S] (the backward's
    prologue; plain jnp in the reference, one reduction here)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class FlashAttention(torch.autograd.Function):
    """The `_flash_core` custom_vjp: forward through K1, backward
    through K2 and K3 with delta = rowsum(dO * O). Saves q, k, v, out,
    lse and the mask, nothing else."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        mask = _mask_u8(mask, q.device)          # converted once, saved
        out, lse = flash_fwd(q, k, v, causal, mask)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse, mask)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, mask = ctx.saved_tensors
        do = do.contiguous()
        delta = flash_delta(out, do)
        dq = flash_dq(q, k, v, do, lse, delta, ctx.causal, mask)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, ctx.causal, mask)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, mask=None):
    """Flash attention over [B, S, H, D] (the reference's layout), with
    gradients through K2/K3. `mask`: optional [B, S] key mask (> 0 =
    attend). Any S >= 1: the kernels mask the ragged tail themselves,
    with no dense fallback. A row whose keys are all masked gets the
    mean of v (the reference's online softmax) and no gradient (the
    backward re-masks p). Returns [B, S, H, D] in q's dtype."""
    _check_flash_shapes(q, k, v, mask)
    return FlashAttention.apply(q, k, v, mask, causal)


__all__ = ["DECODE_CTAS_PER_SM", "DECODE_MIN_SPLIT_TILES",
           "DECODE_TILES_PER_COVER", "FlashAttention", "decode_attention",
           "current_workspace", "decode_attention_ref", "decode_block_k",
           "decode_min_split_tiles", "decode_split_len", "decode_tile",
           "decode_workspace", "flash_attention", "flash_delta", "flash_dkv",
           "flash_dkv_ref", "flash_dq", "flash_dq_ref", "flash_fwd",
           "flash_fwd_ref", "gather_pages", "launch_counts",
           "paged_decode_attention", "paged_decode_attention_ref",
           "reset_launch_counts", "wgmma_probe"]
