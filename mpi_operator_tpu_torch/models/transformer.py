"""The Transformer LM in PyTorch: the decode path and the training forward.

The counterpart of `mpi_operator_tpu/models/transformer.py` for what the
serving and training slices run: the GPT-2 / Llama config ladder
(`gpt2_config`, `llama_config`, `create_lm`), RoPE, LayerNorm/RMSNorm,
the gelu and SwiGLU FFNs, and `Attention` in two modes.

Training forward (`CausalLM(tokens)`: no positions, no cache): the
reference's `decode=False` path. Positions are arange(S), RoPE rotates
q and k at them, GQA repeats K/V across each query group
(`repeat_interleave`, the reference's `jnp.repeat` on the head axis),
and `attend` runs flash attention (K1-K3, ops/attention.py) or the
dense O(S^2) path per `TransformerConfig.attention`. No cache is
allocated or written. The tied head is `TiedHead`, whose backward has
the reference's `_head_matmul_bwd` rounding.

Decode mode (every call with `positions`): the dense path for prefill
chunks (and for `decode_kernel=False`), the CUDA decode kernels for
single-token steps: K4 over the contiguous cache, K5 over the paged one.
A decode-mode call takes explicit per-row positions ([B, S] absolute
offsets), writes its K/V into the cache at those positions, and attends
each query to cache positions <= its own. The lockstep `generate()`
passes the same positions for every row, the serving engine passes each
slot's own cursor. The cache is kv-head-major
[B, KV, L, D] (int8 caches carry [B, KV, L] f32 scales) and is updated
IN PLACE — the reference donates its cache buffers to the jitted step
for the same effect, one live copy of the biggest allocation.

The serving engine's paged mode swaps the per-row cache for a global
POOL of fixed-size pages, [NP, KV, ps, D] per layer (`PagedKVCache`),
and passes each call `pages`, the [B, max_len // ps] table of physical
pages behind each row's logical blocks. A write of position t lands in
page table[b, t // ps] at slot t % ps; page 0 is the trash page that
unallocated entries point at. Positions >= max_len are DROPPED — the
reference sends them to an out-of-range page id and its scatter drops
them; a torch scatter would raise instead. A clamp, as the contiguous
single-token write does, could land inside a SHARED prefix page. Reads
gather the pool back into the logical layout (dense path) or go through
K5.

Decode mode has two forms with one body (`_decode`). `forward` takes
host positions and host page tables (generate(), direct calls) and
drops positions >= max_len on the host (`page_index`, `_write`).
`forward_device` is the form the serving engine's programs run
(serve/programs.py, CUDA graphs on the card): positions and page tables
are device tensors, every shape is fixed by the call's shape, and no
branch reads position data. It sends a paged write past max_len to the
trash page (`page_index_device`). Its contiguous multi-token writes
past max_len go to the TRASH ROW: the serving engine allocates its
contiguous cache with one row more than it has slots
(`new_cache(slots, trash_row=True)`), and a write at a position >=
max_len lands in that last row instead of its own, the part page 0
plays in paged mode (the reference's scatter drops such writes; its
verify step sends a row's padded tail there). Which row a write takes
depends on its position only on the device, and which rule applies
only on the cache's shape, so a write at max_len - 1 and a padded
write never land on the same element. A call of B rows reads the
first B rows of the cache (`c[:B]`, a view with the strides of a
B-row cache), so K4 and the dense path see exactly the rows they saw
without the trash row. A cache with no trash row takes multi-token
writes inside the cache only, which the caller checks on the host.
The single-token write clamps its position to max_len - 1, as the
reference's dynamic_update_slice does. Both forms clamp the
learned-position lookup (the identity below max_len; the outputs at
positions past it are discarded) and agree bit for bit on every input
both take.

Numerics mirror the flax modules op by op in the model dtype: matmuls
round to it before the bias add, norms take their statistics in f32
(eps 1e-5, variance as E[x^2] - E[x]^2 clamped at 0), RoPE rotates in f32
(rotate-half), gelu is the tanh approximation, the dense attention
takes its einsum in the model dtype, scales in f32 by 1/sqrt(D), masks
with -1e30 and casts the probabilities back, and the tied LM head
accumulates and returns f32.

BERT (`MaskedLM`): the bidirectional encoder (`causal=False`) with
learned positions, optional segment embeddings (`wtte`), `ln_emb`, a
[B, S] key-padding mask through `attend`, and the MLM head (`mlm_dense`,
tanh-gelu, `mlm_ln`, the tied head plus an f32 `mlm_bias`).

MoE: with `num_experts > 0`, block i runs `parallel/moe.py`'s `MoeMlp` in
place of its FFN when i % moe_every == moe_every - 1; each block returns
its load-balancing aux loss beside its output (None for a dense FFN), so
the training forward (`forward_train`) hands the losses to the trainer
through the graph the loss uses, never through module state.

Remat (`remat=True`): each block of the training forward runs under
`torch.utils.checkpoint` (non-reentrant). `remat_policy="none"`
recomputes the whole block in the backward; `"dots"` is JAX's
`dots_with_no_batch_dims_saveable`: a selective-checkpoint policy that
saves the outputs of `aten.mm` / `aten.addmm` (the projections, whose
products have no batch dims) and recomputes everything else, attention
included. The flash kernels (K1-K3) are launched through ctypes, where
the dispatcher does not see them: they fill `torch.empty` outputs, and
the policy recomputes every op but the two GEMMs, so it never caches
those allocations; a recomputed forward launches K1 again.

Not here yet (later slices): tp_overlap and ViT.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.attention import (NEG_INF, decode_attention, flash_attention,
                             gather_pages, paged_decode_attention)
from ..parallel.moe import MoeMlp
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    max_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    embed_dim: int = 768
    mlp_dim: int = 3072
    causal: bool = True
    # "learned" (wpe table) | "rope"; "layernorm" | "rmsnorm";
    # "gelu" | "swiglu"; num_kv_heads None = MHA (else GQA)
    pos_embedding: str = "learned"
    norm: str = "layernorm"
    activation: str = "gelu"
    num_kv_heads: Optional[int] = None
    dtype: torch.dtype = torch.bfloat16
    # None = the cache in the model dtype; "int8" = symmetric per-vector
    # quantization, one f32 scale per cached (position, kv head)
    kv_cache_dtype: Optional[str] = None
    # single-token steps run the CUDA decode kernel (ops/attention.py);
    # False keeps the dense path, the correctness oracle
    decode_kernel: bool = False
    # the training forward's attention: "flash" (K1-K3), "dense", or
    # "auto" = flash on a CUDA tensor, dense on the CPU — the reference
    # picks flash only on its accelerator. The kernels take bf16, so an
    # f32 CUDA tensor raises there instead of running dense on the card
    attention: str = "auto"
    use_token_types: bool = False      # BERT segment embeddings (wtte)
    # checkpoint each block of the training forward; "none" recomputes
    # the whole block, "dots" saves the GEMM outputs with no batch dims
    remat: bool = False
    remat_policy: str = "none"
    # MoE: every moe_every-th block's FFN becomes a top-k mixture of
    # num_experts gelu experts (0 = dense FFN everywhere); dropless runs
    # every expert on every token
    num_experts: int = 0
    moe_every: int = 2
    moe_top_k: int = 2
    moe_dropless: bool = False

    @property
    def head_dim(self) -> int:
        assert self.embed_dim % self.num_heads == 0
        return self.embed_dim // self.num_heads

    @property
    def kv_heads(self) -> int:
        kv = self.num_kv_heads or self.num_heads
        if self.num_heads % kv:
            raise ValueError(
                f"num_kv_heads={kv} must divide num_heads="
                f"{self.num_heads} (each query group shares one KV head)")
        return kv


# ---------------------------------------------------------------------------
# the KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LayerCache:
    """One layer's cache: k/v [B, KV, L, D] in the model dtype, or int8
    with k_scale/v_scale [B, KV, L] f32."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    def tensors(self) -> List[torch.Tensor]:
        return [t for t in (self.k, self.v, self.k_scale, self.v_scale)
                if t is not None]


def _layer_caches(cfg: TransformerConfig, shape, device) -> List[LayerCache]:
    """Zeroed per-layer caches of `shape` + [D] (k, v) and `shape` (the
    int8 scales): [B, KV, L] for slot rows, [NP, KV, ps] for a pool."""
    quant = cfg.kv_cache_dtype == "int8"
    if cfg.kv_cache_dtype not in (None, "int8"):
        raise ValueError(f"kv_cache_dtype={cfg.kv_cache_dtype!r}; "
                         f"expected None or 'int8'")
    dt = torch.int8 if quant else cfg.dtype

    def z(*extra, dtype):
        return torch.zeros((*shape, *extra), dtype=dtype, device=device)
    return [LayerCache(
        z(cfg.head_dim, dtype=dt), z(cfg.head_dim, dtype=dt),
        z(dtype=torch.float32) if quant else None,
        z(dtype=torch.float32) if quant else None)
        for _ in range(cfg.num_layers)]


class KVCache:
    """Per-layer caches of one decode batch (or of the serving engine's
    slot rows)."""

    def __init__(self, layers: List[LayerCache]):
        self.layers = layers

    @classmethod
    def zeros(cls, cfg: TransformerConfig, batch: int, device,
              trash_row: bool = False) -> "KVCache":
        """`batch` zeroed rows, plus the trash row that takes device-form
        multi-token writes past max_len when `trash_row` (see the module
        docstring)."""
        rows = batch + 1 if trash_row else batch
        return cls(_layer_caches(cfg, (rows, cfg.kv_heads, cfg.max_len),
                                 device))

    def take_rows(self, idx: torch.Tensor) -> "KVCache":
        """A copy of rows `idx` (a device index tensor), the reference's
        dynamic_slice: one program serves every slot."""
        return KVCache([LayerCache(*[None if t is None
                                     else t.index_select(0, idx)
                                     for t in (c.k, c.v, c.k_scale,
                                               c.v_scale)])
                        for c in self.layers])

    def put_rows(self, idx: torch.Tensor, rows: "KVCache") -> None:
        """Write `rows` back at `idx`, in place (dynamic_update_slice)."""
        for c, r in zip(self.layers, rows.layers):
            for t, u in zip(c.tensors(), r.tensors()):
                t.index_copy_(0, idx, u)

    def zero_(self) -> None:
        for c in self.layers:
            for t in c.tensors():
                t.zero_()


class PagedKVCache(KVCache):
    """Per-layer page pools: k/v [NP, KV, ps, D] in the model dtype, or
    int8 with k_scale/v_scale [NP, KV, ps] f32. Shared by every row; a
    call reaches it through its page tables (`pages`)."""

    def __init__(self, layers: List[LayerCache], page_size: int):
        super().__init__(layers)
        self.page_size = page_size

    @classmethod
    def zeros(cls, cfg: TransformerConfig, num_pages: int, page_size: int,
              device) -> "PagedKVCache":
        if page_size < 1 or cfg.max_len % page_size:
            raise ValueError(f"max_len={cfg.max_len} must be a multiple of "
                             f"page_size={page_size}")
        if num_pages < 2:
            raise ValueError(f"num_pages={num_pages}: need >= 2 (page 0 is "
                             f"the reserved trash page)")
        return cls(_layer_caches(cfg, (num_pages, cfg.kv_heads, page_size),
                                 device), page_size)


@dataclasses.dataclass
class PageIndex:
    """One call's view of the page tables, made once per forward and
    read by every layer: `table` [B, nblk] int32 on the device (K5 and
    the dense gather read it) and the scatter targets of the call's
    writes — physical `page` and `slot` of each written position, and
    `src`, the (row, column) of each kept position in the call's [B, S]
    tokens (None: every position is written; always None from
    `page_index_device`)."""
    table: torch.Tensor
    page: torch.Tensor
    slot: torch.Tensor
    src: Optional[torch.Tensor] = None

    @functools.cached_property
    def table64(self) -> torch.Tensor:
        return self.table.long()


def page_index(pages, pos_host: torch.Tensor, page_size: int, max_len: int,
               device) -> PageIndex:
    """The PageIndex of a call at host positions `pos_host` [B, S] over
    the host page tables `pages` [B, max_len // page_size]. Positions
    >= max_len are dropped here (see the module docstring)."""
    B, S = pos_host.shape
    pt = torch.as_tensor(np.asarray(pages), dtype=torch.int64)
    nblk = max_len // page_size
    if tuple(pt.shape) != (B, nblk):
        raise ValueError(f"pages must be [B, max_len // page_size]="
                         f"{(B, nblk)}, got {tuple(pt.shape)}")
    keep = pos_host < max_len
    blk = torch.where(keep, pos_host // page_size, 0)
    where = torch.stack([pt.gather(1, blk), pos_host % page_size])
    src = None
    if not bool(keep.all()):
        bi, si = keep.nonzero(as_tuple=True)
        where = where[:, bi, si]
        src = torch.stack([bi, si]).to(device, non_blocking=True)
    where = where.to(device, non_blocking=True)
    return PageIndex(pt.to(device, torch.int32, non_blocking=True),
                     where[0], where[1], src)


def page_index_device(table: torch.Tensor, pos: torch.Tensor,
                      page_size: int, max_len: int) -> PageIndex:
    """The PageIndex of a call at device positions `pos` [B, S] over the
    device page tables `table` [B, max_len // page_size] int32, with no
    host read and shapes fixed by [B, S]: a position >= max_len is sent
    to slot pos % page_size of the trash page 0 (never read below a
    cursor) instead of being dropped, which is `page_index` on every
    position it keeps."""
    nblk = max_len // page_size
    if tuple(table.shape) != (pos.shape[0], nblk):
        raise ValueError(f"pages must be [B, max_len // page_size]="
                         f"{(pos.shape[0], nblk)}, got {tuple(table.shape)}")
    blk = (pos // page_size).clamp(max=nblk - 1).long()
    page = torch.where(pos < max_len, table.long().gather(1, blk), 0)
    return PageIndex(table, page, pos % page_size)


def _write(c: torch.Tensor, u: torch.Tensor, pos: torch.Tensor,
           pos_host: Optional[torch.Tensor]) -> None:
    """c [B(+1), KV, L(, D)] <- u [B, KV, S(, D)] at per-row positions,
    in place. A single-token write CLAMPS its position to L-1 (the
    reference's dynamic_update_slice); a multi-token write DROPS
    positions >= L (the reference's scatter with mode="drop") — chosen
    on the host from `pos_host`, so no device sync. With `pos_host`
    None (`forward_device`) a multi-token write takes no branch on the
    data: into a cache with a trash row (B + 1 rows) a position >= L
    goes to that row, into a B-row cache every position must lie below
    L, as the caller checks on the host."""
    B, S = pos.shape
    L = c.shape[2]
    rows = torch.arange(B, device=c.device)
    if S == 1:
        c[rows, :, pos[:, 0].clamp(max=L - 1)] = u[:, :, 0]
        return
    u = u.transpose(1, 2)                     # [B, S, KV(, D)]
    if pos_host is None:
        if c.shape[0] > B:                    # the trash row, row B
            keep = pos < L
            c[torch.where(keep, rows[:, None], B), :,
              torch.where(keep, pos, pos % L)] = u
        else:
            c[rows[:, None], :, pos] = u
        return
    keep = pos_host < L
    if bool(keep.all()):
        c[rows[:, None], :, pos] = u
        return
    bi, si = keep.nonzero(as_tuple=True)
    c[bi.to(c.device), :, pos_host[bi, si].to(c.device)] = \
        u[bi.to(c.device), si.to(c.device)]


def _write_paged(pool: torch.Tensor, u: torch.Tensor,
                 pages: PageIndex) -> None:
    """pool [NP, KV, ps(, D)] <- u [B, KV, S(, D)] at the call's page
    slots, in place."""
    u = u.transpose(1, 2)                     # [B, S, KV(, D)]
    if pages.src is not None:
        u = u[pages.src[0], pages.src[1]]
    pool[pages.page, :, pages.slot] = u


def _quantize_int8(x: torch.Tensor):
    """Symmetric per-vector int8 over the head dim: scale = max|x|/127
    clamped at 1e-8, round half to even, clip to +-127."""
    scale = x.abs().amax(-1, keepdim=True).float() / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q8 = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q8.to(torch.int8), scale[..., 0]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding (rotate-half): x [B, S, H, D] rotated by
    f32 angles of the absolute positions [B, S] (or [S])."""
    D = x.shape[-1]
    half = D // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freqs        # [.., S, half]
    cos = torch.cos(angles)[..., None, :]                # [.., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    """flax Dense in `dtype`: the product rounds to dtype, then the bias
    is added in dtype (two roundings, like the reference)."""
    y = torch.matmul(x, layer.weight.to(dtype).t())
    return y + layer.bias.to(dtype)


class Norm(nn.Module):
    """LayerNorm (scale + bias) or RMSNorm (scale only), eps 1e-5, with
    f32 statistics under any compute dtype, output in the model dtype."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        if cfg.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"norm={cfg.norm!r}; expected 'layernorm' or "
                             f"'rmsnorm'")
        self.rms = cfg.norm == "rmsnorm"
        self.dtype = cfg.dtype
        self.weight = nn.Parameter(torch.ones(cfg.embed_dim))
        self.bias = (None if self.rms
                     else nn.Parameter(torch.zeros(cfg.embed_dim)))

    def forward(self, x):
        x32 = x.float()
        if self.rms:
            var = (x32 * x32).mean(-1, keepdim=True)
            y = x32
        else:
            mu = x32.mean(-1, keepdim=True)
            var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mu * mu,
                              min=0.0)
            y = x32 - mu
        y = y * (torch.rsqrt(var + 1e-5) * self.weight.float())
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(self.dtype)


class Attention(nn.Module):
    """Self-attention over the decode cache. K/V project to cfg.kv_heads
    (GQA); the cache stores the unrepeated kv heads."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.config = cfg
        E, H, KV, D = cfg.embed_dim, cfg.num_heads, cfg.kv_heads, cfg.head_dim
        self.query = nn.Linear(E, H * D)
        self.key = nn.Linear(E, KV * D)
        self.value = nn.Linear(E, KV * D)
        self.out = nn.Linear(H * D, E)

    def forward(self, x, pos, pos_host, cache: Optional[LayerCache],
                pages: Optional[PageIndex] = None, mask=None):
        """Decode mode with a cache; the training forward without one,
        where `mask` is the optional [B, S] key-padding mask (> 0 =
        attend)."""
        cfg = self.config
        dt = cfg.dtype
        B, S, _ = x.shape
        H, KV, D = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        q = _linear(x, self.query, dt).view(B, S, H, D)
        k = _linear(x, self.key, dt).view(B, S, KV, D)
        v = _linear(x, self.value, dt).view(B, S, KV, D)
        if cache is None:
            out = self._train_attend(q, k, v, mask)
        else:
            out = self._decode_attend(q, k, v, pos, pos_host, cache, pages)
        return _linear(out.reshape(B, S, H * D), self.out, dt)

    def _train_attend(self, q, k, v, mask=None):
        """The reference's non-decode branch: RoPE at arange(S), K/V
        repeated across each query group, then `attend`."""
        cfg = self.config
        S, H = q.shape[1], q.shape[2]
        if cfg.pos_embedding == "rope":
            pos = torch.arange(S, device=q.device)
            q = rope(q, pos)
            k = rope(k, pos)
        if k.shape[2] != H:
            g = H // k.shape[2]
            k = k.repeat_interleave(g, dim=2)
            v = v.repeat_interleave(g, dim=2)
        return attend(q, k, v, mask, cfg)

    def _decode_attend(self, q, k, v, pos, pos_host, cache: LayerCache,
                       pages: Optional[PageIndex] = None):
        """Write this call's K/V at `pos` (per row), then attend each
        query to cache positions <= its own. RoPE is applied here, at the
        absolute positions, so cached keys are stored rotated. The
        single-token step with cfg.decode_kernel runs the decode kernel
        (K5 when `pages` is given, else K4); everything else (prefill
        chunks, decode_kernel=False) runs the dense path below, which
        reads the whole logical [B, KV, L, D] cache — gathered from the
        pool through the page table when paged — and masks per row."""
        cfg = self.config
        dt = cfg.dtype
        B, S, H, D = q.shape
        KV = k.shape[2]
        L = cfg.max_len
        if cfg.pos_embedding == "rope":
            q = rope(q, pos)
            k = rope(k, pos)
        k_t = k.transpose(1, 2)                   # [B, KV, S, D]
        v_t = v.transpose(1, 2)
        if pages is not None:
            def write(c, u):
                _write_paged(c, u, pages)

            def read(c):
                return gather_pages(c, pages.table64)
        else:
            def write(c, u):
                _write(c, u, pos, pos_host)

            def read(c):                      # the call's rows: never
                return None if c is None else c[:B]   # the trash row
        if cfg.kv_cache_dtype == "int8":
            k8, k_sc = _quantize_int8(k_t)
            v8, v_sc = _quantize_int8(v_t)
            write(cache.k, k8)
            write(cache.v, v8)
            write(cache.k_scale, k_sc)
            write(cache.v_scale, v_sc)
        else:
            write(cache.k, k_t)
            write(cache.v, v_t)

        if cfg.decode_kernel and S == 1:
            if pages is not None:
                out = paged_decode_attention(
                    q[:, 0], cache.k, cache.v, pos[:, 0], pages.table,
                    k_scale=cache.k_scale, v_scale=cache.v_scale)
            else:
                out = decode_attention(q[:, 0], read(cache.k),
                                       read(cache.v), pos[:, 0],
                                       k_scale=read(cache.k_scale),
                                       v_scale=read(cache.v_scale))
            return out[:, None]
        if cache.k_scale is not None:
            keys = read(cache.k).to(dt) * read(cache.k_scale)[..., None].to(dt)
            values = (read(cache.v).to(dt)
                      * read(cache.v_scale)[..., None].to(dt))
        else:
            keys, values = read(cache.k), read(cache.v)
        if KV != H:
            keys = keys.repeat_interleave(H // KV, dim=1)
            values = values.repeat_interleave(H // KV, dim=1)
        logits = torch.einsum("bqhd,bhkd->bhqk", q, keys)
        logits = logits.float() / math.sqrt(D)
        visible = (torch.arange(L, device=q.device)[None, None, :]
                   <= pos[:, :, None])                       # [B, S, L]
        logits = torch.where(visible[:, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(dt)
        return torch.einsum("bhqk,bhkd->bqhd", probs, values)


class Mlp(nn.Module):
    """FFN: "gelu" (fc_in -> tanh-gelu -> fc_out) or "swiglu"
    (silu(fc_gate) * fc_in -> fc_out)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        if cfg.activation not in ("gelu", "swiglu"):
            raise ValueError(f"activation={cfg.activation!r}; expected "
                             f"'gelu' or 'swiglu'")
        self.config = cfg
        E, M = cfg.embed_dim, cfg.mlp_dim
        self.fc_gate = nn.Linear(E, M) if cfg.activation == "swiglu" else None
        self.fc_in = nn.Linear(E, M)
        self.fc_out = nn.Linear(M, E)

    def forward(self, x):
        dt = self.config.dtype
        if self.fc_gate is not None:
            h = (F.silu(_linear(x, self.fc_gate, dt))
                 * _linear(x, self.fc_in, dt))
        else:
            h = F.gelu(_linear(x, self.fc_in, dt), approximate="tanh")
        return _linear(h, self.fc_out, dt)


class Block(nn.Module):
    """Pre-LN transformer block; `use_moe` swaps the FFN for a MoeMlp.
    Returns (x, aux): the block's MoE load-balancing loss, or None."""

    def __init__(self, cfg: TransformerConfig, use_moe: bool = False):
        super().__init__()
        self.ln_1 = Norm(cfg)
        self.attn = Attention(cfg)
        self.ln_2 = Norm(cfg)
        if use_moe:
            if cfg.activation != "gelu":
                # MoeMlp's experts are gelu FFNs (the reference's check)
                raise ValueError(
                    f"num_experts>0 requires activation='gelu' (MoeMlp "
                    f"experts are gelu FFNs); got {cfg.activation!r}")
            self.moe = MoeMlp(cfg.num_experts, cfg.embed_dim, cfg.mlp_dim,
                              top_k=cfg.moe_top_k, dropless=cfg.moe_dropless,
                              dtype=cfg.dtype)
            self.mlp = None
        else:
            self.moe = None
            self.mlp = Mlp(cfg)

    def forward(self, x, pos, pos_host, cache: Optional[LayerCache],
                pages: Optional[PageIndex] = None, mask=None):
        x = x + self.attn(self.ln_1(x), pos, pos_host, cache, pages, mask)
        if self.moe is None:
            return x + self.mlp(self.ln_2(x)), None
        ff, aux = self.moe(self.ln_2(x))
        return x + ff, aux


def _dots_policy(ctx, op, *args, **kwargs):
    """`dots_with_no_batch_dims_saveable`: keep the 2-D GEMMs' outputs
    (the projections; torch.matmul folds [B, S, E] @ [E, F] into one
    `mm`), recompute every other op — batched products, attention, norms,
    casts and every allocation a ctypes kernel fills."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(cfg: TransformerConfig):
    """The `context_fn` of `torch.utils.checkpoint` for cfg.remat_policy."""
    if cfg.remat_policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _dots_policy)
    if cfg.remat_policy == "none":
        return None                    # recompute everything
    raise ValueError(f"remat_policy={cfg.remat_policy!r}; expected 'none' "
                     f"or 'dots'")


class Backbone(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.blocks = nn.ModuleList(Block(cfg, use_moe=uses_moe(cfg, i))
                                    for i in range(cfg.num_layers))
        self.ln_f = Norm(cfg)
        self.remat = cfg.remat
        self._remat_context = _remat_context(cfg) if cfg.remat else None

    def forward(self, h, pos, pos_host, cache: Optional[KVCache],
                pages: Optional[PageIndex] = None, mask=None):
        """Decode mode through `cache`; the training forward with None
        (each block checkpointed under cfg.remat while autograd records).
        Returns (h, [aux losses of the MoE blocks])."""
        aux = []
        if cache is not None:
            for block, layer_cache in zip(self.blocks, cache.layers):
                h, _ = block(h, pos, pos_host, layer_cache, pages)
            return self.ln_f(h), aux
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                kw = ({} if self._remat_context is None
                      else {"context_fn": self._remat_context})
                h, a = checkpoint(block, h, None, None, None, None, mask,
                                  use_reentrant=False, **kw)
            else:
                h, a = block(h, None, None, None, None, mask)
            if a is not None:
                aux.append(a)
        return self.ln_f(h), aux


def dense_attention(q, k, v, mask=None, causal: bool = True,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The reference O(S^2) attention over [B, S, H, D]: scores as an
    einsum in the inputs' dtype, then f32, divided by sqrt(D), masked
    with -1e30 (causal and/or the [B, S] key mask), f32 softmax, the
    probabilities cast to `dtype` for the p.v einsum."""
    D = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(D)
    if causal:
        S_q, S_k = logits.shape[-2:]
        tril = torch.ones(S_q, S_k, dtype=torch.bool,
                          device=q.device).tril()
        logits = torch.where(tril, logits, NEG_INF)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :].bool(), logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attend(q, k, v, mask, cfg: TransformerConfig) -> torch.Tensor:
    """The training forward's attention over [B, S, H, D] (equal head
    counts), per `cfg.attention` (the reference's `_attend`)."""
    impl = cfg.attention
    if impl == "auto":
        impl = "flash" if q.device.type == "cuda" else "dense"
    if impl == "flash":
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=cfg.causal, mask=mask)
    if impl == "dense":
        return dense_attention(q, k, v, mask=mask, causal=cfg.causal,
                               dtype=cfg.dtype)
    raise ValueError(f"attention={cfg.attention!r}; expected 'auto', "
                     f"'dense' or 'flash'")


class TiedHead(torch.autograd.Function):
    """The tied LM head h [.., E] . table[V, E]^T with the reference's
    `_head_matmul` custom_vjp numerics: the forward is `head_logits` (f32
    out); the backward rounds the f32 cotangent to the table's dtype
    before both products, accumulates them in f32 and returns dh in h's
    dtype and dtable in the table's."""

    @staticmethod
    def forward(ctx, h, table):
        ctx.save_for_backward(h, table)
        return head_logits(h, table, table.dtype)

    @staticmethod
    def backward(ctx, g):
        h, table = ctx.saved_tensors
        gb = g.to(table.dtype)
        dh = torch.matmul(gb, table).to(h.dtype)
        dtable = torch.matmul(gb.reshape(-1, g.shape[-1]).t(),
                              h.reshape(-1, h.shape[-1]).to(table.dtype))
        return dh, dtable.to(table.dtype)


def head_logits(h: torch.Tensor, table: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Tied LM head: h [.., E] against the token table [V, E] cast to the
    model dtype, accumulated and returned in f32. The product runs as an
    f32 matmul of the dtype-exact operands (the reference's bf16 inputs
    with f32 accumulation and f32 output); a later slice can move it to
    a bf16 GEMM with an f32 epilogue."""
    return torch.matmul(h.float(), table.to(dtype).float().t())


def _host_positions(positions, B: int, S: int) -> torch.Tensor:
    """Positions as a host int64 [B, S] tensor ([S] and [1, S] broadcast).
    Callers pass host data (numpy, lists, CPU tensors): the cache write
    decides clamp/drop on the host without a device sync."""
    if isinstance(positions, torch.Tensor):
        p = positions.detach().to("cpu", torch.int64)
    else:
        p = torch.as_tensor(np.asarray(positions), dtype=torch.int64)
    if p.ndim == 1:
        p = p[None]
    return p.expand(B, S)


class CausalLM(nn.Module):
    """GPT-2 / Llama decoder LM with a tied head.

    `forward(tokens [B, S])` with no positions and no cache is the
    training forward (positions arange(S), nothing cached), with
    gradients through every path. `forward(tokens, positions, cache)`
    is decode mode: it writes the call's K/V into `cache` (a new one if
    None) at `positions`. Both return f32 logits [B, S, V] (or the final
    hidden state [B, S, E] with `with_head=False`). A `PagedKVCache`
    needs `pages`, the host [B, max_len // page_size] page tables.
    `forward_device` is decode mode over device operands (the serving
    engine's programs)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        if not cfg.causal:
            raise ValueError("CausalLM needs causal=True")
        if cfg.pos_embedding not in ("learned", "rope"):
            raise ValueError(f"pos_embedding={cfg.pos_embedding!r}; "
                             f"expected 'learned' or 'rope'")
        self.config = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        self.wpe = (nn.Embedding(cfg.max_len, cfg.embed_dim)
                    if cfg.pos_embedding == "learned" else None)
        self.backbone = Backbone(cfg)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def new_cache(self, batch: int, trash_row: bool = False) -> KVCache:
        return KVCache.zeros(self.config, batch, self.device, trash_row)

    def new_paged_cache(self, num_pages: int,
                        page_size: int) -> PagedKVCache:
        """A pool of `num_pages` pages of `page_size` positions (page 0
        is the trash page) for the serving engine's paged mode."""
        return PagedKVCache.zeros(self.config, num_pages, page_size,
                                  self.device)

    def forward(self, tokens: torch.Tensor, positions=None,
                cache: Optional[KVCache] = None, with_head: bool = True,
                pages=None):
        if positions is None and cache is None and pages is None:
            return self.forward_train(tokens, with_head)[0]
        B, S = tokens.shape
        if positions is None:
            positions = np.arange(S)[None]
        pos_host = _host_positions(positions, B, S)
        pos = pos_host.to(self.device, non_blocking=True)
        if cache is None:
            cache = self.new_cache(B)
        index = (page_index(pages, pos_host, cache.page_size,
                            self.config.max_len, self.device)
                 if self._paged(cache, pages) else None)
        return self._decode(tokens, pos, pos_host, cache, index, with_head)

    def forward_device(self, tokens: torch.Tensor, pos: torch.Tensor,
                       cache: KVCache, table: Optional[torch.Tensor] = None,
                       with_head: bool = False):
        """Decode mode over device operands only, the form a CUDA graph
        holds: `pos` int64 [B, S] and, for a PagedKVCache, `table` int32
        [B, max_len // page_size] on the model's device. No host read, no
        branch on their values (see the module docstring); a contiguous
        multi-token call sends positions >= max_len to the cache's trash
        row, and into a cache without one must keep them below max_len."""
        index = (page_index_device(table, pos, cache.page_size,
                                   self.config.max_len)
                 if self._paged(cache, table) else None)
        return self._decode(tokens, pos, None, cache, index, with_head)

    @staticmethod
    def _paged(cache: KVCache, pages) -> bool:
        paged = isinstance(cache, PagedKVCache)
        if paged != (pages is not None):
            raise ValueError("a paged cache needs pages= (the page tables) "
                             "and pages= needs a paged cache")
        return paged

    def _decode(self, tokens, pos, pos_host, cache, index, with_head):
        cfg = self.config
        dt = cfg.dtype
        h = F.embedding(tokens, self.wte.weight.to(dt))
        if self.wpe is not None:
            # a paged prefill runs the rows outside its batch at their own
            # cursor, which can reach past max_len: those positions' K/V
            # writes are dropped and their outputs discarded, so their
            # table row only needs to exist (the reference reads a filled
            # row there); the clamp is the identity everywhere else
            h = h + F.embedding(pos.clamp(max=cfg.max_len - 1),
                                self.wpe.weight.to(dt))
        h, _ = self.backbone(h, pos, pos_host, cache, index)
        if not with_head:
            return h
        return head_logits(h, self.wte.weight, dt)

    def forward_train(self, tokens: torch.Tensor, with_head: bool = True):
        """The reference's decode=False forward, returning (logits or h,
        [the MoE blocks' aux losses]) — the trainer's entry. The table is
        cast to the model dtype separately for the embedding and for the
        head, so its two gradients meet in f32, as the reference's two
        casts do."""
        cfg = self.config
        dt = cfg.dtype
        S = tokens.shape[1]
        if self.wpe is not None and S > cfg.max_len:
            raise ValueError(f"sequence of {S} tokens is longer than "
                             f"max_len={cfg.max_len} (the position table)")
        h = F.embedding(tokens, self.wte.weight.to(dt))
        if self.wpe is not None:
            h = h + self.wpe.weight[:S].to(dt)
        h, aux = self.backbone(h, None, None, None)
        if not with_head:
            return h, aux
        return TiedHead.apply(h, self.wte.weight.to(dt)), aux

    def moe_drop_rates(self) -> List[torch.Tensor]:
        """Each MoE block's drop rate from the last forward (diagnostics,
        never part of the loss)."""
        return _drop_rates(self.backbone)


def _drop_rates(backbone: Backbone) -> List[torch.Tensor]:
    return [b.moe.drop_rate for b in backbone.blocks
            if b.moe is not None and b.moe.drop_rate is not None]


class MaskedLM(nn.Module):
    """BERT-style bidirectional encoder with the MLM head (the
    reference's `MaskedLM`): token + learned position (+ segment)
    embeddings, `ln_emb`, the bidirectional Backbone under an optional
    [B, S] key-padding `attention_mask`, then `mlm_dense`, tanh-gelu,
    `mlm_ln` and the tied head plus an f32 `mlm_bias`. Returns f32
    logits [B, S, V]."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        if cfg.causal:
            raise ValueError("MaskedLM needs causal=False")
        self.config = cfg
        E = cfg.embed_dim
        self.wte = nn.Embedding(cfg.vocab_size, E)
        self.wpe = nn.Embedding(cfg.max_len, E)
        self.wtte = nn.Embedding(2, E) if cfg.use_token_types else None
        self.ln_emb = Norm(cfg)
        self.backbone = Backbone(cfg)
        self.mlm_dense = nn.Linear(E, E)
        self.mlm_ln = Norm(cfg)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def forward(self, tokens: torch.Tensor, token_types=None,
                attention_mask=None):
        return self.forward_train(tokens, token_types, attention_mask)[0]

    def forward_train(self, tokens: torch.Tensor, token_types=None,
                      attention_mask=None):
        """(logits, [the MoE blocks' aux losses])."""
        cfg = self.config
        dt = cfg.dtype
        S = tokens.shape[1]
        if S > cfg.max_len:
            raise ValueError(f"sequence of {S} tokens is longer than "
                             f"max_len={cfg.max_len} (the position table)")
        h = F.embedding(tokens, self.wte.weight.to(dt)) \
            + self.wpe.weight[:S].to(dt)
        if self.wtte is not None:
            if token_types is None:
                token_types = torch.zeros_like(tokens)
            h = h + F.embedding(token_types, self.wtte.weight.to(dt))
        h, aux = self.backbone(self.ln_emb(h), None, None, None,
                               mask=attention_mask)
        h = F.gelu(_linear(h, self.mlm_dense, dt), approximate="tanh")
        logits = TiedHead.apply(self.mlm_ln(h), self.wte.weight.to(dt))
        return logits + self.mlm_bias.float(), aux

    def moe_drop_rates(self) -> List[torch.Tensor]:
        return _drop_rates(self.backbone)


# ---------------------------------------------------------------------------
# presets, parameters and the factory
# ---------------------------------------------------------------------------

def gpt2_config(size: str = "medium", **overrides) -> TransformerConfig:
    dims = {
        "small": (12, 12, 768),
        "medium": (24, 16, 1024),
        "large": (36, 20, 1280),
        "xl": (48, 25, 1600),
        "test": (2, 4, 128),
    }[size]
    L, H, E = dims
    # vocab padded 50257 -> 50304 (a multiple of 128), as the reference
    base = dict(vocab_size=50304, max_len=1024, num_layers=L, num_heads=H,
                embed_dim=E, mlp_dim=4 * E, causal=True)
    base.update(overrides)
    return TransformerConfig(**base)


def llama_config(size: str = "1b", **overrides) -> TransformerConfig:
    """RoPE + RMSNorm + SwiGLU + grouped-query attention."""
    dims = {
        "test": (2, 4, 2, 128, 256),
        "1b": (16, 32, 8, 2048, 5504),
        "7b": (32, 32, 8, 4096, 11008),
    }[size]
    L, H, KV, E, M = dims
    base = dict(vocab_size=32000, max_len=2048, num_layers=L, num_heads=H,
                num_kv_heads=KV, embed_dim=E, mlp_dim=M, causal=True,
                pos_embedding="rope", norm="rmsnorm", activation="swiglu")
    base.update(overrides)
    return TransformerConfig(**base)


def bert_config(size: str = "large", **overrides) -> TransformerConfig:
    dims = {
        "base": (12, 12, 768),
        "large": (24, 16, 1024),
        "test": (2, 4, 128),
    }[size]
    L, H, E = dims
    # vocab padded 30522 -> 30592 (a multiple of 128), as the reference
    base = dict(vocab_size=30592, max_len=512, num_layers=L, num_heads=H,
                embed_dim=E, mlp_dim=4 * E, causal=False,
                use_token_types=True)
    base.update(overrides)
    return TransformerConfig(**base)


def uses_moe(cfg: TransformerConfig, layer: int) -> bool:
    """Whether block `layer` runs a MoeMlp in place of its FFN."""
    return cfg.num_experts > 0 and layer % cfg.moe_every == cfg.moe_every - 1


def model_class(cfg: TransformerConfig):
    """The LM a config builds: MaskedLM for a bidirectional (BERT)
    config, CausalLM otherwise."""
    return CausalLM if cfg.causal else MaskedLM


def param_shapes(cfg: TransformerConfig) -> dict:
    """{state-dict name: shape} of the config's LM (`model_class`), in
    module order."""
    E, M, H, KV, D = (cfg.embed_dim, cfg.mlp_dim, cfg.num_heads,
                      cfg.kv_heads, cfg.head_dim)
    norm = ["weight"] if cfg.norm == "rmsnorm" else ["weight", "bias"]
    out = {"wte.weight": (cfg.vocab_size, E)}
    if cfg.pos_embedding == "learned" or not cfg.causal:
        out["wpe.weight"] = (cfg.max_len, E)
    if not cfg.causal:
        if cfg.use_token_types:
            out["wtte.weight"] = (2, E)
        for n in norm:
            out["ln_emb." + n] = (E,)
    lin = {"attn.query": (H * D, E), "attn.key": (KV * D, E),
           "attn.value": (KV * D, E), "attn.out": (E, H * D)}
    if cfg.activation == "swiglu":
        lin["mlp.fc_gate"] = (M, E)
    lin.update({"mlp.fc_in": (M, E), "mlp.fc_out": (E, M)})
    e = cfg.num_experts
    for i in range(cfg.num_layers):
        p = f"backbone.blocks.{i}."
        for n in norm:
            out[p + "ln_1." + n] = (E,)
        for name in ("attn.query", "attn.key", "attn.value", "attn.out"):
            out[p + name + ".weight"] = lin[name]
            out[p + name + ".bias"] = (lin[name][0],)
        for n in norm:
            out[p + "ln_2." + n] = (E,)
        if uses_moe(cfg, i):
            out[p + "moe.router.weight"] = (e, E)
            out[p + "moe.w_in"] = (e, E, M)
            out[p + "moe.w_out"] = (e, M, E)
            continue
        for name in ("mlp.fc_gate", "mlp.fc_in", "mlp.fc_out"):
            if name in lin:
                out[p + name + ".weight"] = lin[name]
                out[p + name + ".bias"] = (lin[name][0],)
    for n in norm:
        out["backbone.ln_f." + n] = (E,)
    if not cfg.causal:
        out["mlm_dense.weight"] = (E, E)
        out["mlm_dense.bias"] = (E,)
        for n in norm:
            out["mlm_ln." + n] = (E,)
        out["mlm_bias"] = (cfg.vocab_size,)
    return out


def build_lm(cfg: TransformerConfig, state_dict: dict, device=None):
    """The config's LM (`model_class`) whose parameters ARE the given
    tensors (moved to `device`, no copy when they already live there)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = model_class(cfg)(cfg)
    model.load_state_dict({k: torch.as_tensor(v).to(dev)
                           for k, v in state_dict.items()},
                          strict=True, assign=True)
    return model.eval().requires_grad_(False)


def lm_config(name: str = "gpt2-medium", **overrides) -> TransformerConfig:
    """The config of the named model ("gpt2-medium", "llama-test",
    "bert-large", ...; a bare family name is gpt2-medium, llama-1b or
    bert-large)."""
    family, _, size = name.partition("-")
    if family == "gpt2":
        return gpt2_config(size or "medium", **overrides)
    if family == "llama":
        return llama_config(size or "1b", **overrides)
    if family == "bert":
        return bert_config(size or "large", **overrides)
    raise ValueError(f"unknown LM {name!r} (the port has gpt2-*, llama-* "
                     f"and bert-*)")


def create_lm(name: str = "gpt2-medium", device=None, seed: int = 0,
              **overrides):
    """The named model ("gpt2-medium", "llama-test", "bert-large", ...: a
    CausalLM, or a MaskedLM for bert) with random
    f32 weights drawn on `device` from `seed` (models/convert.py
    init_params), frozen for inference. Runs on the CUDA card unless
    `device="cpu"`."""
    from .convert import init_params
    cfg = lm_config(name, **overrides)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return build_lm(cfg, init_params(cfg, gen, device=dev), device=dev)


__all__ = [
    "TransformerConfig", "LayerCache", "KVCache", "PagedKVCache",
    "PageIndex", "page_index", "page_index_device", "Attention", "Mlp",
    "Norm", "Block", "Backbone", "CausalLM", "MaskedLM", "TiedHead",
    "attend", "dense_attention", "rope", "head_logits",
    "gpt2_config", "llama_config", "bert_config", "lm_config",
    "model_class", "param_shapes", "uses_moe", "build_lm", "create_lm",
]
