"""Ring attention: sequence (context) parallelism over the `sp` mesh
axis. The counterpart of `mpi_operator_tpu/parallel/ring_attention.py`.

The sequence is sharded over sp: each rank holds a [B, S/n, H, D] slice
of q, k and v. K/V blocks rotate around the ring (`ring_hop`, one hop
to the next sp rank a step) while each rank accumulates its queries'
attention over every block. Ring step t gives rank i the block of rank
(i - t) mod n, so under a causal mask a whole block is visible (its
index below i), the diagonal (== i, the local triangle) or invisible
(above i), and an invisible block launches nothing.

Each visible block runs K1 (`ops.attention.flash_fwd`), non-causal
below the diagonal and causal on it; the forward combines the blocks'
(out, lse) pairs in f32 by log-sum-exp. The backward is the ring-flash
schedule: K2 and K3 (`flash_dq`, `flash_dkv`) per visible block against
the GLOBAL softmax statistics, lse and delta = rowsum(dO * O) of the
final output; dq accumulates in place (f32) and the f32 dk/dv
accumulators travel with their K/V blocks, home after n hops. On rank i
of a causal ring each of K1, K2 and K3 launches i + 1 times a layer, n
times without the mask. The schedule is written out in both directions
(a `torch.autograd.Function`), so every rank runs the same hops in the
same order whichever blocks it skips: autograd through the hops would
leave the hops of a rank's skipped blocks out of its backward.

Two inner implementations, one schedule: "flash" (the default) with
K1-K3 (on a CPU tensor their plain versions), and "dense", the
reference's fallback for shards its Pallas tiles do not fit, with the
plain PyTorch block functions (`flash_*_ref`: the dense scores of a
block, f32 softmax) on any device and dtype (the port's kernels take
any S, but only bf16 and head dims that are multiples of 16).

Positions are the caller's: a layer under sp offsets learned positions
and RoPE by sp_rank x S/n (models/transformer.py). The ring takes no
key-padding mask, as the reference's does not.
"""
from __future__ import annotations

import torch

from ..ops import attention as ops
from ..ops.attention import NEG_INF, flash_delta
from .collectives import _ring, gather_from, ring_hop, scatter_to
from .mesh import BATCH_AXES

#: the block functions (forward, dq, dk/dv) of each inner
_BLOCKS = {"flash": ("flash_fwd", "flash_dq", "flash_dkv"),
           "dense": ("flash_fwd_ref", "flash_dq_ref", "flash_dkv_ref")}


def _block_fns(impl: str):
    """(forward, dq, dk/dv) of an inner, looked up when a ring runs."""
    return tuple(getattr(ops, name) for name in _BLOCKS[impl])


class _Ring(torch.autograd.Function):
    """The ring core: the block forward per visible block, its dq and
    dk/dv against the global lse and delta backward (see the module
    docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, impl):
        n, i = _ring(mesh, axis)
        flash_fwd = _block_fns(impl)[0]
        out = q.new_zeros(q.shape, dtype=torch.float32)
        lse = q.new_full((q.shape[0], q.shape[2], q.shape[1]), NEG_INF,
                         dtype=torch.float32)
        k_t, v_t = k, v
        for t in range(n):
            src = (i - t) % n
            hop = ring_hop([k_t, v_t], mesh, axis) if t < n - 1 else None
            if not (causal and src > i):
                o_b, lse_b = flash_fwd(q, k_t, v_t, causal and src == i)
                new = torch.logaddexp(lse, lse_b)
                out = (out * torch.exp(lse - new).transpose(1, 2)[..., None]
                       + o_b.float()
                       * torch.exp(lse_b - new).transpose(1, 2)[..., None])
                lse = new
            if hop is not None:
                k_t, v_t = hop.wait()
        out = out.to(q.dtype)
        ctx.mesh, ctx.axis, ctx.causal, ctx.impl = mesh, axis, causal, impl
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, causal = ctx.mesh, ctx.axis, ctx.causal
        _, flash_dq, flash_dkv = _block_fns(ctx.impl)
        n, i = _ring(mesh, axis)
        do = do.contiguous()
        delta = flash_delta(out, do)
        dq = q.new_zeros(q.shape, dtype=torch.float32)
        dk_t = k.new_zeros(k.shape, dtype=torch.float32)
        dv_t = v.new_zeros(v.shape, dtype=torch.float32)
        k_t, v_t = k, v
        for t in range(n):
            src = (i - t) % n
            hop = ring_hop([k_t, v_t], mesh, axis) if t < n - 1 else None
            if not (causal and src > i):
                diag = causal and src == i
                dq += flash_dq(q, k_t, v_t, do, lse, delta, diag).float()
                dk_b, dv_b = flash_dkv(q, k_t, v_t, do, lse, delta, diag)
                dk_t = dk_t + dk_b.float()
                dv_t = dv_t + dv_b.float()
            # the accumulators move with their blocks: n hops bring them
            # home
            dk_t, dv_t = ring_hop([dk_t, dv_t], mesh, axis, tag=2).wait()
            if hop is not None:
                k_t, v_t = hop.wait()
        return (dq.to(q.dtype), dk_t.to(k.dtype), dv_t.to(v.dtype), None,
                None, None, None)


def ring_attention_inner(q, k, v, mesh, axis: str = "sp",
                         causal: bool = True, impl: str = "auto"):
    """Ring attention over this rank's [B, S_local, H, D] shards of q, k
    and v, the sequence split over the ring of `axis`; returns the
    rank's [B, S_local, H, D] output. impl: "flash" (K1-K3 a block;
    "auto" picks it: the kernels take any S) or "dense" (the plain
    block functions)."""
    if impl == "auto":
        impl = "flash"
    if impl not in _BLOCKS:
        raise ValueError(f"impl={impl!r}; expected 'auto', 'flash' or "
                         f"'dense'")
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(), mesh,
                       axis, causal, impl)


def ring_attention(q, k, v, mesh, axis: str = "sp", causal: bool = True,
                   impl: str = "auto"):
    """Ring attention over whole [B, S, H, D] arrays held alike by every
    rank (the reference's shard_map wrapper): each rank takes its block
    (batch over the data axes, the sequence over `axis`, the heads over
    tp where tp divides them: each tp rank rings its own head group),
    runs the ring, and the blocks are gathered back, so every rank
    returns the whole output, differentiable to whole gradients."""
    H, tp = q.shape[2], mesh.shape["tp"]
    heads = tp > 1 and H % tp == 0

    def take(x):
        x = scatter_to(x, mesh, BATCH_AXES, 0)
        x = scatter_to(x, mesh, axis, 1)
        return scatter_to(x, mesh, "tp", 2) if heads else x

    out = ring_attention_inner(take(q), take(k), take(v), mesh, axis,
                               causal, impl)
    if heads:
        out = gather_from(out, mesh, "tp", 2)
    return gather_from(gather_from(out, mesh, axis, 1), mesh, BATCH_AXES, 0)


__all__ = ["ring_attention", "ring_attention_inner"]
