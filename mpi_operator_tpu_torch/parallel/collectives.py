"""The collectives: the counterpart of
`mpi_operator_tpu/parallel/collectives.py` over torch.distributed.

The explicit collectives (`allreduce_mean`, `allreduce_sum`,
`allgather`, `broadcast`, `reduce_scatter`, `alltoall`,
`hierarchical_allreduce_mean`, `allreduce_gradients`,
`sharded_allreduce_fn`): the reference calls these inside shard_map on
each device's shard with an axis name. Here each rank calls them on its
own tensor with a mesh (parallel/mesh.py) and a mesh dim name or a tuple
of them (any subset of the mesh's axes), and the collective runs over
the process group of those dims: NCCL between cards, gloo on the CPU and
where ranks share a card. Each returns a new tensor unless `inplace`
says otherwise; over dims of size 1, or a mesh without a process group
(one process), each is the identity, as a collective over one device is.

The model-parallel autograd ops, which the reference gets from GSPMD's
sharding propagation. Every rank of a tensor- (or expert-) parallel
group computes the same loss, so the gradient a rank needs of a value
replicated over the group is that value's full gradient, the same on
every rank. Four ops keep that so, Megatron's conjugate pairs:

- `copy_to` (identity forward, all-reduce sum backward): a replicated
  value entering computations that each rank does on its own shard;
- `reduce_from` (all-reduce sum forward, identity backward): the
  partial sums of those shards, made whole;
- `scatter_to` (this rank's block forward, all-gather backward) and
  `gather_from` (all-gather forward, this rank's block backward): the
  same pair for a value split along an axis.

The ring collective-matmuls (`allgather_matmul`, `matmul_reducescatter`,
uni- and bidirectional) are `torch.autograd.Function`s whose backward is
the mirrored ring, as the reference's custom_vjp: each hop (`ring_hop`)
is issued before the matmul of the shard in hand and waited for after
it, so the transfer overlaps the product.

Gloo runs the all-reduce, all-gather, reduce-scatter and all-to-all of
this module on CUDA tensors as well (torch 2.11 on the H100, where ranks
share a card), so no leg stages a collective through the host.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import torch
import torch.distributed as dist

from .mesh import MESH_DIMS, Mesh

_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


Dims = Union[str, Sequence[str]]


def _dims(dims: Dims) -> tuple:
    return (dims,) if isinstance(dims, str) else tuple(dims)


def _group(mesh: Mesh, dims: Dims):
    return mesh.group(_dims(dims))


def allreduce_sum(x: torch.Tensor, mesh: Mesh, dims: Dims = MESH_DIMS,
                  inplace: bool = False) -> torch.Tensor:
    """The sum of `x` over the ranks of `dims` (lax.psum)."""
    group = _group(mesh, dims)
    if group is None:
        return x
    out = x if inplace else x.clone()
    dist.all_reduce(out, group=group)
    return out


def allreduce_mean(x: torch.Tensor, mesh: Mesh, dims: Dims = MESH_DIMS,
                   inplace: bool = False) -> torch.Tensor:
    """hvd.allreduce(average=True): the mean of `x` over `dims`."""
    if _group(mesh, dims) is None:
        return x
    return allreduce_sum(x, mesh, dims, inplace).div_(
        mesh.dim_size(_dims(dims)))


def allgather(x: torch.Tensor, mesh: Mesh, dim: Dims, axis: int = 0,
              tiled: bool = True) -> torch.Tensor:
    """hvd.allgather: every rank's `x` along `axis` in rank order,
    concatenated (`tiled`) or stacked on a new axis."""
    group = _group(mesh, dim)
    if group is None:
        return x if tiled else x.unsqueeze(axis)
    n = dist.get_world_size(group)
    out = x.new_empty(n * x.numel())
    _all_gather(out, x.reshape(-1).contiguous(), group=group)
    out = out.view((n,) + tuple(x.shape))
    if not tiled:
        return out.movedim(0, axis)
    return torch.cat(out.unbind(0), dim=axis)


def broadcast(x: torch.Tensor, mesh: Mesh, dim: Dims,
              root: int = 0) -> torch.Tensor:
    """hvd.broadcast: every rank takes the `root`-th rank's value."""
    group = _group(mesh, dim)
    if group is None:
        return x
    out = x.clone()
    dist.broadcast(out, src=dist.get_global_rank(group, root), group=group)
    return out


def reduce_scatter(x: torch.Tensor, mesh: Mesh, dim: Dims,
                   axis: int = 0) -> torch.Tensor:
    """lax.psum_scatter(tiled=True): the sum over `dim`, of which each
    rank keeps its 1/n block along `axis`."""
    group = _group(mesh, dim)
    if group is None:
        return x
    n = dist.get_world_size(group)
    inp = x.movedim(axis, 0).contiguous()
    if inp.shape[0] % n:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    out = inp.new_empty((inp.shape[0] // n,) + tuple(inp.shape[1:]))
    _reduce_scatter(out, inp, group=group)
    return out.movedim(0, axis)


def alltoall(x: torch.Tensor, mesh: Mesh, dim: Dims, split_axis: int = 0,
             concat_axis: int = 0) -> torch.Tensor:
    """hvd.alltoall: `x` split along `split_axis` into one block a rank,
    block j sent to rank j, the blocks received concatenated along
    `concat_axis` in rank order."""
    group = _group(mesh, dim)
    if group is None:
        return x
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"axis {split_axis} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    inp = x.movedim(split_axis, 0).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    blocks = [b.movedim(0, split_axis) for b in out.chunk(n)]
    return torch.cat(blocks, dim=concat_axis)


def hierarchical_allreduce_mean(x: torch.Tensor, mesh: Mesh,
                                ici_dims: Sequence[str] = ("dp",),
                                dcn_dim: str = "dcn") -> torch.Tensor:
    """The two-phase mean over a multi-slice mesh: reduce-scatter over
    the in-slice dims, all-reduce each rank's shard over dcn, all-gather
    back over the in-slice dims. A length that does not split over the
    in-slice ranks is zero-padded first, as the reference pads it. A
    phase over dims of size 1 is the identity; without a process group
    the whole mean is."""
    if _group(mesh, tuple(ici_dims) + (dcn_dim,)) is None:
        return x
    flat = x.reshape(-1)
    n_ici = mesh.dim_size(ici_dims)
    pad = (-flat.shape[0]) % n_ici
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard = flat
    for d in ici_dims:
        shard = reduce_scatter(shard, mesh, d)
    shard = allreduce_sum(shard, mesh, (dcn_dim,), inplace=True)
    for d in reversed(ici_dims):
        shard = allgather(shard, mesh, d)
    if pad:
        shard = shard[:-pad]
    return (shard / (mesh.dim_size((dcn_dim,)) * n_ici)).reshape(x.shape)


def allreduce_gradients(grads, mesh: Mesh, dims: Dims = ("dp",)):
    """Horovod's DistributedOptimizer hook: the mean over `dims` of every
    tensor of a dict, list or tuple of gradients (or of one tensor)."""
    if isinstance(grads, dict):
        return {k: allreduce_gradients(v, mesh, dims)
                for k, v in grads.items()}
    if isinstance(grads, (list, tuple)):
        return type(grads)(allreduce_gradients(g, mesh, dims) for g in grads)
    return allreduce_mean(grads, mesh, dims)


def sharded_allreduce_fn(mesh: Mesh, dims: Dims = ("dp",)):
    """The allreduce the scaling benchmark times
    (examples/allreduce_bench.py): fn(x) replaces this rank's `x` with
    the mean over `dims`, in place (the payload buffer is reused from
    call to call, as NCCL's own benchmarks reuse theirs), and returns
    it."""
    def fn(x: torch.Tensor) -> torch.Tensor:
        return allreduce_mean(x, mesh, dims, inplace=True)
    return fn


def allreduce_max(x: torch.Tensor, mesh: Mesh, dims: Dims) -> torch.Tensor:
    """The element-wise max of `x` over `dims` (lax.pmax; no gradient)."""
    group = _group(mesh, dims)
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


# ---------------------------------------------------------------------------
# the model-parallel autograd ops (Megatron's conjugate pairs)
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return allreduce_sum(g.contiguous(), ctx.mesh, ctx.dims), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        return allreduce_sum(x.contiguous(), mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims, axis):
        ctx.mesh, ctx.dims, ctx.axis = mesh, dims, axis
        ctx.n = x.shape[axis]
        return allgather(x, mesh, dims, axis)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(_dims(ctx.dims))
        return g.narrow(ctx.axis, i * ctx.n, ctx.n), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims, axis):
        ctx.mesh, ctx.dims, ctx.axis = mesh, dims, axis
        n = mesh.dim_size(_dims(dims))
        if x.shape[axis] % n:
            raise ValueError(f"axis {axis} of {tuple(x.shape)} does not "
                             f"split over {n} ranks")
        per = x.shape[axis] // n
        return x.narrow(axis, mesh.index(_dims(dims)) * per,
                        per).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (allgather(g.contiguous(), ctx.mesh, ctx.dims, ctx.axis),
                None, None, None)


def copy_to(x: torch.Tensor, mesh: Mesh, dims: Dims) -> torch.Tensor:
    """Identity forward, all-reduce sum of the gradient over `dims`
    backward: a value replicated over `dims` entering per-shard work."""
    if _group(mesh, dims) is None:
        return x
    return _CopyTo.apply(x, mesh, dims)


def reduce_from(x: torch.Tensor, mesh: Mesh, dims: Dims) -> torch.Tensor:
    """All-reduce sum forward over `dims`, identity backward: per-shard
    partial sums made whole (the conjugate of `copy_to`)."""
    if _group(mesh, dims) is None:
        return x
    return _ReduceFrom.apply(x, mesh, dims)


def gather_from(x: torch.Tensor, mesh: Mesh, dims: Dims,
                axis: int) -> torch.Tensor:
    """All-gather along `axis` forward, this rank's block of the
    gradient backward."""
    if _group(mesh, dims) is None:
        return x
    return _GatherFrom.apply(x, mesh, dims, axis % x.ndim)


def scatter_to(x: torch.Tensor, mesh: Mesh, dims: Dims,
               axis: int) -> torch.Tensor:
    """This rank's block along `axis` forward, all-gather of the
    gradient backward (the conjugate of `gather_from`)."""
    if _group(mesh, dims) is None:
        return x
    return _ScatterTo.apply(x, mesh, dims, axis % x.ndim)


# ---------------------------------------------------------------------------
# ring hops and the ring collective-matmuls
# ---------------------------------------------------------------------------

class _Hop:
    """Receive buffers of an in-flight hop; `wait()` returns them."""

    def __init__(self, outs: List[torch.Tensor], reqs=()):
        self.outs, self.reqs = outs, list(reqs)

    def wait(self) -> List[torch.Tensor]:
        for r in self.reqs:
            r.wait()
        self.reqs = []
        return self.outs


def ring_hop(tensors: Sequence[torch.Tensor], mesh: Mesh, dim: str,
             shift: int = 1, tag: int = 0) -> _Hop:
    """Start one hop of a ring over `dim` (lax.ppermute with the ring
    permutation): each tensor goes to the rank `shift` places on, and
    the same-shaped tensors of the rank `shift` places back arrive in
    new buffers. Returns a `_Hop`; over one rank it is the identity.
    Tensor j travels under message tag `tag + j`: hops in flight at the
    same time between the same ranks take tags of their own.

    Point-to-point sends and receives in one `batch_isend_irecv`, except
    for CUDA tensors over gloo (ranks sharing a card): gloo's send and
    receive take host memory only (a CUDA pointer aborts the process), so
    there each tensor moves by an `all_to_all_single` whose only
    non-empty splits are the one to the next rank and the one from the
    previous rank, a collective gloo runs on CUDA tensors. It completes
    before `ring_hop` returns, so that hop does not overlap the matmul."""
    group = _group(mesh, dim)
    if group is None:
        return _Hop(list(tensors))
    n, i = dist.get_world_size(group), dist.get_rank(group)
    to, frm = (i + shift) % n, (i - shift) % n
    if dist.get_backend(group) == "gloo" and any(t.is_cuda
                                                 for t in tensors):
        outs = []
        for t in tensors:
            t = t.contiguous()
            o = torch.empty_like(t)
            ins, got = [0] * n, [0] * n
            ins[to], got[frm] = t.numel(), t.numel()
            dist.all_to_all_single(o.view(-1), t.view(-1), got, ins,
                                   group=group)
            outs.append(o)
        return _Hop(outs)
    dst = dist.get_global_rank(group, to)
    src = dist.get_global_rank(group, frm)
    outs, ops = [], []
    for j, t in enumerate(tensors):
        t = t.contiguous()
        o = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t, dst, group, tag + j))
        ops.append(dist.P2POp(dist.irecv, o, src, group, tag + j))
        outs.append(o)
    return _Hop(outs, dist.batch_isend_irecv(ops))


#: the message tags of a bidirectional ring's reverse hops
_BACK = 16


def _ring(mesh: Mesh, dim: str):
    group = _group(mesh, dim)
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _halves(size: int):
    """Split a row count for the bidirectional ring: the front half rides
    the forward ring, the back half the reverse ring. Front gets the odd
    row."""
    back = size // 2
    return size - back, back


def _rows(x, start: int, size: int):
    """`size` rows of the second-to-last dim from `start`."""
    return x.narrow(x.ndim - 2, start, size)


def _mm32(a, b):
    """a @ b accumulated and returned in f32."""
    return torch.matmul(a.float(), b.float())


def _dw(x, g):
    """x^T g over every leading dim, in f32: [K, N]."""
    return _mm32(x.reshape(-1, x.shape[-1]).t(), g.reshape(-1, g.shape[-1]))


def _agm_fwd(mesh, dim, x, w):
    """all_gather(x, rows) @ w: shard src's rows land at src * Sl, each
    shard's product computed while the next shard is in flight."""
    n, idx = _ring(mesh, dim)
    Sl = x.shape[-2]
    out = x.new_empty(x.shape[:-2] + (n * Sl, w.shape[-1]),
                      dtype=torch.promote_types(x.dtype, w.dtype))
    x_t = x
    for t in range(n):
        hop = ring_hop([x_t], mesh, dim) if t < n - 1 else None
        src = (idx - t) % n
        _rows(out, src * Sl, Sl).copy_(torch.matmul(x_t, w))
        if hop is not None:
            x_t, = hop.wait()
    return out


def _agm_bidir_fwd(mesh, dim, x, w):
    """Bidirectional all_gather(x, rows) @ w: front rows rotate forward
    (after t hops rank idx holds rank idx - t's front half), back rows
    backward (rank idx + t's back half); the output layout is the
    unidirectional one."""
    n, idx = _ring(mesh, dim)
    Sl = x.shape[-2]
    Hf, Hb = _halves(Sl)
    if n == 1 or Hb == 0:
        return _agm_fwd(mesh, dim, x, w)
    out = x.new_empty(x.shape[:-2] + (n * Sl, w.shape[-1]),
                      dtype=torch.promote_types(x.dtype, w.dtype))
    xf, xb = _rows(x, 0, Hf), _rows(x, Hf, Hb)
    for t in range(n):
        hops = ((ring_hop([xf], mesh, dim, 1),
                 ring_hop([xb], mesh, dim, -1, _BACK)) if t < n - 1 else None)
        _rows(out, ((idx - t) % n) * Sl, Hf).copy_(torch.matmul(xf, w))
        _rows(out, ((idx + t) % n) * Sl + Hf, Hb).copy_(torch.matmul(xb, w))
        if hops is not None:
            (xf,), (xb,) = hops[0].wait(), hops[1].wait()
    return out


def _mrs_fwd(mesh, dim, x, w):
    """reduce_scatter(x @ w, rows): the f32 accumulator bound for rank
    idx - 1 - t picks up this rank's partial for its rows, then moves
    on; after n - 1 hops it is home and takes this rank's own rows."""
    n, idx = _ring(mesh, dim)
    Sl = x.shape[-2] // n
    acc = x.new_zeros(x.shape[:-2] + (Sl, w.shape[-1]), dtype=torch.float32)
    for t in range(n - 1):
        acc = acc + _mm32(_rows(x, ((idx - 1 - t) % n) * Sl, Sl), w)
        acc, = ring_hop([acc], mesh, dim).wait()
    acc = acc + _mm32(_rows(x, idx * Sl, Sl), w)
    return acc.to(torch.promote_types(x.dtype, w.dtype))


def _mrs_bidir_fwd(mesh, dim, x, w):
    """Bidirectional reduce_scatter(x @ w, rows): one accumulator a half
    chunk, the two rotating in opposite directions."""
    n, idx = _ring(mesh, dim)
    Sl = x.shape[-2] // n
    Hf, Hb = _halves(Sl)
    if n == 1 or Hb == 0:
        return _mrs_fwd(mesh, dim, x, w)
    lead, N = x.shape[:-2], w.shape[-1]
    accA = x.new_zeros(lead + (Hf, N), dtype=torch.float32)
    accB = x.new_zeros(lead + (Hb, N), dtype=torch.float32)
    for t in range(n - 1):
        accA = accA + _mm32(_rows(x, ((idx - 1 - t) % n) * Sl, Hf), w)
        accB = accB + _mm32(_rows(x, ((idx + 1 + t) % n) * Sl + Hf, Hb), w)
        ha = ring_hop([accA], mesh, dim, 1)
        hb = ring_hop([accB], mesh, dim, -1, _BACK)
        (accA,), (accB,) = ha.wait(), hb.wait()
    accA = accA + _mm32(_rows(x, idx * Sl, Hf), w)
    accB = accB + _mm32(_rows(x, idx * Sl + Hf, Hb), w)
    return torch.cat([accA, accB], dim=-2).to(
        torch.promote_types(x.dtype, w.dtype))


def _agm_bwd(mesh, dim, x, w, g):
    """The mirrored rings of allgather_matmul: dx is the reduce-scatter
    schedule over g w^T (its accumulator moving with x's re-rotation),
    dw accumulates x_src^T g[src rows] as x goes round."""
    n, idx = _ring(mesh, dim)
    Sl = x.shape[-2]
    wt = w.t()
    dacc = x.new_zeros(x.shape[:-2] + (Sl, x.shape[-1]), dtype=torch.float32)
    dw = x.new_zeros(tuple(w.shape), dtype=torch.float32)
    x_t = x
    for t in range(n - 1):
        dacc = dacc + _mm32(_rows(g, ((idx - 1 - t) % n) * Sl, Sl), wt)
        dw = dw + _dw(x_t, _rows(g, ((idx - t) % n) * Sl, Sl))
        x_t, dacc = ring_hop([x_t, dacc], mesh, dim).wait()
    dacc = dacc + _mm32(_rows(g, idx * Sl, Sl), wt)
    dw = dw + _dw(x_t, _rows(g, ((idx - (n - 1)) % n) * Sl, Sl))
    return dacc.to(x.dtype), dw.to(w.dtype)


def _agm_bidir_bwd(mesh, dim, x, w, g):
    """_agm_bwd with both rings split in halves going opposite ways."""
    n, idx = _ring(mesh, dim)
    Sl = x.shape[-2]
    Hf, Hb = _halves(Sl)
    if n == 1 or Hb == 0:
        return _agm_bwd(mesh, dim, x, w, g)
    wt, K = w.t(), x.shape[-1]
    accA = x.new_zeros(x.shape[:-2] + (Hf, K), dtype=torch.float32)
    accB = x.new_zeros(x.shape[:-2] + (Hb, K), dtype=torch.float32)
    dw = x.new_zeros(tuple(w.shape), dtype=torch.float32)
    xf, xb = _rows(x, 0, Hf), _rows(x, Hf, Hb)
    for t in range(n):
        accA = accA + _mm32(_rows(g, ((idx - 1 - t) % n) * Sl, Hf), wt)
        accB = accB + _mm32(_rows(g, ((idx + 1 + t) % n) * Sl + Hf, Hb), wt)
        dw = dw + _dw(xf, _rows(g, ((idx - t) % n) * Sl, Hf))
        dw = dw + _dw(xb, _rows(g, ((idx + t) % n) * Sl + Hf, Hb))
        if t < n - 1:
            hf = ring_hop([xf, accA], mesh, dim, 1)
            hb = ring_hop([xb, accB], mesh, dim, -1, _BACK)
            (xf, accA), (xb, accB) = hf.wait(), hb.wait()
    return torch.cat([accA, accB], dim=-2).to(x.dtype), dw.to(w.dtype)


def _mrs_bwd(mesh, dim, x, w, g):
    """The mirrored rings of matmul_reducescatter: dx places g w^T blocks
    by the all-gather schedule, dw accumulates x[src rows]^T g as g
    goes round."""
    n, idx = _ring(mesh, dim)
    Sl = g.shape[-2]
    wt = w.t()
    dx = torch.empty_like(x)
    dw = x.new_zeros(tuple(w.shape), dtype=torch.float32)
    g_t = g
    for t in range(n):
        hop = ring_hop([g_t], mesh, dim) if t < n - 1 else None
        src = (idx - t) % n
        _rows(dx, src * Sl, Sl).copy_(torch.matmul(g_t, wt))
        dw = dw + _dw(_rows(x, src * Sl, Sl), g_t)
        if hop is not None:
            g_t, = hop.wait()
    return dx, dw.to(w.dtype)


def _mrs_bidir_bwd(mesh, dim, x, w, g):
    """_mrs_bwd with g's halves rotating in opposite directions."""
    n, idx = _ring(mesh, dim)
    Sl = g.shape[-2]
    Hf, Hb = _halves(Sl)
    if n == 1 or Hb == 0:
        return _mrs_bwd(mesh, dim, x, w, g)
    wt = w.t()
    dx = torch.empty_like(x)
    dw = x.new_zeros(tuple(w.shape), dtype=torch.float32)
    gf, gb = _rows(g, 0, Hf), _rows(g, Hf, Hb)
    for t in range(n):
        hops = ((ring_hop([gf], mesh, dim, 1),
                 ring_hop([gb], mesh, dim, -1, _BACK)) if t < n - 1 else None)
        sf, sb = (idx - t) % n, (idx + t) % n
        _rows(dx, sf * Sl, Hf).copy_(torch.matmul(gf, wt))
        _rows(dx, sb * Sl + Hf, Hb).copy_(torch.matmul(gb, wt))
        dw = dw + _dw(_rows(x, sf * Sl, Hf), gf)
        dw = dw + _dw(_rows(x, sb * Sl + Hf, Hb), gb)
        if hops is not None:
            (gf,), (gb,) = hops[0].wait(), hops[1].wait()
    return dx, dw.to(w.dtype)


class _RingMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mesh, dim, fwd, bwd):
        ctx.save_for_backward(x, w)
        ctx.mesh, ctx.dim, ctx.bwd = mesh, dim, bwd
        return fwd(mesh, dim, x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = ctx.bwd(ctx.mesh, ctx.dim, x, w, g.contiguous())
        return dx, dw, None, None, None, None


_RINGS = {("agm", "uni"): (_agm_fwd, _agm_bwd),
          ("agm", "bidir"): (_agm_bidir_fwd, _agm_bidir_bwd),
          ("mrs", "uni"): (_mrs_fwd, _mrs_bwd),
          ("mrs", "bidir"): (_mrs_bidir_fwd, _mrs_bidir_bwd)}


def _check_operands(name, x, w, ring):
    if x.ndim < 2 or w.ndim != 2:
        raise ValueError(
            f"{name}: x must be rank>=2 and w rank 2; got "
            f"x{tuple(x.shape)} w{tuple(w.shape)}")
    if x.shape[-1] != w.shape[0]:
        raise ValueError(
            f"{name}: contraction mismatch — x[..., {x.shape[-1]}] @ "
            f"w[{w.shape[0]}, ...] (x last dim must equal w first dim)")
    if ring not in ("uni", "bidir"):
        raise ValueError(
            f"{name}: ring must be 'uni' or 'bidir', got {ring!r}")


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, mesh: Mesh,
                     dim: str = "tp", ring: str = "uni") -> torch.Tensor:
    """Overlapped `all_gather(x, rows) @ w` over the ring of `dim`.

    x: [..., S_local, K], this rank's row shard of the gathered operand;
    w: [K, N_local], this rank's column shard (the ring never moves w).
    Returns [..., n * S_local, N_local]: every rank's rows against the
    local columns. The backward runs the mirrored rings. ring="bidir"
    splits each shard in half and rotates the halves in opposite
    directions; values and layout are the "uni" ring's."""
    _check_operands("allgather_matmul", x, w, ring)
    return _RingMatmul.apply(x, w, mesh, dim, *_RINGS["agm", ring])


def matmul_reducescatter(x: torch.Tensor, w: torch.Tensor, mesh: Mesh,
                         dim: str = "tp", ring: str = "uni") -> torch.Tensor:
    """Overlapped `reduce_scatter(x @ w, rows)` over the ring of `dim`.

    x: [..., S, K_local], rows whole, the contraction dim sharded; w:
    [K_local, N], this rank's row shard. Returns [..., ceil(S/n), N]:
    rank r holds rows [r Sl, (r + 1) Sl) of the sum over the ring, Sl =
    ceil(S/n). Rows that do not split over the ring are zero-padded to
    n Sl first, so the pad rows, exactly zero, land on the highest ranks;
    callers slice the gathered result back to S. Partial sums accumulate
    in f32. ring="bidir" as in `allgather_matmul`."""
    _check_operands("matmul_reducescatter", x, w, ring)
    n, _ = _ring(mesh, dim)
    pad = (-x.shape[-2]) % n
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    return _RingMatmul.apply(x, w, mesh, dim, *_RINGS["mrs", ring])


__all__ = ["allgather", "allgather_matmul", "allreduce_gradients",
           "allreduce_max", "allreduce_mean", "allreduce_sum", "alltoall",
           "broadcast", "copy_to", "gather_from",
           "hierarchical_allreduce_mean", "matmul_reducescatter",
           "reduce_from", "reduce_scatter", "ring_hop", "scatter_to",
           "sharded_allreduce_fn"]
