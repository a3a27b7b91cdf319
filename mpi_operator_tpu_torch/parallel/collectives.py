"""The data-parallel collectives: the counterpart of the explicit half of
`mpi_operator_tpu/parallel/collectives.py` (`allreduce_mean`,
`allreduce_sum`, `allgather`, `broadcast`, `reduce_scatter`, `alltoall`,
`hierarchical_allreduce_mean`, `allreduce_gradients`,
`sharded_allreduce_fn`) over torch.distributed.

The reference calls these inside shard_map on each device's shard with
an axis name. Here each rank calls them on its own tensor with a mesh
(parallel/mesh.py) and a mesh dim name (or a tuple of them), and the
collective runs over that dim's process group (both dims: the mesh's
whole group): NCCL between cards, gloo on the CPU and where two ranks
share a card. Each returns a new tensor unless `inplace` says
otherwise; over a mesh without a process group (one process) each is
the identity, as a collective over one device is. The ring
collective-matmuls (`allgather_matmul`, `matmul_reducescatter`) are
ROADMAP.md step 10c.

Gloo runs every one of these on CUDA tensors as well (torch 2.11 on
the H100, where two ranks share a card), so no leg stages a collective
through the host.
"""
from __future__ import annotations

from typing import Sequence, Union

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
    in-slice ranks is zero-padded first, as the reference pads it."""
    if _group(mesh, dcn_dim) is None:
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


__all__ = ["allgather", "allreduce_gradients", "allreduce_mean",
           "allreduce_sum", "alltoall", "broadcast",
           "hierarchical_allreduce_mean", "reduce_scatter",
           "sharded_allreduce_fn"]
