"""The gang's device mesh: the counterpart of
`mpi_operator_tpu/parallel/mesh.py` over every axis of the reference's
`AXIS_ORDER`: slices (`dcn`), pipeline stages (`pp`), data parallelism
(`dp`), fully sharded data parallelism (`fsdp`), expert (`ep`),
sequence (`sp`) and tensor (`tp`) parallelism.

`pp` is not a batch axis: every pp rank with the same data coordinates
holds the same rows, and `Mesh.group(("pp",))` is the stage group a
pipeline's hops run over (parallel/pipeline.py, train/pp_trainer.py).

The reference lays a `jax.sharding.Mesh` over its devices with the axes
of `AXIS_ORDER`, and XLA inserts the collectives. Here every rank is a
process with one card (or a share of one, over gloo), and the mesh is
the ranks laid out row-major over `AXIS_ORDER`, dcn outermost and tp
innermost: rank index i of `ranks` holds the coordinates
`np.unravel_index(i, sizes)`, which is the reference's device order on
a flat device set (its `make_mesh` reshapes the device list the same
way), so rank r of the port and device r of the JAX mesh hold the same
coordinates. The ranks of one slice are consecutive, as the bootstrap
numbers them (bootstrap.process_info).

`Mesh.group(dims)` is the process group of the ranks that share every
coordinate but those of `dims`, for any subset of the axes: the
`torch.distributed.device_mesh.DeviceMesh` over the mesh's axes of size
above 1 gives the one-axis groups, and `make_mesh` makes the group of
every larger subset up front (every rank of the process group calls it,
in one order). A collective over dims whose sizes multiply to 1 is the
identity (parallel/collectives.py); over every axis it runs over the
mesh's whole group, a gang of one included.

A process that joined no process group gets a `Mesh` without groups, and
every collective over it is the identity, so the single-process paths
run as they did.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the reference's axis order, outermost first (cross-slice first)
AXIS_ORDER = ("dcn", "pp", "dp", "fsdp", "ep", "sp", "tp")
#: the dims a Mesh names: every axis of AXIS_ORDER
MESH_DIMS = AXIS_ORDER
#: batch dims shard over every data-like axis (dcn slices x dp x fsdp)
BATCH_AXES = ("dcn", "dp", "fsdp")
#: the axes whose ranks hold other tokens of the global batch: the data
#: axes and the sequence shards (a gradient sums over them)
TOKEN_AXES = BATCH_AXES + ("sp",)


@dataclass
class MeshConfig:
    """Sizes for each mesh axis; 1 means the axis is collapsed."""
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1       # pipeline stages
    dcn: int = 1      # number of slices (multi-slice data parallelism)

    def axis_sizes(self) -> Dict[str, int]:
        return {"dcn": self.dcn, "pp": self.pp, "dp": self.dp,
                "fsdp": self.fsdp, "ep": self.ep, "sp": self.sp,
                "tp": self.tp}

    @property
    def num_devices(self) -> int:
        return math.prod(self.axis_sizes().values())

    @staticmethod
    def data_parallel(n_devices: int, num_slices: int = 1) -> "MeshConfig":
        """The reference's sole strategy: pure data parallelism, the
        slice count on the dcn axis."""
        if n_devices % num_slices != 0:
            raise ValueError(
                f"{n_devices} devices not divisible into {num_slices} slices")
        return MeshConfig(dp=n_devices // num_slices, dcn=num_slices)


class Mesh:
    """The gang's mesh: its config, its ranks in mesh order and, when
    the process joined a group, the DeviceMesh and the groups over them.
    `shape` maps every axis of AXIS_ORDER to its size, as the
    reference's mesh does."""

    def __init__(self, config: MeshConfig, ranks: Sequence[int],
                 device_mesh=None, whole_group=None,
                 groups: Optional[Dict[frozenset, object]] = None):
        self.config = config
        self.ranks = tuple(ranks)
        self.device_mesh = device_mesh
        self._whole = whole_group
        self._groups = groups or {}

    @property
    def shape(self) -> Dict[str, int]:
        return self.config.axis_sizes()

    @property
    def size(self) -> int:
        return self.config.num_devices

    def __contains__(self, rank: int) -> bool:
        return rank in self.ranks

    def group(self, dims: Iterable[str]):
        """The process group of `dims` (any subset of AXIS_ORDER): the
        ranks that share this rank's coordinates on every other axis;
        the whole mesh's group when `dims` spans every rank; None when
        the mesh has no process group or the dims' sizes multiply to 1
        (every collective over it is the identity)."""
        dims = tuple(dims)
        unknown = [d for d in dims if d not in AXIS_ORDER]
        if unknown or not dims:
            raise ValueError(f"mesh dims {dims}: the port's mesh has "
                             f"{AXIS_ORDER}")
        if self.device_mesh is None:
            return None
        n = self.dim_size(dims)
        if n == self.size:
            return self._whole
        if n == 1:
            return None
        live = frozenset(d for d in dims if self.shape[d] > 1)
        if len(live) == 1:
            return self.device_mesh.get_group(next(iter(live)))
        return self._groups[live]

    def dim_size(self, dims: Iterable[str]) -> int:
        return math.prod(self.shape[d] for d in dims)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """{axis: coordinate} of `rank` (default this process's rank; all
        0 for this process without a process group)."""
        if rank is None and self.device_mesh is None:
            return {a: 0 for a in AXIS_ORDER}
        i = self.ranks.index(dist.get_rank() if rank is None else rank)
        sizes = [self.shape[a] for a in AXIS_ORDER]
        return dict(zip(AXIS_ORDER, (int(c) for c in
                                     np.unravel_index(i, sizes))))

    def index(self, dims: Iterable[str], rank: Optional[int] = None) -> int:
        """This rank's index along `dims` (row-major in AXIS_ORDER): its
        rank in `group(dims)`."""
        c = self.coords(rank)
        dims = [d for d in AXIS_ORDER if d in tuple(dims)]
        return int(np.ravel_multi_index([c[d] for d in dims],
                                        [self.shape[d] for d in dims])) \
            if dims else 0

    def position(self, rank: Optional[int] = None) -> int:
        """This rank's (or `rank`'s) place along the batch axes (dcn, dp,
        fsdp), dcn outermost: which rows of the global batch it holds."""
        return self.index(BATCH_AXES, rank)


def _blocks(sizes: Dict[str, int], live: Sequence[str]):
    """The index blocks of the mesh's row-major rank order that share
    every coordinate but those of `live`, in mesh order."""
    shape = [sizes[a] for a in AXIS_ORDER]
    grid = np.arange(math.prod(shape)).reshape(shape)
    moved = np.moveaxis(grid, [AXIS_ORDER.index(a) for a in live],
                        range(-len(live), 0))
    return moved.reshape(-1, math.prod(sizes[a] for a in live))


def make_mesh(config: MeshConfig, ranks: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None) -> Mesh:
    """The mesh over `ranks` (default every rank of the process group;
    rank 0 alone without one), dcn outermost and tp innermost. Every rank
    of the group calls it, member or not: the DeviceMesh and the groups
    of several axes are made collectively. `device_type` is the
    DeviceMesh's ("cuda" when the current process drives a card over
    NCCL, else "cpu")."""
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    ranks = list(range(world) if ranks is None else ranks)
    if config.num_devices != len(ranks):
        raise ValueError(
            f"mesh asks for {config.num_devices} devices "
            f"({config.axis_sizes()}), got {len(ranks)}")
    if not grouped:
        return Mesh(config, ranks)
    if ranks != sorted(ranks):
        raise ValueError(f"mesh ranks {ranks} must ascend")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() and \
            dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import DeviceMesh
    sizes = config.axis_sizes()
    live = [a for a in AXIS_ORDER if sizes[a] > 1] or ["dp"]
    layout = torch.tensor(ranks, dtype=torch.int64).view(
        [sizes[a] for a in live])
    device_mesh = DeviceMesh(device_type, layout,
                             mesh_dim_names=tuple(live))
    whole = (dist.group.WORLD if ranks == list(range(world))
             else dist.new_group(ranks))
    groups, me = {}, dist.get_rank()
    for n in range(2, len(live)):
        for dims in itertools.combinations(live, n):
            for block in _blocks(sizes, dims):
                members = [ranks[i] for i in block]
                group = dist.new_group(members)
                if me in members:
                    groups[frozenset(dims)] = group
    return Mesh(config, ranks, device_mesh, whole, groups)


def data_parallel_mesh(num_slices: int = 1) -> Mesh:
    """The data-parallel mesh over every rank of the process group,
    `num_slices` on dcn (a gang of one without a group included)."""
    world = dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1
    return make_mesh(MeshConfig.data_parallel(world, num_slices))


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = math.prod(mesh.shape[a] for a in BATCH_AXES)
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data-parallel degree {n}")
    return global_batch // n


__all__ = ["AXIS_ORDER", "BATCH_AXES", "MESH_DIMS", "Mesh", "MeshConfig",
           "TOKEN_AXES", "data_parallel_mesh", "local_batch_size",
           "make_mesh"]
