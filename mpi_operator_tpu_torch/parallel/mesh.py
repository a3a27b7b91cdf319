"""The gang's device mesh: the counterpart of
`mpi_operator_tpu/parallel/mesh.py` for the reference's one parallelism
strategy, data parallelism over slices (`dcn`) and the ranks of a slice
(`dp`).

The reference lays a `jax.sharding.Mesh` over its devices with the axes
of `AXIS_ORDER`, and XLA inserts the collectives. Here every rank is a
process with one card, and the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the gang's ranks with
the named dims ("dcn", "dp"), dcn outermost: rank = slice * dp + the
rank's index in its slice, the slice-major order in which the bootstrap
numbers the ranks (bootstrap.process_info). A collective over a dim runs
over that dim's process group (parallel/collectives.py); over both dims
it runs over the mesh's whole group.

`MeshConfig` keeps every axis of the reference so that its sizes, its
device count and `local_batch_size` read the same; an axis other than
dcn and dp above 1 raises, naming the ROADMAP.md step that ports it.

A gang of one is a valid mesh. A process that joined no process group
gets a `Mesh` without a DeviceMesh, and every collective over it is the
identity, so the single-process paths run as they did.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as dist

# the reference's axis order, outermost first (cross-slice first)
AXIS_ORDER = ("dcn", "pp", "dp", "fsdp", "ep", "sp", "tp")
#: the dims of the port's DeviceMesh, outermost first
MESH_DIMS = ("dcn", "dp")
#: batch dims shard over every data-like axis (dcn slices x dp x fsdp)
BATCH_AXES = ("dcn", "dp", "fsdp")
# the ROADMAP.md step that ports each other axis
_STEP = {"fsdp": "10b", "tp": "10c", "sp": "10c", "ep": "10c", "pp": "10d"}


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
    the process joined a group, the DeviceMesh over them. `shape` maps
    every axis of AXIS_ORDER to its size, as the reference's mesh
    does."""

    def __init__(self, config: MeshConfig, ranks: Sequence[int],
                 device_mesh=None, whole_group=None):
        self.config = config
        self.ranks = tuple(ranks)
        self.device_mesh = device_mesh
        self._whole = whole_group

    @property
    def shape(self) -> Dict[str, int]:
        return self.config.axis_sizes()

    @property
    def size(self) -> int:
        return self.config.num_devices

    def __contains__(self, rank: int) -> bool:
        return rank in self.ranks

    def group(self, dims: Iterable[str]):
        """The process group of `dims` (a subset of MESH_DIMS): one
        dim's group, or the whole mesh's for both; None when the mesh
        has no DeviceMesh (every collective over it is the identity)."""
        dims = tuple(dims)
        unknown = [d for d in dims if d not in MESH_DIMS]
        if unknown or not dims:
            raise ValueError(f"mesh dims {dims}: the port's mesh has "
                             f"{MESH_DIMS}")
        if self.device_mesh is None:
            return None
        if set(dims) == set(MESH_DIMS):
            return self._whole
        return self.device_mesh.get_group(dims[0])

    def dim_size(self, dims: Iterable[str]) -> int:
        return math.prod(self.shape[d] for d in dims)

    def position(self, rank: Optional[int] = None) -> int:
        """This rank's (or `rank`'s) place in the mesh, dcn outermost:
        its index along the batch axes."""
        if self.device_mesh is None:
            return 0
        return self.ranks.index(dist.get_rank() if rank is None else rank)


def make_mesh(config: MeshConfig, ranks: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None) -> Mesh:
    """The mesh over `ranks` (default every rank of the process group;
    rank 0 alone without one), dcn outermost. Every rank of the group
    calls it, member or not: the DeviceMesh makes its dims' groups
    collectively. `device_type` is the DeviceMesh's ("cuda" when the
    current process drives a card, else "cpu")."""
    for axis, size in config.axis_sizes().items():
        if axis not in MESH_DIMS and size > 1:
            raise ValueError(
                f"{axis}={size}: the port's mesh is data-parallel over "
                f"{MESH_DIMS} only; {axis} is ROADMAP.md step "
                f"{_STEP[axis]}")
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    ranks = list(range(world) if ranks is None else ranks)
    if config.num_devices != len(ranks):
        raise ValueError(
            f"mesh asks for {config.num_devices} devices "
            f"({config.axis_sizes()}), got {len(ranks)}")
    if not grouped:
        return Mesh(config, ranks)
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() and \
            dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import DeviceMesh
    layout = torch.tensor(ranks, dtype=torch.int64).view(config.dcn,
                                                          config.dp)
    device_mesh = DeviceMesh(device_type, layout, mesh_dim_names=MESH_DIMS)
    whole = (dist.group.WORLD if ranks == list(range(world))
             else dist.new_group(ranks))
    return Mesh(config, ranks, device_mesh, whole)


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
           "data_parallel_mesh", "local_batch_size", "make_mesh"]
