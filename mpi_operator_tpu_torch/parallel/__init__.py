"""Parallel building blocks of the port: the gang's dcn x dp mesh
(mesh.py), its data-parallel collectives (collectives.py) and the
mixture-of-experts FFN with global routing (moe.py). The tp/sp/ep/pp
axes are later slices (ROADMAP.md steps 10b-10d)."""
from .mesh import (BATCH_AXES, Mesh, MeshConfig,  # noqa: F401
                   data_parallel_mesh, local_batch_size, make_mesh)
from .moe import MoeMlp  # noqa: F401

__all__ = ["BATCH_AXES", "Mesh", "MeshConfig", "MoeMlp",
           "data_parallel_mesh", "local_batch_size", "make_mesh"]
