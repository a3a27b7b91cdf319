"""Parallel building blocks of the port: the gang's mesh over dcn, pp,
dp, fsdp, ep, sp and tp (mesh.py), its collectives, the model-parallel
autograd ops and the ring collective-matmuls (collectives.py), the
logical sharding rules (sharding.py), ring attention (ring_attention.py),
the mixture-of-experts FFN with global routing over ep (moe.py), and
pipelines over pp: the stage model, GPipe and the generic pipeline
(pipeline.py), the interleaved 1F1B schedule (pipeline_1f1b.py)."""
from .mesh import (BATCH_AXES, Mesh, MeshConfig,  # noqa: F401
                   data_parallel_mesh, local_batch_size, make_mesh)
from .moe import MoeMlp  # noqa: F401

__all__ = ["BATCH_AXES", "Mesh", "MeshConfig", "MoeMlp",
           "data_parallel_mesh", "local_batch_size", "make_mesh"]
