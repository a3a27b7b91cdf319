"""The TPUJob API (types and admission validation): the PyTorch port's
copy of mpi_operator_tpu/api, with `nvidia.com/gpu` as a resource type.
It imports neither torch nor jax."""
from . import types, validation
from .types import *  # noqa: F401,F403
from .validation import ValidationError, validate_spec  # noqa: F401
