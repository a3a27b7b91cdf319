"""The TPUJob controller in GPU mode: the PyTorch port's copy of
mpi_operator_tpu/controller (the soak harness, controller/chaos.py, is
not ported yet). It imports neither torch nor jax."""
from .controller import (  # noqa: F401
    ControllerConfig, Event, EventRecorder, ForeignOwnershipError,
    TPUJobController,
)
