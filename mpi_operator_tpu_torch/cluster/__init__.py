"""The cluster layer of the operator (API servers, informers, work queue,
manifest serialization, the Kubernetes REST client): the PyTorch port's
copy of mpi_operator_tpu/cluster. It imports neither torch nor jax."""
from .apiserver import (  # noqa: F401
    Action, AlreadyExistsError, ApiError, ConflictError, InMemoryAPIServer,
    NotFoundError, TransientApiError, is_transient,
)
from .chaos import ControllerCrash, FaultingAPIServer, FaultRule  # noqa: F401
from .informers import Informer, InformerFactory, Lister  # noqa: F401
from .workqueue import RateLimitingQueue, meta_namespace_key, split_key  # noqa: F401
from . import resources  # noqa: F401
