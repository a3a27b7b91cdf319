"""The worker/launcher bootstrap on torch.distributed (bootstrap.py) and
the per-worker rank launcher (launch.py)."""
from .bootstrap import (  # noqa: F401
    BootstrapError, ProcessInfo, hybrid_mesh, initialize, process_info,
    resolve_worker_ordinal,
)

__all__ = ["BootstrapError", "ProcessInfo", "hybrid_mesh", "initialize",
           "process_info", "resolve_worker_ordinal"]
