"""Continuous-batching serving on the PyTorch port.

    from mpi_operator_tpu_torch.models import create_lm
    from mpi_operator_tpu_torch.serve import EngineConfig, Request, ServingEngine
    engine = ServingEngine(create_lm("gpt2-medium"), EngineConfig(slots=8))
    # or the paged cache with prefix caching:
    #   EngineConfig(slots=8, paged=True, page_size=64)
    results = engine.run([Request(0, prompt_ids, max_new_tokens=64)])

See engine.py for the architecture notes; generate() remains the
fixed-batch oracle the engine is parity-tested against.
"""
from .engine import (  # noqa: F401
    EngineConfig, RequestResult, ServingEngine, sample_slots,
)
from .scheduler import Request, RequestState, Scheduler, plan_chunks  # noqa: F401
from .slots import PageAllocator, SlotManager  # noqa: F401

__all__ = ["EngineConfig", "PageAllocator", "Request", "RequestResult",
           "RequestState", "Scheduler", "ServingEngine", "SlotManager",
           "plan_chunks", "sample_slots"]
