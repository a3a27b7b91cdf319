"""Continuous-batching serving on the PyTorch port.

    from mpi_operator_tpu_torch.models import create_lm
    from mpi_operator_tpu_torch.serve import EngineConfig, Request, ServingEngine
    engine = ServingEngine(create_lm("gpt2-medium"), EngineConfig(slots=8))
    # or the paged cache with prefix caching:
    #   EngineConfig(slots=8, paged=True, page_size=64)
    results = engine.run([Request(0, prompt_ids, max_new_tokens=64)])

See engine.py for the architecture notes; generate() remains the
fixed-batch oracle the engine is parity-tested against. The fleet:
`DisaggEngine` (prefill and decode pools bridged by the paged-KV
handoff, transfer.py) and `Router` (prefix-affinity dispatch over
engine replicas, with live attach and drain, router.py).
"""
from .engine import (  # noqa: F401
    DecodeEngine, DisaggEngine, EngineConfig, PrefillEngine, RequestResult,
    ServingEngine, propose_ngram, sample_slots,
)
from .router import ReplicaHandle, Router, RouterConfig  # noqa: F401
from .scheduler import Request, RequestState, Scheduler, plan_chunks  # noqa: F401
from .slots import PageAllocator, SlotManager  # noqa: F401
from .transfer import PageTransfer  # noqa: F401

__all__ = ["DecodeEngine", "DisaggEngine", "EngineConfig", "PageAllocator",
           "PageTransfer", "PrefillEngine", "ReplicaHandle", "Request",
           "RequestResult", "RequestState", "Router", "RouterConfig",
           "Scheduler", "ServingEngine", "SlotManager", "plan_chunks",
           "propose_ngram", "sample_slots"]
