"""Serving in PyTorch (the port of ``repro.serve``): the paged cache's page
tables, the SALP-aware scheduler, the step functions and the engine, and
``what_if``, the query layer over sweep results."""
from repro_torch.serve.kvcache import PagedKVCache, PageAllocator
from repro_torch.serve.scheduler import SalpScheduler, Request
from repro_torch.serve.engine import EngineStats, ServingEngine
from repro_torch.serve.what_if import SweepIndex, what_if

__all__ = ["PagedKVCache", "PageAllocator", "SalpScheduler", "Request",
           "EngineStats", "ServingEngine", "SweepIndex", "what_if"]
