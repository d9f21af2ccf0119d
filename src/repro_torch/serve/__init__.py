"""Serving in PyTorch (the port of ``repro.serve``): the paged cache's page
tables, the SALP-aware scheduler, the step functions and the engine.
``what_if`` (a query layer over sweep results) waits for the sweep layer."""
from repro_torch.serve.kvcache import PagedKVCache, PageAllocator
from repro_torch.serve.scheduler import SalpScheduler, Request
from repro_torch.serve.engine import EngineStats, ServingEngine

__all__ = ["PagedKVCache", "PageAllocator", "SalpScheduler", "Request",
           "EngineStats", "ServingEngine"]
