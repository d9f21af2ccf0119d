"""Shared SALP abstractions: the paper's scheduling math, reused above the DRAM layer.

``cost_model``    — analytic conflict/overlap cost model (derived from the DRAM
                    timing engine) used by the serving scheduler to order
                    requests so that conflicts become designated hits.
``pipeline``      — the generic SALP pipeline schedule (fetch/compute/writeback
                    overlap with k resident slots) used to reason about Pallas
                    kernel residency and host prefetch depth.

Port note: a framework-free copy of ``repro.core.salp``, with import paths
rewritten to ``repro_torch`` (the port never imports the JAX
package); tests/test_torch_serve.py holds it equal to the reference.
"""
from repro_torch.core.salp.cost_model import SalpCostModel, AccessClass
from repro_torch.core.salp.pipeline import PipelineSpec, steady_state_throughput

__all__ = ["SalpCostModel", "AccessClass", "PipelineSpec", "steady_state_throughput"]
