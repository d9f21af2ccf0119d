"""The generic SALP pipeline schedule.

Models the steady-state throughput of a k-slot fetch/compute/writeback pipeline
— the TPU-level analogue of the paper's mechanisms (DESIGN.md Layer B):

  slots = 1                      -> fully serialized  (the subarray-oblivious bank)
  slots = 2, overlap_wb = False  -> SALP-1  (fetch(i+1) overlaps writeback(i))
  slots = 2, overlap_wb = True   -> SALP-2  (fetch issued before writeback completes)
  slots = k > 2                  -> MASA    (k resident buffers; reuse hits skip fetch)

Used to choose Pallas kernel residency depth and host prefetch depth, and as a
pure-python oracle in tests.

Port note: a framework-free copy of ``repro.core.salp.pipeline``, with import paths
rewritten to ``repro_torch`` (the port never imports the JAX
package); tests/test_torch_serve.py holds it equal to the reference.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    fetch_cycles: float        # "ACTIVATE": HBM->VMEM tile DMA
    compute_cycles: float      # "column access": MXU/VPU on the resident tile
    writeback_cycles: float    # "PRECHARGE/write recovery": VMEM->HBM
    slots: int = 2             # concurrently resident tiles ("activated subarrays")
    overlap_writeback: bool = True   # SALP-2 semantics
    reuse_rate: float = 0.0    # fraction of steps whose tile is already resident (MASA hits)


def steady_state_throughput(spec: PipelineSpec) -> float:
    """Tiles retired per cycle in steady state."""
    f = spec.fetch_cycles * (1.0 - spec.reuse_rate)
    c = spec.compute_cycles
    w = spec.writeback_cycles

    if spec.slots <= 1:
        # fully serialized: fetch -> compute -> writeback per tile
        per_tile = f + c + w
    elif not spec.overlap_writeback:
        # SALP-1: fetch(i+1) may start only after writeback(i) issued; the
        # writeback itself overlaps the next fetch.
        per_tile = max(c, f, w) if spec.slots > 2 else max(c, f + (w if f < w else 0), w)
        per_tile = max(c, f) + max(0.0, w - f)  # conservative 2-slot schedule
    else:
        # SALP-2/MASA: all three phases overlap; the slowest stage binds.
        per_tile = max(c, f, w)
    return 1.0 / max(per_tile, 1e-9)


def speedup_ladder(fetch: float, compute: float, writeback: float,
                   reuse_rate: float = 0.0) -> dict[str, float]:
    """Throughput of the four policy analogues for a given tile shape."""
    base = steady_state_throughput(PipelineSpec(fetch, compute, writeback, slots=1))
    out = {"baseline": base}
    out["salp1"] = steady_state_throughput(
        PipelineSpec(fetch, compute, writeback, slots=2, overlap_writeback=False))
    out["salp2"] = steady_state_throughput(
        PipelineSpec(fetch, compute, writeback, slots=2, overlap_writeback=True))
    out["masa"] = steady_state_throughput(
        PipelineSpec(fetch, compute, writeback, slots=4, overlap_writeback=True,
                     reuse_rate=reuse_rate))
    return out
