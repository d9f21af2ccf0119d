"""The Python side of ``csrc/hopper_gemm.cuh``, the Hopper building blocks
of the bf16 bodies that the masa_gemm and moe_gemm kernels share (wgmma on
tiles that TMA feeds through a ring of shared-memory stages) and that the
flash_attention kernel's wgmma body is built from, and of
``csrc/tf32x3.cuh``, which masa_gemm's, moe_gemm's and
flash_attention's fp32 ``tf32x3`` bodies share (three TF32 ``mma.sync`` a
product on tiles that ``cp.async`` feeds).

Each wrapper picks its body by shape, before the launch, in one predicate
(``masa_gemm.kernel.body``, ``moe_gemm.kernel.body``,
``flash_attention.kernel.body``) built on :func:`tma_ready` and
:func:`tf32x3_ready`; every other input takes the wrapper's simt body. The
choice is never a fallback on failure: a wgmma or tf32x3 launch that fails
raises. :func:`raster` mirrors the header's tile raster, which the launch
order of both GEMMs follows.
"""
from __future__ import annotations

import torch

#: The bodies a wrapper with a wgmma body counts its launches by.
BODIES = ("wgmma", "simt")


def tma_ready(*tensors: torch.Tensor) -> bool:
    """True when every tensor is bf16 with a 16-byte aligned base, as TMA's
    tensor maps need (the caller checks that the rows are whole 16-byte
    units)."""
    return all(t.dtype == torch.bfloat16 and t.data_ptr() % 16 == 0
               for t in tensors)


def tf32x3_ready(*tensors: torch.Tensor) -> bool:
    """True when every tensor is fp32 with a 16-byte aligned base, as the
    tf32x3 bodies' 16-byte ``cp.async`` copies need (the caller checks that
    the rows are whole 16-byte units)."""
    return all(t.dtype == torch.float32 and t.data_ptr() % 16 == 0
               for t in tensors)


def raster(t: int, mt: int, nt: int, group_m: int) -> tuple[int, int]:
    """Tile ``t`` of an ``mt`` x ``nt`` grid of output tiles -> its (row
    tile, column tile), as ``hopper::raster`` launches them: groups of
    ``group_m`` row tiles one after the other, M fastest within one column
    tile inside a group."""
    per_group = group_m * nt
    g, r = divmod(t, per_group)
    first = g * group_m
    rows = min(mt - first, group_m)
    return first + r % rows, r // rows
