"""Public wrapper for the grouped expert GEMM (the counterpart of
``repro.kernels.moe_gemm.ops``).

Contract: ``x_sorted`` is the MoE dispatch buffer flattened to [E*C, D] (C =
per-expert capacity, a multiple of the token block bt), so token blocks
never straddle experts and ``block_eids = arange(E*C/bt) // (C/bt)``;
:func:`capacity_block_eids` builds that designation vector. The kernel
trusts the ids, so :func:`grouped_matmul` checks them first: int32, each in
``[0, E)``. The tensor's device picks the CUDA kernel or its plain version.
"""
from __future__ import annotations

import torch

from repro_torch import compat
from repro_torch.kernels.moe_gemm.kernel import grouped_matmul_kernel


def capacity_block_eids(n_experts: int, capacity: int, bt: int,
                        device=None) -> torch.Tensor:
    """The expert id of each token block of the capacity layout, int32, on
    ``device`` (None: the card)."""
    if capacity % bt:
        raise ValueError(f"capacity {capacity} is not a multiple of bt={bt}")
    ids = torch.arange(n_experts * capacity // bt, dtype=torch.int32,
                       device=compat.resolve_device(device))
    return ids // (capacity // bt)


def grouped_matmul(x_sorted: torch.Tensor, w: torch.Tensor,
                   block_eids: torch.Tensor, *, bt: int = 128,
                   bf: int = 128) -> torch.Tensor:
    """x_sorted [T, D] @ w[block_eids[t // bt]] -> [T, F] in x's dtype."""
    if block_eids.dtype != torch.int32:
        raise TypeError(f"grouped_matmul takes int32 block_eids, got "
                        f"{block_eids.dtype}")
    if block_eids.numel():
        lo, hi = (int(v) for v in torch.aminmax(block_eids))
        if lo < 0 or hi >= w.shape[0]:
            raise ValueError(f"grouped_matmul: expert ids span [{lo}, {hi}], "
                             f"outside [0, {w.shape[0]})")
    return grouped_matmul_kernel(x_sorted, w, block_eids, bt=bt, bf=bf)
