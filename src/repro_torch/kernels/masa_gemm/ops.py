"""Public wrapper for the MASA-tiled matmul (the counterpart of
``repro.kernels.masa_gemm.ops``).

The reference falls back from the weight-stationary order to the
output-stationary one when the whole-K panel exceeds its VMEM budget. The
port keeps that fallback with the card's limit in the budget's place: it
runs output-stationary when the weight-stationary launch's shared memory
(``kernel.ws_panel_bytes``, ``(64 + 128) * K`` elements) exceeds the
232,448 bytes a block may have on the H100 (K above 302 in float32, above
605 in bfloat16). The reference's checks apply to the order the caller
asked for, before the fallback: the output-stationary kernel takes any K,
so a weight-stationary K that is not a multiple of ``bk`` is taken on
either side of the limit (the reference refuses it above its own budget,
K above 8192 in float32 at the default tiles). The tensor's device picks the CUDA kernel or its
plain version.
"""
from __future__ import annotations

import torch

from repro_torch import cuda_build
from repro_torch.kernels.masa_gemm import kernel as K


def masa_gemm(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
              bn: int = 128, bk: int = 128,
              order: str = "output_stationary") -> torch.Tensor:
    """C = A @ B with an explicit residency order (see kernel.py)."""
    K.check_args(a, b, bm, bn, bk, order)
    if (order == "weight_stationary"
            and K.ws_panel_bytes(a.shape[1], a.dtype) > cuda_build.MAX_SMEM_BYTES):
        order = "output_stationary"  # K panel too large: fall back
    return K.run(a, b, order)
