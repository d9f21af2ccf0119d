"""Oracle for grouped_matmul (the counterpart of
``repro.kernels.moe_gemm.ref``): gather each token block's expert panel and
multiply, summing in fp32."""
from __future__ import annotations

import torch


def grouped_matmul_ref(x_sorted: torch.Tensor, w: torch.Tensor,
                       block_eids: torch.Tensor, bt: int) -> torch.Tensor:
    t, d = x_sorted.shape
    xb = x_sorted.reshape(t // bt, bt, d).to(torch.float32)
    wb = w[block_eids.long()].to(torch.float32)           # [nb, D, F]
    y = torch.einsum("ntd,ndf->ntf", xb, wb)
    return y.reshape(t, w.shape[-1]).to(x_sorted.dtype)
