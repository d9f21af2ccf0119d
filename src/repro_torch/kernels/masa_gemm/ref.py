"""Oracle for masa_gemm (the counterpart of ``repro.kernels.masa_gemm.ref``):
one fp32 product, cast back to a's dtype."""
from __future__ import annotations

import torch


def masa_gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.to(torch.float32) @ b.to(torch.float32)).to(a.dtype)
