"""Grouped expert GEMM: the CUDA kernel (``kernel.py``, ``csrc/moe_gemm.cu``),
the wrapper with the capacity-layout helper (``ops.py``) and the dense
oracle (``ref.py``)."""
from repro_torch.kernels.moe_gemm.ops import capacity_block_eids, grouped_matmul

__all__ = ["capacity_block_eids", "grouped_matmul"]
