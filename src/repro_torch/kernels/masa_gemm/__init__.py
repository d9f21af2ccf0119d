"""MASA-tiled matmul: the CUDA kernel (``kernel.py``, ``csrc/masa_gemm.cu``)
in two residency orders, the wrapper with the reference's fallback
(``ops.py``) and the dense oracle (``ref.py``)."""
from repro_torch.kernels.masa_gemm.ops import masa_gemm

__all__ = ["masa_gemm"]
