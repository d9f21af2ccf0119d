"""Paged decode attention: the CUDA kernel (``kernel.py``,
``csrc/paged_attention.cu``), the wrapper that clamps the block table
(``ops.py``) and the dense oracle (``ref.py``)."""
from repro_torch.kernels.paged_attention.ops import paged_attention

__all__ = ["paged_attention"]
