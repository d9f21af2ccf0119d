"""Fused attention forward: the CUDA kernel (``kernel.py``,
``csrc/flash_attention.cu``), the GQA wrapper in the model's layout
(``ops.py``) and the dense oracle (``ref.py``)."""
from repro_torch.kernels.flash_attention.ops import flash_attention

__all__ = ["flash_attention"]
