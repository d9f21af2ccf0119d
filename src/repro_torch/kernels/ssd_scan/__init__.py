"""Mamba-2 SSD chunked scan: the CUDA kernel (``kernel.py``,
``csrc/ssd_scan.cu``), the model-layout wrapper (``ops.py``) and the
brute-force oracle (``ref.py``)."""
from repro_torch.kernels.ssd_scan.ops import ssd_scan

__all__ = ["ssd_scan"]
