"""Hand-written CUDA kernels of the accelerator layer (the port of
``repro.kernels``).

Each kernel package has ``kernel.py`` (the ctypes wrapper, its launch
count and its plain PyTorch version), ``ops.py`` (the public wrapper in
the model's layout), ``ref.py`` (the brute-force oracle) and ``csrc/``
(the CUDA source).

  ssd_scan -- Mamba-2 SSD chunked scan; the chunk state stays in shared
              memory across the chunks of one batch*head

The reference's masa_gemm, moe_gemm, paged_attention and flash_attention
kernels are not ported yet (ROADMAP.md, Queue 2).
"""
from repro_torch.kernels.ssd_scan.ops import ssd_scan

__all__ = ["ssd_scan"]
