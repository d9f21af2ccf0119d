"""PyTorch + CUDA port of the SALP/MASA DRAM simulator (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its tree
(``repro_torch/core/dram/<same module names>``) and never imports it. The
entry points run on the card unless the caller asks for the CPU: on CUDA
they launch hand-written kernels, on ``device="cpu"`` the kernels' plain
PyTorch versions.
"""
