"""Hand-written CUDA kernels of the accelerator layer (the port of
``repro.kernels``).

Each kernel package has ``kernel.py`` (the ctypes wrapper, its launch
count and its plain PyTorch version), ``ops.py`` (the public wrapper in
the model's layout), ``ref.py`` (the dense or brute-force oracle) and
``csrc/`` (the CUDA source).

  masa_gemm       -- tiled matmul in two residency orders: output-stationary
                     (accumulator tile in registers, K innermost) and
                     weight-stationary (a panel of B resident in shared
                     memory across the walk over M)
  ssd_scan        -- Mamba-2 SSD chunked scan; blocks take a head's state
                     columns, which stay in registers across its chunks
  moe_gemm        -- grouped expert GEMM; each token block's expert id
                     designates the weight panel it multiplies
  paged_attention -- decode attention over a paged KV cache through a
                     block table, online softmax over the pages, each
                     sequence split over a thread-block cluster
  flash_attention -- fused attention forward; the S x S scores never reach
                     device memory, and GQA's kv head is indexed, not
                     expanded

:func:`build` compiles the five libraries together and :func:`load` opens
them; :func:`launches` and :func:`reset_launches` read and clear every
wrapper's launch count. ``dispatch`` holds the steps every wrapper shares
between its checks and its kernel.
"""
from repro_torch import cuda_build
from repro_torch.kernels.flash_attention import kernel as _flash_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.masa_gemm import kernel as _masa_gemm
from repro_torch.kernels.masa_gemm.ops import masa_gemm
from repro_torch.kernels.moe_gemm import kernel as _moe_gemm
from repro_torch.kernels.moe_gemm.ops import grouped_matmul
from repro_torch.kernels.paged_attention import kernel as _paged_attention
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.ssd_scan import kernel as _ssd_scan
from repro_torch.kernels.ssd_scan.ops import ssd_scan

__all__ = ["masa_gemm", "ssd_scan", "grouped_matmul", "paged_attention",
           "flash_attention"]

#: The kernel module of each package, in the order above.
MODULES = (_masa_gemm, _ssd_scan, _moe_gemm, _paged_attention,
           _flash_attention)
#: Library name -> source, for every kernel of the layer.
SOURCES = {n: p for m in MODULES for n, p in m.SOURCES.items()}


def build() -> dict:
    """Compile every library of the layer (one nvcc each, all at once) and
    load each; returns :func:`cuda_build.build`'s record."""
    built = cuda_build.build(SOURCES)
    load()
    return built


def load() -> None:
    """Open every library of the layer, each already built."""
    for m in MODULES:
        m._library()


def launches() -> dict[str, int]:
    """Every wrapper's launch count, by kernel."""
    return {k: v for m in MODULES for k, v in m.LAUNCHES.items()}


def reset_launches() -> None:
    for m in MODULES:
        m.reset_launches()
