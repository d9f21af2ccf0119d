"""The CUDA MASA-tiled matmul, its wrapper and its plain version.

The counterpart of ``repro.kernels.masa_gemm.kernel`` (``masa_gemm_kernel``,
bodies ``_kernel_os`` and ``_kernel_ws``): ``csrc/masa_gemm.cu`` computes
``c = a @ b`` for ``a [M, K]``, ``b [K, N]`` in one of two residency orders
(the source's header says how each keeps its tiles and what bounds it),
summing in fp32 and writing ``c`` in a's dtype. It has three bodies:
wgmma on TMA-fed tiles for bf16 (``csrc/hopper_gemm.cuh``), ``tf32x3`` for
fp32 (three TF32 ``mma.sync`` a product on ``cp.async``-fed tiles, as
accurate as fp32: ``csrc/tf32x3.cuh``) and fp32 FMAs on the CUDA cores
(``simt``) for the rest.

* :func:`masa_gemm_kernel` is the wrapper: :func:`check_args`, the
  reference's divisibility checks (``bm``, ``bn``, and ``bk`` for the
  output-stationary order) raised as ``ValueError``, then :func:`run`,
  which launches the kernel on a CUDA tensor (or raises) and runs
  :func:`masa_gemm_plain` on a CPU tensor. The kernel's tiles are its own.
* :func:`ws_panel_bytes` is the weight-stationary budget, counted here
  alone: the simt launch takes it as its shared memory and ``ops`` falls
  back on it.
* :func:`body` picks the body of a launch by shape, before it: ``wgmma``
  for bf16 with K and N multiples of 8 and 16-byte aligned bases,
  ``tf32x3`` for fp32 with K and N multiples of 4 and 16-byte aligned
  bases, else ``simt``.
* :func:`masa_gemm_plain` is the plain PyTorch version, on any device.
* ``LAUNCHES`` counts launches by the order that ran: ``masa_gemm_os`` and
  ``masa_gemm_ws``; ``BODIES`` counts the same launches by body.

The library is built at first use by :mod:`repro_torch.cuda_build`.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch import cuda_build
from repro_torch.kernels import dispatch, hopper_gemm
from repro_torch.kernels.masa_gemm.ref import masa_gemm_ref

CSRC = Path(__file__).resolve().parent / "csrc"
#: Kernel name -> source.
SOURCES = {"masa_gemm": CSRC / "masa_gemm.cu"}
#: Kernel launches by order (set to 0 with :func:`reset_launches`).
LAUNCHES: dict[str, int] = {"masa_gemm_os": 0, "masa_gemm_ws": 0}
#: The same launches by body (set to 0 with :func:`reset_launches`).
BODIES: dict[str, int] = dict.fromkeys((*hopper_gemm.BODIES, "tf32x3"), 0)
#: The C entry's code of each body.
_BODY_CODE = {"simt": 0, "wgmma": 1, "tf32x3": 2}
#: Row tiles in one group of the output-stationary wgmma and tf32x3
#: rasters (``hopper_gemm.raster``): at the port's timing shape all 16, so
#: a wave shares B's column tiles and all of A stays in L2.
GROUP_M = 16
ORDERS = ("output_stationary", "weight_stationary")

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for counts in (LAUNCHES, BODIES):
        for k in counts:
            counts[k] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return declare(cuda_build.load("masa_gemm", SOURCES["masa_gemm"]))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the C signature of its ``masa_gemm_launch``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.masa_gemm_launch.argtypes = [vp] * 3 + [ci] * 7 + [ctypes.c_longlong,
                                                          vp]
    lib.masa_gemm_launch.restype = ci
    return lib


#: The weight-stationary simt body's tiles (csrc/masa_gemm.cu: kWsBM,
#: kBN): rows of A a step, columns of the resident panel of B.
WS_BM, WS_BN = 64, 128


def ws_panel_bytes(k: int, dtype: torch.dtype) -> int:
    """The weight-stationary budget at depth ``k``: the ``[K, 128]`` panel
    of B and a ``[64, K]`` tile of A, the simt body's shared memory. ``ops``
    falls back on it alone; the wgmma and tf32x3 bodies' layouts (the panel
    and a ring of A) fit a block whenever this does for a K they take
    (csrc/masa_gemm.cu)."""
    return (WS_BM + WS_BN) * k * dtype.itemsize


def body(a: torch.Tensor, b: torch.Tensor) -> str:
    """The body a launch on ``a`` and ``b`` takes, by shape, in either
    order: ``wgmma`` for bf16 with K and N multiples of 8 (rows of whole
    16-byte units, as TMA's strides need) and 16-byte aligned bases;
    ``tf32x3`` for fp32 with K and N multiples of 4 (rows of whole 16-byte
    ``cp.async`` units) and 16-byte aligned bases; else ``simt``."""
    k, n = a.shape[1], b.shape[1]
    if hopper_gemm.tma_ready(a, b) and k % 8 == 0 and n % 8 == 0:
        return "wgmma"
    if hopper_gemm.tf32x3_ready(a, b) and k % 4 == 0 and n % 4 == 0:
        return "tf32x3"
    return "simt"


def check_args(a, b, bm: int, bn: int, bk: int, order: str) -> None:
    """The reference's checks of ``masa_gemm_kernel``, for ``order``."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"masa_gemm takes a [M, K] and b [K, N]; got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if m % bm or n % bn:
        raise ValueError(f"masa_gemm: M={m} and N={n} must be multiples of "
                         f"bm={bm} and bn={bn}")
    if order not in ORDERS:
        raise ValueError(f"masa_gemm: order {order!r} is not one of {ORDERS}")
    if order == "output_stationary" and k % bk:
        raise ValueError(f"masa_gemm: K={k} is not a multiple of bk={bk}")


def masa_gemm_kernel(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                     bn: int = 128, bk: int = 128,
                     order: str = "output_stationary") -> torch.Tensor:
    """``a @ b`` in ``order``, after the reference's checks."""
    check_args(a, b, bm, bn, bk, order)
    return run(a, b, order)


def run(a: torch.Tensor, b: torch.Tensor, order: str) -> torch.Tensor:
    """``a @ b`` in ``order`` (checked by the caller): the CUDA kernel on
    a CUDA tensor, :func:`masa_gemm_plain` on a CPU tensor."""
    if dispatch.runs_plain("masa_gemm", a, b):
        return masa_gemm_plain(a, b)
    return _launch(a, b, order)


def _launch(a, b, order: str, which: str | None = None):
    """One launch of the kernel on PyTorch's current stream, on the body
    :func:`body` picks or, for a timing beside it, on ``which`` (``simt``
    takes every shape; a body that does not take the shape raises)."""
    if a.dtype not in _DTYPES or a.dtype != b.dtype:
        raise TypeError(f"masa_gemm kernel takes a and b both float32 or both "
                        f"bfloat16; got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("masa_gemm kernel takes contiguous tensors")
    (m, k), n = a.shape, b.shape[1]
    ws = order == "weight_stationary"
    smem = ws_panel_bytes(k, a.dtype) if ws else 0
    if smem > cuda_build.MAX_SMEM_BYTES:
        raise ValueError(
            f"masa_gemm weight-stationary kernel does not take K={k} in "
            f"{a.dtype}: its panel needs {smem} bytes of shared memory, more "
            f"than {cuda_build.MAX_SMEM_BYTES} (ops.masa_gemm falls back to "
            f"output-stationary)")
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if c.numel() == 0 or k == 0:
        return c.zero_()
    which = which or body(a, b)
    with torch.cuda.device(a.device):
        err = _library().masa_gemm_launch(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, k, n, int(ws),
            int(a.dtype == torch.bfloat16), _BODY_CODE[which], GROUP_M,
            smem, dispatch.stream(a.device))
    dispatch.check("masa_gemm", err)
    LAUNCHES["masa_gemm_ws" if ws else "masa_gemm_os"] += 1
    BODIES[which] += 1
    return c


def masa_gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, on a's device: both orders compute the
    dense oracle's function, one fp32 product cast back to a's dtype."""
    return masa_gemm_ref(a, b)
