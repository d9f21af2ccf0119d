"""The CUDA SSD-scan kernel, its wrapper and its plain version.

The counterpart of ``repro.kernels.ssd_scan.kernel`` (``ssd_scan_kernel``,
body ``_ssd_body``): ``csrc/ssd_scan.cu`` runs one block per batch*head and
tile of :func:`column_tile` state columns, walks the chunks in order in
sub-chunks of 16 steps with the next ones staged ahead, and keeps its fp32
``[ds, TD]`` slice of the state in registers (the source's header says
what bounds it and how it is laid out). The layout is the kernel's::

  xr [BH, L, hd]   l [BH, L]   b, c [B, L, ds]   ->   y [BH, L, hd], hT [BH, ds, hd]

``xr`` is the dt-scaled input, ``l = dt * A`` the per-step log decay, and
``b``/``c`` are shared by the heads of one batch element (``bh //
n_heads``). ``y`` leaves in ``xr``'s dtype, ``hT`` in float32.

* :func:`ssd_scan_kernel` is the wrapper: on a CUDA tensor it launches the
  kernel (or raises), on a CPU tensor it runs :func:`ssd_scan_plain`. It
  never falls back from the kernel to the plain version.
* :func:`ssd_scan_plain` is the plain PyTorch version, on any device: the
  CPU tests use it, ``chip_smoke.py`` holds the kernel against it on the
  card.
* ``LAUNCHES["ssd_scan"]`` counts kernel launches.

The library is built at first use by :mod:`repro_torch.cuda_build`;
nothing is built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch import cuda_build
from repro_torch.kernels import dispatch

CSRC = Path(__file__).resolve().parent / "csrc"
#: Kernel name -> source.
SOURCES = {"ssd_scan": CSRC / "ssd_scan.cu"}
#: Kernel launches (set to 0 with :func:`reset_launches`).
LAUNCHES: dict[str, int] = {"ssd_scan": 0}
#: State columns a block takes at most (the kernel takes 4, 8, 16, 32).
MAX_TILE = 32

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return declare(cuda_build.load("ssd_scan", SOURCES["ssd_scan"]))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the C signatures of its ``ssd_scan_launch`` and
    ``ssd_scan_smem_bytes``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [vp] * 6 + [ci] * 8 + [vp]
    lib.ssd_scan_launch.restype = ci
    lib.ssd_scan_smem_bytes.argtypes = [ci] * 5
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def column_tile(hd: int) -> int:
    """State columns a block takes: 32, or hd where it is smaller."""
    return min(MAX_TILE, hd)


def _check(xr, l, b, c, chunk: int, n_heads: int) -> None:
    if xr.dim() != 3 or l.dim() != 2 or b.dim() != 3 or c.shape != b.shape:
        raise ValueError(f"ssd_scan takes xr [BH, L, hd], l [BH, L], b and c "
                         f"[B, L, ds]; got {tuple(xr.shape)}, {tuple(l.shape)},"
                         f" {tuple(b.shape)}, {tuple(c.shape)}")
    bh, L, _ = xr.shape
    if (l.shape != (bh, L) or n_heads < 1 or bh != b.shape[0] * n_heads
            or b.shape[1] != L):
        raise ValueError(f"ssd_scan: xr {tuple(xr.shape)}, l {tuple(l.shape)}"
                         f" and b {tuple(b.shape)} disagree for n_heads="
                         f"{n_heads}")
    if chunk < 1 or L % chunk:
        raise ValueError(f"ssd_scan: L={L} is not a multiple of chunk={chunk}")
    if not xr.device == l.device == b.device == c.device:
        raise ValueError(f"ssd_scan: inputs on {xr.device}, {l.device}, "
                         f"{b.device}, {c.device}")


def ssd_scan_kernel(xr: torch.Tensor, l: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, *, chunk: int, n_heads: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan in the kernel's layout: the CUDA kernel on a CUDA
    tensor, :func:`ssd_scan_plain` on a CPU tensor."""
    _check(xr, l, b, c, chunk, n_heads)
    if dispatch.runs_plain("ssd_scan", xr, l, b, c):
        return ssd_scan_plain(xr, l, b, c, chunk=chunk, n_heads=n_heads)
    return _launch(xr, l, b, c, chunk, n_heads)


def _launch(xr, l, b, c, chunk: int, n_heads: int):
    """One launch of the kernel on PyTorch's current stream, with
    :func:`column_tile` state columns a block."""
    bh, L, hd = xr.shape
    ds = b.shape[-1]
    if xr.dtype not in _DTYPES or not xr.dtype == b.dtype == c.dtype:
        raise TypeError(f"ssd_scan kernel takes xr, b and c all float32 or "
                        f"all bfloat16; got xr {xr.dtype}, b {b.dtype}, "
                        f"c {c.dtype}")
    if l.dtype != torch.float32:
        raise TypeError(f"ssd_scan kernel takes float32 l, got {l.dtype}")
    if not all(t.is_contiguous() for t in (xr, l, b, c)):
        raise ValueError("ssd_scan kernel takes contiguous tensors")
    td, bf16 = column_tile(hd), int(xr.dtype == torch.bfloat16)
    lib = _library()
    need = lib.ssd_scan_smem_bytes(chunk, hd, ds, td, bf16)
    limit = cuda_build.MAX_SMEM_BYTES
    if need < 0 or need > limit:
        raise ValueError(
            f"ssd_scan kernel does not take chunk={chunk}, hd={hd}, ds={ds}: "
            f"it needs chunk a multiple of 16, hd a power of two from 4 to "
            f"128, ds a multiple of 4 up to 512, and at most {limit} bytes "
            f"of shared memory (this shape: {need})")
    dev = xr.device
    with torch.cuda.device(dev):
        y = torch.empty_like(xr)
        hT = torch.empty((bh, ds, hd), dtype=torch.float32, device=dev)
        if bh == 0 or L == 0:
            return y, hT.zero_()
        err = lib.ssd_scan_launch(
            xr.data_ptr(), l.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), hT.data_ptr(), bh, L, hd, ds, chunk, n_heads,
            bf16, td, dispatch.stream(dev))
        dispatch.check("ssd_scan", err)
        LAUNCHES["ssd_scan"] += 1
    return y, hT


def ssd_scan_plain(xr: torch.Tensor, l: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, *, chunk: int, n_heads: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version, in the kernel's layout, on ``xr``'s
    device: ``_ssd_body`` over all batch*heads at once, looped over the
    chunks, with the fp32 state carried across them."""
    _check(xr, l, b, c, chunk, n_heads)
    bh, L, hd = xr.shape
    ds = b.shape[-1]
    f32 = torch.float32
    bexp = b.to(f32).repeat_interleave(n_heads, dim=0)       # [BH, L, ds]
    cexp = c.to(f32).repeat_interleave(n_heads, dim=0)
    xr32, l32 = xr.to(f32), l.to(f32)
    state = torch.zeros((bh, ds, hd), dtype=f32, device=xr.device)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=xr.device).tril()
    ys = []
    for t0 in range(0, L, chunk):
        xc = xr32[:, t0:t0 + chunk]                           # [BH, Q, hd]
        bc, cc = bexp[:, t0:t0 + chunk], cexp[:, t0:t0 + chunk]
        cum = torch.cumsum(l32[:, t0:t0 + chunk], dim=1)      # [BH, Q]
        total = cum[:, -1:]
        g = cc @ bc.transpose(1, 2)                           # [BH, Q, Q]
        delta = cum[:, :, None] - cum[:, None, :]
        m = torch.where(mask, torch.exp(delta.masked_fill(~mask, 0.0)), 0.0)
        y = (g * m) @ xc
        y = y + torch.exp(cum)[..., None] * (cc @ state)
        w = torch.exp(total - cum)                            # [BH, Q]
        state = (torch.exp(total)[..., None] * state
                 + (bc.transpose(1, 2) * w[:, None, :]) @ xc)
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else xr32
    return y.to(xr.dtype), state
