"""The CUDA grouped expert GEMM, its wrapper and its plain version.

The counterpart of ``repro.kernels.moe_gemm.kernel``
(``grouped_matmul_kernel``, body ``_body``)::

  y[T, F] = x_sorted[T, D] @ W[block_eids[t // bt], D, F]

``csrc/moe_gemm.cu`` runs one block per (tile of token rows, columns of
F); the block reads its token block's expert id and multiplies by that
expert's panel (the designation), summing in fp32 and writing ``y`` in x's
dtype. It has four bodies: wgmma on TMA-fed tiles for bf16
(``csrc/hopper_gemm.cuh``, tiles launched in the raster of
``hopper_gemm.raster``), ``stream`` for token blocks too short for the
tensor cores (bt <= 32: each block streams its expert's W panel through a
``cp.async`` ring at the memory's rate), ``tf32x3`` for fp32 token blocks
past 32 rows (three TF32 ``mma.sync`` a product, ``csrc/tf32x3.cuh``, on
row tiles that :func:`tf32x3_tiles` lays out, in the same raster) and fp32
FMAs on the CUDA cores (``simt``) for the rest.

* :func:`grouped_matmul_kernel` is the wrapper: on a CUDA tensor it
  launches the kernel (or raises), on a CPU tensor it runs
  :func:`grouped_matmul_plain`. It keeps the reference's checks
  (``T % bt``, ``F % bf``, one expert id per token block), raised as
  ``ValueError``; ``bt`` is also the token block that ``block_eids``
  indexes.
* :func:`body` picks the body of a launch by shape, before it: ``wgmma``
  for bf16 with D and F multiples of 8, ``bt % 64 == 0`` and 16-byte
  aligned bases; ``stream`` for fp32 or bf16 with ``bt`` a multiple of 8
  up to :data:`STREAM_MAX_BT`, rows of F whole 16-byte units and 16-byte
  aligned bases; ``tf32x3`` for fp32 with ``bt`` a multiple of 8 past
  :data:`STREAM_MAX_BT`, D and F multiples of 4 and 16-byte aligned bases;
  else ``simt``.
* :func:`grouped_matmul_plain` is the plain PyTorch version, on any device.
* ``LAUNCHES["moe_gemm"]`` counts kernel launches; ``BODIES`` counts the
  same launches by body.

The library is built at first use by :mod:`repro_torch.cuda_build`.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch import cuda_build
from repro_torch.kernels import dispatch, hopper_gemm

CSRC = Path(__file__).resolve().parent / "csrc"
#: Kernel name -> source.
SOURCES = {"moe_gemm": CSRC / "moe_gemm.cu"}
#: Kernel launches (set to 0 with :func:`reset_launches`).
LAUNCHES: dict[str, int] = {"moe_gemm": 0}
#: The same launches by body (set to 0 with :func:`reset_launches`).
BODIES: dict[str, int] = dict.fromkeys(
    (*hopper_gemm.BODIES, "stream", "tf32x3"), 0)
#: The C entry's code of each body.
_BODY_CODE = {"simt": 0, "wgmma": 1, "stream": 2, "tf32x3": 3}
#: The largest token block the stream body takes: it keeps 4 fp32 sums a
#: row for each of bt rows in a thread's registers, 128 at bt 32.
STREAM_MAX_BT = 32
#: Row tiles in one group of the wgmma raster (``hopper_gemm.raster``): 12
#: tiles hold whole experts at jamba's capacity (3 token blocks of 128, or
#: 6 of 64), and the group's rows of x (12 MB at D 4096) stay in L2.
GROUP_M = 12

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for counts in (LAUNCHES, BODIES):
        for k in counts:
            counts[k] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return declare(cuda_build.load("moe_gemm", SOURCES["moe_gemm"]))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the C signature of its ``moe_gemm_launch``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.moe_gemm_launch.argtypes = [vp] * 4 + [ci] * 8 + [vp]
    lib.moe_gemm_launch.restype = ci
    return lib


def _check(x, w, block_eids, bt: int, bf: int) -> None:
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"grouped_matmul takes x_sorted [T, D] and w [E, D, "
                         f"F]; got {tuple(x.shape)} and {tuple(w.shape)}")
    t, f = x.shape[0], w.shape[2]
    if bt < 1 or bf < 1 or t % bt or f % bf:
        raise ValueError(f"grouped_matmul: T={t} and F={f} must be multiples "
                         f"of bt={bt} and bf={bf}")
    if tuple(block_eids.shape) != (t // bt,):
        raise ValueError(f"grouped_matmul: block_eids has shape "
                         f"{tuple(block_eids.shape)}, not ({t // bt},)")


def body(x: torch.Tensor, w: torch.Tensor, bt: int) -> str:
    """The body a launch on ``x`` and ``w`` with token blocks of ``bt``
    takes, by shape: ``wgmma`` for bf16 with D and F multiples of 8 (rows of
    whole 16-byte units, as TMA's strides need), ``bt % 64 == 0`` (tiles of
    128 or 64 rows that never straddle two token blocks) and 16-byte aligned
    bases; ``stream`` for fp32 or bf16 with ``bt`` a multiple of 8 up to
    :data:`STREAM_MAX_BT` (moonshot's capacities 8 and 16), F's rows whole
    16-byte units (its ring copies W in 16-byte pieces) and 16-byte aligned
    bases (D may be ragged); ``tf32x3`` for fp32 with ``bt`` a multiple of
    8 past :data:`STREAM_MAX_BT` (jamba's 128, moonshot's capacities past
    a prefill of about 273 tokens), D and F multiples of 4 (rows of whole
    16-byte ``cp.async`` units; D may be ragged past its last 32) and
    16-byte aligned bases; else ``simt``."""
    d, f = x.shape[1], w.shape[2]
    if (hopper_gemm.tma_ready(x, w) and d % 8 == 0 and f % 8 == 0
            and bt % 64 == 0):
        return "wgmma"
    if (x.dtype in _DTYPES and w.dtype == x.dtype
            and bt % 8 == 0 and bt <= STREAM_MAX_BT
            and (f * x.element_size()) % 16 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "stream"
    if (hopper_gemm.tf32x3_ready(x, w) and bt % 8 == 0
            and bt > STREAM_MAX_BT and d % 4 == 0 and f % 4 == 0):
        return "tf32x3"
    return "simt"


def tf32x3_rows(bt: int) -> int:
    """Rows of the tf32x3 body's tiles at token blocks of ``bt``, as the
    kernel's ``tile_rows`` picks them: 64 when 64-row tiles cover a token
    block in fewer rows than 128-row ones (bt 40 to 64, 136 to 192, ...),
    else 128."""
    return 64 if -(-bt // 64) * 64 < -(-bt // 128) * 128 else 128


def tf32x3_tiles(n_blocks: int, bt: int) -> list[tuple[int, int]]:
    """The tf32x3 body's row tiles, in order, for ``n_blocks`` token blocks
    of ``bt`` rows, as its kernel lays them out: row tile ``tm`` of token
    block ``tm // tpb`` (``tpb = ceil(bt / rows)``) holds rows ``[r0,
    min(r0 + rows, end))`` of it, ``end`` the token block's end; the rows
    past it are zero-filled on load and masked on store."""
    rows = tf32x3_rows(bt)
    tpb = -(-bt // rows)
    out = []
    for tm in range(n_blocks * tpb):
        tb = tm // tpb
        r0 = tb * bt + (tm - tb * tpb) * rows
        out.append((r0, min(r0 + rows, (tb + 1) * bt)))
    return out


def grouped_matmul_kernel(x_sorted: torch.Tensor, w: torch.Tensor,
                          block_eids: torch.Tensor, *, bt: int = 128,
                          bf: int = 128) -> torch.Tensor:
    """The grouped GEMM: the CUDA kernel on a CUDA tensor,
    :func:`grouped_matmul_plain` on a CPU tensor."""
    _check(x_sorted, w, block_eids, bt, bf)
    if dispatch.runs_plain("grouped_matmul", x_sorted, w, block_eids):
        return grouped_matmul_plain(x_sorted, w, block_eids, bt=bt)
    return _launch(x_sorted, w, block_eids, bt)


def _launch(x, w, block_eids, bt: int, which: str | None = None):
    """One launch of the kernel on PyTorch's current stream, on the body
    :func:`body` picks or, for a timing beside it, on ``which`` (``simt``
    takes every shape; a body that does not take the shape raises, and
    never hands over to another)."""
    if x.dtype not in _DTYPES or x.dtype != w.dtype:
        raise TypeError(f"moe_gemm kernel takes x_sorted and w both float32 "
                        f"or both bfloat16; got {x.dtype} and {w.dtype}")
    if block_eids.dtype != torch.int32:
        raise TypeError(f"moe_gemm kernel takes int32 block_eids, got "
                        f"{block_eids.dtype}")
    if not all(t.is_contiguous() for t in (x, w, block_eids)):
        raise ValueError("moe_gemm kernel takes contiguous tensors")
    (t, d), (e, _, f) = x.shape, w.shape
    y = torch.empty((t, f), dtype=x.dtype, device=x.device)
    if y.numel() == 0 or d == 0:
        return y.zero_()
    which = which or body(x, w, bt)
    with torch.cuda.device(x.device):
        err = _library().moe_gemm_launch(
            x.data_ptr(), w.data_ptr(), block_eids.data_ptr(), y.data_ptr(),
            t, d, f, e, bt, int(x.dtype == torch.bfloat16),
            _BODY_CODE[which], GROUP_M, dispatch.stream(x.device))
    dispatch.check("moe_gemm", err)
    LAUNCHES["moe_gemm"] += 1
    BODIES[which] += 1
    return y


def grouped_matmul_plain(x_sorted: torch.Tensor, w: torch.Tensor,
                         block_eids: torch.Tensor, *, bt: int = 128
                         ) -> torch.Tensor:
    """The plain PyTorch version, on x's device: one fp32 matmul per token
    block, looped, so that no block's panel is gathered whole (at jamba's
    MoE shape that gather would be 48 x 235 MB)."""
    t, f = x_sorted.shape[0], w.shape[2]
    y = torch.empty((t, f), dtype=x_sorted.dtype, device=x_sorted.device)
    for i, e in enumerate(block_eids.tolist()):
        rows = slice(i * bt, (i + 1) * bt)
        y[rows] = (x_sorted[rows].to(torch.float32)
                   @ w[e].to(torch.float32)).to(y.dtype)
    return y
