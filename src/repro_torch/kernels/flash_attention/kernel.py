"""The CUDA fused attention forward, its wrapper and its plain version.

The counterpart of ``repro.kernels.flash_attention.kernel``
(``flash_attention_kernel``, body ``_body``): q, k, v ``[BH, S, hd]`` ->
out ``[BH, S, hd]`` in q's dtype, scores ``q . k * hd ** -0.5``, an
optional causal mask at -1e30, the fp32 online softmax over key blocks and
``acc / max(l, 1e-30)``. ``csrc/flash_attention.cu`` runs one block per
(query tile, batch*head) and walks the key tiles in order (the source's
header says what bounds it); it takes head dims 64, 96 and 128. It has three
bodies: wgmma with a TMA ring of K/V tiles and the softmax in registers for
bf16 (``csrc/hopper_gemm.cuh``'s building blocks), ``tf32x3`` for fp32
(both products by three TF32 ``mma.sync`` each, as accurate as fp32, on
``cp.async`` double buffers of K and V, the softmax in registers:
``csrc/tf32x3.cuh``) and fp32 FMAs on the CUDA cores (``simt``) for the
rest. The kernel indexes GQA itself: k and v may have
``BH / g`` rows, and q's row ``bh`` reads their row ``bh // g``.

* :func:`flash_attention_kernel` is the wrapper: it keeps the reference's
  signature and checks (q, k, v of one shape; ``S`` a multiple of ``bq``
  and ``bk``), raised as ``ValueError``, then :func:`run`. The kernel's
  tiles are its own.
* :func:`run` takes k/v of ``BH / g`` rows (``ops.flash_attention``'s
  unexpanded kv heads): on a CUDA tensor it launches the kernel (or
  raises), on a CPU tensor it runs :func:`flash_attention_plain`.
* :func:`body` picks the body of a launch by shape, before it: ``wgmma``
  for bf16 and ``tf32x3`` for fp32, each with 16-byte aligned bases and hd
  64, 96 or 128, else ``simt``.
* :func:`flash_attention_plain` is the plain PyTorch version, on any
  device: the online softmax over the reference's key blocks of ``bk``.
* ``LAUNCHES["flash_attention"]`` counts kernel launches; ``BODIES``
  counts the same launches by body.

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
SOURCES = {"flash_attention": CSRC / "flash_attention.cu"}
#: Kernel launches (set to 0 with :func:`reset_launches`).
LAUNCHES: dict[str, int] = {"flash_attention": 0}
#: The same launches by body (set to 0 with :func:`reset_launches`).
BODIES: dict[str, int] = dict.fromkeys((*hopper_gemm.BODIES, "tf32x3"), 0)
#: The C entry's code of each body.
_BODY_CODE = {"simt": 0, "wgmma": 1, "tf32x3": 2}
#: Head dims the kernel takes, in every body (the wgmma body runs hd 96 as
#: 128, TMA filling the upper 32 columns with zeros).
HEAD_DIMS = (64, 96, 128)

_DTYPES = (torch.float32, torch.bfloat16)
_NEG_INF = -1e30


def reset_launches() -> None:
    for counts in (LAUNCHES, BODIES):
        for k in counts:
            counts[k] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return declare(cuda_build.load("flash_attention",
                                   SOURCES["flash_attention"]))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the C signature of its ``flash_attention_launch``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = ([vp] * 4 + [ci] * 4
                                           + [ctypes.c_float] + [ci] * 3
                                           + [vp])
    lib.flash_attention_launch.restype = ci
    return lib


def body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The body a launch on q, k and v takes, by shape: ``wgmma`` for bf16
    with 16-byte aligned bases (TMA's tensor maps; rows of hd 64, 96 and
    128 are whole 16-byte units) and hd in :data:`HEAD_DIMS`; ``tf32x3``
    for fp32 with 16-byte aligned bases (16-byte ``cp.async`` copies) and
    hd in :data:`HEAD_DIMS`; else ``simt``."""
    if q.shape[-1] in HEAD_DIMS:
        if hopper_gemm.tma_ready(q, k, v):
            return "wgmma"
        if hopper_gemm.tf32x3_ready(q, k, v):
            return "tf32x3"
    return "simt"


def check_blocks(s: int, bq: int, bk: int) -> None:
    """The reference's ``S`` multiple of ``bq`` and ``bk``."""
    if bq < 1 or bk < 1 or s % bq or s % bk:
        raise ValueError(f"flash_attention: S={s} must be a multiple of "
                         f"bq={bq} and bk={bk}")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, bq: int = 128,
                           bk: int = 128) -> torch.Tensor:
    """q/k/v [BH, S, hd] -> out [BH, S, hd]: the CUDA kernel on a CUDA
    tensor, :func:`flash_attention_plain` on a CPU tensor."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention takes q, k, v [BH, S, hd] of one "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    check_blocks(q.shape[1], bq, bk)
    return run(q, k, v, causal=causal, bk=bk)


def run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, bk: int = 128) -> torch.Tensor:
    """q [BH, S, hd], k/v [BH / g, S, hd] (checked by the caller) -> out
    [BH, S, hd], q's row bh attending k/v row bh // g: the CUDA kernel on a
    CUDA tensor, :func:`flash_attention_plain` on a CPU tensor."""
    if dispatch.runs_plain("flash_attention", q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, bk=bk)
    return _launch(q, k, v, causal)


def _launch(q, k, v, causal: bool, which: str | None = None):
    """One launch of the kernel on PyTorch's current stream, on the body
    :func:`body` picks or, for a timing beside it, on ``which`` (``simt``
    takes every shape; a body that does not take the shape raises)."""
    if q.dtype not in _DTYPES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention kernel takes q, k, v all float32 or "
                        f"all bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes contiguous tensors")
    bh, s, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims 64, 96 and "
                         f"128, not {hd}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    which = which or body(q, k, v)
    with torch.cuda.device(q.device):
        err = _library().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s,
            hd, int(causal), hd ** -0.5, int(q.dtype == torch.bfloat16),
            _BODY_CODE[which], bh // k.shape[0],
            dispatch.stream(q.device))
    dispatch.check("flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    BODIES[which] += 1
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, bk: int = 128
                          ) -> torch.Tensor:
    """The plain PyTorch version, on q's device: ``_body``'s online softmax
    over key blocks of ``bk``, every batch*head and query at once, in
    fp32. k/v of ``BH / g`` rows are expanded as the reference's ops
    expands GQA (row ``bh`` of q reads row ``bh // g``)."""
    bh, s, hd = q.shape
    if k.shape[0] != bh:
        k, v = (t.repeat_interleave(bh // k.shape[0], dim=0) for t in (k, v))
    f32 = torch.float32
    q32 = q.to(f32)
    m = torch.full((bh, s, 1), _NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((bh, s, hd), dtype=f32, device=q.device)
    qpos = torch.arange(s, device=q.device)[:, None]
    for j0 in range(0, s, bk):
        sc = (q32 @ k[:, j0:j0 + bk].to(f32).transpose(1, 2)) * hd ** -0.5
        if causal:
            kpos = torch.arange(j0, min(j0 + bk, s), device=q.device)[None, :]
            sc = torch.where(qpos >= kpos, sc, _NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        e = torch.exp(sc - m_new)
        l = l * corr + e.sum(dim=-1, keepdim=True)
        acc = acc * corr + e @ v[:, j0:j0 + bk].to(f32)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)
