"""The CUDA paged decode-attention kernel, its wrapper and its plain
version.

The counterpart of ``repro.kernels.paged_attention.kernel``
(``paged_attention_kernel``, body ``_body``)::

  q [B, KVH, G, hd]   k_pages, v_pages [P, page, KVH, hd]
  block_table [B, n_pages] int32   seq_lens [B] int32   ->   [B, KVH, G, hd]

``csrc/paged_attention.cu`` runs one block per (kv head, sequence): it walks
the sequence's pages in table order with the fp32 online softmax of the G
query rows, scoring slots at or beyond ``seq_lens[b]`` -1e30 before the max
(the source's header says what bounds it). It trusts the table:
``ops.paged_attention`` clamps it first.

* :func:`paged_attention_kernel` is the wrapper: on a CUDA tensor it
  launches the kernel (or raises), on a CPU tensor it runs
  :func:`paged_attention_plain`.
* :func:`paged_attention_plain` is the plain PyTorch version, on any
  device: the online softmax over pages.
* ``LAUNCHES["paged_attention"]`` counts kernel launches.

The library is built at first use by :mod:`repro_torch.cuda_build`.
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
SOURCES = {"paged_attention": CSRC / "paged_attention.cu"}
#: Kernel launches (set to 0 with :func:`reset_launches`).
LAUNCHES: dict[str, int] = {"paged_attention": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_NEG_INF = -1e30


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("paged_attention", SOURCES["paged_attention"])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_launch.argtypes = ([vp] * 6 + [ci] * 6
                                           + [ctypes.c_float, ci, vp])
    lib.paged_attention_launch.restype = ci
    lib.paged_attention_smem_bytes.argtypes = [ci, ci]
    lib.paged_attention_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(q, k_pages, v_pages, block_table, seq_lens) -> None:
    if (q.dim() != 4 or k_pages.dim() != 4
            or v_pages.shape != k_pages.shape):
        raise ValueError(f"paged_attention takes q [B, KVH, G, hd] and k/v "
                         f"pages [P, page, KVH, hd]; got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    bsz, kvh, _, hd = q.shape
    if k_pages.shape[2] != kvh or k_pages.shape[3] != hd:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} and pages "
                         f"{tuple(k_pages.shape)} disagree on KVH or hd")
    if (block_table.dim() != 2 or block_table.shape[0] != bsz
            or tuple(seq_lens.shape) != (bsz,)):
        raise ValueError(f"paged_attention takes block_table [B, n_pages] "
                         f"and seq_lens [B] for B={bsz}; got "
                         f"{tuple(block_table.shape)}, "
                         f"{tuple(seq_lens.shape)}")


def paged_attention_kernel(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           seq_lens: torch.Tensor) -> torch.Tensor:
    """Decode attention over the paged cache: the CUDA kernel on a CUDA
    tensor, :func:`paged_attention_plain` on a CPU tensor."""
    _check(q, k_pages, v_pages, block_table, seq_lens)
    args = (q, k_pages, v_pages, block_table, seq_lens)
    if dispatch.runs_plain("paged_attention", *args):
        return paged_attention_plain(*args)
    return _launch(*args)


def _launch(q, k_pages, v_pages, block_table, seq_lens):
    """One launch of the kernel on PyTorch's current stream."""
    if q.dtype not in _DTYPES or not q.dtype == k_pages.dtype == v_pages.dtype:
        raise TypeError(f"paged_attention kernel takes q and the pages all "
                        f"float32 or all bfloat16; got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError(f"paged_attention kernel takes int32 block_table and "
                        f"seq_lens; got {block_table.dtype}, {seq_lens.dtype}")
    args = (q, k_pages, v_pages, block_table, seq_lens)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("paged_attention kernel takes contiguous tensors")
    bsz, kvh, g, hd = q.shape
    page, n_pages = k_pages.shape[1], block_table.shape[1]
    lib = _library()
    need = lib.paged_attention_smem_bytes(g, hd)
    if need < 0 or need > cuda_build.MAX_SMEM_BYTES:
        raise ValueError(f"paged_attention kernel does not take G={g}, "
                         f"hd={hd}: it needs {need} bytes of shared memory, "
                         f"at most {cuda_build.MAX_SMEM_BYTES}")
    out = torch.empty_like(q)
    if out.numel() == 0 or n_pages == 0 or page == 0:
        return out.zero_()
    with torch.cuda.device(q.device):
        err = lib.paged_attention_launch(
            *(t.data_ptr() for t in args), out.data_ptr(), bsz, kvh, g, hd,
            page, n_pages, hd ** -0.5, int(q.dtype == torch.bfloat16),
            dispatch.stream(q.device))
    dispatch.check("paged_attention", err)
    LAUNCHES["paged_attention"] += 1
    return out


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_table: torch.Tensor,
                          seq_lens: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, on q's device: ``_body``'s online softmax
    over the pages, all sequences and heads at once, in fp32."""
    bsz, kvh, g, hd = q.shape
    page, n_pages = k_pages.shape[1], block_table.shape[1]
    f32 = torch.float32
    q32 = q.to(f32)
    m = torch.full((bsz, kvh, g, 1), _NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((bsz, kvh, g, hd), dtype=f32, device=q.device)
    table = block_table.long()
    lens = seq_lens.to(q.device)[:, None]
    slot = torch.arange(page, device=q.device)
    for p in range(n_pages):
        k = k_pages[table[:, p]].to(f32)                 # [B, page, KVH, hd]
        v = v_pages[table[:, p]].to(f32)
        s = torch.einsum("bhgd,bshd->bhgs", q32, k) * hd ** -0.5
        valid = (p * page + slot)[None, :] < lens        # [B, page]
        s = torch.where(valid[:, None, None, :], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        e = torch.exp(s - m_new)
        l = l * corr + e.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhgs,bshd->bhgd", e, v)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)
