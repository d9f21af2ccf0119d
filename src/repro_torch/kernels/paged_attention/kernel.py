"""The CUDA paged decode-attention kernel, its wrapper and its plain
version.

The counterpart of ``repro.kernels.paged_attention.kernel``
(``paged_attention_kernel``, body ``_body``)::

  q [B, KVH, G, hd]   k_pages, v_pages [P, page, KVH, hd]
  block_table [B, n_pages] int32   seq_lens [B] int32   ->   [B, KVH, G, hd]

``csrc/paged_attention.cu`` scores slots at or beyond ``seq_lens[b]``
-1e30 before the max, with the fp32 online softmax of the G query rows (the
source's header says what bounds it and how each body works). It has two
bodies, which :func:`body` picks by shape before the launch: ``split`` cuts
each (sequence, kv head) over a thread-block cluster of :func:`splits`
blocks, whose warps stream the rows through cp.async rings and merge their
partial softmaxes in shared memory; ``serial`` walks the sequence in one
block. It trusts the table: ``ops.paged_attention`` clamps it first.

* :func:`paged_attention_kernel` is the wrapper: on a CUDA tensor it
  launches the kernel (or raises), on a CPU tensor it runs
  :func:`paged_attention_plain`.
* :func:`paged_attention_plain` is the plain PyTorch version, on any
  device: the online softmax over pages.
* ``LAUNCHES["paged_attention"]`` counts kernel launches; ``BODIES`` counts
  the same launches by body.

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
#: The same launches by body (set to 0 with :func:`reset_launches`).
BODIES: dict[str, int] = {"split": 0, "serial": 0}
#: Query heads a kv head the split body takes at most (its registers hold
#: them, rounded up to 1, 2, 4 or 8).
MAX_SPLIT_GROUP = 8
#: Cluster sizes the split body takes, and the blocks it aims for: about
#: one for each of the H100's 132 SMs (PERF.md: at jamba's 256 sequence x
#: kv-head pairs one split is fastest, at 32 pairs four).
SPLIT_COUNTS = (1, 2, 4, 8)
FILL_BLOCKS = 128
#: Live slots a split takes at least: below this, fewer splits.
MIN_SPLIT_SLOTS = 64

_DTYPES = (torch.float32, torch.bfloat16)
_NEG_INF = -1e30


def reset_launches() -> None:
    for counts in (LAUNCHES, BODIES):
        for k in counts:
            counts[k] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return declare(cuda_build.load("paged_attention",
                                   SOURCES["paged_attention"]))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the C signatures of its ``paged_attention_launch`` and
    ``paged_attention_smem_bytes``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_launch.argtypes = ([vp] * 6 + [ci] * 6
                                           + [ctypes.c_float] + [ci] * 3
                                           + [vp])
    lib.paged_attention_launch.restype = ci
    lib.paged_attention_smem_bytes.argtypes = [ci] * 4
    lib.paged_attention_smem_bytes.restype = ctypes.c_longlong
    return lib


def body(q: torch.Tensor, k_pages: torch.Tensor,
         v_pages: torch.Tensor) -> str:
    """The body a launch takes, by shape: ``split`` for G from 1 to
    :data:`MAX_SPLIT_GROUP`, rows of hd elements that are 1 to 32 whole
    16-byte units (a power of two) and 16-byte aligned bases of q and the
    pages; ``serial`` otherwise."""
    g, hd = q.shape[2], q.shape[3]
    units, rest = divmod(hd * q.element_size(), 16)
    ok = (1 <= g <= MAX_SPLIT_GROUP and not rest and 1 <= units <= 32
          and units & (units - 1) == 0
          and all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)))
    return "split" if ok else "serial"


def splits(bsz: int, kvh: int, n_slots: int) -> int:
    """Blocks (one cluster) the split body cuts a (sequence, kv head)
    into: the fewest of :data:`SPLIT_COUNTS` that give
    :data:`FILL_BLOCKS` blocks, with at least :data:`MIN_SPLIT_SLOTS`
    slots a split."""
    s = SPLIT_COUNTS[0]
    for n in SPLIT_COUNTS[1:]:
        if bsz * kvh * s >= FILL_BLOCKS or n_slots < n * MIN_SPLIT_SLOTS:
            break
        s = n
    return s


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


def _launch(q, k_pages, v_pages, block_table, seq_lens, which=None,
            n_split=None):
    """One launch of the kernel on PyTorch's current stream, on the body
    :func:`body` picks and :func:`splits` blocks a cluster (or ``which``
    and ``n_split`` where the shape allows them: the card tests and the
    timings set them)."""
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
    picked = body(q, k_pages, v_pages)
    which = picked if which is None else which
    if which not in BODIES or (which == "split" and picked != which):
        raise ValueError(f"paged_attention: body {which!r} does not take "
                         f"G={g}, hd={hd} in {q.dtype}")
    n_split = splits(bsz, kvh, n_pages * page) if n_split is None else n_split
    if which == "split" and n_split not in SPLIT_COUNTS:
        raise ValueError(f"paged_attention: {n_split} splits, not one of "
                         f"{SPLIT_COUNTS}")
    bf16 = int(q.dtype == torch.bfloat16)
    lib = _library()
    need = lib.paged_attention_smem_bytes(g, hd, bf16, int(which == "split"))
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
            page, n_pages, hd ** -0.5, bf16, int(which == "split"), n_split,
            dispatch.stream(q.device))
    dispatch.check("paged_attention", err)
    LAUNCHES["paged_attention"] += 1
    BODIES[which] += 1
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
