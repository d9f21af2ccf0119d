"""Public wrapper for paged decode attention (the counterpart of
``repro.kernels.paged_attention.ops``). The tensor's device picks the CUDA
kernel or its plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.kernel import paged_attention_kernel


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    seq_lens: torch.Tensor) -> torch.Tensor:
    """q [B,KVH,G,hd]; pages [P,page,KVH,hd]; block_table [B,n]; seq_lens [B].

    Entries of block_table beyond a sequence's length may be arbitrary; they
    are clamped here and masked inside the kernel by seq_lens."""
    table = block_table.clamp(0, k_pages.shape[0] - 1).to(torch.int32)
    return paged_attention_kernel(q, k_pages, v_pages, table.contiguous(),
                                  seq_lens.to(torch.int32).contiguous())
