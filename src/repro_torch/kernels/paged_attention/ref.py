"""Oracle for paged_attention (the counterpart of
``repro.kernels.paged_attention.ref``): gather the pages densely, then a
masked softmax decode in fp32."""
from __future__ import annotations

import torch


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_table: torch.Tensor,
                        seq_lens: torch.Tensor) -> torch.Tensor:
    bsz, kvh, g, hd = q.shape
    page = k_pages.shape[1]
    n_pages = block_table.shape[1]
    s_max = n_pages * page
    bt = block_table.long()
    k = k_pages[bt].reshape(bsz, s_max, kvh, hd).to(torch.float32)
    v = v_pages[bt].reshape(bsz, s_max, kvh, hd).to(torch.float32)
    scores = torch.einsum("bhgd,bshd->bhgs", q.to(torch.float32),
                          k) * hd ** -0.5
    valid = (torch.arange(s_max, device=q.device)[None, :]
             < seq_lens.to(q.device)[:, None])
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", probs, v).to(q.dtype)
