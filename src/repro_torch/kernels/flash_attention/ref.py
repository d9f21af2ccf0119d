"""Oracle for flash_attention (the counterpart of
``repro.kernels.flash_attention.ref``): dense masked softmax attention in
fp32."""
from __future__ import annotations

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    bh, s, hd = q.shape
    scores = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                          k.to(torch.float32)) * hd ** -0.5
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask[None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs,
                        v.to(torch.float32)).to(q.dtype)
