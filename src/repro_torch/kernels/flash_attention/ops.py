"""Public wrapper: model-layout GQA -> fused attention kernel (the
counterpart of ``repro.kernels.flash_attention.ops``).

Drop-in for the model's attention core (after the QKV projections). GQA is
expanded as the reference expands it, by repeating each KV head for its
group of query heads; indexing the KV head inside the kernel instead is a
later optimisation. The tensor's device picks the CUDA kernel or its plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """q [B,S,H,hd], k/v [B,S,Hkv,hd] -> out [B,S,H,hd]."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    if hkv < 1 or h % hkv or v.shape != k.shape:
        raise ValueError(f"flash_attention: {h} query heads cannot share "
                         f"k {tuple(k.shape)} and v {tuple(v.shape)}")
    k = k.repeat_interleave(h // hkv, dim=2)
    v = v.repeat_interleave(h // hkv, dim=2)
    qf, kf, vf = (t.transpose(1, 2).reshape(b * h, s, hd).contiguous()
                  for t in (q, k, v))
    out = flash_attention_kernel(qf, kf, vf, causal=causal, bq=bq, bk=bk)
    return out.reshape(b, h, s, hd).transpose(1, 2)
