"""Public wrapper: model-layout GQA -> fused attention kernel (the
counterpart of ``repro.kernels.flash_attention.ops``).

Drop-in for the model's attention core (after the QKV projections). GQA is
indexed, not expanded: the kv heads go to the kernel as they are
(``[B * Hkv, S, hd]``) and q's row ``b * H + h`` reads their row
``b * Hkv + h // g``, as the reference's BlockSpecs would view one page
for a group. The tensor's device picks the CUDA kernel or its plain
version, which expands the kv heads as the reference's ops does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as K


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """q [B,S,H,hd], k/v [B,S,Hkv,hd] -> out [B,S,H,hd]."""
    b, s, h, hd = q.shape
    if (k.dim() != 4 or v.shape != k.shape or k.shape[2] < 1
            or h % k.shape[2]
            or (k.shape[0], k.shape[1], k.shape[3]) != (b, s, hd)):
        raise ValueError(f"flash_attention: {h} query heads cannot share "
                         f"k {tuple(k.shape)} and v {tuple(v.shape)}")
    qf, kf, vf = (t.transpose(1, 2).reshape(-1, s, hd).contiguous()
                  for t in (q, k, v))
    K.check_blocks(s, bq, bk)
    out = K.run(qf, kf, vf, causal=causal, bk=bk)
    return out.reshape(b, h, s, hd).transpose(1, 2)
