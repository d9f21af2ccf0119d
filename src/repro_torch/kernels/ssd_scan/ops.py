"""Public wrapper: model layout -> kernel layout -> back.

The counterpart of ``repro.kernels.ssd_scan.ops``: ``ssd_scan`` is a
drop-in replacement for :func:`repro_torch.models.ssm.ssd_chunked` (same
signature for the n_groups=1 case the architectures use). It applies dt,
casts the dt-scaled input to x's dtype before the kernel and adds the D
skip in x's dtype, as the reference does, so bf16 results round where the
reference's do. The tensor's device picks the CUDA kernel or its plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
             chunk: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,L,H,hd], dt [B,L,H], a_log [H], b/c [B,L,ds], d_skip [H]
    -> y [B,L,H,hd], hT [B,H,ds,hd]   (matches models.ssm.ssd_chunked)."""
    bsz, L, H, hd = x.shape
    ds = b.shape[-1]
    f32 = torch.float32

    A = -torch.exp(a_log.to(f32))
    dt32 = dt.to(f32)
    l = (dt32 * A).transpose(1, 2).reshape(bsz * H, L).contiguous()  # [BH,L]
    xr = (x.to(f32) * dt32[..., None]).transpose(1, 2)
    xr = xr.reshape(bsz * H, L, hd).to(x.dtype).contiguous()

    y, hT = ssd_scan_kernel(xr, l, b.contiguous(), c.contiguous(),
                            chunk=chunk, n_heads=H)
    y = y.reshape(bsz, H, L, hd).transpose(1, 2)
    y = y + x * d_skip.to(x.dtype)[None, None, :, None]
    return y, hT.reshape(bsz, H, ds, hd)
