"""Oracle for ssd_scan: a brute-force sequential recurrence in the kernel's
per-(batch*head) layout, used to cross-check the kernel and the model's
chunked form (the counterpart of ``repro.kernels.ssd_scan.ref``)."""
from __future__ import annotations

import torch


def ssd_scan_ref(xr: torch.Tensor, l: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, n_heads: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Brute-force sequential recurrence (fp32).

    xr [BH,L,hd] (dt-scaled inputs), l [BH,L] log decays, b/c [B,L,ds].
    y_t = C_t . h_t ;  h_t = exp(l_t) h_{t-1} + B_t (x) xr_t
    """
    bh, L, hd = xr.shape
    ds = b.shape[-1]
    f32 = torch.float32
    bexp = b.to(f32).repeat_interleave(n_heads, dim=0)       # [BH,L,ds]
    cexp = c.to(f32).repeat_interleave(n_heads, dim=0)
    xr32, l32 = xr.to(f32), l.to(f32)
    h = torch.zeros((bh, ds, hd), dtype=f32, device=xr.device)
    ys = []
    for t in range(L):
        h = (torch.exp(l32[:, t])[:, None, None] * h
             + bexp[:, t, :, None] * xr32[:, t, None, :])
        ys.append(torch.einsum("bs,bsd->bd", cexp[:, t], h))
    y = torch.stack(ys, dim=1) if ys else xr32
    return y.to(xr.dtype), h
