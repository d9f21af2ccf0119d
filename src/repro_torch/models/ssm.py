"""Mamba-2 (SSD, state-space duality) block in PyTorch.

The counterpart of ``repro.models.ssm``, with the same layout [arXiv:2405.21060]:

  in_proj: d -> [z(di), x(di)] and d -> [B(g*ds), C(g*ds), dt(H)]
  causal depthwise conv over x and [B,C] (split params)
  SSD: h_t = a_t h_{t-1} + (dt_t B_t) (x) x_t ; y_t = C_t . h_t + D x_t
       a_t = exp(dt_t * A), A = -exp(A_log)  (per head)
  gated norm: y = RMSNorm(y * silu(z)); out_proj: di -> d

:func:`ssm_forward` (train/prefill) always runs the SSD scan through
:func:`repro_torch.kernels.ssd_scan.ssd_scan`, whose tensor's device picks
the CUDA kernel or its plain version; the reference's ``use_kernel`` flag
is dropped. :func:`ssd_chunked`, the reference model's default path, is
kept as a second oracle. :func:`ssm_decode` stays plain PyTorch, as it is
plain JAX in the reference. The causal conv is the reference's shifted
sums, not a cuDNN convolution.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.layers import Gen, Params, trunc_normal


class SSMState(NamedTuple):
    conv_x: torch.Tensor   # [B, d_conv-1, di]      rolling conv inputs (x part)
    conv_bc: torch.Tensor  # [B, d_conv-1, 2*g*ds]  rolling conv inputs (B/C part)
    ssd: torch.Tensor      # [B, H, d_state, head_dim] recurrent state


def init_ssm(gen: Gen, d: int, cfg: SSMConfig,
             device=None) -> Params:
    di = cfg.d_inner(d)
    h = cfg.n_heads(d)
    gds = cfg.n_groups * cfg.d_state
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_zx": trunc_normal(gen, (d, 2 * di), 1.0, device=device),
        "in_bcdt": trunc_normal(gen, (d, 2 * gds + h), 1.0, device=device),
        "conv_x_w": trunc_normal(gen, (cfg.d_conv, di), 2.0, device=device),
        "conv_x_b": torch.zeros((di,), **f32),
        "conv_bc_w": trunc_normal(gen, (cfg.d_conv, 2 * gds), 2.0,
                                  device=device),
        "conv_bc_b": torch.zeros((2 * gds,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "D": torch.ones((h,), **f32),
        # softplus^-1(0.01)
        "dt_bias": torch.full((h,), math.log(math.expm1(0.01)), **f32),
        "norm_scale": torch.ones((di,), **f32),
        "out_proj": trunc_normal(gen, (di, d), 1.0, device=device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv + SiLU: xbc [B,L,C], w [K,C] -> [B,L,C]."""
    k, L = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + pad[:, i:i + L, :] * w[i].to(xbc.dtype)
    return F.silu(out + bias.to(xbc.dtype))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                chunk: int, h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (n_groups=1 layout), the reference model's form.

    x  [B, L, H, hd]  raw inputs (dt applied here)
    dt [B, L, H]      post-softplus
    b,c [B, L, ds]
    returns y [B, L, H, hd], final state [B, H, ds, hd]
    """
    bsz, L, H, hd = x.shape
    ds = b.shape[-1]
    if L % chunk:
        raise ValueError(f"ssd_chunked: L={L} is not a multiple of "
                         f"chunk={chunk}")
    n = L // chunk
    f32 = torch.float32

    A = -torch.exp(a_log.to(f32))                          # [H], negative
    dt32 = dt.to(f32)
    l = dt32 * A                                           # [B,L,H]
    xr = x.to(f32) * dt32[..., None]                       # dt-scaled input

    xc = xr.reshape(bsz, n, chunk, H, hd)
    lc = l.reshape(bsz, n, chunk, H)
    bc = b.to(f32).reshape(bsz, n, chunk, ds)
    cc = c.to(f32).reshape(bsz, n, chunk, ds)

    cum = torch.cumsum(lc, dim=2)                          # [B,n,Q,H]
    total = cum[:, :, -1, :]                               # [B,n,H]

    # intra-chunk: M_ij = (C_i.B_j) * exp(cum_i - cum_j) * (i >= j)
    g = torch.einsum("bnis,bnjs->bnij", cc, bc)            # [B,n,Q,Q]
    delta = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,n,Q,Q,H]
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()[None, None, :, :, None]
    m = torch.where(mask, torch.exp(delta.masked_fill(~mask, 0.0)), 0.0)
    y_intra = torch.einsum("bnij,bnijh,bnjhd->bnihd", g, m, xc)

    # per-chunk state contribution: S_n = sum_j exp(total - cum_j) B_j (x) x_j
    w = torch.exp(total[:, :, None, :] - cum)              # [B,n,Q,H]
    s_chunk = torch.einsum("bnjs,bnjh,bnjhd->bnhsd", bc, w, xc)

    # inter-chunk scan over n
    h = (torch.zeros((bsz, H, ds, hd), dtype=f32, device=x.device)
         if h0 is None else h0)
    h_prevs = []
    for k in range(n):
        h_prevs.append(h)                                  # state BEFORE chunk k
        h = h * torch.exp(total[:, k])[..., None, None] + s_chunk[:, k]
    h_prevs = torch.stack(h_prevs, dim=1)                  # [B,n,H,ds,hd]

    y_inter = torch.einsum("bnis,bnhsd,bnih->bnihd", cc, h_prevs,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(bsz, L, H, hd)
    y = y + x.to(f32) * d_skip.to(f32)[None, None, :, None]
    return y.to(x.dtype), h


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    dt = y.dtype
    y32 = y.float() * F.silu(z.float())
    var = y32.square().mean(dim=-1, keepdim=True)
    return (y32 * torch.rsqrt(var + eps) * scale).to(dt)


def ssm_forward(p: Params, x: torch.Tensor, d: int, cfg: SSMConfig,
                return_state: bool = False):
    """Train/prefill forward. x [B,L,D] -> y [B,L,D] (+ SSMState)."""
    bsz, L, _ = x.shape
    di = cfg.d_inner(d)
    H = cfg.n_heads(d)
    gds = cfg.n_groups * cfg.d_state
    dt_ = x.dtype

    zx = x @ p["in_zx"].to(dt_)
    z, xs = zx[..., :di], zx[..., di:]
    bcdt = x @ p["in_bcdt"].to(dt_)
    bc, dt_raw = bcdt[..., :2 * gds], bcdt[..., 2 * gds:]

    xs = _causal_conv(xs, p["conv_x_w"], p["conv_x_b"])
    bc_conv = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"])
    b, c = bc_conv[..., :gds], bc_conv[..., gds:]

    dt = softplus(dt_raw.float() + p["dt_bias"])
    xh = xs.reshape(bsz, L, H, cfg.head_dim)
    y, hT = ssd_scan(xh, dt, p["A_log"], b, c, p["D"], chunk=cfg.chunk)
    y = y.reshape(bsz, L, di)
    y = _gated_norm(y, z, p["norm_scale"])
    out = y @ p["out_proj"].to(dt_)
    if not return_state:
        return out
    # conv states = last (d_conv-1) PRE-conv inputs; recompute cheaply
    tail = x[:, -(cfg.d_conv - 1):, :]
    xs_t = (tail @ p["in_zx"].to(dt_))[..., di:]
    bc_t = (tail @ p["in_bcdt"].to(dt_))[..., :2 * gds]
    return out, SSMState(conv_x=xs_t, conv_bc=bc_t, ssd=hT)


def ssm_decode(p: Params, x: torch.Tensor, state: SSMState, d: int,
               cfg: SSMConfig) -> tuple[torch.Tensor, SSMState]:
    """Single-token decode. x [B,1,D]."""
    bsz = x.shape[0]
    di = cfg.d_inner(d)
    H = cfg.n_heads(d)
    gds = cfg.n_groups * cfg.d_state
    dt_ = x.dtype

    zx = x[:, 0] @ p["in_zx"].to(dt_)
    z, xs_new = zx[..., :di], zx[..., di:]
    bcdt = x[:, 0] @ p["in_bcdt"].to(dt_)
    bc_new, dt_raw = bcdt[..., :2 * gds], bcdt[..., 2 * gds:]

    # rolling causal convs
    win_x = torch.cat([state.conv_x, xs_new[:, None]], dim=1)    # [B,K,di]
    win_bc = torch.cat([state.conv_bc, bc_new[:, None]], dim=1)
    xs = F.silu(torch.einsum("bkc,kc->bc", win_x, p["conv_x_w"].to(dt_))
                + p["conv_x_b"].to(dt_))
    bc = F.silu(torch.einsum("bkc,kc->bc", win_bc, p["conv_bc_w"].to(dt_))
                + p["conv_bc_b"].to(dt_))
    b, c = bc[..., :gds], bc[..., gds:]

    dt = softplus(dt_raw.float() + p["dt_bias"])                 # [B,H]
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)                                        # [B,H]
    xh = xs.reshape(bsz, H, cfg.head_dim).float() * dt[..., None]
    h = state.ssd * a[..., None, None] + torch.einsum(
        "bs,bhd->bhsd", b.float(), xh)
    y = torch.einsum("bs,bhsd->bhd", c.float(), h)
    y = y + xs.reshape(bsz, H, cfg.head_dim).float() * p["D"][None, :, None]
    y = y.reshape(bsz, di).to(dt_)
    y = _gated_norm(y, z, p["norm_scale"])
    out = (y @ p["out_proj"].to(dt_))[:, None]
    return out, SSMState(conv_x=win_x[:, 1:], conv_bc=win_bc[:, 1:], ssd=h)
