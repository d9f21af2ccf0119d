"""Shared layers: norms, rotary embeddings, MLPs, embeddings.

The counterpart of ``repro.models.layers``. Functional, as the reference
is: ``init_*`` builds a parameter dict (fp32), the apply functions consume
one. Compute happens in the activation dtype; parameters are cast at use.
Initialisers are variance-scaled truncated normals drawn from an explicit
``torch.Generator``, or from a ``numpy.random.Generator``, which makes the
same draws on any machine (:func:`repro_torch.interop.numpy_reference_params`
uses it; the reference's ``jax.random`` keys give other numbers, so tests
carry weights across with ``repro_torch.interop``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

Params = dict
#: A source of initial weights: a torch.Generator or a numpy.random.Generator.
Gen = "torch.Generator | np.random.Generator"


def _np_trunc_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """float32 standard normals truncated to [-2, 2]: draws outside are
    drawn again, in order, until none is left."""
    out = rng.standard_normal(shape, dtype=np.float32)
    flat = out.reshape(-1)
    bad = np.flatnonzero(np.abs(flat) > 2.0)
    while bad.size:
        flat[bad] = rng.standard_normal(bad.size, dtype=np.float32)
        bad = bad[np.abs(flat[bad]) > 2.0]
    return out


def trunc_normal(gen: Gen, shape, scale: float, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """``scale / sqrt(fan_in)`` times a standard normal truncated to
    [-2, 2]; fan_in is ``shape[0]``. ``gen`` is a ``torch.Generator`` or a
    ``numpy.random.Generator``."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    std = scale / math.sqrt(max(fan_in, 1))
    if isinstance(gen, np.random.Generator):
        t = torch.from_numpy(_np_trunc_normal(gen, shape)).to(device, dtype)
    else:
        t = torch.empty(shape, dtype=dtype, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std)


# ----------------------------------------------------------------- RMSNorm
def init_rmsnorm(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(dt)


# ----------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [*, S] -> (sin, cos) each [*, S, head_dim//2], fp32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions[..., None].float() * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """x [..., S, H, hd]; sin/cos [..., S, hd//2] broadcast over heads."""
    dt = x.dtype
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    s, c = sin[..., None, :], cos[..., None, :]  # head axis
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


# ----------------------------------------------------------------- MLP
#: jax.nn.gelu defaults to the tanh approximation.
ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu}


def init_mlp(gen: Gen, d: int, d_ff: int, glu: bool,
             device=None) -> Params:
    p = {"up": trunc_normal(gen, (d, d_ff), 1.0, device=device),
         "down": trunc_normal(gen, (d_ff, d), 1.0, device=device)}
    if glu:
        p["gate"] = trunc_normal(gen, (d, d_ff), 1.0, device=device)
    return p


def mlp(p: Params, x: torch.Tensor, act: str = "silu", glu: bool = True
        ) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["up"].to(dt)
    if glu:
        h = ACTS[act](x @ p["gate"].to(dt)) * h
    else:
        h = ACTS[act](h)
    return h @ p["down"].to(dt)


# ----------------------------------------------------------------- embeddings
def init_embedding(gen: Gen, vocab: int, d: int,
                   device=None) -> Params:
    return {"table": trunc_normal(gen, (vocab, d), math.sqrt(d),
                                  device=device)}


def embed(p: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["table"][tokens].to(dtype)


def unembed(p: Params, x: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Logits against the (possibly padded) table; padded ids are masked."""
    table = p["table"]
    logits = x @ table.to(x.dtype).T
    if table.shape[0] > vocab_size:
        logits[..., vocab_size:] = -1e9
    return logits
