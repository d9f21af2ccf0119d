"""Grouped-query attention: training/prefill (naive or chunked) and
single-token decode against a KV cache.

The counterpart of ``repro.models.attention``, plain PyTorch as the
reference is plain JAX (no kernel: the reference model calls neither flash
nor paged attention). Shapes: x [B, S, D]; q [B, S, H, hd]; kv [B, S, Hkv,
hd]; GQA groups G = H // Hkv. ``n_pad_heads`` adds zero-initialised query
heads (and their rows of ``wo``) for tensor-parallel head padding, as the
reference does; the groups are then ``(H + pad) // Hkv``, so a real query
head h reads kv head ``h // groups`` of the padded count, which the port
keeps. Masks are -1e9, the softmax runs in fp32 and is cast to the
activation dtype before P V, everywhere, as in the reference.

``kv_index`` (tensor parallelism, ``repro_torch.distributed.partition``):
the kv head each of the given query heads reads, as an index into the
given keys and values, for a rank that holds a slice of the heads; None
expands them ``groups`` times as above.

:class:`Window` (decode, sequence parallelism): the cache a rank holds is
a window of the whole cache's slots, its query heads perhaps a slice of
them; the softmax over the window's slots is merged with the other
windows' from each window's max, sum of exp and unnormalised output. The
default window is the single device's: every slot, no collective, the
reference's own operations.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import AttnConfig
from repro_torch.models.layers import (Gen, Params, apply_rope, rope_angles,
                                       trunc_normal)

NEG = -1e9


class KVCache(NamedTuple):
    k: torch.Tensor   # [B, S_max, Hkv, hd]
    v: torch.Tensor   # [B, S_max, Hkv, hd]


class Window(NamedTuple):
    """One rank's share of a decode attention (``Layout.window``). The
    cache it is given holds slots ``[s0, s0 + S_l)`` of the whole.
    ``merge`` (``.max(t)`` / ``.sum(t)`` over the ranks that split the
    slots; None: no other rank) merges the partial softmax terms.
    ``heads`` (``.gather(t)``: a ``[B, 1, h, hd]`` tensor of the rank's
    heads -> every head; ``.own(t)``: every head -> the rank's) where the
    rank's projections hold a slice of the heads; None: every head."""

    s0: int = 0
    merge: Any = None
    heads: Any = None


def init_attention(gen: Gen, d: int, cfg: AttnConfig, n_pad_heads: int = 0,
                   device=None) -> Params:
    """wq, wk, wv, wo at the reference's scales; padded heads are zero (wo
    keeps the fan-in of all H + pad heads, as the reference draws it)."""
    h, hd = cfg.n_heads + n_pad_heads, cfg.head_dim
    p = {"wq": trunc_normal(gen, (d, h, hd), 1.0, device=device),
         "wk": trunc_normal(gen, (d, cfg.n_kv_heads, hd), 1.0, device=device),
         "wv": trunc_normal(gen, (d, cfg.n_kv_heads, hd), 1.0, device=device),
         "wo": trunc_normal(gen, (h, hd, d), 1.0, device=device)}
    if n_pad_heads:
        p["wq"][:, cfg.n_heads:] = 0
        p["wo"][cfg.n_heads:] = 0
    return p


def _qkv(p: Params, x: torch.Tensor, cfg: AttnConfig,
         positions: torch.Tensor):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    sin, cos = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def _expand_kv(k: torch.Tensor, groups: int,
               kv_index: torch.Tensor | None = None) -> torch.Tensor:
    if kv_index is not None:
        return k.index_select(2, kv_index)
    return k.repeat_interleave(groups, dim=2)


def _softmax(scores: torch.Tensor, dtype) -> torch.Tensor:
    return torch.softmax(scores.float(), dim=-1).to(dtype)


def _merged(scores: torch.Tensor, v: torch.Tensor, eq: str, dtype, merge
            ) -> torch.Tensor:
    """softmax(scores) @ v where the slots (the scores' last axis) are
    split over ranks: this rank's max, sum of exp and unnormalised output
    (its weights cast to ``dtype`` before P V, as the reference casts its
    probabilities), each rescaled to the ranks' max and summed over them.
    A rank whose slots are all masked (max ``NEG``) gets weight
    exp(NEG - max) = 0. ``eq`` keeps the scores' leading axes."""
    s = scores.float()
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum(eq, p.to(dtype), v).float()
    w = torch.exp(m - merge.max(m))
    lo = merge.sum(torch.cat([p.sum(-1, keepdim=True) * w, o * w], dim=-1))
    return (lo[..., 1:] / lo[..., :1]).to(dtype)


def _full(q, k, v, scale: float, causal: bool) -> torch.Tensor:
    """Attention over the whole sequence at once: [B, S, H, hd]."""
    s = q.shape[1]
    scores = torch.einsum("bqhk,bshk->bhqs", q, k) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, NEG)
    return torch.einsum("bhqs,bshk->bqhk", _softmax(scores, q.dtype), v)


def attention(p: Params, x: torch.Tensor, cfg: AttnConfig, *,
              positions: torch.Tensor | None = None, impl: str = "naive",
              q_chunk: int = 1024, kv_index: torch.Tensor | None = None
              ) -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _qkv(p, x, cfg, positions)
    groups = q.shape[2] // cfg.n_kv_heads
    k, v = _expand_kv(k, groups, kv_index), _expand_kv(v, groups, kv_index)
    scale = cfg.head_dim ** -0.5
    if impl == "chunked" and s > q_chunk:
        out = _chunked_attention(q, k, v, scale, cfg.causal, q_chunk)
    else:
        out = _full(q, k, v, scale, cfg.causal)
    return torch.einsum("bqhk,hkd->bqd", out, p["wo"].to(x.dtype))


def _chunked_attention(q, k, v, scale: float, causal: bool, q_chunk: int
                       ) -> torch.Tensor:
    """The reference's query-chunk schedule: a full softmax over all keys
    for each chunk of ``q_chunk`` queries (peak memory O(q_chunk * S))."""
    b, s, h, hd = q.shape
    nq = s // q_chunk
    q_ = q.reshape(b, nq, q_chunk, h, hd).permute(1, 0, 3, 2, 4)
    kt = k.permute(0, 2, 3, 1)                                   # [B,H,hd,S]
    vt = v.permute(0, 2, 1, 3)                                   # [B,H,S,hd]
    keys = torch.arange(s, device=q.device)
    outs = []
    for i in range(nq):
        scores = torch.einsum("bhqk,bhks->bhqs", q_[i], kt) * scale
        if causal:
            qpos = i * q_chunk + torch.arange(q_chunk, device=q.device)
            scores = scores.masked_fill(~(qpos[:, None] >= keys[None, :]), NEG)
        outs.append(torch.einsum("bhqs,bhsk->bhqk",
                                 _softmax(scores, q.dtype), vt))
    out = torch.stack(outs)                              # [nq,B,H,qc,hd]
    return out.permute(1, 0, 3, 2, 4).reshape(b, s, h, hd)


def prefill_attention(p: Params, x: torch.Tensor, cfg: AttnConfig, *,
                      impl: str = "chunked",
                      kv_index: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, KVCache]:
    """Prefill: causal self-attention and the KV cache (rotated keys);
    chunked only above 1024 tokens."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _qkv(p, x, cfg, positions)
    groups = q.shape[2] // cfg.n_kv_heads
    scale = cfg.head_dim ** -0.5
    ke, ve = _expand_kv(k, groups, kv_index), _expand_kv(v, groups, kv_index)
    if impl == "chunked" and s > 1024:
        out = _chunked_attention(q, ke, ve, scale, cfg.causal, 1024)
    else:
        out = _full(q, ke, ve, scale, True)
    y = torch.einsum("bqhk,hkd->bqd", out, p["wo"].to(x.dtype))
    return y, KVCache(k=k, v=v)


def decode_attention(p: Params, x: torch.Tensor, cfg: AttnConfig,
                     cache: KVCache, cur_len, grouped: bool = False,
                     window: Window = Window()
                     ) -> tuple[torch.Tensor, KVCache]:
    """One-token decode: x [B, 1, D]; cache [B, S_l, Hkv, hd], slots
    ``[window.s0, window.s0 + S_l)`` of the whole cache's S_max; cur_len
    an int, a [] or a [B] tensor.

    The new key and value are added to the cache at ``cur_len`` by a
    one-hot sum, as the reference appends: at ``cur_len >= S_max`` nothing
    is written (and every slot stays valid), never an index out of range;
    a window without slot ``cur_len`` writes nothing either. ``grouped=
    True`` computes GQA on the raw cache (q as [B, Hkv, G, hd])."""
    b = x.shape[0]
    s_l = cache.k.shape[1]
    cur = torch.as_tensor(cur_len, device=x.device).reshape(-1, 1)
    q, k_new, v_new = _qkv(p, x, cfg, cur.expand(b, 1))
    if window.heads is not None:
        q = window.heads.gather(q)
        if k_new.shape[2] != cache.k.shape[2]:
            k_new, v_new = (window.heads.gather(k_new),
                            window.heads.gather(v_new))

    slots = window.s0 + torch.arange(s_l, device=x.device)[None, :]
    onehot = (slots == cur)[..., None, None]                     # [B,S,1,1]
    k = cache.k + onehot * k_new.to(cache.k.dtype)
    v = cache.v + onehot * v_new.to(cache.v.dtype)

    scale = cfg.head_dim ** -0.5
    valid = slots <= cur                                         # [B,S]
    groups = q.shape[2] // cfg.n_kv_heads
    if grouped:
        qg = q[:, 0].reshape(b, cfg.n_kv_heads, groups, cfg.head_dim)
        scores = torch.einsum("bhgd,bshd->bhgs", qg, k) * scale
        scores = scores.masked_fill(~valid[:, None, None, :], NEG)
        if window.merge is None:
            out = torch.einsum("bhgs,bshd->bhgd", _softmax(scores, x.dtype),
                               v)
        else:
            out = _merged(scores, v, "bhgs,bshd->bhgd", x.dtype,
                          window.merge)
        out = out.reshape(b, 1, q.shape[2], cfg.head_dim)
    else:
        ke, ve = _expand_kv(k, groups), _expand_kv(v, groups)
        scores = torch.einsum("bqhk,bshk->bhqs", q, ke) * scale
        scores = scores.masked_fill(~valid[:, None, None, :], NEG)
        if window.merge is None:
            out = torch.einsum("bhqs,bshk->bqhk", _softmax(scores, x.dtype),
                               ve)
        else:
            out = _merged(scores, ve, "bhqs,bshk->bhqk", x.dtype,
                          window.merge).transpose(1, 2)
    if window.heads is not None:
        out = window.heads.own(out)
    y = torch.einsum("bqhk,hkd->bqd", out, p["wo"].to(x.dtype))
    return y, KVCache(k=k, v=v)


# --------------------------------------------------------------- cross-attn
def cross_kv(p: Params, enc: torch.Tensor, dtype) -> KVCache:
    """The encoder's keys and values (no RoPE), as the decoder caches
    them."""
    k = torch.einsum("bsd,dhk->bshk", enc, p["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", enc, p["wv"].to(dtype))
    return KVCache(k=k, v=v)


def cross_attend(p: Params, x: torch.Tensor, kv: KVCache,
                 cfg: AttnConfig, kv_index: torch.Tensor | None = None,
                 window: Window = Window()) -> torch.Tensor:
    """Decoder cross-attention against the encoder's keys and values
    (:func:`cross_kv`; full, no causal mask), or against ``window``'s
    slots of them (decode; nothing is written)."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    if window.heads is not None:
        q = window.heads.gather(q)
    groups = q.shape[2] // cfg.n_kv_heads
    k = _expand_kv(kv.k, groups, kv_index)
    v = _expand_kv(kv.v, groups, kv_index)
    scale = cfg.head_dim ** -0.5
    if window.merge is None:
        out = _full(q, k, v, scale, False)
    else:
        scores = torch.einsum("bqhk,bshk->bhqs", q, k) * scale
        out = _merged(scores, v, "bhqs,bshk->bhqk", dt,
                      window.merge).transpose(1, 2)
    if window.heads is not None:
        out = window.heads.own(out)
    return torch.einsum("bqhk,hkd->bqd", out, p["wo"].to(dt))


def cross_attention(p: Params, x: torch.Tensor, enc: torch.Tensor,
                    cfg: AttnConfig, kv_index: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """Decoder cross-attention (full; no causal mask; no RoPE on encoder
    keys)."""
    return cross_attend(p, x, cross_kv(p, enc, x.dtype), cfg, kv_index)
