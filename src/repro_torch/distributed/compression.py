"""Compressed gradient reduction for the scarce cross-node links.

The counterpart of ``repro.distributed.compression``: an int8 ring
all-reduce whose every hop sends an int8-quantized payload (absmax scale
per chunk) and accumulates in fp32, with an optional **error-feedback**
residual kept rank-local so quantization noise is re-injected next step
(EF-SGD). Traffic drops ~4x against fp32. The arithmetic and the order of
the hops are the reference's: scale = absmax / 127 + 1e-12, round half to
even, an int8 payload and an fp32 scale a hop, fp32 accumulation, the
reduce-scatter ring then the all-gather ring. Two roundings follow what
XLA compiles the reference to, so that the result equals the reference's
bit for bit: the absmax is multiplied by the float32 reciprocal of 127,
and each received partial is added as one fused multiply-add
(``_accumulate``). Each hop's payload and scale move by send/recv to the
next rank of the axis's process group (the reference's ``ppermute``
i -> i+1).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import map_tree, rows_over


#: 1/127 in float32: XLA turns the reference's division of the absmax by
#: the constant 127 into a multiplication by this reciprocal.
INV_127 = 1.0 / 127.0


def _quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # a float32 tensor times a Python float multiplies by the float32 of it
    scale = torch.max(torch.abs(x)) * INV_127 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _accumulate(acc: torch.Tensor, q: torch.Tensor, s: torch.Tensor
                ) -> torch.Tensor:
    """acc + dequant(q, s), rounded once to float32 as a fused
    multiply-add: XLA contracts the reference's ``acc + _dequant(q, s)``
    into one FMA, and the port rounds likewise (the product of an int8 and
    a float32 scale is exact in float64, and so is its sum with acc but
    for a difference of exponents over 21 bits)."""
    return (acc.double() + q.double() * s.double()).float()


def _hop(q: torch.Tensor, s: torch.Tensor, group, nxt: int, prv: int):
    """Send (q, s) to the next rank, receive the previous rank's."""
    q_in, s_in = torch.empty_like(q), torch.empty_like(s)
    for r in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, q, nxt, group),
            dist.P2POp(dist.isend, s, nxt, group),
            dist.P2POp(dist.irecv, q_in, prv, group),
            dist.P2POp(dist.irecv, s_in, prv, group)]):
        r.wait()
    return q_in, s_in


def int8_ring_allreduce(x: torch.Tensor, group: dist.ProcessGroup
                        ) -> torch.Tensor:
    """Mean-all-reduce of x over ``group`` with int8 payloads on every hop
    (reduce-scatter ring + all-gather ring). Every rank of ``group`` calls
    it with its own x."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    idx = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)

    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n
    flat = torch.nn.functional.pad(flat, (0, pad))
    acc = flat.reshape(n, -1).to(torch.float32).clone()

    # ---- reduce-scatter: after n-1 hops, rank d owns the sum of chunk d+1
    for i in range(n - 1):
        q, s = _quant(acc[(idx - i) % n])
        q, s = _hop(q, s.reshape(1), group, nxt, prv)
        r = (idx - i - 1) % n
        acc[r] = _accumulate(acc[r], q, s[0])
    own = (idx + 1) % n
    mine = acc[own] / n                               # mean

    # ---- all-gather ring, also int8 per hop
    out = torch.zeros_like(acc)
    out[own] = mine
    cur, cur_idx = mine, own
    for _ in range(n - 1):
        q, s = _quant(cur)
        q, s = _hop(q, s.reshape(1), group, nxt, prv)
        cur = _dequant(q, s[0])
        cur_idx = (cur_idx - 1) % n
        out[cur_idx] = cur
    res = out.reshape(-1)[:x.numel()].reshape(x.shape)
    return res.to(x.dtype)


def compressed_mean(x, mesh, axis: str = "pod") -> DTensor:
    """x [n_axis, ...]: row i is rank-group i's local value (e.g. a pod's
    gradients), laid out as ``rows_over`` takes it. Returns x's layout
    with every row replaced by the mean, computed with int8 ring hops
    over ``axis``."""
    x = rows_over(x, mesh, axis)
    out = int8_ring_allreduce(x.to_local(), mesh.get_group(axis))
    return DTensor.from_local(out, mesh, x.placements, run_check=False)


def ef_compress_update(grads: Any, residual: Any, mesh,
                       axis: str = "pod") -> tuple[Any, Any]:
    """Error-feedback compressed gradient mean over ``axis``.

    grads: a tree whose leaves are stacked per-group local gradients
    [n_axis, ...] laid out as ``compressed_mean`` takes them; residual:
    the same structure (per-group EF state). Returns (synced grads — every
    row equal, new residual)."""
    def one(g, r):
        corrected = (rows_over(g, mesh, axis).to(torch.float32)
                     + rows_over(r, mesh, axis))
        synced = compressed_mean(corrected, mesh, axis)
        new_r = corrected - synced  # what compression lost, re-injected next step
        return synced.to(g.dtype), new_r

    out = map_tree(lambda g, r: one(g, r), grads, residual)
    pick = lambda i: map_tree(lambda o: o[i], out,  # noqa: E731
                              is_leaf=lambda o: isinstance(o, tuple))
    return pick(0), pick(1)
