"""Mixture-of-Experts FFN with sort-based (grouped-GEMM) dispatch.

The counterpart of ``repro.models.moe``. Tokens are routed top-k, sorted
by expert id, scattered into per-expert capacity buffers ``[E, C, D]``,
multiplied by their expert's weights and combined with the router
weights; slots past an expert's capacity are dropped.

Where the reference computes the three expert products as
``einsum("ecd,edf->ecf")`` (the grouped GEMM its Pallas kernel replaces),
the port runs each through
:func:`repro_torch.kernels.moe_gemm.ops.grouped_matmul` on the capacity
buffer flattened to ``[E*C, D]``, one token block per expert (``bt = C``,
``block_eids = arange(E)``): on a CPU tensor its plain version, on the card
the CUDA kernel. The train route (``Model.loss``) passes
``use_kernel=False`` and takes the reference's own ``einsum`` in autograd,
since the kernel has no backward. Shared experts stay plain matmuls, as in
the reference.
The top k comes from a stable descending sort, so ties go to the lower
expert id as ``jax.lax.top_k`` breaks them.

A batch split over ranks (the sharded steps, ``repro_torch.distributed``)
passes a ``group`` (:class:`repro_torch.models.layers.BatchGroup`): the
capacity and the drop order are then the whole batch's, as the
reference's one global program takes them. The capacity is
``expert_capacity`` of every member's tokens; a member's slots in an
expert's buffer start after the slots the members before it (in batch
order) send there, from an all-gather of ``E + 1`` integers a layer; the
aux loss takes ``density`` and the router mean as sums over the group.
``experts=(e0, e1)`` (tensor parallelism over "model") pushes the tokens
through those experts only, whose weights ``p`` then holds, and returns
their part of the output. That route (:func:`_moe_split`) multiplies each
expert's kept rows alone, with ``@`` in autograd, and never launches the
kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels.moe_gemm.ops import (capacity_block_eids,
                                              grouped_matmul)
from repro_torch.models.layers import ACTS, Gen, Params, trunc_normal


def init_moe(gen: Gen, d: int, cfg: MoEConfig, glu: bool,
             device=None) -> Params:
    e, f = cfg.n_experts, cfg.d_ff_expert
    p = {"router": trunc_normal(gen, (d, e), 1.0, device=device),
         "up": trunc_normal(gen, (e, d, f), 1.0, device=device),
         "down": trunc_normal(gen, (e, f, d), 1.0, device=device)}
    if glu:
        p["gate"] = trunc_normal(gen, (e, d, f), 1.0, device=device)
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_up"] = trunc_normal(gen, (d, fs), 1.0, device=device)
        p["shared_down"] = trunc_normal(gen, (fs, d), 1.0, device=device)
        if glu:
            p["shared_gate"] = trunc_normal(gen, (d, fs), 1.0, device=device)
    return p


def expert_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    cap = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                        * cfg.capacity_factor))
    return max(8, -(-cap // 8) * 8)  # round up to 8


def route(p: Params, x2d: torch.Tensor, cfg: MoEConfig, group=None):
    """x2d [T, D] -> (weights [T,k], expert_ids [T,k], aux_loss). With a
    ``group`` the aux loss is the whole batch's: ``density`` and the
    router mean are summed over the group (one all-reduce, the router
    mean's gradient carried) and divided by its tokens."""
    logits = (x2d @ p["router"].to(x2d.dtype)).float()             # [T,E]
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :cfg.top_k], ids[:, :cfg.top_k]
    w = w / w.sum(dim=-1, keepdim=True)
    # Switch-style load-balancing aux loss
    if group is None:
        density = F.one_hot(ids[:, 0], cfg.n_experts).float().mean(dim=0)
        aux = cfg.n_experts * (density * probs.mean(dim=0)).sum()
    else:
        sums = group.sum(torch.cat([
            F.one_hot(ids[:, 0], cfg.n_experts).float().sum(dim=0),
            probs.sum(dim=0)]))
        n = float(x2d.shape[0] * group.size)
        aux = cfg.n_experts * (sums[:cfg.n_experts] / n
                               * (sums[cfg.n_experts:] / n)).sum()
    return w.to(x2d.dtype), ids, aux


def _experts(w: torch.Tensor, xs: torch.Tensor, eids: torch.Tensor | None,
             cap: int) -> torch.Tensor:
    """[E*C, K] @ w[e] for each expert's C rows: through the kernel, or
    with ``eids`` None as the reference's einsum over ``[E, C, K]``."""
    if eids is None:
        e = w.shape[0]
        return torch.einsum("ecd,edf->ecf", xs.reshape(e, cap, -1),
                            w.to(xs.dtype)).reshape(e * cap, -1)
    return grouped_matmul(xs, w.to(xs.dtype).contiguous(), eids, bt=cap,
                          bf=math.gcd(w.shape[-1], 128))


def moe_ffn(p: Params, x: torch.Tensor, cfg: MoEConfig, act: str = "silu",
            glu: bool = True, use_kernel: bool = True, group=None,
            experts: tuple[int, int] | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux_loss). Sort-based dispatch with
    drops. ``use_kernel=False`` takes the einsum products
    (differentiable). ``group`` / ``experts``: see the module docstring
    (either takes :func:`_moe_split`)."""
    if group is not None or experts is not None:
        return _moe_split(p, x, cfg, act, glu, group, experts)
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.n_experts
    x2d = x.reshape(t, d)
    w, ids, aux = route(p, x2d, cfg)
    cap = expert_capacity(t, cfg)

    flat_e = ids.reshape(-1)                          # [T*k] expert per slot
    order = torch.argsort(flat_e, stable=True)        # sort slots by expert
    sorted_e = flat_e[order]
    # position of each sorted slot within its expert's capacity buffer
    pos_in_e = (torch.arange(t * k, device=x.device)
                - torch.searchsorted(sorted_e, sorted_e, side="left"))
    keep = pos_in_e < cap                             # dropped beyond capacity
    dest = torch.where(keep, sorted_e * cap + pos_in_e, e * cap)

    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = x2d[order // k]                       # dispatch scatter
    xs = buf[:-1]                                     # [E*C, D]

    eids = (capacity_block_eids(e, cap, cap, device=x.device) if use_kernel
            else None)
    h = _experts(p["up"], xs, eids, cap)
    if glu:
        h = ACTS[act](_experts(p["gate"], xs, eids, cap)) * h
    else:
        h = ACTS[act](h)
    yflat = _experts(p["down"], h, eids, cap)         # [E*C, D]

    # combine: gather back to slots, weight, sum over k
    slot_y = torch.where(keep[:, None],
                         yflat[torch.clamp(dest, max=e * cap - 1)], 0)
    unsort = torch.zeros((t * k, d), dtype=x.dtype, device=x.device)
    unsort[order] = slot_y
    y = (unsort.reshape(t, k, d) * w[..., None]).sum(dim=1)

    if cfg.n_shared_experts:
        hs = x2d @ p["shared_up"].to(x.dtype)
        if glu:
            hs = ACTS[act](x2d @ p["shared_gate"].to(x.dtype)) * hs
        else:
            hs = ACTS[act](hs)
        y = y + hs @ p["shared_down"].to(x.dtype)

    return y.reshape(b, s, d), aux * cfg.aux_loss_coef


def _shared(p: Params, x2d: torch.Tensor, act: str, glu: bool
            ) -> torch.Tensor:
    hs = x2d @ p["shared_up"].to(x2d.dtype)
    if glu:
        hs = ACTS[act](x2d @ p["shared_gate"].to(x2d.dtype)) * hs
    else:
        hs = ACTS[act](hs)
    return hs @ p["shared_down"].to(x2d.dtype)


def _moe_split(p: Params, x: torch.Tensor, cfg: MoEConfig, act: str,
               glu: bool, group, experts: tuple[int, int] | None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` on one member of a batch ``group`` (None: the batch is
    whole) through experts ``[e0, e1)`` (None: all), whose weights are
    ``p``'s. A slot's position in its expert's buffer is the slots the
    earlier members send there plus its rank among this member's, as the
    reference's stable sort over the whole batch places it; slots at or
    past the global capacity drop. Each expert's kept rows (a contiguous
    run of the sorted slots) are multiplied alone, so the work is this
    member's tokens, not the capacity buffer. On ``meta`` (no routing to
    read) each expert takes the balanced load, ``T k / E`` rows."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.n_experts
    e0, e1 = experts if experts is not None else (0, e)
    x2d = x.reshape(t, d)
    w, ids, aux = route(p, x2d, cfg, group)
    members = 1 if group is None else group.size
    cap = expert_capacity(t * members, cfg)

    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(e, dtype=torch.long, device=x.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    if group is None:
        before = torch.zeros_like(counts)
    else:
        every = group.gather(counts)                           # [n, E]
        before = every[:group.index].sum(dim=0)
    kept = (cap - before).clamp(min=0).minimum(counts)         # [E]
    starts = torch.cumsum(counts, 0) - counts
    if x.device.type == "meta":
        sizes = [min(cap, -(-t * k // e))] * (e1 - e0)
        firsts = [0] * (e1 - e0)
    else:
        sizes = kept[e0:e1].tolist()
        firsts = starts[e0:e1].tolist()
    slots = torch.cat([order[f:f + n] for f, n in zip(firsts, sizes)])
    xs = x2d[slots // k]
    outs, lo = [], 0
    for j, n in enumerate(sizes):
        xe, lo = xs[lo:lo + n], lo + n
        h = xe @ p["up"][j].to(x.dtype)
        if glu:
            h = ACTS[act](xe @ p["gate"][j].to(x.dtype)) * h
        else:
            h = ACTS[act](h)
        outs.append(h @ p["down"][j].to(x.dtype))
    slot_y = torch.zeros((t * k, d), dtype=x.dtype, device=x.device)
    slot_y = slot_y.index_put((slots,), torch.cat(outs))
    y = (slot_y.reshape(t, k, d) * w[..., None]).sum(dim=1)
    if cfg.n_shared_experts:
        y = y + _shared(p, x2d, act, glu)
    return y.reshape(b, s, d), aux * cfg.aux_loss_coef
