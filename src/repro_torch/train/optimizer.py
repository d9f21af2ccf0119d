"""Optimizers over nested dicts of tensors: AdamW and a low-memory variant.

The counterpart of ``repro.train.optimizer``, with the reference's
arithmetic in the reference's order (float32 throughout):

``adamw``     fp32 m/v (params are the fp32 master).
``adafactor`` no first moment + factored second moment (row/col means for
              rank>=2 leaves, a rank-1 ``vhat``).

Both clip by the global norm and follow a warmup + cosine schedule. Not
``torch.optim.AdamW``: its decoupled decay rounds otherwise, and it has no
Adafactor of this form. ``update`` writes the parameters in place (under
``torch.no_grad()``) and returns them with the new state. Its leaves may
be ``DTensor`` shards (``repro_torch.distributed.step``): the global norm
then sums every shard, and Adafactor's row and column means reduce
across a sharded dimension; each mean's sum is carried out on the vector
itself (``_settled``), so the rank-1 ``vhat`` stays sharded as its leaf
is. ``state_pspecs`` lays the state out as the parameters are
(``repro_torch.distributed.sharding``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed.sharding import PSpec
from repro_torch.tree import leaves, tree_map

Params = dict


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> Callable:
    """step -> learning rate, a float32 0-d tensor (on the CPU)."""
    def lr(step):
        step = torch.as_tensor(step).to("cpu", torch.float32)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def _settled(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending sums (its ``Partial`` placements) carried out,
    so that an op combining it with a sharded tensor stays sharded; any
    other tensor as it is."""
    if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
        return t.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])
    return t


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares (float32), summed leaf by
    leaf in the reference's (sorted-key) order."""
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves(tree)))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    mode: str
    lr_fn: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    # ------------------------------------------------------------- state
    def init(self, params: Params) -> Params:
        def zeros(shape, p):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        if self.mode == "adamw":
            return {"m": tree_map(lambda p: zeros(p.shape, p), params),
                    "v": tree_map(lambda p: zeros(p.shape, p), params)}

        def v_factored(p):
            if p.ndim >= 2:
                return {"row": zeros(p.shape[:-1], p),
                        "col": zeros(p.shape[:-2] + p.shape[-1:], p)}
            return {"full": zeros(p.shape, p)}

        return {"v": tree_map(v_factored, params)}

    def state_pspecs(self, param_specs: Params, params_tree: Params) -> Params:
        """Optimizer-state specs mirroring the parameter specs.

        ``params_tree``: tensors of the parameters' shapes (for leaf
        ranks; meta tensors serve)."""
        if self.mode == "adamw":
            return {"m": param_specs, "v": param_specs}

        def v_spec(spec, p):
            if p.ndim >= 2:
                return {"row": PSpec(*spec[:-1]),
                        "col": PSpec(*(spec[:-2] + spec[-1:]))}
            return {"full": spec}

        return {"v": tree_map(v_spec, param_specs, params_tree)}

    # ------------------------------------------------------------- update
    @torch.no_grad()
    def update(self, grads: Params, state: Params, params: Params, step
               ) -> tuple[Params, Params, dict]:
        """One step: ``params`` updated in place and returned, the new
        state, and ``{"grad_norm", "lr"}``."""
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        lr_t = self.lr_fn(step)
        t = torch.as_tensor(step).to("cpu", torch.float32) + 1.0
        # float32 scalars, exact as Python floats
        lr = float(lr_t)
        bc1 = float(1 - self.b1 ** t)
        bc2 = float(1 - self.b2 ** t)
        wd = self.weight_decay

        def apply(p, u):
            p.copy_(p.float() - u.mul_(lr))

        if self.mode == "adamw":
            def upd(g, m, v, p):
                g = g.float() * scale
                m.mul_(self.b1).add_(g * (1 - self.b1))
                v.mul_(self.b2).add_(torch.square(g) * (1 - self.b2))
                u = (m / bc1).div_(torch.sqrt(v / bc2).add_(self.eps))
                apply(p, u.add_(p.float() * wd))

            tree_map(upd, grads, state["m"], state["v"], params)
            return params, state, {"grad_norm": gnorm, "lr": lr_t}

        # ---- adafactor (no first moment, factored second moment)
        def upd_low(g, v, p):
            g32 = g.float() * scale
            g2 = torch.square(g32) + 1e-30
            if p.ndim >= 2:
                row = self.b2 * v["row"] + (1 - self.b2) * _settled(
                    g2.mean(dim=-1))
                col = self.b2 * v["col"] + (1 - self.b2) * _settled(
                    g2.mean(dim=-2))
                # rank-1 reconstruction (Adafactor)
                denom = _settled(row.mean(dim=-1, keepdim=True)) + 1e-30
                vhat = row[..., :, None] * col[..., None, :] / denom[..., None]
                new_v = {"row": row, "col": col}
            else:
                vhat = self.b2 * v["full"] + (1 - self.b2) * g2
                new_v = {"full": vhat}
            u = g32.div_(torch.sqrt(vhat / bc2).add_(self.eps))
            apply(p, u.add_(p.float() * wd))
            return new_v

        return params, {"v": tree_map(upd_low, grads, state["v"], params)}, {
            "grad_norm": gnorm, "lr": lr_t}


def make_optimizer(mode: str = "adamw", *, lr: float = 3e-4, warmup: int = 200,
                   total_steps: int = 10_000, weight_decay: float = 0.1,
                   clip_norm: float = 1.0) -> Optimizer:
    if mode not in ("adamw", "adafactor"):
        raise ValueError(f"unknown optimizer mode {mode!r}")
    return Optimizer(mode=mode, lr_fn=warmup_cosine(lr, warmup, total_steps),
                     weight_decay=weight_decay, clip_norm=clip_norm)
