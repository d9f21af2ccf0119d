"""Train step assembly: loss -> grads (with optional microbatch
accumulation) -> optimizer update.

The counterpart of ``repro.train.step``, with its signature: the step
takes ``(params, opt_state, batch, step)`` and returns ``(params,
opt_state, metrics)``, ``metrics = {loss, ce, aux, grad_norm, lr}``.
``params`` is a tree in the model's layout; where its tensors are not the
model's own (a restored checkpoint's), they are copied into the model
first. Gradients come from ``Model.loss`` (the train route) by
``torch.autograd.grad``, and the update writes the model's parameters in
place. With ``grad_accum > 1`` the batch's leading dimension is split into
that many microbatches; their gradients and losses are summed from zero,
in order, and divided by ``grad_accum``, and ``ce`` / ``aux`` are the last
microbatch's, as the reference's ``lax.scan`` returns them.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.builder import Model
from repro_torch.train.optimizer import Optimizer
from repro_torch.tree import leaves_with_paths, unflatten


def value_and_grad(model: Model, batch: dict
                   ) -> tuple[torch.Tensor, dict, dict[str, torch.Tensor]]:
    """``model.loss(batch)`` and its gradient: (loss, {"ce", "aux"},
    {path: grad}) with paths as ``repro_torch.tree`` names them. Every
    parameter must take part in the loss (a leaf the graph does not reach
    raises)."""
    paths, params = zip(*leaves_with_paths(model.param_tree()))
    loss, extras = model.loss(batch)
    grads = torch.autograd.grad(loss, params)
    return (loss.detach(), {k: v.detach() for k, v in extras.items()},
            dict(zip(paths, grads)))


@torch.no_grad()
def adopt(model: Model, params: dict) -> None:
    """Copy ``params`` (a tree in the model's layout) into the model's own
    parameters, leaf by leaf, where a leaf is not already the model's."""
    given = dict(leaves_with_paths(params))
    own = dict(leaves_with_paths(model.param_tree()))
    if set(given) != set(own):
        raise ValueError(f"parameter tree differs from the model's: "
                         f"{sorted(set(given) ^ set(own))[:4]}")
    for k, t in own.items():
        if given[k] is not t:
            t.copy_(given[k])


def loss_and_grads(model: Model, batch: dict, grad_accum: int = 1
                   ) -> tuple[torch.Tensor, dict, dict[str, torch.Tensor]]:
    """``value_and_grad`` over ``batch``, or with ``grad_accum > 1`` over
    that many microbatches of its leading dimension: their losses and
    gradients summed from zero, in order, and divided by ``grad_accum``;
    ``{"ce", "aux"}`` the last microbatch's."""
    if grad_accum == 1:
        return value_and_grad(model, batch)

    def split(x, i):
        b = x.shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} does not split into "
                             f"{grad_accum} microbatches")
        return x.reshape(grad_accum, b // grad_accum, *x.shape[1:])[i]

    loss = torch.zeros((), dtype=torch.float32, device=model.device)
    grads = None
    for i in range(grad_accum):
        mb = {k: split(v, i) for k, v in batch.items()}
        l, extras, g = value_and_grad(model, mb)
        loss = loss + l
        if grads is None:
            grads = {k: torch.zeros_like(v, dtype=torch.float32)
                     for k, v in g.items()}
        for k, v in g.items():
            grads[k].add_(v)
    return (loss / grad_accum, extras,
            {k: v / grad_accum for k, v in grads.items()})


def make_train_step(model: Model, optimizer: Optimizer,
                    grad_accum: int = 1) -> Callable:
    """The step function for ``model``, whose parameters it sets to
    require grad."""
    model.requires_grad_(True)

    def train_step(params, opt_state, batch, step):
        adopt(model, params)
        loss, extras, grads = loss_and_grads(model, batch, grad_accum)
        params, opt_state, opt_metrics = optimizer.update(
            unflatten(grads), opt_state, model.param_tree(), step)
        return params, opt_state, {"loss": loss, **extras, **opt_metrics}

    return train_step
