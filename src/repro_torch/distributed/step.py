"""The sharded train, prefill and decode steps: the port's counterpart of
``jax.jit`` on sharded inputs.

The reference writes layouts only (``sharding.py``) and lets XLA's GSPMD
decide the data movement of the unchanged step. PyTorch has no GSPMD, so
these steps state it. Every parameter, optimizer-state, batch and cache
leaf lives on the mesh as a ``DTensor`` laid out by its spec, as the
reference's arrays are, and the optimizer updates only its shards. The
parameters are not sharded during compute: each rank's ``model`` holds a
whole copy of every parameter for as long as the step lives, and the
steps gather the whole tree into it. A train step:

1. each rank takes its batch rows (the batch's ``batch_pspecs`` layout);
2. it gathers every parameter in full (an all-gather of each sharded
   leaf) and copies the tree into its model;
3. it runs the port's own ``Model.loss`` and ``torch.autograd.grad`` on
   its rows (``train.step.loss_and_grads``, with ``grad_accum``): whole
   gradients, as many bytes as the parameters;
4. each gradient becomes a ``Partial("avg")`` DTensor over the mesh
   dimensions that split the batch, replicated over the others;
5. it is redistributed to its leaf's layout (a reduce-scatter where the
   leaf is sharded, an all-reduce where it is not);
6. ``Optimizer.update`` runs on the shards, and the new state is laid out
   by ``Optimizer.state_pspecs``;
7. the loss, ``ce`` and ``aux`` are averaged over the batch's mesh
   dimensions.

So a device holds the whole parameters and, during the backward, the
whole gradients, beside its shards of the parameters and of the optimizer
state: the memory of ZeRO stage 1, not of ZeRO-3 / FSDP, which would
gather a block's parameters at its use and free them after. The
dry-run's ``memory.model_copy_bytes`` counts the whole copy. Compute is
replicated over "model" wherever the batch is not split over it:
tensor-parallel compute inside a layer is not ported (a deliberate
difference, as is the whole copy; ROADMAP). Averaging per-rank losses equals the
reference's global mean when every rank's rows hold as many valid labels,
as every batch of ``data.synth`` does; a MoE's load-balancing ``aux`` is
the ranks' mean, where the reference's is the whole batch's.

The decode step gathers the parameters and the cache rows of the rank's
batch rows (the sequence and heads in full), runs ``Model.decode_step``
and writes the updated rows back into the cache's own layout; the prefill
step runs ``Model.prefill`` on the rank's rows. Every rank of a mesh must
call a step together: each holds collectives.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import (gather_tree, is_spec,
                                              map_tree, placements,
                                              shard_tree)
from repro_torch.models.builder import Model
from repro_torch.train.optimizer import Optimizer
from repro_torch.train.step import adopt, loss_and_grads
from repro_torch.tree import leaves_with_paths, unflatten


def shard_params(params: dict, specs: dict, mesh) -> dict:
    """The parameter tree (whole tensors, alike on every rank) sharded by
    ``specs`` (``param_pspecs``), into memory of its own: a rank's shard
    never aliases the model's parameter it came from."""
    return shard_tree(map_tree(lambda t: t.detach().clone(), params), specs,
                      mesh)


def shard_opt_state(optimizer: Optimizer, params: dict, specs: dict,
                    mesh) -> dict:
    """``optimizer.init`` of the whole ``params``, sharded by
    ``optimizer.state_pspecs(specs, params)``."""
    return shard_tree(optimizer.init(params),
                      optimizer.state_pspecs(specs, params), mesh)


def _rows(t: DTensor, dim: int) -> list:
    """Placements that keep ``t``'s split of dimension ``dim`` (the batch)
    and replicate everything else."""
    return [p if p == Shard(dim) else Replicate() for p in t.placements]


def _local(t: DTensor, pl: list) -> torch.Tensor:
    return t.redistribute(t.device_mesh, pl).to_local()


def _mean_over(x: torch.Tensor, mesh, batch_pl: list) -> torch.Tensor:
    """This rank's ``x`` averaged over the mesh dimensions that split the
    batch (a whole tensor on every rank)."""
    pl = [Partial("avg") if p == Shard(0) else Replicate() for p in batch_pl]
    return DTensor.from_local(x, mesh, pl, run_check=False).full_tensor()


def make_sharded_train_step(model: Model, optimizer: Optimizer, mesh,
                            param_specs: dict, grad_accum: int = 1
                            ) -> Callable:
    """The sharded step for ``model`` (the rank's compute copy, whose
    parameters it sets to require grad) on ``mesh``: ``(params,
    opt_state, batch, step) -> (params, opt_state, metrics)`` with
    ``params`` / ``opt_state`` as ``shard_params`` / ``shard_opt_state``
    make them and ``batch`` sharded by ``batch_pspecs``. ``params`` is
    updated in place; ``metrics`` are whole tensors, alike on every
    rank."""
    model.requires_grad_(True)
    spec_of = dict(leaves_with_paths(param_specs))
    state_specs = optimizer.state_pspecs(param_specs, model.param_tree())

    def train_step(params, opt_state, batch, step):
        adopt(model, gather_tree(params))
        batch_pl = next(iter(batch.values())).placements
        local = {k: v.to_local() for k, v in batch.items()}
        loss, extras, grads = loss_and_grads(model, local, grad_accum)
        partial = [Partial("avg") if p == Shard(0) else Replicate()
                   for p in batch_pl]
        grads = {k: DTensor.from_local(g, mesh, partial, run_check=False)
                 .redistribute(mesh, placements(spec_of[k], mesh))
                 for k, g in grads.items()}
        params, opt_state, m = optimizer.update(unflatten(grads), opt_state,
                                                params, step)
        opt_state = map_tree(
            lambda s, t: t.redistribute(mesh, placements(s, mesh)),
            state_specs, opt_state, is_leaf=is_spec)
        metrics = {"loss": _mean_over(loss, mesh, batch_pl),
                   **{k: _mean_over(v, mesh, batch_pl)
                      for k, v in extras.items()},
                   "grad_norm": gather_tree(m["grad_norm"]), "lr": m["lr"]}
        return params, opt_state, metrics

    return train_step


def make_sharded_prefill_step(model: Model, mesh) -> Callable:
    """``(params, batch) -> (logits, cache)`` on the rank's batch rows:
    logits ``[B, 1, V]`` and the cache as DTensors split over the batch's
    mesh dimensions (the cache's batch is its dimension 1)."""

    def prefill(params, batch):
        adopt(model, gather_tree(params))
        batch_pl = next(iter(batch.values())).placements
        logits, cache = model.prefill({k: v.to_local()
                                       for k, v in batch.items()})
        cache_pl = [Shard(1) if p == Shard(0) else Replicate()
                    for p in batch_pl]
        return (DTensor.from_local(logits, mesh, batch_pl, run_check=False),
                map_tree(lambda c: DTensor.from_local(c, mesh, cache_pl,
                                                      run_check=False),
                         cache))

    return prefill


def make_sharded_decode_step(model: Model, mesh) -> Callable:
    """``(params, tokens, cache, cur_len) -> (logits, cache)``: ``cache``
    laid out by ``cache_pspecs`` and returned so, ``tokens`` ``[B, 1]``
    in any layout; logits ``[B, 1, V]`` split as the cache's batch."""

    def decode(params, tokens, cache, cur_len):
        adopt(model, gather_tree(params))
        rows = _rows(next(iter(cache.values()))[0], 1)
        tok_pl = [Shard(0) if p == Shard(1) else Replicate() for p in rows]
        local = map_tree(lambda c: _local(c, _rows(c, 1)), cache)
        logits, new = model.decode_step(_local(tokens, tok_pl), local,
                                        cur_len)
        new = map_tree(lambda n, c: DTensor.from_local(
            n, mesh, _rows(c, 1), run_check=False).redistribute(
                mesh, c.placements), new, cache)
        return DTensor.from_local(logits, mesh, tok_pl, run_check=False), new

    return decode
