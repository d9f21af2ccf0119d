"""The sharded train, prefill and decode steps: the port's counterpart of
``jax.jit`` on sharded inputs.

The reference writes layouts only (``sharding.py``) and lets XLA's GSPMD
partition the unchanged step. PyTorch has no GSPMD, so these steps state
it (``partition.Partitioned``). Every parameter, optimizer-state, batch
and cache leaf lives on the mesh as a ``DTensor`` laid out by its spec,
as the reference's arrays are, and no rank ever holds the whole parameter
tree: a block's leaves are gathered over "data" at their use and freed
after it (FSDP, ZeRO-3), and where a spec splits a leaf over "model" the
rank computes only its slice (tensor, expert and vocabulary parallelism,
with the sequence-parallel carry between blocks). ``pure_dp``
architectures (smollm) keep every parameter replicated and split the
batch over ("data", "model"). A train step:

1. each rank takes its batch rows (the batch's ``batch_pspecs`` layout;
   with ``grad_accum > 1``, microbatch i is the batch's rows ``[i B / a,
   (i + 1) B / a)`` split over the same ranks, as the reference's reshape
   of the global batch takes them);
2. it runs ``Model.loss`` through the partitioned layout: the whole
   batch's cross-entropy and MoE capacity, drop order and aux loss, on
   every rank alike;
3. its backward, seeded with ``loss / N`` (N ranks), reduce-scatters
   each split leaf's gradient into its shard and sums a replicated leaf's
   over the dimensions that replicate it (``Partitioned.grads``);
4. ``Optimizer.update`` runs on the shards, and the new state is laid out
   by ``Optimizer.state_pspecs``.

The prefill step runs the same partitioned forward without the carry and
returns the cache split over the batch's mesh dimensions (the cache's
batch is its dimension 1), its heads and sequence whole. The decode step
takes the cache as ``cache_pspecs`` lays it out and computes on each
rank's shards as they lie: the KV sequence split over "model" (or "data"
and "model"), each rank attending over its window of slots with the
partial softmax merged across the ranks (``attention.Window``), the SSM
state's heads over "model"; the mixers and FFNs split over "model" as in
prefill. It returns the new shards in the same placements: no cache leaf
is gathered or redistributed. Neither step launches a kernel: the
sharded steps take the reference's own operations.
Each step function carries ``meter`` (``partition.GatherMeter``): the
most gathered parameter bytes it held at once. Every rank of a mesh must
call a step together: each holds collectives.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.distributed.partition import (GatherMeter, MeshBatch,
                                               Partitioned)
from repro_torch.distributed.sharding import (is_spec, map_tree, placements,
                                              shard_tree)
from repro_torch.models.attention import KVCache
from repro_torch.models.builder import Model
from repro_torch.train.optimizer import Optimizer
from repro_torch.tree import unflatten


def _own(tree: dict) -> dict:
    """Each DTensor's local shard copied into memory of its own, so that
    it holds no view of the whole tensor it was cut from."""
    return map_tree(lambda t: DTensor.from_local(
        t.to_local().detach().clone(), t.device_mesh, t.placements,
        run_check=False, shape=t.shape, stride=t.stride()), tree)


def shard_params(params: dict, specs: dict, mesh) -> dict:
    """The parameter tree (whole tensors, alike on every rank) sharded by
    ``specs`` (``param_pspecs``), each shard in memory of its own: it
    never aliases the model's parameter it came from, nor keeps the whole
    tensor alive."""
    return _own(shard_tree(params, specs, mesh))


def shard_opt_state(optimizer: Optimizer, params: dict, specs: dict,
                    mesh) -> dict:
    """``optimizer.init`` of the whole ``params``, sharded by
    ``optimizer.state_pspecs(specs, params)``, each shard in memory of its
    own."""
    return _own(shard_tree(optimizer.init(params),
                           optimizer.state_pspecs(specs, params), mesh))


def _local(t: DTensor, pl: list) -> torch.Tensor:
    return t.redistribute(t.device_mesh, pl).to_local()


def _batch_dims(pl: list, dim: int = 0) -> list[int]:
    return [d for d, p in enumerate(pl) if p == Shard(dim)]


def _microbatches(batch: dict, mesh, dims: list[int], n: int) -> list[dict]:
    """The rank's rows of each of ``n`` microbatches: microbatch i is the
    global batch's rows ``[i B / n, (i + 1) B / n)``, split over the
    batch's ranks in order."""
    if n == 1:
        return [{k: v.to_local() for k, v in batch.items()}]
    group = MeshBatch(mesh, dims)
    whole = {k: v.full_tensor() for k, v in batch.items()}
    rows = next(iter(whole.values())).shape[0]
    if rows % (n * group.size):
        raise ValueError(f"batch {rows} does not split into {n} "
                         f"microbatches over {group.size} ranks")
    per = rows // n
    return [{k: v[i * per:(i + 1) * per].tensor_split(group.size)[
        group.index] for k, v in whole.items()} for i in range(n)]


def make_sharded_train_step(model: Model, optimizer: Optimizer, mesh,
                            param_specs: dict, grad_accum: int = 1
                            ) -> Callable:
    """The sharded step for ``model`` (its config and fields; its own
    parameters are not read, so it may live on ``meta``) on ``mesh``:
    ``(params, opt_state, batch, step) -> (params, opt_state, metrics)``
    with ``params`` / ``opt_state`` as ``shard_params`` /
    ``shard_opt_state`` make them and ``batch`` sharded by
    ``batch_pspecs``. ``params`` is updated in place; ``metrics`` are
    whole tensors, alike on every rank. ``train_step.grads(params,
    batch)`` is steps 1-3 alone: (loss, {"ce", "aux"}, {path: gradient
    DTensor}); the loss and ``ce`` / ``aux`` as ``train.step.
    loss_and_grads`` returns them."""
    meter = GatherMeter()
    n = mesh.size()

    def grads(params, batch):
        dims = _batch_dims(next(iter(batch.values())).placements)
        loss = total = None
        for mb in _microbatches(batch, mesh, dims, grad_accum):
            layout = Partitioned(model.cfg, params, mesh, dims, "train",
                                 meter)
            l, extras = model.loss(mb, layout=layout)
            g = layout.grads(l / n)
            loss = l.detach() if loss is None else loss + l.detach()
            total = g if total is None else {k: total[k] + v
                                             for k, v in g.items()}
        extras = {k: v.detach() for k, v in extras.items()}
        if grad_accum == 1:
            return loss, extras, total
        return (loss / grad_accum, extras,
                {k: v / grad_accum for k, v in total.items()})

    def train_step(params, opt_state, batch, step):
        loss, extras, g = grads(params, batch)
        params, opt_state, m = optimizer.update(unflatten(g), opt_state,
                                                params, step)
        state_specs = optimizer.state_pspecs(param_specs, params)
        opt_state = map_tree(
            lambda s, t: t.redistribute(mesh, placements(s, mesh)),
            state_specs, opt_state, is_leaf=is_spec)
        metrics = {"loss": loss, **extras,
                   "grad_norm": _whole(m["grad_norm"]), "lr": m["lr"]}
        return params, opt_state, metrics

    train_step.grads, train_step.meter = grads, meter
    return train_step


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_sharded_prefill_step(model: Model, mesh) -> Callable:
    """``(params, batch) -> (logits, cache)`` on the rank's batch rows:
    logits ``[B, 1, V]`` and the cache as DTensors split over the batch's
    mesh dimensions (the cache's batch is its dimension 1)."""
    meter = GatherMeter()

    def prefill(params, batch):
        batch_pl = next(iter(batch.values())).placements
        layout = Partitioned(model.cfg, params, mesh, _batch_dims(batch_pl),
                             "prefill", meter)
        logits, cache = model.prefill({k: v.to_local()
                                       for k, v in batch.items()},
                                      layout=layout)
        cache_pl = [Shard(1) if p == Shard(0) else Replicate()
                    for p in batch_pl]
        return (DTensor.from_local(logits, mesh, batch_pl, run_check=False),
                map_tree(lambda c: DTensor.from_local(c, mesh, cache_pl,
                                                      run_check=False),
                         cache))

    prefill.meter = meter
    return prefill


def _window(k: DTensor, mesh) -> tuple:
    """(the first global slot of this rank's share of a KV cache leaf
    ``[R, B, S, Hkv, hd]``, the :class:`MeshBatch` over the mesh
    dimensions that split its sequence, None if none does)."""
    _, offset = compute_local_shape_and_global_offset(k.shape, mesh,
                                                      k.placements)
    group = MeshBatch(mesh, _batch_dims(k.placements, 2))
    return offset[2], (group if group.size > 1 else None)


def _cur_rows(cur_len, mesh, dims: list[int]):
    """``cur_len`` for this rank's batch rows: an int or a ``[]`` tensor as
    it is, a whole ``[B]`` tensor (alike on every rank) cut to the rows."""
    if not isinstance(cur_len, torch.Tensor) or cur_len.ndim == 0:
        return cur_len
    group = MeshBatch(mesh, dims)
    return cur_len.tensor_split(group.size)[group.index]


def make_sharded_decode_step(model: Model, mesh) -> Callable:
    """``(params, tokens, cache, cur_len) -> (logits, cache)``: ``cache``
    laid out by ``cache_pspecs`` and returned so, ``tokens`` ``[B, 1]``
    in any layout (taken to the cache's batch rows), ``cur_len`` an int,
    a ``[]`` or a ``[B]`` tensor; logits ``[B, 1, V]`` split as the cache's
    batch."""
    meter = GatherMeter()

    def decode(params, tokens, cache, cur_len):
        dims = _batch_dims(next(iter(cache.values()))[0].placements, 1)
        rows = [Shard(0) if d in dims else Replicate()
                for d in range(mesh.ndim)]
        slots = {k: _window(c.k, mesh) for k, c in cache.items()
                 if isinstance(c, KVCache)}
        layout = Partitioned(model.cfg, params, mesh, dims, "decode", meter,
                             slots)
        logits, new = model.decode_step(
            _local(tokens, rows), map_tree(lambda c: c.to_local(), cache),
            _cur_rows(cur_len, mesh, dims), layout=layout)
        new = map_tree(lambda n, c: DTensor.from_local(
            n, mesh, c.placements, run_check=False, shape=c.shape,
            stride=c.stride()), new, cache)
        return DTensor.from_local(logits, mesh, rows, run_check=False), new

    decode.meter = meter
    return decode
