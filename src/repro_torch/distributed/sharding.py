"""Sharding rules: parameter, batch and cache specs for the production mesh,
and their placements on a ``torch.distributed`` ``DeviceMesh``.

The counterpart of ``repro.distributed.sharding``, rule for rule. Mesh axes
(``launch/mesh.py``): ("data", "model") single-pod, ("pod", "data",
"model") multi-pod. "data" carries DP+FSDP (ZeRO-3-style parameter
sharding), "model" carries TP/EP; "pod" joins "data" for the gradient
reduction. A spec is a :class:`PSpec`, one entry per tensor dimension: a
mesh axis, a tuple of axes (major to minor), or None; it compares equal to
the reference's ``tuple(PartitionSpec)``. Rules are path-based over the
parameter tree:

  embed/lm_head table [V,d]        -> (model, data)        vocab TP + FSDP
  attn  wq [R,d,H,hd]              -> (_, data, model, _)  heads TP (pad if needed)
        wk/wv [R,d,Hkv,hd]         -> (_, data, model|None, _)  replicate if Hkv∤TP
        wo [R,H,hd,d]              -> (_, model, _, data)
  mlp   up/gate [R,d,f]            -> (_, data, model); down transposed
  moe   up/gate/down [R,E,d,f]     -> (_, model, data, _)  expert parallelism
  ssm   in_zx [R,d,2di]            -> (_, data, model)     head-aligned TP
        in_bcdt / conv_bc          -> replicated (n_groups=1 B/C/dt)
        conv_x/norm/out_proj       -> di over model
  norms                            -> replicated

pure_dp archs (smollm): every param replicated, batch over (data, model).
A dimension is sharded only where it divides evenly (``_maybe``), so no
shard is uneven. The functions read only the mesh's axis names and sizes:
``mesh`` is a ``DeviceMesh``, or any object with its ``mesh_dim_names`` and
``shape``. :func:`placements` turns a spec into a ``DTensor``'s placements;
:func:`shard_tree` and :func:`gather_tree` move a tree of tensors (nested
dicts and the cache's named tuples) onto the mesh and back.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.base import ModelConfig, ShapeSpec

Params = Any


class PSpec(tuple):
    """A partition spec: one entry per tensor dimension (a mesh axis, a
    tuple of axes, or None). A one-axis tuple is stored as the axis, as
    JAX's ``PartitionSpec`` stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e
                                     for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PSpec{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def dp_axes(mesh, pure_dp: bool = False):
    """The mesh axes carrying the batch dimension."""
    multi_pod = "pod" in mesh.mesh_dim_names
    if pure_dp:
        # replicate params; spread batch over everything that divides it
        return ("data", "model")
    return ("pod", "data") if multi_pod else ("data",)


def pad_heads_for(cfg: ModelConfig, mesh) -> int:
    """Heads added so n_heads divides the model axis (llama4: 40->48)."""
    if cfg.pure_dp or cfg.attn is None:
        return 0
    tp = axis_sizes(mesh)["model"]
    return (-cfg.attn.n_heads) % tp


def _maybe(axis: str, dim: int, size: int):
    return axis if dim % size == 0 else None


def map_tree(fn: Callable, tree, *rest, is_leaf=lambda x: False):
    """``fn`` over the leaves of nested dicts and named tuples (the cache's
    ``KVCache`` / ``SSMState``), ``rest`` alike in structure."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v, *(r[i] for r in rest),
                                     is_leaf=is_leaf)
                            for i, v in enumerate(tree)))
    return fn(tree, *rest)


def _with_paths(tree, prefix=()):
    """A tree of ``(path names, leaf)`` pairs in ``tree``'s structure."""
    return {k: (_with_paths(v, prefix + (k,)) if isinstance(v, dict)
                else (prefix + (k,), v)) for k, v in tree.items()}


def param_pspecs(cfg: ModelConfig, params_tree: Params, mesh) -> Params:
    """A :class:`PSpec` tree matching ``params_tree`` (a nested dict of
    tensors, meta tensors included)."""
    sizes = axis_sizes(mesh)
    tp = sizes["model"]
    fsdp = sizes["data"]

    def rule(named) -> PSpec:
        names, leaf = named
        name = names[-1]
        shape = tuple(leaf.shape)
        if cfg.pure_dp:
            return PSpec()
        stacked = names[0] in ("dec", "enc")          # leading [R, ...] axis
        lead = (None,) if stacked else ()

        def spec(*rest):
            if len(lead) + len(rest) != len(shape):
                raise ValueError(f"{names}: spec {rest} for shape {shape}")
            return PSpec(*lead, *rest)

        if name == "table":                            # embed / lm_head [V, d]
            return PSpec(_maybe("model", shape[0], tp),
                         _maybe("data", shape[1], fsdp))
        if name == "scale":                            # norms: replicated
            return PSpec(*((None,) * len(shape)))
        if name == "wq":                               # [R, d, H(+pad), hd]
            return spec(_maybe("data", shape[-3], fsdp),
                        _maybe("model", shape[-2], tp), None)
        if name in ("wk", "wv"):                       # [R, d, Hkv, hd]
            return spec(_maybe("data", shape[-3], fsdp),
                        _maybe("model", shape[-2], tp), None)
        if name == "wo":                               # [R, H, hd, d]
            return spec(_maybe("model", shape[-3], tp), None,
                        _maybe("data", shape[-1], fsdp))
        if name == "router":                           # [R, d, E]
            return spec(_maybe("data", shape[-2], fsdp), None)
        if name in ("up", "gate", "down") and len(shape) == len(lead) + 3:
            # MoE expert stacks [R, E, d, f] / [R, E, f, d]
            if name == "down":
                return spec(_maybe("model", shape[-3], tp), None,
                            _maybe("data", shape[-1], fsdp))
            return spec(_maybe("model", shape[-3], tp),
                        _maybe("data", shape[-2], fsdp), None)
        if name in ("up", "gate", "shared_up", "shared_gate"):  # [R, d, f]
            return spec(_maybe("data", shape[-2], fsdp),
                        _maybe("model", shape[-1], tp))
        if name in ("down", "shared_down"):            # [R, f, d]
            return spec(_maybe("model", shape[-2], tp),
                        _maybe("data", shape[-1], fsdp))
        if name == "in_zx":                            # [R, d, 2di]
            return spec(_maybe("data", shape[-2], fsdp),
                        _maybe("model", shape[-1], tp))
        if name == "in_bcdt":                          # replicated output
            return spec(_maybe("data", shape[-2], fsdp), None)
        if name == "conv_x_w":                         # [R, K, di]
            return spec(None, _maybe("model", shape[-1], tp))
        if name in ("conv_x_b", "norm_scale"):         # [R, di]
            return spec(_maybe("model", shape[-1], tp))
        if name == "conv_bc_w":
            return spec(None, None)
        if name == "conv_bc_b":
            return spec(None)
        if name in ("A_log", "D", "dt_bias"):          # [R, H]
            return spec(_maybe("model", shape[-1], tp))
        if name == "out_proj":                         # [R, di, d]
            return spec(_maybe("model", shape[-2], tp),
                        _maybe("data", shape[-1], fsdp))
        # fallback: replicate
        return PSpec(*((None,) * len(shape)))

    return map_tree(rule, _with_paths(params_tree),
                    is_leaf=lambda x: isinstance(x, tuple)
                    and not hasattr(x, "_fields"))


def batch_pspecs(cfg: ModelConfig, mesh, shape: ShapeSpec,
                 smart: bool = False) -> dict[str, PSpec]:
    """Specs for the input batch dict (keys from ``data.synth``).

    ``smart``: when the preferred batch axes don't divide the global batch,
    fall back through smaller axis subsets instead of replicating."""
    from repro_torch.data.synth import batch_shapes

    sizes = axis_sizes(mesh)
    b = shape.global_batch
    dp = dp_axes(mesh, cfg.pure_dp)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    bspec = dp if b % dp_size == 0 else (None,)
    if smart and bspec == (None,):
        for cand in (dp, dp[:-1], dp[:1], ("data",)):
            size = 1
            for a in cand:
                size *= sizes[a]
            if cand and b % size == 0:
                bspec = cand
                break

    out = {}
    for name, (shp, _) in batch_shapes(cfg, b, shape.seq_len).items():
        rest = (None,) * (len(shp) - 1)
        out[name] = PSpec(bspec if len(bspec) > 1 or bspec[0] else None,
                          *rest)
    return out


def cache_pspecs(cfg: ModelConfig, mesh, batch: int,
                 smart: bool = False) -> Any:
    """Specs for the decode cache (mirrors ``Model.init_cache``).

    KV: batch -> data when divisible, sequence -> model. Batch-1
    long-context decode shards the sequence over (data, model). SSM state:
    heads -> model.
    """
    from repro_torch.models.attention import KVCache
    from repro_torch.models.ssm import SSMState

    sizes = axis_sizes(mesh)
    tp = sizes["model"]
    dsz = sizes["data"]
    bat = "data" if (batch % dsz == 0 and batch > 1 and not cfg.pure_dp) else None
    seq_axes = "model" if bat == "data" else ("data", "model")
    if cfg.pure_dp:
        bat = ("data", "model") if batch % (tp * dsz) == 0 else None
        seq_axes = None
        if smart and bat is None and batch % dsz == 0:
            # pure-DP fallback: batch over data, KV sequence over model
            bat, seq_axes = "data", "model"

    cache = {}
    for i, spec in enumerate(cfg.pattern):
        if spec.mixer == "ssm":
            h = cfg.ssm.n_heads(cfg.d_model)
            cache[f"pos{i}"] = SSMState(
                conv_x=PSpec(None, bat, None,
                             _maybe("model", cfg.ssm.d_inner(cfg.d_model), tp)),
                conv_bc=PSpec(None, bat, None, None),
                ssd=PSpec(None, bat, _maybe("model", h, tp), None, None))
        else:
            kv = PSpec(None, bat, seq_axes, None, None)
            cache[f"pos{i}"] = KVCache(k=kv, v=kv)
    return cache


# ---------------------------------------------------------------- placements
def is_spec(x) -> bool:
    return isinstance(x, PSpec)


def placements(spec, mesh) -> list:
    """The placements of a tensor laid out by ``spec`` on ``mesh``: a mesh
    dimension named in the spec shards that tensor dimension (``Shard``),
    every other one replicates it. A tuple of axes shards one dimension
    over several mesh dimensions, major to minor, which must follow the
    mesh's own order (as the reference's tuples do)."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) \
            else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def shard(tensor: torch.Tensor, spec, mesh) -> DTensor:
    """``tensor`` (the whole array, alike on every rank) as a DTensor laid
    out by ``spec``: each rank keeps its own slice, nothing is sent."""
    return distribute_tensor(tensor, mesh, placements(spec, mesh),
                             src_data_rank=None)


def shard_tree(tree, specs, mesh):
    """Every leaf of ``tree`` sharded by the matching spec of ``specs``."""
    return map_tree(lambda s, t: shard(t, s, mesh), specs, tree,
                    is_leaf=is_spec)


def rows_over(x, mesh, axis: str) -> DTensor:
    """x as a DTensor split on its dimension 0 over ``axis`` (replicated
    over the other mesh dimensions): a DTensor so split as it is, or the
    whole x, of which each rank keeps its own rows."""
    dim = list(mesh.mesh_dim_names).index(axis)
    if not isinstance(x, DTensor):
        pl = [Replicate()] * mesh.ndim
        pl[dim] = Shard(0)
        x = DTensor.from_local(x.tensor_split(mesh.size(dim))[
            mesh.get_local_rank(axis)], mesh, pl, run_check=False)
    if x.placements[dim] != Shard(0):
        raise ValueError(f"x must be Shard(0) over {axis!r}, got "
                         f"{x.placements}")
    return x


def gather(t):
    """A DTensor's whole array on every rank (a collective); any other
    leaf as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def gather_tree(tree):
    return map_tree(gather, tree)


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of ``tree``'s tensors (a tuple of trees
    counts each)."""
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return sum(local_bytes(t) for t in tree)
    total = 0

    def add(t):
        nonlocal total
        if isinstance(t, torch.Tensor):
            local = t.to_local() if isinstance(t, DTensor) else t
            total += local.numel() * local.element_size()
    map_tree(add, tree)
    return total
