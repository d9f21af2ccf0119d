"""Checkpoint store in the reference's format.

The counterpart of ``repro.checkpoint.store``; a checkpoint written by
either package loads in the other. Layout (one directory per step):

  step_000123/
    manifest.json       # step, per-leaf global shape/dtype/pspec, extra
    shard_h000.npz      # this host's leaves, keyed by leaf path ("/" -> "__")
  latest step = the highest step_* directory that holds a manifest

Write protocol: write into ``step_000123.tmp/`` then ``rename``: a crash
mid-save leaves the previous checkpoint intact. Leaf paths join a nested
dict's keys with ``/`` in sorted order, as ``jax.tree_util`` names them.
Each leaf's ``"pspec"`` is its spec in ``pspecs`` as the reference
writes it (a list, a tuple of axes as a list; null without ``pspecs``).
Restore is elastic: the manifest holds whole shapes and specs, not a
layout, so a checkpoint written on one mesh loads onto another (a
``DTensor`` template leaf gets the array in its own layout). A ``DTensor``
leaf is gathered before the write (every rank takes part); with a process
group up, only rank 0 writes (ranks would write the same file). numpy has
no bfloat16 here: a bfloat16 leaf is stored as its bits (``uint16``) and
the manifest keeps ``"bfloat16"``, which ``load_checkpoint`` reads back.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.tree import leaves_with_paths


def spec_entries(spec) -> list:
    """A spec as the reference's manifest lists it."""
    return [None if a is None else list(a) if isinstance(a, tuple) else a
            for a in tuple(spec)]


def writes() -> bool:
    """Whether this process writes checkpoints: rank 0, or any process
    without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host array and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def save_checkpoint(directory: str | os.PathLike, step: int, tree: dict,
                    *, pspecs: dict | None = None, host_index: int = 0,
                    extra_meta: dict | None = None) -> pathlib.Path:
    """Save ``tree`` (tensors, DTensors or arrays, any device) atomically,
    with ``pspecs`` (a tree of specs over ``tree``'s paths) in the
    manifest."""
    directory = pathlib.Path(directory)
    final = directory / f"step_{step:06d}"
    tmp = directory / f"step_{step:06d}.tmp"
    leaves = [(k, v.full_tensor() if isinstance(v, DTensor) else v)
              for k, v in leaves_with_paths(tree)]
    if not writes():
        return final
    tmp.mkdir(parents=True, exist_ok=True)

    spec_map = {k: spec_entries(s) for k, s in leaves_with_paths(pspecs)} \
        if pspecs is not None else {}
    manifest = {"step": step, "leaves": {}, "extra": extra_meta or {}}
    shards = {}
    for key, leaf in leaves:
        arr, dtype = _to_numpy(leaf)
        manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype,
                                   "pspec": spec_map.get(key)}
        shards[key.replace("/", "__")] = arr

    np.savez(tmp / f"shard_h{host_index:03d}.npz", **shards)
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                     # atomic commit
    return final


def latest_step(directory: str | os.PathLike) -> int | None:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if not p.name.endswith(".tmp") and (p / "manifest.json").exists()]
    return max(steps) if steps else None


def load_checkpoint(directory: str | os.PathLike, step: int | None = None,
                    *, template: Any = None) -> tuple[int, Any, dict]:
    """Load a checkpoint (the latest without ``step``). Returns (step,
    tree, extra_meta).

    With ``template`` (a nested dict of tensors), each leaf is checked
    against the template leaf's shape, cast to its dtype, put on its
    device (a DTensor leaf's mesh and placements) and returned in the
    template's structure. Without it, returns {leaf path: CPU tensor}.
    """
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = directory / f"step_{step:06d}"
    manifest = json.loads((d / "manifest.json").read_text())

    data: dict[str, torch.Tensor] = {}
    for shard_file in sorted(d.glob("shard_h*.npz")):
        with np.load(shard_file) as z:
            for k in z.files:
                key = k.replace("__", "/")
                data[key] = _to_tensor(z[k], manifest["leaves"][key]["dtype"])

    if template is None:
        return step, data, manifest.get("extra", {})

    def fill(tree: dict, prefix: str = "") -> dict:
        out = {}
        for k, v in tree.items():
            key = prefix + str(k)
            if isinstance(v, dict):
                out[k] = fill(v, key + "/")
                continue
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(v.shape):
                raise ValueError(f"{key}: checkpoint {tuple(arr.shape)} vs "
                                 f"template {tuple(v.shape)}")
            if isinstance(v, DTensor):
                out[k] = distribute_tensor(
                    arr.to(device=v.device, dtype=v.dtype), v.device_mesh,
                    v.placements, src_data_rank=None)
            else:
                out[k] = arr.to(device=v.device, dtype=v.dtype)
        return out

    return step, fill(template), manifest.get("extra", {})
