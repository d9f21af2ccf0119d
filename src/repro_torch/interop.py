"""Carry the reference's state across to the port.

The simulator has no weights: its "parameters" are the configuration and
the trace arrays. These helpers turn the JAX package's plain-Python and
numpy forms of both into the port's, so tests feed the two packages
identical inputs. Nothing here imports the JAX package: a config arrives as
``dataclasses.asdict`` of the reference's ``SimConfig``.

The model stack has weights. :func:`params_from_reference` turns the JAX
package's parameter pytree (as numpy) into the port's ``state_dict``, and
:func:`numpy_reference_params` draws a tree in the reference's layout from
``numpy.random.default_rng(seed)``, so a machine without JAX (the card's)
builds the same weights as a test that hands them to both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dram.engine import SimConfig
from repro_torch.core.dram.schedulers import Scheduler
from repro_torch.core.dram.timing import DramTiming
from repro_torch.models.builder import check_supported, init_params

#: Fields of stack_traces output that become [B, N] / [B] int32 tensors
#: (``[M, C, N]`` / ``[M, C]`` for mixes).
STACKED_FIELDS = ("bank", "subarray", "row", "is_write", "gap", "dep",
                  "mlp_window")


def config_from_reference(fields: dict) -> SimConfig:
    """The port's ``SimConfig`` from ``dataclasses.asdict`` of a reference
    config. ``backend`` is dropped (the device takes its place); ``timing``
    arrives as a dict and ``scheduler`` as the reference's enum."""
    f = {k: v for k, v in fields.items() if k != "backend"}
    if isinstance(f.get("timing"), dict):
        f["timing"] = DramTiming(**f["timing"])
    if "scheduler" in f:
        f["scheduler"] = Scheduler(int(f["scheduler"]))
    return SimConfig(**f)


def stacked_from_numpy(d: dict, device) -> dict[str, torch.Tensor]:
    """``stack_traces`` output (numpy) as int32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(d[k]).astype(np.int32),
                               device=device)
            for k in STACKED_FIELDS}


def mixes_from_numpy(stacked_list: list[dict], ranks, device
                     ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """M mixes' ``stack_traces`` outputs (numpy, ``[C, N]`` fields and
    ``[C]`` windows) and their ``[M, C]`` TCM ranks as ``[M, C, N]`` /
    ``[M, C]`` int32 tensors on ``device``, the form
    :func:`repro_torch.core.dram.engine.mix_inputs` takes."""
    stacked = {k: torch.as_tensor(
        np.stack([np.asarray(d[k]) for d in stacked_list]).astype(np.int32),
        device=device) for k in STACKED_FIELDS}
    return stacked, torch.as_tensor(np.asarray(ranks, np.int32), device=device)


def flatten(tree: dict, prefix: str = "") -> dict:
    """``{"a": {"b": leaf}}`` -> ``{"a.b": leaf}``, in the tree's order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def numpy_reference_params(cfg: ModelConfig, seed: int) -> dict:
    """A parameter tree in the reference's layout, shapes and dtypes
    (float32 numpy arrays, ``[n_repeats, ...]`` under ``dec``), drawn from
    ``np.random.default_rng(seed)`` at the scales of the reference's
    initialisers. The same on every machine with the same numpy."""
    check_supported(cfg)
    tree = init_params(cfg, np.random.default_rng(seed), device="cpu")

    def to_numpy(t):
        return ({k: to_numpy(v) for k, v in t.items()} if isinstance(t, dict)
                else t.numpy())
    return to_numpy(tree)


def params_from_reference(cfg: ModelConfig, tree: dict
                          ) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` for ``cfg`` from the JAX package's
    parameter pytree as numpy (``jax.tree.map(np.asarray, params)``). Leaf
    names, shapes and dtypes must match the port's model exactly. The
    tensors share the arrays' memory; ``build_model`` copies them."""
    check_supported(cfg)
    want = flatten(init_params(cfg, torch.Generator(), device="meta"))
    got = flatten(tree)
    if set(got) != set(want):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))}")
    out = {}
    for k, ref in want.items():
        a = np.asarray(got[k])
        if a.shape != tuple(ref.shape) or a.dtype != np.float32:
            raise ValueError(f"{k}: got {a.dtype} {a.shape}, want float32 "
                             f"{tuple(ref.shape)}")
        # np.require copies only an array that is read-only or strided
        out[k] = torch.from_numpy(np.require(a, requirements=["C", "W"]))
    return out
