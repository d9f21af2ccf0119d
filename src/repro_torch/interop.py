"""Carry the reference's state across to the port.

The simulator has no weights: its "parameters" are the configuration and
the trace arrays. These helpers turn the JAX package's plain-Python and
numpy forms of both into the port's, so tests feed the two packages
identical inputs. Nothing here imports the JAX package: a config arrives as
``dataclasses.asdict`` of the reference's ``SimConfig``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dram.engine import SimConfig
from repro_torch.core.dram.schedulers import Scheduler
from repro_torch.core.dram.timing import DramTiming

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
