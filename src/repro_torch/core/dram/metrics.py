"""IPC / latency / energy metrics from simulator results.

The port of ``repro.core.dram.metrics``: the same float64 formulas, over
SimResult fields that are int32 tensors (moved to the host with
``.cpu().numpy()``; ``np.asarray`` on a CUDA tensor fails) or numpy values.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.dram.engine import SimResult
from repro_torch.core.dram.timing import (CoreModel, EnergyModel, DEFAULT_CORE,
                                          DEFAULT_ENERGY)
from repro_torch.core.dram.trace import WorkloadProfile


def _f64(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def ipc_from_result(res: SimResult, profile: WorkloadProfile,
                    core: CoreModel = DEFAULT_CORE) -> np.ndarray:
    """Instructions per CPU cycle (the paper's Fig. 4 metric):
    ``n_requests * 1000 / MPKI`` instructions over the total DRAM cycles in
    CPU cycles."""
    instr = _f64(res.n_requests) * (1000.0 / profile.mpki)
    cpu_cycles = _f64(res.total_cycles) * core.cpu_per_dram
    return instr / np.maximum(cpu_cycles, 1.0)


def energy_from_result(res: SimResult,
                       energy: EnergyModel = DEFAULT_ENERGY) -> dict[str, np.ndarray]:
    """DRAM energy split into dynamic (per-command) and static parts (nJ)."""
    dynamic = (_f64(res.n_act) * energy.e_act + _f64(res.n_pre) * energy.e_pre
               + _f64(res.n_rd) * energy.e_rd + _f64(res.n_wr) * energy.e_wr
               + _f64(res.n_sasel) * energy.e_sasel)
    static = energy.static_nj(_f64(res.total_cycles), _f64(res.sa_open_cycles))
    return {"dynamic_nj": dynamic, "static_nj": static,
            "total_nj": dynamic + static}


def row_hit_rate(res: SimResult) -> np.ndarray:
    return _f64(res.n_hit) / np.maximum(_f64(res.n_requests), 1.0)


def avg_read_latency(res: SimResult, core: CoreModel = DEFAULT_CORE) -> np.ndarray:
    """Mean read service latency in CPU cycles."""
    return (_f64(res.sum_latency) / np.maximum(_f64(res.n_reads), 1.0)
            * core.cpu_per_dram)


def sasel_per_act(res: SimResult) -> np.ndarray:
    return _f64(res.n_sasel) / np.maximum(_f64(res.n_act), 1.0)


def summarize(res: SimResult, profile: WorkloadProfile,
              core: CoreModel = DEFAULT_CORE,
              energy: EnergyModel = DEFAULT_ENERGY) -> dict[str, Any]:
    """One result's metrics as plain Python numbers."""
    e = energy_from_result(res, energy)
    return {
        "workload": profile.name,
        "mpki": profile.mpki,
        "wmpki": profile.wmpki,
        "ipc": float(ipc_from_result(res, profile, core)),
        "row_hit_rate": float(row_hit_rate(res)),
        "avg_read_latency_cpu": float(avg_read_latency(res, core)),
        "dynamic_nj": float(e["dynamic_nj"]),
        "total_nj": float(e["total_nj"]),
        "sasel_per_act": float(sasel_per_act(res)),
        "total_cycles": int(res.total_cycles),
        "acts": int(res.n_act),
    }
