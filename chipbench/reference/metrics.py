"""The paper's derived results, frozen: IPC, per-workload IPC gain over the
baseline, and a mix's weighted speedup. float64, in the order of operations
the simulator's own formulas use, so equal counters give equal floats."""
from __future__ import annotations

import numpy as np


def ipc(counters: dict, mpki: float, cpu_per_dram: float) -> float:
    instr = np.float64(counters["n_requests"]) * (1000.0 / mpki)
    cycles = np.float64(counters["total_cycles"]) * cpu_per_dram
    return float(instr / np.maximum(cycles, 1.0))


def ipc_gain_pct(ipc_policy: float, ipc_baseline: float) -> float:
    return float((np.float64(ipc_policy) / np.float64(ipc_baseline) - 1.0)
                 * 100.0)


def weighted_speedup(alone_cycles, core_cycles) -> float:
    """Sum over cores of IPC shared / IPC alone on the baseline system."""
    alone = np.asarray(alone_cycles, np.float64)
    core = np.asarray(core_cycles, np.float64)
    return float(np.sum(alone / np.maximum(core, 1)))
