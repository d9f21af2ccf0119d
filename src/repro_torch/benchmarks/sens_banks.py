"""Paper Sec. 9.2 / Sec. 1: the cost argument.

"A naive solution to bank conflicts is to increase the number of banks ...
at significantly high cost." This benchmark quantifies the trade the paper
leads with: MASA on 8 banks x 8 subarrays (<0.15% die overhead) vs a
subarray-oblivious baseline given 8/16/32/64 REAL banks (expensive).

One grid over the n_banks axis; traces are regenerated per bank count by the
sweep runner (the address space spreads across whatever banks exist). The
``where`` filter prunes MASA to the 8-bank point — the only one the paper's
comparison needs. Each (policy, bank count) bucket is one lane-kernel launch
on the card; the 8-bank cells are cache hits after ``sens_subarrays`` in the
same process. The port of the repo's ``benchmarks/sens_banks.py``: the same
grid, rows and summary.

    python -m repro_torch.benchmarks.sens_banks [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import (SEED, emit, mem_intensive,
                                           per_sim_cell_us, run_grid, timed)
from repro_torch.core.dram import Policy
from repro_torch.experiments import SweepGrid

BANK_COUNTS = (8, 16, 32, 64)
N = 4000
SUBSET = mem_intensive(9.0)


def make_grid() -> SweepGrid:
    return SweepGrid(
        name="sens_banks",
        workloads=SUBSET,
        policies=(Policy.BASELINE, Policy.MASA),
        n_requests=N,
        seed=SEED,
        config_axes={"n_banks": BANK_COUNTS},
        where=lambda pol, ov: pol == Policy.BASELINE or ov.get("n_banks") == 8,
    )


def run(device=None) -> dict:
    (sweep, us) = timed(run_grid, make_grid(), device=device)
    per_cell = per_sim_cell_us(sweep, us)

    base8 = sweep.metric("total_cycles", policy=Policy.BASELINE, n_banks=8)
    out = {}
    for nb in BANK_COUNTS:
        cyc = sweep.metric("total_cycles", policy=Policy.BASELINE, n_banks=nb)
        g = float((base8 / cyc - 1).mean() * 100)
        out[f"baseline_{nb}banks"] = g
        emit(f"sens_banks.baseline_{nb}banks", per_cell, f"+{g:.1f}%")

    masa = sweep.metric("total_cycles", policy=Policy.MASA, n_banks=8)
    g_masa = float((base8 / masa - 1).mean() * 100)
    out["masa_8banks_8subarrays"] = g_masa
    emit("sens_banks.MASA_8banksx8subarrays", 0.0,
         f"+{g_masa:.1f}%(free_vs_the_{_closest(out, g_masa)}-bank_cost)")
    return out


def _closest(out: dict, g: float) -> int:
    best, bn = None, 8
    for nb in BANK_COUNTS:
        d = abs(out[f"baseline_{nb}banks"] - g)
        if best is None or d < best:
            best, bn = d, nb
    return bn


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain version")
    run(ap.parse_args().device)
