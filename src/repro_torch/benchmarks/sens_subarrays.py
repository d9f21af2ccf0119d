"""Paper Sec. 9.2 sensitivity: mechanism gains vs subarrays-per-bank (1..64).

The paper shows gains grow with the number of subarrays exposed (their main
results conservatively assume 8; real devices have ~64).

Expressed as one declarative grid — (BASELINE, SALP-1, MASA) x workloads x
n_subarrays — executed as one bucketed sweep: each (policy, geometry) bucket
is one lane-kernel launch on the card (21 of them). The result cache
guarantees the baseline is simulated exactly once per (workload, geometry)
cell, not once per mechanism policy compared against it. The port of the
repo's ``benchmarks/sens_subarrays.py``: the same grid, rows and summary.

    python -m repro_torch.benchmarks.sens_subarrays [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import (SEED, emit, mem_intensive,
                                           per_sim_cell_us, run_grid, timed)
from repro_torch.core.dram import Policy
from repro_torch.experiments import SweepGrid

SUBARRAY_COUNTS = (1, 2, 4, 8, 16, 32, 64)
N = 4000
SUBSET = mem_intensive(9.0)


def make_grid() -> SweepGrid:
    return SweepGrid(
        name="sens_subarrays",
        workloads=SUBSET,
        policies=(Policy.BASELINE, Policy.SALP1, Policy.MASA),
        n_requests=N,
        seed=SEED,
        config_axes={"n_subarrays": SUBARRAY_COUNTS},
    )


def run(device=None) -> dict:
    (sweep, us) = timed(run_grid, make_grid(), device=device)
    per_cell = per_sim_cell_us(sweep, us)

    out = {}
    for ns in SUBARRAY_COUNTS:
        g_s1 = float(sweep.speedup_pct(Policy.SALP1, n_subarrays=ns).mean())
        g_masa = float(sweep.speedup_pct(Policy.MASA, n_subarrays=ns).mean())
        out[ns] = {"salp1": g_s1, "masa": g_masa}
        emit(f"sens_subarrays.{ns}", per_cell,
             f"salp1=+{g_s1:.1f}%;masa=+{g_masa:.1f}%")

    masas = [out[ns]["masa"] for ns in SUBARRAY_COUNTS]
    monotone = all(b >= a - 0.5 for a, b in zip(masas, masas[1:]))
    emit("sens_subarrays.monotone", 0.0, f"{monotone}(paper:gains_grow_with_subarrays)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain version")
    run(ap.parse_args().device)
