"""Scheduler-combination comparison (paper Sec. 4 / 9.3): policy x scheduler
x mix, with refresh enabled, as ONE declarative mix grid.

The paper's headline multi-core numbers come from *combining* subarray-level
parallelism with memory-request scheduling: FR-FCFS as the base discipline
and application-aware (TCM-style) thread ranking on top. With the controller
layer unified, the whole cross product — request scheduler x SALP policy x
workload mix, under refresh — is a single
:class:`repro_torch.experiments.MixGrid` run through the grid API: each
(policy, scheduler) point is one mix-kernel launch over the four mixes, and
the run-alone baseline references are computed once a mix (one lane-kernel
launch each) and shared across every scheduler column.

Reported per policy: mean weighted speedup per scheduler, plus the
FR-FCFS-over-FCFS and TCM-over-FR-FCFS deltas (the composition the paper
argues for). FR-FCFS+SALP-aware is only meaningful under MASA (it prefers
already-activated subarrays) and is pruned elsewhere.

The port of the repo's ``benchmarks/sched_bench.py``: the same grid, rows and
summary.

    python -m repro_torch.benchmarks.sched_bench [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import SEED, emit, run_mix_grid, timed
from repro_torch.core.dram import ALL_SCHEDULERS, Policy, Scheduler, workload
from repro_torch.experiments import MixGrid

N = 1000
#: Same four 4-core intensity-spanning mixes as the repo's multicore_bench.
MIXES = (
    ("mcf", "lbm", "soplex", "sphinx3"),
    ("gups", "milc", "omnetpp", "xalancbmk"),
    ("stream_copy", "GemsFDTD", "leslie3d", "gcc"),
    ("libquantum", "zeusmp", "bwaves", "astar"),
)
POLICIES = (Policy.BASELINE, Policy.SALP2, Policy.MASA)
SCHEDULERS = ALL_SCHEDULERS


def make_grid(n_requests: int = N, mixes=MIXES) -> MixGrid:
    return MixGrid(
        name="sched",
        mixes=[tuple(workload(n) for n in m) for m in mixes],
        policies=POLICIES,
        n_requests=n_requests,
        seed=SEED,
        configs=[{"scheduler": s, "refresh": True} for s in SCHEDULERS],
        # preferring already-activated subarrays needs MASA's many open rows
        where=lambda pol, ov: not (ov.get("scheduler") == Scheduler.FRFCFS_SALP
                                   and pol != Policy.MASA),
    )


def run(device=None) -> dict:
    (sweep, us) = timed(run_mix_grid, make_grid(), device=device)
    per_cell = us / max(sweep.stats["n_cells"], 1)

    out: dict[str, float] = {}
    ws = {}
    for pol in POLICIES:
        for sched in SCHEDULERS:
            if sched == Scheduler.FRFCFS_SALP and pol != Policy.MASA:
                continue
            ws[pol, sched] = sweep.weighted_speedups(pol, scheduler=sched)
        row = ";".join(
            f"{s.pretty}={ws[pol, s].mean():.3f}" for s in SCHEDULERS
            if (pol, s) in ws)
        emit(f"sched.{pol.pretty}.ws", per_cell, row)
        out[f"ws_{pol.name}_FRFCFS"] = float(ws[pol, Scheduler.FRFCFS].mean())

    # the combinations the paper argues for, on MASA
    frfcfs = ws[Policy.MASA, Scheduler.FRFCFS].mean()
    fcfs = ws[Policy.MASA, Scheduler.FCFS].mean()
    tcm = ws[Policy.MASA, Scheduler.TCM].mean()
    salp_aware = ws[Policy.MASA, Scheduler.FRFCFS_SALP].mean()
    out["masa_frfcfs_vs_fcfs_pct"] = float(100 * (frfcfs / fcfs - 1))
    out["masa_tcm_vs_frfcfs_pct"] = float(100 * (tcm / frfcfs - 1))
    out["masa_salp_aware_vs_frfcfs_pct"] = float(100 * (salp_aware / frfcfs - 1))
    emit("sched.MASA.combos", 0.0,
         f"frfcfs_vs_fcfs={out['masa_frfcfs_vs_fcfs_pct']:+.1f}%;"
         f"tcm_vs_frfcfs={out['masa_tcm_vs_frfcfs_pct']:+.1f}%;"
         f"salp_aware_vs_frfcfs={out['masa_salp_aware_vs_frfcfs_pct']:+.1f}%")

    # cross-policy at the paper's scheduler (FR-FCFS), refresh on
    base = ws[Policy.BASELINE, Scheduler.FRFCFS]
    for pol in (Policy.SALP2, Policy.MASA):
        g = float((100 * (ws[pol, Scheduler.FRFCFS] / base - 1)).mean())
        out[f"{pol.name.lower()}_gain_frfcfs_pct"] = g
        emit(f"sched.{pol.pretty}.gain_at_frfcfs", 0.0, f"{g:+.1f}%")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain version")
    run(ap.parse_args().device)
