"""Paper multi-core results (Sec. 4: +15/16/20% weighted speedup) and the
composition with application-aware (TCM-style) scheduling (Sec. 9.3).

The port of the repo's ``benchmarks/multicore_bench.py``: the same mixes,
rows and summary. The simulation is :func:`repro_torch.paper_repro.run_multicore`
(the run-alone baselines once, one lane-kernel launch; then one
``simulate_multicore_batch`` over all four mixes per point, FR-FCFS x 5
policies and TCM x {BASELINE, MASA}: seven mix-kernel launches on the card).

    python -m repro_torch.benchmarks.multicore_bench [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.benchmarks.common import SEED, emit, timed
from repro_torch.core.dram import Policy, Scheduler
from repro_torch.paper_repro import MIXES, run_multicore

N = 1500


def run(device=None) -> dict:
    (results, us) = timed(run_multicore, N, SEED, device=device)
    us /= len(results)
    pols = (Policy.SALP1, Policy.SALP2, Policy.MASA, Policy.IDEAL)

    def ws(pol: Policy, sched: Scheduler) -> np.ndarray:
        return np.array([r.weighted_speedup
                         for r in results[(pol.name, sched.name)]])

    ws0 = ws(Policy.BASELINE, Scheduler.FRFCFS)
    gains = {pol: 100 * (ws(pol, Scheduler.FRFCFS) / ws0 - 1) for pol in pols}
    for i, mix in enumerate(MIXES):
        row = ";".join(f"{pol.pretty}=+{gains[pol][i]:.1f}%" for pol in pols)
        emit(f"multicore.{'+'.join(mix)}", us / len(MIXES), row)

    out = {}
    paper = {Policy.SALP1: 15.0, Policy.SALP2: 16.0, Policy.MASA: 20.0}
    for pol in pols:
        m = float(gains[pol].mean())
        out[pol.pretty] = m
        ref = f"(paper={paper[pol]}%)" if pol in paper else ""
        emit(f"multicore.MEAN.{pol.pretty}", 0.0, f"+{m:.1f}%{ref}")
    out["masa_tcm"] = float((100 * (ws(Policy.MASA, Scheduler.TCM)
                                    / ws0 - 1)).mean())
    out["base_tcm"] = float((100 * (ws(Policy.BASELINE, Scheduler.TCM)
                                    / ws0 - 1)).mean())
    emit("multicore.MEAN.MASA+TCM", 0.0,
         f"+{out['masa_tcm']:.1f}%vs_base_tcm=+{out['base_tcm']:.1f}%(composes)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain version")
    run(ap.parse_args().device)
