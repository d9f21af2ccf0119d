"""Paper Figure 4: IPC improvement of SALP-1 / SALP-2 / MASA / Ideal over the
subarray-oblivious baseline, per workload and averaged, plus the paper's
mechanism-attribution statistics (MPKI of >5% gainers, SALP-2/WMPKI standouts,
MASA SA_SEL:ACT ratio).

The 32-workload x 5-policy cross product is one declarative grid: five
batched simulator calls (one per policy bucket), baseline cells shared with
any other benchmark in the process via the result cache. The port of the
repo's ``benchmarks/fig4_ipc.py``: the same grid, rows and summary; each
policy bucket is one lane-kernel launch on the card.

    python -m repro_torch.benchmarks.fig4_ipc [--device cuda|cpu]
"""
from __future__ import annotations

import numpy as np

import argparse

from repro_torch.benchmarks.common import (N_REQUESTS, SEED, emit,
                                           per_sim_cell_us, run_grid, timed)
from repro_torch.core.dram import PAPER_WORKLOADS, Policy
from repro_torch.experiments import SweepGrid

PAPER_MEANS = {Policy.SALP1: 6.6, Policy.SALP2: 13.4, Policy.MASA: 16.7, Policy.IDEAL: 19.6}
POLICIES = (Policy.BASELINE, Policy.SALP1, Policy.SALP2, Policy.MASA, Policy.IDEAL)


def make_grid() -> SweepGrid:
    return SweepGrid(name="fig4", workloads=PAPER_WORKLOADS, policies=POLICIES,
                     n_requests=N_REQUESTS, seed=SEED)


def run(device=None) -> dict:
    (sweep, us) = timed(run_grid, make_grid(), device=device)
    per_cell = per_sim_cell_us(sweep, us)

    gains = {pol: sweep.ipc_gain_pct(pol) for pol in PAPER_MEANS}

    for i, p in enumerate(PAPER_WORKLOADS):
        emit(f"fig4.{p.name}", per_cell,
             "s1={:.1f}%;s2={:.1f}%;masa={:.1f}%;ideal={:.1f}%".format(
                 gains[Policy.SALP1][i], gains[Policy.SALP2][i],
                 gains[Policy.MASA][i], gains[Policy.IDEAL][i]))

    summary = {}
    for pol, paper in PAPER_MEANS.items():
        m = float(gains[pol].mean())
        summary[pol.pretty] = m
        emit(f"fig4.MEAN.{pol.pretty}", per_cell, f"{m:.2f}%(paper={paper}%)")

    # attribution stats from the paper's Section 4
    mpki = np.array([p.mpki for p in PAPER_WORKLOADS])
    g1 = gains[Policy.SALP1]
    emit("fig4.stat.salp1_gainers_mpki", 0.0,
         f"{mpki[g1 > 5].mean():.1f}vs{mpki[g1 <= 5].mean():.2f}(paper=18.4vs1.14)")
    g2 = gains[Policy.SALP2]
    top3 = np.argsort(g2)[-3:]
    wmpki3 = np.array([PAPER_WORKLOADS[i].wmpki for i in top3])
    emit("fig4.stat.salp2_top3_wmpki", 0.0,
         f"min={wmpki3.min():.1f}(paper:>15WMPKI)")
    sasel = sweep.metric("n_sasel", policy=Policy.MASA)
    acts = sweep.metric("n_act", policy=Policy.MASA)
    gm = gains[Policy.MASA]
    hi = gm > 30
    ratio_hi = (sasel[hi] / acts[hi]).mean() if hi.any() else 0.0
    ratio_lo = (sasel[~hi] / acts[~hi]).mean()
    emit("fig4.stat.masa_sasel_per_act", 0.0,
         f"hi={ratio_hi:.2f};lo={ratio_lo:.2f}(paper:0.5vs0.06)")
    return summary


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain version")
    run(ap.parse_args().device)
