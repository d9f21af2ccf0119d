"""Paper Figure 5: DRAM dynamic energy under MASA, normalized to baseline,
plus the row-buffer hit-rate improvement that drives it (paper: -18.6% dynamic
energy, +12.8% row-hit rate).

The port of the repo's ``benchmarks/fig5_energy.py``: the same rows and
summary. The suite's 32 traces (8000 requests, seed 7; memoized, so a run
after Fig. 4 regenerates nothing) go through ``simulate_batch`` under
BASELINE and MASA: two lane-kernel launches on the card.

    python -m repro_torch.benchmarks.fig5_energy [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import emit, suite_traces, timed
from repro_torch.core.dram import (PAPER_WORKLOADS, Policy, energy_from_result,
                                   simulate_batch)
from repro_torch.core.dram.metrics import _f64


def run(device=None) -> dict:
    traces = suite_traces()
    (res_b, us_b) = timed(simulate_batch, traces, Policy.BASELINE,
                          device=device)
    (res_m, us_m) = timed(simulate_batch, traces, Policy.MASA, device=device)

    eb = energy_from_result(res_b)
    em = energy_from_result(res_m)
    dyn_red = 1.0 - em["dynamic_nj"] / eb["dynamic_nj"]
    tot_red = 1.0 - em["total_nj"] / eb["total_nj"]

    hit_b = _f64(res_b.n_hit) / _f64(res_b.n_requests)
    hit_m = _f64(res_m.n_hit) / _f64(res_m.n_requests)

    for i, p in enumerate(PAPER_WORKLOADS):
        emit(f"fig5.{p.name}", us_m / len(traces),
             f"dyn_red={100*dyn_red[i]:.1f}%;hit:{hit_b[i]:.2f}->{hit_m[i]:.2f}")

    out = {
        "mean_dynamic_reduction_pct": float(100 * dyn_red.mean()),
        "mean_total_reduction_pct": float(100 * tot_red.mean()),
        "mean_hit_delta": float((hit_m - hit_b).mean()),
    }
    emit("fig5.MEAN.dynamic_energy", us_m, f"{out['mean_dynamic_reduction_pct']:.1f}%(paper=18.6%)")
    emit("fig5.MEAN.rowhit_delta", us_m, f"+{100*out['mean_hit_delta']:.1f}pp(paper=+12.8pp)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain version")
    run(ap.parse_args().device)
