"""The paper's headline result (Fig. 4) on the port, end to end.

    python -m repro_torch.paper_repro [--n 8000] [--seed 7] [--device cuda]

The counterpart of ``examples/dram_paper_repro.py``: the 32 paper workloads
are generated exactly as the reference's sweep runner generates them (one
seed for every workload, 8 banks x 8 subarrays, the "golden" mapping), each
policy runs as ONE batched ``simulate_batch`` call (one lane-kernel launch
on the card), and the mean IPC gains, MASA's row-hit and dynamic-energy
deltas and the attribution statistics print beside the paper's numbers.
There is no sweep layer yet: cells are not cached.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.core.dram import (PAPER_WORKLOADS, Policy, SimConfig,
                                   SimResult, generate_trace, simulate_batch)
from repro_torch.core.dram.metrics import energy_from_result, ipc_from_result

POLICIES = (Policy.BASELINE, Policy.SALP1, Policy.SALP2, Policy.MASA,
            Policy.IDEAL)

#: The paper's mean IPC gains over the baseline, percent.
PAPER_GAINS = {Policy.SALP1: 6.6, Policy.SALP2: 13.4, Policy.MASA: 16.7,
               Policy.IDEAL: 19.6}

COUNTERS = tuple(f.name for f in dataclasses.fields(SimResult))


def fig4_traces(n: int, seed: int, config: SimConfig = SimConfig()):
    """The 32 workload traces, as the reference's ``trace_for`` makes them."""
    return [generate_trace(w, n, n_banks=config.n_banks,
                           n_subarrays=config.n_subarrays, seed=seed,
                           mapping=config.mapping)
            for w in PAPER_WORKLOADS]


def run_fig4(n: int, seed: int, device=None) -> dict[Policy, SimResult]:
    """One ``simulate_batch`` call per policy over the 32 traces."""
    traces = fig4_traces(n, seed)
    return {pol: simulate_batch(traces, pol, SimConfig(), device=device)
            for pol in POLICIES}


def cell_counters(results: dict[Policy, SimResult]) -> dict[tuple, dict]:
    """``{(workload name, policy name): {counter: int}}`` for all cells."""
    host = {pol: {f: getattr(r, f).cpu().numpy() for f in COUNTERS}
            for pol, r in results.items()}
    return {(w.name, pol.name): {f: int(host[pol][f][b]) for f in COUNTERS}
            for pol in results for b, w in enumerate(PAPER_WORKLOADS)}


def _metric(cells: dict, pol: Policy, fn) -> np.ndarray:
    """A per-workload float64 metric, from each cell's counters alone (as
    the reference's sweep derives it)."""
    out = []
    for w in PAPER_WORKLOADS:
        res = SimResult(**{f: np.asarray(v)
                           for f, v in cells[(w.name, pol.name)].items()})
        out.append(float(fn(res, w)))
    return np.asarray(out, np.float64)


def summary(results: dict[Policy, SimResult], n: int) -> dict:
    """The numbers the reference example prints, as a dict."""
    cells = cell_counters(results)
    mpki = np.array([p.mpki for p in PAPER_WORKLOADS])
    ipc = {pol: _metric(cells, pol, ipc_from_result) for pol in POLICIES}
    base = ipc[Policy.BASELINE]
    gains = {pol.name: float(100 * (ipc[pol] / base - 1).mean())
             for pol in PAPER_GAINS}

    def counter(name, pol):
        return _metric(cells, pol, lambda r, w: getattr(r, name))

    def dyn(r, w):
        return energy_from_result(r)["dynamic_nj"]

    hit_b = counter("n_hit", Policy.BASELINE) / n
    hit_m = counter("n_hit", Policy.MASA) / n
    eb, em = _metric(cells, Policy.BASELINE, dyn), _metric(cells, Policy.MASA, dyn)
    g1 = 100 * (ipc[Policy.SALP1] / base - 1)
    gm = 100 * (ipc[Policy.MASA] / base - 1)
    hi = gm > 30
    sasel, acts = counter("n_sasel", Policy.MASA), counter("n_act", Policy.MASA)
    return dict(
        gains_pct=gains,
        row_hit_baseline=float(hit_b.mean()), row_hit_masa=float(hit_m.mean()),
        row_hit_delta_pp=float(100 * (hit_m - hit_b).mean()),
        dynamic_energy_reduction_pct=float(100 * (1 - em / eb).mean()),
        salp1_gainers_mpki=float(mpki[g1 > 5].mean()),
        salp1_others_mpki=float(mpki[g1 <= 5].mean()),
        masa_sasel_per_act_high=float(np.mean(sasel[hi] / acts[hi])),
        masa_sasel_per_act_rest=float(np.mean(sasel[~hi] / acts[~hi])),
    )


def report(s: dict) -> str:
    """``summary`` as the reference example prints it."""
    lines = [f"{'mechanism':12s} {'ours':>8s} {'paper':>8s}"]
    for pol, ref in PAPER_GAINS.items():
        lines.append(f"{pol.pretty:12s} {s['gains_pct'][pol.name]:7.2f}% "
                     f"{ref:7.1f}%")
    lines += [
        "",
        f"row-hit rate: {s['row_hit_baseline']:.3f} -> {s['row_hit_masa']:.3f} "
        f"(+{s['row_hit_delta_pp']:.1f}pp; paper +12.8pp)",
        f"dynamic DRAM energy: -{s['dynamic_energy_reduction_pct']:.1f}% "
        f"(paper -18.6%)",
        "",
        f"SALP-1 >5% gainers mean MPKI: {s['salp1_gainers_mpki']:.1f} vs "
        f"others {s['salp1_others_mpki']:.2f} (paper 18.4 vs 1.14)",
        f"MASA SA_SEL per ACT: high-benefit apps "
        f"{s['masa_sasel_per_act_high']:.2f} vs rest "
        f"{s['masa_sasel_per_act_rest']:.2f} (paper ~0.5 vs ~0.06)",
    ]
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain version")
    args = ap.parse_args(argv)
    results = run_fig4(args.n, args.seed, device=args.device)
    print(f"# {len(POLICIES) * len(PAPER_WORKLOADS)} cells in "
          f"{len(POLICIES)} batched calls\n")
    print(report(summary(results, args.n)))


if __name__ == "__main__":
    main()
