"""The paper's headline results on the port, end to end.

    python -m repro_torch.paper_repro [--n 8000] [--seed 7] [--device cuda]
    python -m repro_torch.paper_repro --multicore [--seed 7] [--device cuda]

Fig. 4 (the default) is the counterpart of ``examples/dram_paper_repro.py``:
the 32 paper workloads are generated exactly as the reference's sweep runner
generates them (one seed for every workload, 8 banks x 8 subarrays, the
"golden" mapping), each policy runs as ONE batched ``simulate_batch`` call
(one lane-kernel launch on the card), and the mean IPC gains, MASA's row-hit
and dynamic-energy deltas and the attribution statistics print beside the
paper's numbers.

``--multicore`` is the counterpart of ``benchmarks/multicore_bench.py`` and
``benchmarks/sched_bench.py``: four 4-core mixes, each (policy, scheduler)
point ONE batched ``simulate_multicore_batch`` call (one mix-kernel launch on
the card) and the run-alone baselines one ``simulate_batch`` call (one
lane-kernel launch); the mean weighted-speedup gains print beside the
paper's. ``--n`` then sets both products' trace length (by default the
benches' 1500 and, for the scheduler study, 1000).

There is no sweep layer yet: cells are not cached.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.core.dram import (ALL_SCHEDULERS, PAPER_WORKLOADS,
                                   ROW_SPACE_STRIDE, Policy, Scheduler,
                                   SimConfig, SimResult, alone_baseline_cycles,
                                   generate_trace, simulate_batch,
                                   simulate_multicore_batch, workload)
from repro_torch.core.dram.metrics import energy_from_result, ipc_from_result

POLICIES = (Policy.BASELINE, Policy.SALP1, Policy.SALP2, Policy.MASA,
            Policy.IDEAL)

#: The paper's mean IPC gains over the baseline, percent.
PAPER_GAINS = {Policy.SALP1: 6.6, Policy.SALP2: 13.4, Policy.MASA: 16.7,
               Policy.IDEAL: 19.6}

COUNTERS = tuple(f.name for f in dataclasses.fields(SimResult))

FIG4_N = 8000


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


#: Four 4-core mixes spanning intensity classes: ``MIXES`` of
#: ``benchmarks/multicore_bench.py`` and ``benchmarks/sched_bench.py``.
MIXES = (
    ("mcf", "lbm", "soplex", "sphinx3"),
    ("gups", "milc", "omnetpp", "xalancbmk"),
    ("stream_copy", "GemsFDTD", "leslie3d", "gcc"),
    ("libquantum", "zeusmp", "bwaves", "astar"),
)
MULTICORE_N, SCHED_N = 1500, 1000

#: The paper's mean multi-core weighted-speedup gains over the baseline.
MULTICORE_PAPER_GAINS = {Policy.SALP1: 15.0, Policy.SALP2: 16.0,
                         Policy.MASA: 20.0}

#: The scheduler study's policies, and its refresh-on configuration.
SCHED_POLICIES = (Policy.BASELINE, Policy.SALP2, Policy.MASA)
SCHED_REFRESH = dict(refresh=True)


def mix_traces(names, n: int, seed: int) -> list:
    """One mix's traces, each core in its own row space (as the benches)."""
    return [generate_trace(workload(w), n, seed=seed,
                           row_space_offset=ROW_SPACE_STRIDE * i)
            for i, w in enumerate(names)]


def run_multicore(n: int = MULTICORE_N, seed: int = 7, device=None) -> dict:
    """``multicore_bench``'s product: ``{(policy, scheduler): [M results]}``.

    The run-alone baselines once (one lane-kernel launch), then one
    ``simulate_multicore_batch`` per policy under FR-FCFS and for BASELINE
    and MASA under TCM (seven mix-kernel launches).
    """
    mixes = [mix_traces(m, n, seed) for m in MIXES]
    alone = alone_baseline_cycles(mixes, device=device)
    points = ([(pol, Scheduler.FRFCFS) for pol in POLICIES]
              + [(Policy.BASELINE, Scheduler.TCM), (Policy.MASA, Scheduler.TCM)])
    return {(pol.name, sched.name): simulate_multicore_batch(
                mixes, pol, SimConfig(scheduler=sched), alone_cycles=alone,
                device=device)
            for pol, sched in points}


def sched_points() -> list[tuple[Policy, Scheduler]]:
    """``sched_bench``'s (policy, scheduler) points: FR-FCFS+SALP (which
    prefers already-activated subarrays) only under MASA."""
    return [(pol, sched) for sched in ALL_SCHEDULERS for pol in SCHED_POLICIES
            if not (sched == Scheduler.FRFCFS_SALP and pol != Policy.MASA)]


def run_sched(n: int = SCHED_N, seed: int = 7, device=None) -> dict:
    """``sched_bench``'s product with refresh on, directly through
    ``simulate_multicore_batch``: the run-alone baselines once (one
    lane-kernel launch), then one call per point (ten mix-kernel launches).
    """
    mixes = [mix_traces(m, n, seed) for m in MIXES]
    alone = alone_baseline_cycles(mixes, SimConfig(**SCHED_REFRESH),
                                  device=device)
    return {(pol.name, sched.name): simulate_multicore_batch(
                mixes, pol, SimConfig(scheduler=sched, **SCHED_REFRESH),
                alone_cycles=alone, device=device)
            for pol, sched in sched_points()}


def mix_cells(results: dict) -> dict[tuple, dict]:
    """``{(mix, policy, scheduler): {counters, core_cycles, alone_cycles}}``
    with plain ints and floats, the fixture's form."""
    out = {}
    for (pol, sched), per_mix in results.items():
        for names, r in zip(MIXES, per_mix):
            out[("+".join(names), pol, sched)] = dict(
                counters={f: int(getattr(r.shared, f)) for f in COUNTERS},
                core_cycles=[int(x) for x in r.core_cycles],
                alone_cycles=[float(x) for x in r.alone_cycles])
    return out


def _ws(results: dict, pol: Policy, sched: Scheduler) -> np.ndarray:
    return np.array([r.weighted_speedup
                     for r in results[(pol.name, sched.name)]])


def multicore_summary(results: dict) -> dict:
    """The numbers ``multicore_bench`` prints: mean weighted-speedup gains
    over BASELINE under FR-FCFS, and the TCM composition."""
    ws0 = _ws(results, Policy.BASELINE, Scheduler.FRFCFS)
    gains = {pol.name: float((100 * (_ws(results, pol, Scheduler.FRFCFS)
                                     / ws0 - 1)).mean())
             for pol in POLICIES[1:]}
    return dict(
        gains_pct=gains,
        masa_tcm_pct=float((100 * (_ws(results, Policy.MASA, Scheduler.TCM)
                                   / ws0 - 1)).mean()),
        base_tcm_pct=float((100 * (_ws(results, Policy.BASELINE,
                                       Scheduler.TCM) / ws0 - 1)).mean()))


def sched_summary(results: dict) -> dict:
    """The numbers ``sched_bench`` prints: mean weighted speedup per
    (policy, scheduler), MASA's scheduler combinations, and the policy
    gains at FR-FCFS."""
    ws = {(pol, sched): float(_ws(results, pol, sched).mean())
          for pol, sched in sched_points()}
    m = {s: ws[(Policy.MASA, s)] for s in ALL_SCHEDULERS}
    base = _ws(results, Policy.BASELINE, Scheduler.FRFCFS)
    return dict(
        ws={f"{p.name}/{s.name}": v for (p, s), v in ws.items()},
        masa_frfcfs_vs_fcfs_pct=100 * (m[Scheduler.FRFCFS]
                                       / m[Scheduler.FCFS] - 1),
        masa_tcm_vs_frfcfs_pct=100 * (m[Scheduler.TCM]
                                      / m[Scheduler.FRFCFS] - 1),
        masa_salp_aware_vs_frfcfs_pct=100 * (m[Scheduler.FRFCFS_SALP]
                                             / m[Scheduler.FRFCFS] - 1),
        gain_at_frfcfs_pct={
            pol.name: float((100 * (_ws(results, pol, Scheduler.FRFCFS)
                                    / base - 1)).mean())
            for pol in (Policy.SALP2, Policy.MASA)})


def multicore_report(mc: dict, sc: dict) -> str:
    """Both summaries as the benches print them, beside the paper."""
    lines = [f"{'mechanism':12s} {'ours':>8s} {'paper':>8s}   "
             f"(4-core weighted speedup over BASELINE, FR-FCFS)"]
    for pol in POLICIES[1:]:
        ref = MULTICORE_PAPER_GAINS.get(pol)
        lines.append(f"{pol.pretty:12s} {mc['gains_pct'][pol.name]:+7.2f}% "
                     + (f"{ref:7.1f}%" if ref is not None else f"{'-':>8s}"))
    lines += [
        f"MASA+TCM {mc['masa_tcm_pct']:+.2f}% vs BASE+TCM "
        f"{mc['base_tcm_pct']:+.2f}% (composes)",
        "",
        "scheduler study, refresh on (mean weighted speedup):",
    ]
    for pol in SCHED_POLICIES:
        row = "  ".join(f"{s.pretty}={sc['ws'][f'{pol.name}/{s.name}']:.3f}"
                        for s in ALL_SCHEDULERS
                        if f"{pol.name}/{s.name}" in sc["ws"])
        lines.append(f"  {pol.pretty:10s} {row}")
    lines += [
        f"MASA: FR-FCFS vs FCFS {sc['masa_frfcfs_vs_fcfs_pct']:+.2f}%, "
        f"TCM vs FR-FCFS {sc['masa_tcm_vs_frfcfs_pct']:+.2f}%, "
        f"FR-FCFS+SALP vs FR-FCFS {sc['masa_salp_aware_vs_frfcfs_pct']:+.2f}%",
        "at FR-FCFS: " + ", ".join(
            f"{Policy[p].pretty} {g:+.2f}%"
            for p, g in sc["gain_at_frfcfs_pct"].items()),
    ]
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=None,
                    help=f"requests a trace (Fig. 4: {FIG4_N}; multicore: "
                         f"{MULTICORE_N}, scheduler study: {SCHED_N})")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--multicore", action="store_true",
                    help="the 4-core weighted-speedup results and the "
                         "scheduler study instead of Fig. 4")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain version")
    args = ap.parse_args(argv)
    if args.multicore:
        mc = run_multicore(args.n or MULTICORE_N, args.seed,
                           device=args.device)
        sc = run_sched(args.n or SCHED_N, args.seed, device=args.device)
        print(f"# {len(mc) * len(MIXES)} + {len(sc) * len(MIXES)} mix cells "
              f"in {len(mc)} + {len(sc)} batched calls\n")
        print(multicore_report(multicore_summary(mc), sched_summary(sc)))
        return
    n = args.n or FIG4_N
    results = run_fig4(n, args.seed, device=args.device)
    print(f"# {len(POLICIES) * len(PAPER_WORKLOADS)} cells in "
          f"{len(POLICIES)} batched calls\n")
    print(report(summary(results, n)))


if __name__ == "__main__":
    main()
