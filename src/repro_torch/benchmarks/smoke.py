"""Smoke sweep: tiny grids through the full experiments pipeline.

Exercises grid expansion, shape bucketing, the result cache, and the batched
engine on a small problem (3 workloads x 3 policies x 2 geometries at 256
requests), then sanity-checks the policy ladder so a silently-broken engine or
sweep runner fails loudly. A second, even smaller MIX grid drives the
multicore controller through policy x scheduler (with refresh on), so the
scheduler layer and ``run_mix_sweep`` are covered by the same cell. Then a
command slice (MASA with refresh on mcf) is exported, checked and dumped
under ``artifacts/torch/``.

The port of the repo's ``benchmarks/smoke.py``: the same grids, checks, rows
and summary. On the card each (policy, geometry) bucket is one lane-kernel
launch, each mix bucket one mix-kernel launch (plus one lane launch a mix for
the run-alone baselines); the command slice runs the plain emitting step.

    python -m repro_torch.benchmarks.smoke [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os

from repro_torch.benchmarks.common import (COMMANDS_DIR, SEED, command_slice,
                                           emit, per_sim_cell_us, run_grid,
                                           run_mix_grid, timed)
from repro_torch.core.dram import (PAPER_WORKLOADS, Policy, Scheduler,
                                   SimConfig, generate_trace, workload)
from repro_torch.experiments import MixGrid, SweepGrid

N = 256
N_MIX = 128
SUBSET = tuple(p for p in PAPER_WORKLOADS if p.name in ("mcf", "lbm", "gups"))

#: Command-level fidelity slice: dump + re-checkable artifact.
COMMANDS_OUT = os.path.join(COMMANDS_DIR, "commands_smoke.trace")


def make_grid() -> SweepGrid:
    return SweepGrid(
        name="smoke",
        workloads=SUBSET,
        policies=(Policy.BASELINE, Policy.SALP1, Policy.MASA),
        n_requests=N,
        seed=SEED,
        config_axes={"n_subarrays": (4, 8)},
    )


def make_sched_grid() -> MixGrid:
    return MixGrid(
        name="smoke_sched",
        mixes=[(workload("mcf"), workload("lbm")),
               (workload("gups"), workload("stream_copy"))],
        policies=(Policy.BASELINE, Policy.MASA),
        n_requests=N_MIX,
        seed=SEED,
        configs=({"scheduler": Scheduler.FCFS, "refresh": True},
                 {"scheduler": Scheduler.FRFCFS, "refresh": True}),
    )


def run(device=None) -> dict:
    from repro_torch.benchmarks import common

    (sweep, us) = timed(run_grid, make_grid(), device=device)
    assert sweep.stats["n_cells"] == len(SUBSET) * 3 * 2
    # quarantine bookkeeping FIRST: whatever a fault drill stranded, every
    # grid cell must be accounted for before any metric is read
    assert (len(sweep.cells) + sweep.stats["quarantined_cells"]
            == sweep.stats["n_cells"]), sweep.stats
    faulted = common.FAULT_PLAN is not None
    n_shards = (sweep.stats.get("sharding") or {}).get("n_shards", 1)
    if not faulted:   # bisection retries legitimately add batches under faults
        # 3 pol x 2 geom buckets, each split into at most n_shards pieces
        assert sweep.stats["sim_batches"] <= 6 * n_shards, sweep.stats
        assert not sweep.quarantined, sweep.quarantined

    # ladder checks, quarantine-aware per CELL (not per workload): a pair is
    # skipped only when one of its cells was quarantined by the fault drill;
    # a cell missing for any OTHER reason still fails the ladder — a
    # quarantine can shrink the comparison, never fake a pass
    bad = {(q["workload"], q["policy"], q["overrides"].get("n_subarrays"))
           for q in sweep.quarantined}

    def cyc(policy, ns, wl):
        if (wl, policy.name, ns) in bad:
            return None   # quarantined: legitimately absent
        sel = sweep.select(policy=policy, workload=wl, n_subarrays=ns)
        assert sel, (f"cell ({wl}, {policy.name}, n_subarrays={ns}) missing "
                     f"without a quarantine record")
        return sel[0].counters["total_cycles"]

    ok = True
    compared = 0
    gains = []
    for wl in (p.name for p in SUBSET):
        for ns in (4, 8):
            base, s1 = cyc(Policy.BASELINE, ns, wl), cyc(Policy.SALP1, ns, wl)
            if base is None or s1 is None:
                continue
            compared += 1
            if not s1 <= base:
                ok = False
        b8, m8 = cyc(Policy.BASELINE, 8, wl), cyc(Policy.MASA, 8, wl)
        if b8 is not None and m8 is not None:
            gains.append((b8 / m8 - 1.0) * 100.0)
    assert compared, (f"fault plan quarantined every ladder pair "
                      f"({len(sweep.quarantined)} cells) — nothing to check")
    g = sum(gains) / len(gains) if gains else float("nan")
    emit("smoke.grid", per_sim_cell_us(sweep, us),
         f"cells={sweep.stats['n_cells']};batches={sweep.stats['sim_batches']};"
         f"ladder_ok={ok};pairs={compared};masa=+{g:.1f}%;"
         f"quarantined={len(sweep.quarantined)}")
    if not ok:
        raise AssertionError("policy ladder violated in smoke sweep")

    # scheduler x policy mix grid through the shared controller, refresh on
    (mix_sweep, mus) = timed(run_mix_grid, make_sched_grid(), device=device)
    assert mix_sweep.stats["n_cells"] == 2 * 2 * 2   # mixes x policies x scheds
    assert (len(mix_sweep.cells) + mix_sweep.stats["quarantined_cells"]
            == mix_sweep.stats["n_cells"]), mix_sweep.stats
    if not faulted:
        assert not mix_sweep.quarantined, mix_sweep.quarantined
    sched_ok = bool(mix_sweep.cells)
    n_cores = mix_sweep.grid.n_cores
    for cell in mix_sweep.cells:
        # every request served exactly once, whatever the discipline — a
        # starving/duplicating scheduler fails loudly here
        n = n_cores * N_MIX
        if (cell.counters["n_rd"] + cell.counters["n_wr"] != n
                or cell.counters["n_act"] + cell.counters["n_hit"] != n):
            sched_ok = False
        # weighted speedup is bounded by the core count up to mechanism gains
        if not (0.1 < cell.weighted_speedup < 2 * n_cores):
            sched_ok = False
    emit("smoke.sched", mus / max(mix_sweep.stats["n_cells"], 1),
         f"cells={mix_sweep.stats['n_cells']};"
         f"batches={mix_sweep.stats['sim_batches']};ok={sched_ok}")
    if not sched_ok:
        raise AssertionError(
            "scheduler mix grid violated conservation or speedup bounds")

    # command-level fidelity: export the MASA+refresh cell's full command
    # stream, run the JEDEC checker inline, cross-validate its counters
    # against the engine, and leave the dump for validate --check-commands
    (cmd, cus) = timed(
        command_slice, generate_trace(workload("mcf"), N, seed=SEED),
        Policy.MASA, SimConfig(refresh=True), COMMANDS_OUT, device=device)
    emit("smoke.commands", cus,
         f"n={cmd['n_commands']};rules={cmd['n_rules']};checker_ok")

    n_quarantined = len(sweep.quarantined) + len(mix_sweep.quarantined)
    return {"cells": sweep.stats["n_cells"], "masa_gain_pct": g, "ladder_ok": ok,
            "sched_cells": mix_sweep.stats["n_cells"], "sched_ok": sched_ok,
            "quarantined": n_quarantined, "fault_injection": faulted,
            "commands": cmd}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain version")
    run(ap.parse_args().device)
