"""Refresh-policy ladder reproduction (paper Sec. 6.1; Chang et al. HPCA'14).

The port of the repo's ``benchmarks/refresh_bench.py``: the same grid, rows,
ladder assertion and command slice. One grid spans the full mechanism
ladder — off / REFab / REFpb / DARP / SARP / DSARP
(``SimConfig.refresh_policy``) — at three densities (8/16/32 Gb: ``tRFC`` /
``tRFCpb`` grow with density) under the extended-temperature ``tREFI``.
The headline is the HPCA'14 trend, mean penalty ordered ``all_bank >
per_bank > darp >= sarp`` per density and policy (``ladder_ok``; re-checked
by :mod:`repro_torch.benchmarks.validate`). The baseline+DSARP point is
pruned (subarray-granular refresh with a full tRFC burst needs MASA).

Each (policy, config) bucket of the grid is one lane-kernel launch on the
card (33 of them); the command slice (32 Gb DARP under MASA) runs the plain
emitting step on the same device and dumps under ``artifacts/torch/``.

    python -m repro_torch.benchmarks.refresh_bench [--device cuda|cpu] [--n N]

``--n`` cuts the grid's requests a workload (the command slice's trace
too); the ladder assertion needs about 1000 or more, since with a few
hundred requests refresh barely fires.
"""
from __future__ import annotations

import argparse
import os

from repro_torch.benchmarks.common import (COMMANDS_DIR, SEED, command_slice,
                                           emit, mem_intensive,
                                           per_sim_cell_us, run_grid, timed)
from repro_torch.core.dram import (DramTiming, Policy, SimConfig,
                                   generate_trace)
from repro_torch.experiments import SweepGrid

N = 4000
SUBSET = mem_intensive(15.0)

#: Command-level fidelity slice: the refresh-dominated corner (32 Gb hot
#: DARP under MASA) exported + JEDEC-checked + dumped for re-validation.
COMMANDS_OUT = os.path.join(COMMANDS_DIR, "commands_refresh.trace")

#: Density ladder, in Gb (``DramTiming.preset``'s ``density_gb`` axis).
DENSITIES = ("8Gb", "16Gb", "32Gb")

#: Extended-temperature refresh interval (tREFI halves above 85 C).
T_REFI_HOT = 2080

LADDER = ("all_bank", "per_bank", "darp", "sarp", "dsarp")
POLICIES = (Policy.BASELINE, Policy.MASA)


def _timing(gb: str):
    return DramTiming.preset("ddr3", density_gb=int(gb[:-2]),
                             t_refi=T_REFI_HOT)


def make_grid() -> SweepGrid:
    configs = []
    for gb in DENSITIES:
        t = _timing(gb)
        configs.append({"timing": t})                       # refresh off
        configs.extend({"timing": t, "refresh_policy": rp} for rp in LADDER)
    return SweepGrid(
        name="refresh",
        workloads=SUBSET,
        policies=POLICIES,
        n_requests=N,
        seed=SEED,
        configs=tuple(configs),
        where=lambda pol, ov: not (pol == Policy.BASELINE
                                   and ov.get("refresh_policy") == "dsarp"),
    )


def run(device=None) -> dict:
    (sweep, us) = timed(run_grid, make_grid(), device=device)
    per_cell = per_sim_cell_us(sweep, us)

    table: dict[str, dict[str, dict[str, float]]] = {}
    ladder_ok = True
    for gb in DENSITIES:
        t = _timing(gb)
        table[gb] = {}
        for pol in POLICIES:
            off = sweep.metric("total_cycles", policy=pol, timing=t,
                               refresh_policy="none")
            pens = {}
            for rp in LADDER:
                if pol == Policy.BASELINE and rp == "dsarp":
                    continue
                cyc = sweep.metric("total_cycles", policy=pol, timing=t,
                                   refresh_policy=rp)
                pens[rp] = float((cyc / off - 1).mean() * 100)
            table[gb][pol.name] = pens
            if not (pens["all_bank"] > pens["per_bank"] > pens["darp"]
                    >= pens["sarp"]):
                ladder_ok = False

    # headline derived numbers (32 Gb, where refresh dominates)
    hi = table["32Gb"]
    darp_recovered = 100 * (1 - hi["MASA"]["darp"]
                            / max(hi["MASA"]["per_bank"], 1e-9))
    sarp_vs_dsarp = hi["MASA"]["sarp"] - hi["MASA"]["dsarp"]

    emit("refresh.grid", per_cell,
         f"cells={sweep.stats['n_cells']};ladder_ok={ladder_ok}")
    for gb, per_pol in table.items():
        for pol, pens in per_pol.items():
            row = ";".join(f"{rp}=+{v:.1f}%" for rp, v in pens.items())
            emit(f"refresh.penalty.{gb}.{pol}", 0.0, row)
    emit("refresh.darp_recovered_32Gb", 0.0,
         f"{darp_recovered:.0f}%(HPCA14:'recovers_most_of_the_penalty')")
    emit("refresh.sarp_minus_dsarp_32Gb", 0.0,
         f"{sarp_vs_dsarp:+.1f}pp(HPCA14:'SARP~=DSARP_without_MASA')")
    if not ladder_ok:
        raise AssertionError(f"refresh ladder ordering violated: {table}")

    # command-level fidelity: the slice where every refresh mechanism fires
    # (DARP idle pull-ins, forced bursts, write shadows)
    (cmd, cus) = timed(
        command_slice, generate_trace(SUBSET[0], N, seed=SEED), Policy.MASA,
        SimConfig(refresh_policy="darp", timing=_timing("32Gb")),
        COMMANDS_OUT, device=device)
    emit("refresh.commands", cus,
         f"n={cmd['n_commands']};rules={cmd['n_rules']};checker_ok")

    return dict(ladder_ok=ladder_ok, table=table, commands=cmd,
                darp_recovered_pct_32Gb=darp_recovered,
                sarp_minus_dsarp_pp_32Gb=sarp_vs_dsarp,
                densities={gb: dict(t_rfc=_timing(gb).t_rfc,
                                    t_rfc_pb=_timing(gb).t_rfc_pb)
                           for gb in DENSITIES},
                t_refi=T_REFI_HOT,
                n_cells=sweep.stats["n_cells"])


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain version")
    ap.add_argument("--n", type=int, default=N,
                    help=f"requests a workload (default {N}; the ladder "
                         "assertion needs about 1000 or more)")
    args = ap.parse_args()
    N = args.n
    run(args.device)
