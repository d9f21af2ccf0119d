"""Memory-technology comparison: DDR3-1066 / LPDDR4-3200 / PCM-PALP.

The port of the repo's ``benchmarks/memtech_bench.py``: the same grid, pin,
PALP comparison, command slices and failure checks. Does subarray-level
parallelism survive a change of memory technology?

* **SALP ladder per technology** — memory-intensive subset x
  (BASELINE/SALP1/SALP2/MASA) x (ddr3/lpddr4/pcm_palp): SALP1 <= SALP2 <=
  MASA speedup on EVERY technology (``salp_ladder_ok``). Subarray ==
  partition on PCM (PALP).
* **DDR3 column bit-pin** — ``memtech="ddr3"`` must be the historical
  default: the lbm/2000/seed-7 MASA cell equals :data:`DDR3_PIN_WANT`
  (``ddr3_pin_ok``).
* **PALP read-priority scheduling** — on a 4-core PCM mix the
  ``Scheduler.PALP_RP`` rung must cut MEAN READ LATENCY against plain
  FR-FCFS; the same pair on DDR3 is the control.
* **Command-level fidelity** — an exported + JEDEC-checked + dumped slice
  per technology extreme: the PCM stream has ZERO refresh commands, the
  LPDDR4 stream under per-bank refresh has some.

On the card each grid bucket is one lane-kernel launch (12), the pin one
more, and each PALP mix one mix-kernel launch plus one lane launch for its
run-alone baselines; the command slices run the plain emitting step on the
same device and dump under ``artifacts/torch/``.

    python -m repro_torch.benchmarks.memtech_bench [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os

from repro_torch.benchmarks.common import (COMMANDS_DIR, SEED, command_slice,
                                           emit, mem_intensive,
                                           per_sim_cell_us, run_grid, timed)
from repro_torch.core.dram import (MEMTECHS, Policy, ROW_SPACE_STRIDE,
                                   Scheduler, SimConfig, generate_trace,
                                   simulate, simulate_multicore, workload)
from repro_torch.experiments import SweepGrid

N = 2000
SUBSET = mem_intensive(15.0)
POLICIES = (Policy.BASELINE, Policy.SALP1, Policy.SALP2, Policy.MASA)
TECHS = tuple(MEMTECHS)  # ("ddr3", "lpddr4", "pcm_palp")

#: Command-level fidelity slices; the PCM dump is the one
#: ``validate --check-commands`` re-checks against the artifact.
COMMANDS_OUT = os.path.join(COMMANDS_DIR, "commands_memtech_pcm.trace")
COMMANDS_LPDDR4_OUT = os.path.join(COMMANDS_DIR,
                                   "commands_memtech_lpddr4.trace")

#: The DDR3 default-path pin: lbm, 2000 requests, seed 7, MASA, default
#: config (total_cycles, n_act, n_pre, n_hit, n_sasel, sum_latency,
#: sa_open_cycles) — the cell the JAX package's engine tests pin.
DDR3_PIN_WANT = (15410, 266, 208, 1734, 373, 32542, 645656)

#: 4-core mixes for the PALP scheduler comparison (>= 4 cores: with fewer
#: heads the scheduler rarely has a real choice and the rung is inert).
PALP_MIX = ("mcf", "lbm", "stream_copy", "milc")
PALP_N = 300


def make_grid() -> SweepGrid:
    return SweepGrid(
        name="memtech",
        workloads=SUBSET,
        policies=POLICIES,
        n_requests=N,
        seed=SEED,
        config_axes={"memtech": TECHS},
    )


def _ddr3_pin(device=None) -> tuple[bool, tuple, tuple]:
    # the memtech field must be invisible on the default path...
    assert (dataclasses.astuple(SimConfig(memtech="ddr3"))
            == dataclasses.astuple(SimConfig()))
    # ...and the pinned cell must reproduce the literals
    tr = generate_trace(workload("lbm"), 2000, seed=7)
    res = simulate(tr, Policy.MASA, SimConfig(memtech="ddr3"), device=device)
    got = tuple(int(getattr(res, f)) for f in
                ("total_cycles", "n_act", "n_pre", "n_hit", "n_sasel",
                 "sum_latency", "sa_open_cycles"))
    return got == DDR3_PIN_WANT, got, DDR3_PIN_WANT


def _palp_read_latency(memtech: str, sched: Scheduler, device=None) -> float:
    mix = [generate_trace(workload(m), PALP_N, seed=SEED,
                          row_space_offset=ROW_SPACE_STRIDE * i)
           for i, m in enumerate(PALP_MIX)]
    r = simulate_multicore(mix, Policy.MASA,
                           SimConfig(memtech=memtech, scheduler=sched),
                           device=device).shared
    return float(int(r.sum_latency) / int(r.n_reads))


def run(device=None) -> dict:
    (sweep, us) = timed(run_grid, make_grid(), device=device)
    per_cell = per_sim_cell_us(sweep, us)

    # SALP ladder per technology: mean speedup over that tech's own baseline
    table: dict[str, dict[str, float]] = {}
    salp_ladder_ok = True
    for tech in TECHS:
        gains = {pol.name: float(sweep.speedup_pct(pol, memtech=tech).mean())
                 for pol in POLICIES[1:]}
        table[tech] = gains
        if not (gains["MASA"] >= gains["SALP2"] >= gains["SALP1"] > 0):
            salp_ladder_ok = False

    pin_ok, pin_got, pin_want = _ddr3_pin(device)

    palp = {}
    for tech in ("pcm_palp", "ddr3"):
        (fr, fus) = timed(_palp_read_latency, tech, Scheduler.FRFCFS, device)
        (rp, rus) = timed(_palp_read_latency, tech, Scheduler.PALP_RP, device)
        palp[tech] = dict(frfcfs_read_lat=fr, palp_rp_read_lat=rp,
                          improvement_pct=float((fr / rp - 1) * 100))
        emit(f"memtech.palp_rp.{tech}", fus + rus,
             f"read_lat:frfcfs={fr:.2f};palp_rp={rp:.2f};"
             f"gain={palp[tech]['improvement_pct']:+.1f}%")
    palp_ok = palp["pcm_palp"]["palp_rp_read_lat"] \
        < palp["pcm_palp"]["frfcfs_read_lat"]

    # command-level fidelity at the two technology extremes
    (cmd_pcm, cus) = timed(
        command_slice, generate_trace(SUBSET[0], N, seed=SEED), Policy.MASA,
        SimConfig.for_tech("pcm_palp"), COMMANDS_OUT, device=device)
    (cmd_lp, lus) = timed(
        command_slice, generate_trace(SUBSET[0], N, seed=SEED), Policy.MASA,
        SimConfig.for_tech("lpddr4", refresh_policy="per_bank"),
        COMMANDS_LPDDR4_OUT, device=device)
    pcm_refs = cmd_pcm["ops"].get("REF", 0)
    lp_refs = cmd_lp["ops"].get("REF", 0)
    emit("memtech.commands.pcm", cus,
         f"n={cmd_pcm['n_commands']};rules={cmd_pcm['n_rules']};"
         f"refs={pcm_refs};checker_ok")
    emit("memtech.commands.lpddr4", lus,
         f"n={cmd_lp['n_commands']};rules={cmd_lp['n_rules']};"
         f"refs={lp_refs};checker_ok")

    emit("memtech.grid", per_cell,
         f"cells={sweep.stats['n_cells']};ladder_ok={salp_ladder_ok};"
         f"ddr3_pin_ok={pin_ok}")
    for tech, gains in table.items():
        row = ";".join(f"{p}=+{v:.1f}%" for p, v in gains.items())
        emit(f"memtech.salp.{tech}", 0.0, row)

    failures = []
    if not salp_ladder_ok:
        failures.append(f"SALP ladder violated on some memtech: {table}")
    if not pin_ok:
        failures.append(f"ddr3 column drifted off the pinned default: "
                        f"{pin_got} != {pin_want}")
    if not palp_ok:
        failures.append(f"PALP_RP did not improve PCM read latency: {palp}")
    if pcm_refs != 0:
        failures.append(f"PCM command stream has {pcm_refs} REF commands")
    if lp_refs == 0:
        failures.append("LPDDR4 per-bank stream emitted no REF commands "
                        "(refresh never engaged — shrink the trace?)")
    if failures:
        raise AssertionError("; ".join(failures))

    return dict(memtechs=list(TECHS), table=table,
                salp_ladder_ok=salp_ladder_ok,
                ddr3_pin=dict(ok=pin_ok, got=list(pin_got),
                              want=list(pin_want)),
                palp=palp, palp_ok=palp_ok,
                commands=cmd_pcm, commands_lpddr4=cmd_lp,
                n_cells=sweep.stats["n_cells"])


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain version")
    args = ap.parse_args()
    run(args.device)
