"""Regenerate ``tests/data/torch_refresh_memtech_fixture.json`` from the JAX
package.

NOT a test module (no ``test_`` prefix). Run

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/make_torch_refresh_memtech_fixture.py

The fixture pins what the repo's ``benchmarks/refresh_bench.py`` and
``benchmarks/memtech_bench.py`` compute at their own size, as the JAX
package computes it: every grid cell's key and integer counters (refresh:
12 workloads x 4000 requests x 33 (policy, config) points; memtech: 12 x
2000 x 4 policies x 3 technologies), the DDR3 pin, the PALP read latencies
(4-core mixes of 300 requests, FR-FCFS and PALP_RP on PCM and DDR3) and
the three command slices' sha256, command count and opcode counts.
``chip_smoke.py`` holds the port's benches on the card to it, and
``tests/test_torch_refresh_memtech.py`` checks that its keys are exactly the
port's grid keys.
"""
import json
import os
import tempfile

from benchmarks import memtech_bench, refresh_bench
from benchmarks.common import SEED, command_slice
from repro.core.dram import Policy, Scheduler, SimConfig, generate_trace
from repro.experiments import ResultCache, run_sweep

OUT = os.path.join(os.path.dirname(__file__), "data",
                   "torch_refresh_memtech_fixture.json")


def grid_cells(bench) -> list[dict]:
    sweep = run_sweep(bench.make_grid(), ResultCache())
    return [{"grid": bench.make_grid().name, "key": c.key,
             "workload": c.workload.name, "policy": c.policy.name,
             "counters": c.counters} for c in sweep.cells]


def slices(tmp: str) -> dict[str, dict]:
    """The benches' three command slices, as their ``run()``s call them."""
    specs = {
        "refresh": (refresh_bench, Policy.MASA, SimConfig(
            refresh_policy="darp", timing=refresh_bench._timing("32Gb"))),
        "memtech_pcm": (memtech_bench, Policy.MASA,
                        SimConfig.for_tech("pcm_palp")),
        "memtech_lpddr4": (memtech_bench, Policy.MASA, SimConfig.for_tech(
            "lpddr4", refresh_policy="per_bank")),
    }
    out = {}
    for name, (bench, pol, cfg) in specs.items():
        tr = generate_trace(bench.SUBSET[0], bench.N, seed=SEED)
        rec = command_slice(tr, pol, cfg, os.path.join(tmp, name + ".trace"))
        out[name] = {k: rec[k] for k in ("sha256", "n_commands", "ops",
                                         "n_rules")}
    return out


def main() -> None:
    pin_ok, pin_got, _ = memtech_bench._ddr3_pin()
    assert pin_ok, pin_got
    palp = {tech: {s.name: memtech_bench._palp_read_latency(tech, s)
                   for s in (Scheduler.FRFCFS, Scheduler.PALP_RP)}
            for tech in ("pcm_palp", "ddr3")}
    with tempfile.TemporaryDirectory() as tmp:
        cmds = slices(tmp)
    cells = grid_cells(refresh_bench) + grid_cells(memtech_bench)
    head = {"source": "benchmarks/refresh_bench.py, benchmarks/memtech_bench.py"
                      " (JAX reference)",
            "sizes": {"refresh": {"n": refresh_bench.N,
                                  "workloads": len(refresh_bench.SUBSET)},
                      "memtech": {"n": memtech_bench.N,
                                  "workloads": len(memtech_bench.SUBSET)}},
            "seed": SEED, "ddr3_pin": list(pin_got), "palp": palp,
            "commands": cmds}
    # one cell per line: diffs of a regeneration show the cells that moved
    text = json.dumps(head, sort_keys=True)[:-1]
    body = ",\n".join(json.dumps(c, sort_keys=True) for c in cells)
    with open(OUT, "w") as f:
        f.write(f'{text}, "cells": [\n{body}\n]}}\n')
    print(f"wrote {len(cells)} cells to {OUT}")


if __name__ == "__main__":
    main()
