"""Regenerate ``tests/data/torch_paper_benches_fixture.json`` from the JAX
package.

NOT a test module (no ``test_`` prefix). Run

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/make_torch_paper_benches_fixture.py

The fixture pins what the repo's remaining paper benches compute at their own
size, as the JAX package computes it:

* every grid cell's key, overrides and integer counters of
  ``benchmarks/sens_subarrays.py`` (15 workloads x 3 policies x 7 subarray
  counts x 4000 requests), ``sens_banks.py`` (75 cells), ``mapping_bench.py``
  (6 x 4 x 3 mappings x 2000) and ``smoke.py`` (18 cells), and the smoke mix
  grid's 8 cells (counters, per-core and run-alone cycles, weighted
  speedup);
* ``row_policy_bench.py``'s 120 counter rows (open and closed row x 4
  policies x 15 workloads x 4000 requests);
* smoke's command slice (sha256, command count, opcode counts, rules);
* every bench's ``run()`` summary at full size (``fig4``, ``fig5``,
  ``sens_subarrays``, ``sens_banks``, ``row_policy``, ``multicore``,
  ``sched``, ``mapping``, ``serving``, ``smoke``; JSON-rounded, smoke's
  command-slice path left out). Fig. 5's and the multicore bench's counters
  are those of ``torch_fig4_n8000.json`` and ``torch_multicore_fixture.json``.

``chip_smoke.py`` holds the port's benches on the card to it, and
``tests/test_torch_paper_benches.py`` checks that its keys are exactly the
port's grid keys.
"""
import dataclasses
import json
import os
import tempfile

from benchmarks import (common, fig4_ipc, fig5_energy, mapping_bench,
                        multicore_bench, row_policy_bench, sched_bench,
                        sens_banks, sens_subarrays, serving_bench, smoke)
from repro.core.dram import Policy, SimConfig, generate_trace, simulate_batch
from repro.core.dram.engine import SimResult

OUT = os.path.join(os.path.dirname(__file__), "data",
                   "torch_paper_benches_fixture.json")

#: The benches whose run() summaries the fixture pins, in the runner's order.
BENCHES = {"fig4": fig4_ipc, "fig5": fig5_energy,
           "sens_subarrays": sens_subarrays, "sens_banks": sens_banks,
           "row_policy": row_policy_bench, "multicore": multicore_bench,
           "sched": sched_bench, "mapping": mapping_bench,
           "serving": serving_bench, "smoke": smoke}
#: The sweeps whose cells the fixture pins.
GRIDS = ("sens_subarrays", "sens_banks", "mapping", "smoke", "smoke_sched")
ROW_POLICIES = ("open", "closed")
ROW_POLICY_POLICIES = (Policy.BASELINE, Policy.SALP1, Policy.SALP2,
                       Policy.MASA)
COUNTERS = tuple(f.name for f in dataclasses.fields(SimResult))


def cell_record(grid: str, c: dict) -> dict:
    """One sweep cell of a ``repro.sweep/v1`` document, without its derived
    floats and cache flag."""
    if "mix" in c:
        keep = ("mix", "policy", "overrides", "counters", "core_cycles",
                "alone_cycles", "weighted_speedup")
    else:
        keep = ("key", "workload", "policy", "overrides", "counters")
    return {"grid": grid, **{k: c[k] for k in keep}}


def row_policy_rows() -> list[dict]:
    """Every (row policy, policy, workload) counter set of row_policy_bench's
    ``simulate_batch`` calls."""
    traces = [generate_trace(p, row_policy_bench.N, seed=common.SEED)
              for p in row_policy_bench.SUBSET]
    rows = []
    for rp in ROW_POLICIES:
        for pol in ROW_POLICY_POLICIES:
            res = simulate_batch(traces, pol, SimConfig(row_policy=rp))
            for i, p in enumerate(row_policy_bench.SUBSET):
                rows.append({"row_policy": rp, "policy": pol.name,
                             "workload": p.name,
                             "counters": {f: int(getattr(res, f)[i])
                                          for f in COUNTERS}})
    return rows


def main() -> None:
    summaries = {}
    with tempfile.TemporaryDirectory() as tmp:
        smoke.COMMANDS_OUT = os.path.join(tmp, "commands_smoke.trace")
        for key, bench in BENCHES.items():
            summaries[key] = bench.run()
    slice_rec = summaries["smoke"].pop("commands")
    slice_rec.pop("path")
    summaries = json.loads(json.dumps(summaries))
    cells = [cell_record(s["grid"]["name"], c) for s in common.SWEEPS
             if s["grid"]["name"] in GRIDS for c in s["cells"]]
    head = {"source": "benchmarks/{fig4_ipc,fig5_energy,sens_subarrays,"
                      "sens_banks,row_policy_bench,multicore_bench,"
                      "sched_bench,mapping_bench,serving_bench,smoke}.py "
                      "(JAX reference)",
            "seed": common.SEED,
            "sizes": {"sens_subarrays": sens_subarrays.N,
                      "sens_banks": sens_banks.N,
                      "row_policy": row_policy_bench.N,
                      "mapping": mapping_bench.N, "smoke": smoke.N,
                      "smoke_sched": smoke.N_MIX},
            "summaries": summaries, "smoke_commands": slice_rec}
    rows = row_policy_rows()
    # one cell or row per line: diffs of a regeneration show what moved
    text = json.dumps(head, sort_keys=True)[:-1]
    body = ",\n".join(json.dumps(c, sort_keys=True) for c in cells)
    rbody = ",\n".join(json.dumps(r, sort_keys=True) for r in rows)
    with open(OUT, "w") as f:
        f.write(f'{text}, "cells": [\n{body}\n], '
                f'"row_policy": [\n{rbody}\n]}}\n')
    print(f"wrote {len(cells)} cells and {len(rows)} row-policy rows to {OUT}")


if __name__ == "__main__":
    main()
