"""Regenerate ``tests/data/torch_multicore_fixture.json`` from the JAX package.

NOT a test module (no ``test_`` prefix). Run

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_multicore_fixture.py

The fixture pins the shared counters, per-core cycles and run-alone cycles
of the paper's multi-core products at their own sizes, as the reference
computes them:

* ``multicore`` — ``benchmarks/multicore_bench.py``: four 4-core mixes x
  1500 requests, seed 7; BASELINE / SALP-1 / SALP-2 / MASA / IDEAL under
  FR-FCFS and BASELINE / MASA under TCM (28 cells), through
  ``repro.core.dram.multicore.simulate_multicore_batch``;
* ``sched`` — ``benchmarks/sched_bench.py``: the same mixes x 1000
  requests with refresh on, BASELINE / SALP-2 / MASA x the four
  ``ALL_SCHEDULERS`` with FR-FCFS+SALP under MASA only (40 cells), through
  the reference's mix-grid runner (``repro.experiments.run_mix_sweep``).

``chip_smoke.py`` holds the CUDA mix and lane kernels to it on the card, and
``tests/test_torch_multicore.py`` / ``tests/test_torch_sched.py`` hold the
JAX package to it on the CPU, so it cannot rot.
"""
import dataclasses
import json
import os

from benchmarks import multicore_bench, sched_bench
from repro.core.dram import Policy, SimResult
from repro.core.dram.multicore import (alone_baseline_cycles,
                                       simulate_multicore_batch)
from repro.experiments import run_mix_sweep

OUT = os.path.join(os.path.dirname(__file__), "data",
                   "torch_multicore_fixture.json")
SEED = 7
COUNTERS = tuple(f.name for f in dataclasses.fields(SimResult))
POLICIES = (Policy.BASELINE, Policy.SALP1, Policy.SALP2, Policy.MASA,
            Policy.IDEAL)


def _cell(part, names, policy, scheduler, counters, core, alone) -> dict:
    return {"part": part, "mix": "+".join(names), "policy": policy.name,
            "scheduler": scheduler.name, "counters": counters,
            "core_cycles": [int(x) for x in core],
            "alone_cycles": [float(x) for x in alone]}


def multicore_cells() -> list[dict]:
    """``multicore_bench``'s product, as its ``run()`` simulates it."""
    mixes = [multicore_bench._mix_traces(m) for m in multicore_bench.MIXES]
    alone = alone_baseline_cycles(mixes)
    points = ([(pol, multicore_bench.FRFCFS) for pol in POLICIES]
              + [(Policy.BASELINE, multicore_bench.TCM),
                 (Policy.MASA, multicore_bench.TCM)])
    cells = []
    for pol, cfg in points:
        res = simulate_multicore_batch(mixes, pol, cfg, alone_cycles=alone)
        for names, r in zip(multicore_bench.MIXES, res):
            cells.append(_cell(
                "multicore", names, pol, cfg.scheduler,
                {f: int(getattr(r.shared, f)) for f in COUNTERS},
                r.core_cycles, r.alone_cycles))
    return cells


def sched_cells() -> list[dict]:
    """``sched_bench``'s grid, through the reference's mix-grid runner."""
    sweep = run_mix_sweep(sched_bench.make_grid())
    return [_cell("sched", [p.name for p in c.cell.profiles], c.cell.policy,
                  c.cell.config.scheduler, c.counters, c.core_cycles,
                  c.alone_cycles)
            for c in sweep.cells]


def main() -> None:
    doc = {"seed": SEED,
           "n_requests": {"multicore": multicore_bench.N,
                          "sched": sched_bench.N},
           "source": "repro.core.dram.multicore.simulate_multicore_batch "
                     "and repro.experiments.run_mix_sweep (JAX reference)",
           "cells": multicore_cells() + sched_cells()}
    # one cell per line: diffs of a regeneration show the cells that moved
    head = json.dumps({k: v for k, v in doc.items() if k != "cells"},
                      sort_keys=True)[:-1]
    body = ",\n".join(json.dumps(c, sort_keys=True) for c in doc["cells"])
    with open(OUT, "w") as f:
        f.write(f'{head}, "cells": [\n{body}\n]}}\n')
    print(f"wrote {len(doc['cells'])} cells to {OUT}")


if __name__ == "__main__":
    main()
