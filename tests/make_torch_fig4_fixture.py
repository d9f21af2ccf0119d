"""Regenerate ``tests/data/torch_fig4_n8000.json`` from the JAX package.

NOT a test module (no ``test_`` prefix). Run

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_fig4_fixture.py

The fixture pins the counters of the paper's Fig. 4 grid at its own size —
32 workloads x 5 policies x 8000 requests, seed 7
(``benchmarks/common.py``) — as the reference's sweep runner
(``repro.experiments.run_sweep``) computes them. ``chip_smoke.py`` holds
the CUDA lane kernel to it on the card, and
``tests/test_torch_paper_repro.py`` holds the JAX package to it on the CPU,
so it cannot rot.
"""
import json
import os

from repro.core.dram import PAPER_WORKLOADS, Policy
from repro.experiments import ResultCache, SweepGrid, run_sweep

OUT = os.path.join(os.path.dirname(__file__), "data", "torch_fig4_n8000.json")
N_REQUESTS = 8000
SEED = 7
POLICIES = (Policy.BASELINE, Policy.SALP1, Policy.SALP2, Policy.MASA,
            Policy.IDEAL)


def fig4_cells(n: int = N_REQUESTS, seed: int = SEED) -> list[dict]:
    """The grid's cells (workload-major, policy-minor) with their counters."""
    grid = SweepGrid(name="paper_repro", workloads=PAPER_WORKLOADS,
                     policies=POLICIES, n_requests=n, seed=seed)
    sweep = run_sweep(grid, ResultCache())
    return [{"workload": c.workload.name, "policy": c.policy.name,
             "counters": c.counters} for c in sweep.cells]


def main() -> None:
    doc = {"n_requests": N_REQUESTS, "seed": SEED,
           "source": "repro.experiments.run_sweep (JAX reference)",
           "cells": fig4_cells()}
    # one cell per line: diffs of a regeneration show the cells that moved
    head = json.dumps({k: v for k, v in doc.items() if k != "cells"},
                      sort_keys=True)[:-1]
    body = ",\n".join(json.dumps(c, sort_keys=True) for c in doc["cells"])
    with open(OUT, "w") as f:
        f.write(f'{head}, "cells": [\n{body}\n]}}\n')
    print(f"wrote {len(doc['cells'])} cells to {OUT}")


if __name__ == "__main__":
    main()
