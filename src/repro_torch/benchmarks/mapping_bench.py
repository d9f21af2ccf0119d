"""Address-mapping sensitivity (docs/address-mapping.md): mapping x policy.

The paper's mechanisms assume that requests conflicting in a bank land in
*different* subarrays — a property of the controller's address-mapping
function, not of the timing core. This bench demonstrates the claim the paper
argues but a hard-coded frontend cannot show: with a dense physical footprint
(the realistic regime — an application's resident set is small and
contiguously allocated), a subarray-oblivious **contiguous** mapping folds the
whole footprint into one subarray slab and SALP/MASA gains collapse toward
zero, while **XOR** / **golden-hash** mappings spread the same physical
stream across subarrays and recover them.

One declarative grid: mapping x policy over memory-intensive workloads, with
``footprint_rows`` confining each workload to a contiguous 1024-row region
(1/4 of a subarray slab at the default 8 x 32768 geometry). Each (policy,
mapping) bucket is one lane-kernel launch on the card. The port of the
repo's ``benchmarks/mapping_bench.py``: the same grid, rows, summary and
assertion (which needs the full size's footprint pressure).

    python -m repro_torch.benchmarks.mapping_bench [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import (SEED, emit, per_sim_cell_us,
                                           run_grid, timed)
from repro_torch.core.dram import Policy, workload
from repro_torch.experiments import SweepGrid

N = 2000
#: Dense resident set: well inside one contiguous subarray slab
#: (rows_per_bank / n_subarrays = 4096 rows at the default geometry).
FOOTPRINT_ROWS = 1024
#: Memory-intensive subset spanning streaming / strided / pointer-chasing.
WORKLOAD_NAMES = ("lbm", "milc", "GemsFDTD", "libquantum", "stream_copy", "soplex")
POLICIES = (Policy.BASELINE, Policy.SALP1, Policy.SALP2, Policy.MASA)
MAPPINGS = ("contiguous", "golden", "xor")


def make_grid(n_requests: int = N) -> SweepGrid:
    return SweepGrid(
        name="mapping",
        workloads=tuple(workload(n) for n in WORKLOAD_NAMES),
        policies=POLICIES,
        n_requests=n_requests,
        seed=SEED,
        config_axes={"mapping": MAPPINGS},
        footprint_rows=FOOTPRINT_ROWS,
    )


def run(device=None) -> dict:
    (sweep, us) = timed(run_grid, make_grid(), device=device)

    out: dict[str, float] = {"footprint_rows": FOOTPRINT_ROWS}
    gains: dict[tuple, float] = {}
    for mapping in MAPPINGS:
        row = []
        for pol in POLICIES[1:]:
            g = float(sweep.speedup_pct(pol, mapping=mapping).mean())
            gains[mapping, pol] = g
            out[f"gain_{mapping}_{pol.name}"] = g
            row.append(f"{pol.pretty}=+{g:.1f}%")
        emit(f"mapping.{mapping}.speedup", per_sim_cell_us(sweep, us),
             ";".join(row))

    # The scenario the paper argues: a subarray-oblivious layout forfeits the
    # mechanisms. "Materially smaller" = contiguous keeps less than half of
    # the XOR-mapping gain (in practice it keeps ~none: one slab, no
    # cross-subarray conflicts to overlap).
    masa_xor, masa_contig = gains["xor", Policy.MASA], gains["contiguous", Policy.MASA]
    collapse_ok = bool(masa_contig < 0.5 * masa_xor)
    recover_ok = bool(gains["golden", Policy.MASA] > 0.5 * masa_xor)
    out["masa_contig_over_xor"] = masa_contig / masa_xor if masa_xor else float("nan")
    out["collapse_ok"] = collapse_ok
    out["recover_ok"] = recover_ok
    emit("mapping.collapse", 0.0,
         f"masa_xor=+{masa_xor:.1f}%;masa_contiguous=+{masa_contig:.1f}%;"
         f"collapse_ok={collapse_ok};recover_ok={recover_ok}")
    if not (collapse_ok and recover_ok):
        raise AssertionError(
            f"mapping sensitivity not demonstrated: {gains}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain version")
    run(ap.parse_args().device)
