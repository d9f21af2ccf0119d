"""Paper Sec. 9.3 sensitivity: open- vs closed-row policy.

Under the closed-row policy every access auto-precharges, so (a) there are no
row-buffer hits for MASA's multiple row buffers to win, and (b) the auto-PRE
occupies the bank's global structures, which SALP-1/2 can still overlap.
Expected (and measured): SALP-1/2 retain roughly half their open-row gains;
MASA degenerates to exactly SALP-2.

The port of the repo's ``benchmarks/row_policy_bench.py``: the same rows and
summary, outside the sweep layer as there. Each (row policy, policy) pair is
one ``simulate_batch`` call over the 15 traces: eight lane-kernel launches
on the card.

    python -m repro_torch.benchmarks.row_policy_bench [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import SEED, emit, timed
from repro_torch.core.dram import (PAPER_WORKLOADS, Policy, SimConfig,
                                   generate_trace, simulate_batch)
from repro_torch.core.dram.metrics import _f64

N = 4000
SUBSET = [p for p in PAPER_WORKLOADS if p.mpki >= 9.0]


def run(device=None) -> dict:
    traces = [generate_trace(p, N, seed=SEED) for p in SUBSET]
    out = {}
    for rp in ("open", "closed"):
        cfg = SimConfig(row_policy=rp)
        (res_b, us) = timed(simulate_batch, traces, Policy.BASELINE, cfg,
                            device=device)
        base = _f64(res_b.total_cycles)
        gains = {}
        for pol in (Policy.SALP1, Policy.SALP2, Policy.MASA):
            cyc = _f64(simulate_batch(traces, pol, cfg,
                                      device=device).total_cycles)
            gains[pol.pretty] = float((base / cyc - 1).mean() * 100)
        out[rp] = gains
        emit(f"row_policy.{rp}", us / len(SUBSET),
             ";".join(f"{k}=+{v:.1f}%" for k, v in gains.items()))
    masa_eq_salp2 = abs(out["closed"]["MASA"] - out["closed"]["SALP-2"]) < 0.5
    emit("row_policy.closed_masa_equals_salp2", 0.0,
         f"{masa_eq_salp2}(multiple_row_buffers_need_open_rows)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain version")
    run(ap.parse_args().device)
