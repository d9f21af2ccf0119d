"""Layer C benchmark: the SALP-aware serving scheduler vs FIFO.

Builds a high-conflict serving state (many sequences whose current pages
cluster into few banks — the serving analogue of the paper's lockstep-array
workloads) and measures the page-access critical-path cost of the scheduled
order vs FIFO under each policy's cost model. MASA should gain the most: its
multiple "activated" pages turn revisits into hits.

The port of the repo's ``benchmarks/serving_bench.py`` on
:mod:`repro_torch.serve.kvcache` and :mod:`repro_torch.serve.scheduler`: the
same states, rows and summary. It runs on the host only and launches
nothing; ``run`` takes ``device`` only so the runner can call every bench
alike.

    python -m repro_torch.benchmarks.serving_bench
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import emit, timed
from repro_torch.core.dram.policies import Policy
from repro_torch.serve.kvcache import PagedKVCache
from repro_torch.serve.scheduler import Request, SalpScheduler


def build_state(n_seqs: int, policy: Policy, seed: int = 0,
                interleave: bool = False):
    cache = PagedKVCache(n_pages=4096, page_size=4)
    # sequential page allocation (no bank interleave) => clustered banks,
    # maximal conflict pressure, like the paper's aligned streams
    cache.allocator.alloc = (lambda n, _orig=cache.allocator.alloc,
                             il=interleave: _orig(n, interleave=il))
    sched = SalpScheduler(cache, max_batch=n_seqs, policy=policy)
    rng = np.random.default_rng(seed)
    for rid in range(n_seqs):
        share = rid - 1 if (rid > 0 and rng.random() < 0.4) else None
        sched.submit(Request(rid, int(rng.integers(8, 64)), 8,
                             shared_prefix_of=share))
    sched.admit()
    return sched


def run(device=None) -> dict:
    out = {}
    abs_cost = {}
    for policy in (Policy.BASELINE, Policy.SALP1, Policy.SALP2, Policy.MASA):
        red, costs, n = [], [], 24
        for seed in range(6):
            sched = build_state(n, policy, seed)
            (order, us) = timed(sched.schedule_step)
            fifo_cost = sched.order_cost(sorted(order))
            sched_cost = sched.order_cost(order)
            red.append(1 - sched_cost / max(fifo_cost, 1))
            costs.append(sched_cost)
        m = float(np.mean(red))
        abs_cost[policy] = float(np.mean(costs))
        out[policy.pretty] = m
        ladder = abs_cost[policy] / abs_cost[Policy.BASELINE]
        emit(f"serving.scheduler.{policy.pretty}", us,
             f"cost_vs_fifo=-{100 * m:.1f}%;abs_vs_baseline={ladder:.2f}x")
    out["masa_abs_vs_baseline"] = abs_cost[Policy.MASA] / abs_cost[Policy.BASELINE]

    # bank-interleaved allocation (the kvcache default) should already remove
    # most conflicts; scheduled gains shrink => allocation + scheduling compose
    sched = build_state(24, Policy.MASA, 0, interleave=True)
    order = sched.schedule_step()
    m2 = 1 - sched.order_cost(order) / max(sched.order_cost(sorted(order)), 1)
    emit("serving.scheduler.MASA+interleaved_alloc", 0.0,
         f"cost_vs_fifo=-{100 * m2:.1f}%(alloc_already_avoids_conflicts)")
    out["masa_interleaved"] = float(m2)
    return out


if __name__ == "__main__":
    run()
