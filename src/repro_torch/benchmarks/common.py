"""Shared helpers for the port's benchmarks (the port of the repo's
``benchmarks/common.py``).

Canonical reproduction settings: 8000 requests/workload, seed 7 — the
calibration frozen in EXPERIMENTS.md. Every benchmark prints
``name,us_per_call,derived`` CSV rows (one per paper table/figure entry).
``run_grid``, ``run_mix_grid``, ``suite_ipc`` and ``command_slice`` take
the ``device`` they run on (``None`` = the card). Command dumps and the
runner's artifacts go under :data:`COMMANDS_DIR`, beside (never over) the
JAX benches' files.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

N_REQUESTS = 8000
SEED = 7

#: Sweep artifacts (``repro.sweep/v1`` dicts) produced by benchmarks in this
#: process; ``repro_torch.benchmarks.run`` folds them into its single bench
#: artifact.
SWEEPS: list[dict] = []

#: Deterministic fault-injection plan (``repro_torch.experiments.FaultPlan``)
#: set by ``repro_torch.benchmarks.run --inject-faults``; threaded through
#: every sweep so a drill exercises the retry/bisect/quarantine paths on the
#: real pipeline.
FAULT_PLAN = None

#: Optional ``repro_torch.experiments.ResiliencePolicy`` override for every
#: sweep.
RESILIENCE = None

#: Optional ``repro_torch.experiments.ShardPlan`` set by
#: ``repro_torch.benchmarks.run --shards/--mesh``: every sweep partitions its
#: buckets across the plan's devices and streams per-shard fragments
#: (bit-identical results). The plan names its own devices, so a sweep under
#: it ignores ``device``.
SHARD_PLAN = None

#: Root directory for streamed ``repro.sweep-fragment/v1`` documents
#: (``repro_torch.benchmarks.run --fragments``); each sweep writes under
#: ``<FRAGMENT_DIR>/<grid name>/``. ``None`` = keep fragments in memory only.
FRAGMENT_DIR = None

#: Where the port's benches write their command dumps, relative to the
#: working directory (``artifacts/*`` is git-ignored; the JAX benches write
#: ``artifacts/commands_*.trace``).
COMMANDS_DIR = "artifacts/torch"


def _fragment_dir(grid) -> str | None:
    if FRAGMENT_DIR is None:
        return None
    import os
    return os.path.join(FRAGMENT_DIR, grid.name)


def mem_intensive(min_mpki: float = 9.0):
    """The memory-intensive subset (the regime where geometry matters)."""
    from repro_torch.core.dram import PAPER_WORKLOADS
    return tuple(p for p in PAPER_WORKLOADS if p.mpki >= min_mpki)


def run_grid(grid, device=None):
    """Run a SweepGrid against the process-wide result cache.

    All benchmarks of one process share ``GLOBAL_CACHE``, so a (workload,
    geometry, policy) cell is simulated at most once per process no matter
    how many benchmarks touch it. With a journal-backed cache installed
    (``repro_torch.benchmarks.run --journal``) the sharing extends across
    processes: completed cells replay from disk.
    """
    from repro_torch.experiments import GLOBAL_CACHE, run_sweep
    sweep = run_sweep(grid, GLOBAL_CACHE, resilience=RESILIENCE,
                      fault_plan=FAULT_PLAN, shards=SHARD_PLAN,
                      fragment_dir=_fragment_dir(grid),
                      device=None if SHARD_PLAN is not None else device)
    SWEEPS.append(sweep.to_json())
    return sweep


def run_mix_grid(grid, device=None):
    """Run a MixGrid (multi-core policy x scheduler sweep), registering its
    ``repro.sweep/v1`` artifact alongside the single-core sweeps."""
    from repro_torch.experiments import run_mix_sweep
    sweep = run_mix_sweep(grid, resilience=RESILIENCE, fault_plan=FAULT_PLAN,
                          shards=SHARD_PLAN, fragment_dir=_fragment_dir(grid),
                          device=None if SHARD_PLAN is not None else device)
    SWEEPS.append(sweep.to_json())
    return sweep


def per_sim_cell_us(sweep, us: float) -> float:
    """us per actually-simulated cell (cache hits cost ~nothing and would
    dilute the column into meaninglessness on warm caches)."""
    return us / max(sweep.stats["simulated_cells"], 1)


def timed(fn: Callable, *args, **kwargs):
    """Wall-time one call in microseconds, *including* device completion.

    Kernel launches are asynchronous: without a synchronize the clock could
    stop before the card's last work is done. The sweep runner already
    copies every bucket's counters to the host; the synchronize makes the
    rule hold for any ``fn``.
    """
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e6


def emit(name: str, us: float, derived) -> str:
    row = f"{name},{us:.1f},{derived}"
    print(row)
    return row


def suite_traces(n: int = N_REQUESTS, seed: int = SEED):
    """Suite traces via the sweep runner's memoized trace cache.

    Trace generation is a host-side Python loop over n requests; routing
    through :func:`repro_torch.experiments.runner.trace_for` means benchmark
    modules sharing (workload, n, geometry, seed) cells regenerate nothing.
    """
    from repro_torch.core.dram import PAPER_WORKLOADS
    from repro_torch.core.dram.engine import SimConfig
    from repro_torch.experiments.runner import trace_for
    cfg = SimConfig()  # default geometry — matches generate_trace defaults
    return [trace_for(p, n, cfg, seed) for p in PAPER_WORKLOADS]


def suite_ipc(traces, policy, device=None):
    """Per-workload IPC under one policy (one batched call over the suite:
    one lane-kernel launch on the card)."""
    from repro_torch.core.dram import PAPER_WORKLOADS, simulate_batch
    from repro_torch.core.dram.metrics import _f64
    from repro_torch.core.dram.timing import DEFAULT_CORE
    res = simulate_batch(traces, policy, device=device)
    total = _f64(res.total_cycles)
    nreq = _f64(res.n_requests)
    mpki = np.array([p.mpki for p in PAPER_WORKLOADS])
    instr = nreq * 1000.0 / mpki
    return instr / (total * DEFAULT_CORE.cpu_per_dram), res


def command_slice(trace, policy, config, out_path: str, device=None) -> dict:
    """One command-level fidelity cell: export, check, cross-validate, dump.

    Runs the emitting simulation (the plain emitting step on ``device``),
    asserts the stream is legal under the full JEDEC rule table
    (``check_trace``), asserts the stream alone reproduces the SimResult
    counters (minus the non-derivable ``sa_open_cycles``), then writes the
    ramulator-style dump to ``out_path`` so it can be re-parsed and
    re-checked (``repro_torch.benchmarks.validate --check-commands``).
    """
    import dataclasses
    import hashlib
    import os

    from repro_torch.core.dram import (check_trace, counters_from_commands,
                                       simulate_commands)
    from repro_torch.core.dram.engine import SimResult

    res, ct = simulate_commands(trace, policy, config, device=device)
    chk = check_trace(ct)
    if not chk.ok:
        raise AssertionError(f"illegal command stream: {chk.summary()}")
    got = counters_from_commands(ct)
    want = {f.name: int(getattr(res, f.name))
            for f in dataclasses.fields(SimResult)}
    want.pop("sa_open_cycles")
    if got != want:
        raise AssertionError(
            f"command stream does not reproduce the engine's counters: "
            f"{got} != {want}")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    text = ct.dumps()
    with open(out_path, "w") as f:
        f.write(text)
    return {"path": out_path, "n_commands": len(ct), "ops": ct.counts(),
            "n_rules": chk.n_rules, "checker_ok": True,
            "sha256": hashlib.sha256(text.encode()).hexdigest()}
