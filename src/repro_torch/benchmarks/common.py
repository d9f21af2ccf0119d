"""Shared helpers for the port's benchmarks (the port of the repo's
``benchmarks/common.py``).

Canonical reproduction settings: 8000 requests/workload, seed 7 — the
calibration frozen in EXPERIMENTS.md. Every benchmark prints
``name,us_per_call,derived`` CSV rows (one per paper table/figure entry).
``run_grid`` and ``run_mix_grid`` take the ``device`` the sweep runs on
(``None`` = the card).
"""
from __future__ import annotations

import time
from typing import Callable

import torch

N_REQUESTS = 8000
SEED = 7

#: Sweep artifacts (``repro.sweep/v1`` dicts) produced by benchmarks in this
#: process, for a runner to fold into one bench artifact.
SWEEPS: list[dict] = []


def mem_intensive(min_mpki: float = 9.0):
    """The memory-intensive subset (the regime where geometry matters)."""
    from repro_torch.core.dram import PAPER_WORKLOADS
    return tuple(p for p in PAPER_WORKLOADS if p.mpki >= min_mpki)


def run_grid(grid, device=None):
    """Run a SweepGrid against the process-wide result cache.

    All benchmarks of one process share ``GLOBAL_CACHE``, so a (workload,
    geometry, policy) cell is simulated at most once per process no matter
    how many benchmarks touch it. With a journal-backed cache installed
    (``install_global_cache``) the sharing extends across processes:
    completed cells replay from disk.
    """
    from repro_torch.experiments import GLOBAL_CACHE, run_sweep
    sweep = run_sweep(grid, GLOBAL_CACHE, device=device)
    SWEEPS.append(sweep.to_json())
    return sweep


def run_mix_grid(grid, device=None):
    """Run a MixGrid (multi-core policy x scheduler sweep), registering its
    ``repro.sweep/v1`` artifact alongside the single-core sweeps."""
    from repro_torch.experiments import run_mix_sweep
    sweep = run_mix_sweep(grid, device=device)
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

