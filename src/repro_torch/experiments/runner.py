"""Batched sweep execution (the port of ``repro.experiments.runner``).

``run_sweep`` turns a :class:`~repro_torch.experiments.grid.SweepGrid` into
results via three mechanisms:

1. **Trace memoization** — traces depend only on (workload, n_requests,
   n_banks, n_subarrays, seed); cells that differ only in policy / refresh /
   row-policy share one generated trace.
2. **Content-hashed result cache** — every cell is keyed by
   :func:`repro_torch.experiments.cache.cell_key` (the reference's keys),
   the arrays of each distinct trace hashed once a call; a hit skips
   simulation entirely.
   The baseline is therefore simulated once per (workload, geometry) cell, not
   once per mechanism policy compared against it.
3. **Shape bucketing** — uncached cells are grouped by their static
   signature (policy, scheduler, geometry, timing, refresh mode, row
   policy, trace length); each bucket becomes ONE
   :func:`repro_torch.core.dram.engine.simulate_stacked` call over the
   bucket's stacked traces: one lane-kernel launch on the card. A
   32-workload x 5-policy grid is 5 launches, not 160.

``run_mix_sweep`` executes the multi-core analogue (:class:`MixGrid`, the
paper's policy x scheduler x mix surface) with the same bucketing idea over
:func:`repro_torch.core.dram.multicore.simulate_multicore_batch`: one
mix-kernel launch a bucket, plus one lane-kernel launch a memoised run-alone
baseline.

Both runners execute their buckets through the resilience layer
(:mod:`repro_torch.experiments.resilience`). On a card each bucket is
issued on a stream of its own (:mod:`repro_torch.experiments.streams`), up
to 8 ahead of the oldest bucket collected, so the one-warp chains of
independent buckets run side by side; buckets are collected and committed
in order. On the CPU each is collected as soon as it is issued, and a
sharded run stays serial. A bucket that raises is retried
with bounded backoff, then bisected so only truly-poisoned cells are
stranded in the sweep's ``quarantined`` record (a CUDA error is never
retried: it propagates); per-bucket wall time feeds an EWMA straggler
watchdog; and a :class:`~repro_torch.experiments.resilience.FaultPlan` can
inject deterministic failures for tests/CI. Completed buckets are committed
to the cache — and, for a
:class:`~repro_torch.experiments.cache.PersistentResultCache`, flushed to its
journal — immediately, so a crash never loses finished work.

Devices: both runners take ``device=None``, which means ``"cuda"``;
``device="cpu"`` runs the kernels' plain PyTorch versions, and with no card
and no explicit CPU they raise. A sharded run places each shard on its
plan's device. Each bucket's counters come to the host in ONE copy (the 11
counters stacked) once the bucket is collected, so a kernel fault raises
inside the bucket that caused it or an earlier one.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.dram import engine
from repro_torch.core.dram.engine import SimConfig, SimResult
from repro_torch.core.dram.metrics import (avg_read_latency,
                                           energy_from_result,
                                           ipc_from_result, row_hit_rate,
                                           sasel_per_act)
from repro_torch.core.dram.policies import Policy
from repro_torch.core.dram.trace import (ROW_SPACE_STRIDE, Trace,
                                         WorkloadProfile, generate_trace,
                                         stack_traces)
from repro_torch.experiments.cache import (ResultCache, finish_key,
                                          trace_digest)
from repro_torch.experiments.grid import (Cell, MixCell, MixGrid, SweepGrid,
                                          _json_safe)
from repro_torch.experiments import streams
from repro_torch.experiments.resilience import (FaultPlan, ResiliencePolicy,
                                                execute_buckets)
from repro_torch.experiments.sharding import (ShardPlan, StreamingAggregator,
                                              device_of, execute_sharded)
from repro_torch.fault.watchdog import StepWatchdog

_COUNTER_FIELDS = tuple(f.name for f in dataclasses.fields(SimResult))

#: Test seam + single choke point: every simulation a sweep performs goes
#: through this callable, as ``_SIMULATE(stacked, policy, config, device)``
#: (monkeypatch it to count engine invocations).
_SIMULATE = engine.simulate_stacked

_TRACE_CACHE: dict[tuple, Trace] = {}


def clear_trace_cache() -> None:
    _TRACE_CACHE.clear()


def trace_for(workload: WorkloadProfile, n_requests: int, config: SimConfig,
              seed: int, row_space_offset: int = 0,
              footprint_rows: int | None = None) -> Trace:
    """Memoized trace generation; geometry AND address mapping are part of
    the trace's identity (``config.mapping`` decodes the physical stream).

    ``row_space_offset`` shifts the hot-row address space (each core of a
    multi-core mix gets its own rows while sharing banks); ``footprint_rows``
    is the physical-address mode's dense-resident-set knob
    (docs/address-mapping.md).
    """
    key = (workload, n_requests, config.n_banks, config.n_subarrays, seed,
           row_space_offset, config.mapping, footprint_rows)
    tr = _TRACE_CACHE.get(key)
    if tr is None:
        with obs.span("frontend.generate_trace"):
            tr = generate_trace(workload, n_requests, n_banks=config.n_banks,
                                n_subarrays=config.n_subarrays, seed=seed,
                                row_space_offset=row_space_offset,
                                mapping=config.mapping,
                                footprint_rows=footprint_rows)
        _TRACE_CACHE[key] = tr
    return tr


def _bucket_key(cell: Cell | MixCell, n_requests: int) -> tuple:
    """Static signature: cells sharing it can share one batched call.

    Derived from the FULL config (like cell_key) so a future SimConfig field
    swept via config_axes can never land two different configs in one bucket.
    Shared by ``run_sweep`` and ``run_mix_sweep``.
    """
    return (int(cell.policy), dataclasses.astuple(cell.config), n_requests)


@dataclasses.dataclass
class CellResult:
    workload: WorkloadProfile
    policy: Policy
    config: SimConfig
    overrides: dict[str, Any]
    key: str
    cache_hit: bool
    counters: dict[str, int]

    @property
    def sim_result(self) -> SimResult:
        return SimResult(**{f: np.asarray(v) for f, v in self.counters.items()})

    @property
    def derived(self) -> dict[str, float]:
        res = self.sim_result
        e = energy_from_result(res)
        return {
            "ipc": float(ipc_from_result(res, self.workload)),
            "row_hit_rate": float(row_hit_rate(res)),
            "avg_read_latency_cpu": float(avg_read_latency(res)),
            "dynamic_nj": float(e["dynamic_nj"]),
            "total_nj": float(e["total_nj"]),
            "sasel_per_act": float(sasel_per_act(res)),
        }

    def to_json(self) -> dict[str, Any]:
        return {
            "workload": self.workload.name,
            "policy": self.policy.name,
            "overrides": {k: _json_safe(v) for k, v in self.overrides.items()},
            "key": self.key,
            "cache_hit": self.cache_hit,
            "counters": self.counters,
            "derived": self.derived,
        }


class SweepResult:
    """Results of one grid run, with paper-metric accessors.

    ``quarantined`` lists the cells (if any) stranded by the resilience
    layer after retries + bisection — see docs/experiments.md. Quarantined
    cells are absent from ``cells``; accessors raise when asked for one.
    """

    def __init__(self, grid: SweepGrid, cells: list[CellResult],
                 stats: dict[str, Any],
                 quarantined: list[dict[str, Any]] | None = None) -> None:
        self.grid = grid
        self.cells = cells
        self.stats = stats
        self.quarantined = quarantined or []
        #: Shard fragments (``repro.sweep-fragment/v1`` dicts) emitted by a
        #: sharded run; empty for the single-device path. Deliberately NOT
        #: part of ``to_json`` — the sweep artifact stays byte-compatible.
        self.fragments: list[dict[str, Any]] = []

    def select(self, policy: Policy | None = None,
               workload: str | None = None, **config_eq: Any) -> list[CellResult]:
        """Cells matching a policy / workload-name / SimConfig field values."""
        out = []
        for c in self.cells:
            if policy is not None and c.policy != policy:
                continue
            if workload is not None and c.workload.name != workload:
                continue
            if any(getattr(c.config, k) != v for k, v in config_eq.items()):
                continue
            out.append(c)
        return out

    def metric(self, name: str, policy: Policy | None = None,
               **config_eq: Any) -> np.ndarray:
        """[W]-vector of a counter or derived metric, in grid workload order."""
        sel = self.select(policy=policy, **config_eq)
        by_wl = {c.workload.name: c for c in sel}
        if len(by_wl) != len(sel):
            raise ValueError(
                f"selection for metric {name!r} is ambiguous "
                f"({len(sel)} cells, {len(by_wl)} workloads); add config filters")
        vals = []
        for w in self.grid.workloads:
            c = by_wl.get(w.name)
            if c is None:
                hint = (" or quarantined by the resilience layer "
                        f"({len(self.quarantined)} cells quarantined)"
                        if self.quarantined else "")
                raise ValueError(
                    f"no cell for workload {w.name!r} matching policy={policy} "
                    f"{config_eq} — was it pruned by the grid's where filter"
                    f"{hint}?")
            vals.append(c.counters[name] if name in c.counters
                        else c.derived[name])
        return np.asarray(vals, np.float64)

    def speedup_pct(self, policy: Policy, baseline: Policy = Policy.BASELINE,
                    **config_eq: Any) -> np.ndarray:
        """Per-workload cycle-time gain of `policy` over `baseline`, percent."""
        base = self.metric("total_cycles", policy=baseline, **config_eq)
        pol = self.metric("total_cycles", policy=policy, **config_eq)
        return (base / pol - 1.0) * 100.0

    def ipc_gain_pct(self, policy: Policy, baseline: Policy = Policy.BASELINE,
                     **config_eq: Any) -> np.ndarray:
        """Per-workload IPC gain of `policy` over `baseline`, percent."""
        base = self.metric("ipc", policy=baseline, **config_eq)
        pol = self.metric("ipc", policy=policy, **config_eq)
        return (pol / base - 1.0) * 100.0

    def to_json(self) -> dict[str, Any]:
        return {
            "schema_version": "repro.sweep/v1",
            "grid": self.grid.describe(),
            "stats": self.stats,
            "cells": [c.to_json() for c in self.cells],
            "quarantined": self.quarantined,
        }


def _resolve_plan(shards: "ShardPlan | int | None",
                  fragment_dir: str | None, device) -> ShardPlan | None:
    """``None`` = the exact single-device path (no aggregator, no fragments).
    An int becomes a plan over ``device`` when one is given, else over all
    CUDA devices; ``fragment_dir`` alone implies a 1-shard plan so streaming
    works without several devices. A :class:`ShardPlan` names its own
    devices, so it takes no ``device``."""
    if isinstance(shards, ShardPlan):
        if device is not None:
            raise ValueError("a ShardPlan names its own devices; pass "
                             "device= only with an int shard count")
        return shards
    devices = None if device is None else [device_of(device)]
    if shards is not None:
        return ShardPlan(int(shards), devices)
    return ShardPlan(1, devices) if fragment_dir is not None else None


def _host_counters(counters: torch.Tensor) -> np.ndarray:
    """Copy the stacked counters of a collected launch to the host at
    once."""
    return streams.to_host(counters)


@obs.spanned("sweep.run")
def run_sweep(grid: SweepGrid, cache: ResultCache | None = None, *,
              resilience: ResiliencePolicy | None = None,
              fault_plan: FaultPlan | None = None,
              shards: ShardPlan | int | None = None,
              fragment_dir: str | None = None,
              device=None) -> SweepResult:
    """Execute a grid: dedupe via cache, bucket by static shape, batch,
    unpack.

    Buckets run through the resilience layer (retry → bisect → quarantine;
    see :mod:`repro_torch.experiments.resilience`): a failing bucket strands
    only its truly-poisoned cells in ``SweepResult.quarantined`` instead of
    aborting the sweep, and each completed (sub-)bucket is committed to
    ``cache`` — journal included, for a persistent cache — in bucket order,
    before any later bucket is committed, so a crash or kill never loses
    finished cells. On a card up to 8 buckets are in flight at once.

    ``shards`` (a :class:`~repro_torch.experiments.sharding.ShardPlan` or an
    int) partitions every bucket's cell axis across devices and streams each
    shard's slice of the artifact as a ``repro.sweep-fragment/v1`` document
    (to ``fragment_dir`` when given). Per-cell counters are bit-identical
    to the single-device path — lanes of a batched bucket are independent —
    and faults strand only the poisoned shard's cells. See
    :mod:`repro_torch.experiments.sharding` and docs/experiments.md.

    ``device`` (``None`` = ``"cuda"``) is where every bucket runs, or, with
    an int ``shards``, the one device all shards share.
    """
    cache = cache if cache is not None else ResultCache()
    resilience = resilience or ResiliencePolicy()
    plan = _resolve_plan(shards, fragment_dir, device)
    dev = device_of(device) if plan is None else None
    t0 = time.perf_counter()
    cells = grid.expand()

    traces = [trace_for(c.workload, grid.n_requests, c.config, grid.seed,
                        footprint_rows=grid.footprint_rows)
              for c in cells]
    with obs.span("sweep.cell_key"):
        # cells of one trace share its digest; ``traces`` holds every trace
        # to the end of the call, so no id is reused within it
        digests: dict[int, Any] = {}
        keys = []
        for tr, c in zip(traces, cells):
            digest = digests.get(id(tr))
            if digest is None:
                digest = digests[id(tr)] = trace_digest(tr)
                obs.count("sweep.trace_digests")
            keys.append(finish_key(digest, tr, c.policy, c.config))

    # Partition: cached / to-simulate (deduping repeated keys within the sweep).
    counters_by_key: dict[str, dict[str, int]] = {}
    hit_keys: set[str] = set()
    pending: dict[tuple, list[int]] = {}   # bucket -> cell indices (first per key)
    seen_pending: set[str] = set()
    for i, (c, k) in enumerate(zip(cells, keys)):
        if k in counters_by_key or k in seen_pending:
            continue
        got = cache.get(k)
        if got is not None:
            counters_by_key[k] = got
            hit_keys.add(k)
        else:
            pending.setdefault(_bucket_key(c, grid.n_requests), []).append(i)
            seen_pending.add(k)

    # One batched simulator call per static-shape (sub-)bucket, fault-isolated:
    # issued on a stream of its own, collected in bucket order.
    issuer = streams.Issuer()

    def issue_bucket(idxs: list[int], device: torch.device):
        with obs.span("sweep.stack"):
            stacked = stack_traces([traces[i] for i in idxs])
        with issuer.launch(device) as launch:
            res = _SIMULATE(stacked, cells[idxs[0]].policy,
                            cells[idxs[0]].config, device=device)
            on_device = torch.stack([getattr(res, f)
                                     for f in _COUNTER_FIELDS])

        def collect() -> dict[int, dict[str, int]]:
            launch.wait()
            with obs.span("sweep.readback"):
                counters = _host_counters(on_device)
                return {i: {f: int(counters[k, b])
                            for k, f in enumerate(_COUNTER_FIELDS)}
                        for b, i in enumerate(idxs)}
        return collect

    def commit_bucket(out: dict[int, dict[str, int]]) -> None:
        for i, counters in out.items():
            counters_by_key[keys[i]] = counters
            cache.put(keys[i], counters)
        cache.flush()   # crash consistency: journal the bucket before moving on

    def q_record(q) -> dict[str, Any]:
        return {"index": q.index, "workload": cells[q.index].workload.name,
                "policy": cells[q.index].policy.name,
                "overrides": {k: _json_safe(v)
                              for k, v in cells[q.index].override_dict.items()},
                "key": keys[q.index], "bucket": q.bucket,
                "error": q.error, "attempts": q.attempts}

    agg = None
    if plan is None:
        report = execute_buckets(
            pending.values(), lambda idxs: issue_bucket(idxs, dev),
            commit_bucket, policy=resilience, fault_plan=fault_plan,
            watchdog=StepWatchdog(threshold=resilience.straggler_threshold),
            window=streams.window(dev))
    else:
        # Streaming-fragment path: every cell resolves exactly once — cache
        # hits (and their duplicate-key cells) up front via the prologue,
        # executed cells (and duplicates their key resolves) per shard commit.
        indices_by_key: dict[str, list[int]] = {}
        for i, k in enumerate(keys):
            indices_by_key.setdefault(k, []).append(i)

        def cell_json(i: int) -> dict[str, Any]:
            c, k = cells[i], keys[i]
            doc = CellResult(workload=c.workload, policy=c.policy,
                             config=c.config, overrides=c.override_dict,
                             key=k, cache_hit=k in hit_keys,
                             counters=counters_by_key[k]).to_json()
            return {"index": i, **doc}

        agg = StreamingAggregator(grid.describe(), len(cells),
                                  fragment_dir=fragment_dir, plan=plan)
        agg.prologue([(i, cell_json(i)) for i in range(len(cells))
                      if keys[i] in counters_by_key])

        def commit_shard(out: dict[int, dict[str, int]]) -> None:
            commit_bucket(out)
            agg.commit_cells([(j, cell_json(j)) for i in out
                              for j in indices_by_key[keys[i]]])

        report, _ = execute_sharded(
            pending.values(), issue_bucket, commit_shard,
            plan=plan, aggregator=agg, quarantine_record=q_record,
            policy=resilience, fault_plan=fault_plan,
            watchdog=StepWatchdog(threshold=resilience.straggler_threshold))

    quarantined = [q_record(q) for q in report.quarantined]
    results = [
        CellResult(workload=c.workload, policy=c.policy, config=c.config,
                   overrides=c.override_dict, key=k, cache_hit=k in hit_keys,
                   counters=counters_by_key[k])
        for c, k in zip(cells, keys) if k in counters_by_key
    ]
    stats = {
        "n_cells": len(cells),
        "n_unique": len(set(keys)),
        "cache_hits": len(hit_keys),
        # pending holds one index per unique key; quarantined ones never
        # produced counters, so they don't count as simulated
        "simulated_cells": (sum(len(v) for v in pending.values())
                            - len(report.quarantined)),
        "sim_batches": report.n_batches,
        "quarantined_cells": len(cells) - len(results),
        "elapsed_s": round(time.perf_counter() - t0, 4),
        **report.stats(),
    }
    if plan is not None:
        stats["sharding"] = {**plan.describe(),
                             "fragment_dir": fragment_dir,
                             "n_fragments": len(agg.fragments)}
    sweep = SweepResult(grid, results, stats, quarantined)
    if agg is not None:
        sweep.fragments = agg.fragments
    return sweep


# ---------------------------------------------------------------------------
# Multi-core mix sweeps (policy x scheduler x mix grids)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MixCellResult:
    """One (mix, policy, config) point of a :class:`MixGrid` run."""
    cell: MixCell
    counters: dict[str, int]          # shared-channel SimResult counters
    weighted_speedup: float
    core_cycles: list[int]            # per-core completion of its own stream
    alone_cycles: list[float]         # per-core run-alone baseline reference

    @property
    def policy(self) -> Policy:
        return self.cell.policy

    @property
    def config(self) -> SimConfig:
        return self.cell.config

    @property
    def mix_name(self) -> str:
        return self.cell.mix_name

    def to_json(self) -> dict[str, Any]:
        return {
            "mix": self.mix_name,
            "policy": self.cell.policy.name,
            "overrides": {k: _json_safe(v)
                          for k, v in self.cell.override_dict.items()},
            "counters": self.counters,
            "weighted_speedup": self.weighted_speedup,
            "core_cycles": self.core_cycles,
            "alone_cycles": self.alone_cycles,
        }


class MixSweepResult:
    """Results of one mix-grid run, with weighted-speedup accessors.

    ``quarantined`` mirrors :class:`SweepResult`: mix cells stranded by the
    resilience layer, absent from ``cells``.
    """

    def __init__(self, grid: MixGrid, cells: list[MixCellResult],
                 stats: dict[str, Any],
                 quarantined: list[dict[str, Any]] | None = None) -> None:
        self.grid = grid
        self.cells = cells
        self.stats = stats
        self.quarantined = quarantined or []
        #: Shard fragments from a sharded run (see :class:`SweepResult`).
        self.fragments: list[dict[str, Any]] = []

    def select(self, policy: Policy | None = None, mix: str | None = None,
               **config_eq: Any) -> list[MixCellResult]:
        out = []
        for c in self.cells:
            if policy is not None and c.policy != policy:
                continue
            if mix is not None and c.mix_name != mix:
                continue
            if any(getattr(c.config, k) != v for k, v in config_eq.items()):
                continue
            out.append(c)
        return out

    def weighted_speedups(self, policy: Policy,
                          **config_eq: Any) -> np.ndarray:
        """[M]-vector of weighted speedups in grid mix order."""
        sel = self.select(policy=policy, **config_eq)
        by_mix = {c.cell.mix_index: c for c in sel}
        if len(by_mix) != len(sel):
            raise ValueError(
                f"selection is ambiguous ({len(sel)} cells, {len(by_mix)} "
                f"mixes); add config filters (e.g. scheduler=...)")
        vals = []
        for i in range(len(self.grid.mixes)):
            c = by_mix.get(i)
            if c is None:
                hint = (" or quarantined by the resilience layer "
                        f"({len(self.quarantined)} cells quarantined)"
                        if self.quarantined else "")
                raise ValueError(
                    f"no cell for mix {i} matching policy={policy} {config_eq}"
                    f" — was it pruned by the grid's where filter{hint}?")
            vals.append(c.weighted_speedup)
        return np.asarray(vals, np.float64)

    def to_json(self) -> dict[str, Any]:
        return {
            "schema_version": "repro.sweep/v1",
            "kind": "mix_sweep",
            "grid": self.grid.describe(),
            "stats": self.stats,
            "cells": [c.to_json() for c in self.cells],
            "quarantined": self.quarantined,
        }


@obs.spanned("sweep.run")
def run_mix_sweep(grid: MixGrid, *,
                  resilience: ResiliencePolicy | None = None,
                  fault_plan: FaultPlan | None = None,
                  shards: ShardPlan | int | None = None,
                  fragment_dir: str | None = None,
                  device=None) -> MixSweepResult:
    """Execute a :class:`MixGrid`: bucket by static shape, batch over mixes.

    Each (policy, config) bucket becomes ONE
    :func:`repro_torch.core.dram.multicore.simulate_multicore_batch` call
    over the bucket's mixes ([M, C, N] stacked traces). The policy- and
    scheduler-independent run-alone baseline references are computed once per
    geometry/refresh point and shared across every policy x scheduler cell
    (mix results are not content-hash cached — the multicore scan dominates
    and mix grids are small). Buckets run through the same retry → bisect →
    quarantine isolation as :func:`run_sweep`, and ``shards``/``fragment_dir``
    stream per-shard ``repro.sweep-fragment/v1`` slices exactly like the
    single-core runner (mix sweeps have no cache, so no prologue fragment).
    ``device`` as in :func:`run_sweep`.
    """
    from repro_torch.core.dram import multicore
    from repro_torch.core.dram.schedulers import Scheduler

    resilience = resilience or ResiliencePolicy()
    plan = _resolve_plan(shards, fragment_dir, device)
    dev = device_of(device) if plan is None else None
    t0 = time.perf_counter()
    cells = grid.expand()

    def mix_traces(cell: MixCell) -> list[Trace]:
        return [trace_for(p, grid.n_requests, cell.config, grid.seed,
                          row_space_offset=ROW_SPACE_STRIDE * i,
                          footprint_rows=grid.footprint_rows)
                for i, p in enumerate(cell.profiles)]

    issuer = streams.Issuer()
    # Run-alone references: scheduler-independent (a single stream has a
    # single head request), so memoize on the config minus its scheduler.
    # Each is issued like a bucket's launch, and read when the first bucket
    # that needs it is collected: the memo holds its launch and its cycles
    # on the device, then on the host.
    alone_memo: dict[tuple, tuple[streams.Launch, torch.Tensor]] = {}
    alone_host: dict[tuple, np.ndarray] = {}

    def issue_alone(cell: MixCell, traces: list[Trace],
                    device: torch.device) -> tuple:
        """The memo's key of ``cell``'s run-alone launch, issued if new."""
        ref_cfg = dataclasses.replace(cell.config, scheduler=Scheduler.FCFS)
        key = (dataclasses.astuple(ref_cfg), cell.mix_index)
        if key not in alone_memo:
            with obs.span("sweep.alone"), issuer.launch(device) as launch:
                alone_memo[key] = launch, multicore.launch_alone_baseline(
                    [traces], ref_cfg, device=device)
        return key

    def alone_cycles(key: tuple) -> np.ndarray:
        if key not in alone_host:
            launch, total = alone_memo[key]
            launch.wait()
            with obs.span("sweep.readback"):
                alone_host[key] = streams.to_host(total)
        return alone_host[key]

    buckets: dict[tuple, list[int]] = {}
    for i, c in enumerate(cells):
        buckets.setdefault(_bucket_key(c, grid.n_requests), []).append(i)

    def issue_bucket(idxs: list[int], device: torch.device):
        bucket_cells = [cells[i] for i in idxs]
        traces = [mix_traces(c) for c in bucket_cells]
        alone = [issue_alone(c, tr, device)
                 for c, tr in zip(bucket_cells, traces)]
        with issuer.launch(device) as launch:
            shared, core_cycles = multicore.launch_multicore_batch(
                traces, bucket_cells[0].policy, bucket_cells[0].config,
                device=device)
            on_device = torch.stack([getattr(shared, f)
                                     for f in _COUNTER_FIELDS])

        def collect() -> dict[int, MixCellResult]:
            alone_all = np.concatenate([alone_cycles(k) for k in alone])
            launch.wait()
            with obs.span("sweep.readback"):
                mc = multicore.multicore_results(
                    traces, shared, streams.to_host(core_cycles), alone_all)
                counters_host = _host_counters(on_device)
                out: dict[int, MixCellResult] = {}
                for b, (i, res) in enumerate(zip(idxs, mc)):
                    counters = {f: int(counters_host[k, b])
                                for k, f in enumerate(_COUNTER_FIELDS)}
                    out[i] = MixCellResult(
                        cell=cells[i], counters=counters,
                        weighted_speedup=res.weighted_speedup,
                        core_cycles=[int(x) for x in res.core_cycles],
                        alone_cycles=[float(x) for x in res.alone_cycles])
                return out
        return collect

    results: dict[int, MixCellResult] = {}

    def q_record(q) -> dict[str, Any]:
        return {"index": q.index, "mix": cells[q.index].mix_name,
                "policy": cells[q.index].policy.name,
                "overrides": {k: _json_safe(v)
                              for k, v in cells[q.index].override_dict.items()},
                "bucket": q.bucket, "error": q.error, "attempts": q.attempts}

    agg = None
    if plan is None:
        report = execute_buckets(
            buckets.values(), lambda idxs: issue_bucket(idxs, dev),
            results.update, policy=resilience, fault_plan=fault_plan,
            watchdog=StepWatchdog(threshold=resilience.straggler_threshold),
            window=streams.window(dev))
    else:
        agg = StreamingAggregator(grid.describe(), len(cells),
                                  kind="mix_sweep",
                                  fragment_dir=fragment_dir, plan=plan)

        def commit_shard(out: dict[int, MixCellResult]) -> None:
            results.update(out)
            agg.commit_cells([(i, {"index": i, **out[i].to_json()})
                              for i in out])

        report, _ = execute_sharded(
            buckets.values(), issue_bucket, commit_shard,
            plan=plan, aggregator=agg, quarantine_record=q_record,
            policy=resilience, fault_plan=fault_plan,
            watchdog=StepWatchdog(threshold=resilience.straggler_threshold))

    quarantined = [q_record(q) for q in report.quarantined]
    stats = {
        "n_cells": len(cells),
        "n_cores": grid.n_cores,
        "sim_batches": report.n_batches,
        "quarantined_cells": len(cells) - len(results),
        "elapsed_s": round(time.perf_counter() - t0, 4),
        **report.stats(),
    }
    if plan is not None:
        stats["sharding"] = {**plan.describe(),
                             "fragment_dir": fragment_dir,
                             "n_fragments": len(agg.fragments)}
    mix_sweep = MixSweepResult(grid,
                               [results[i] for i in range(len(cells))
                                if i in results],
                               stats, quarantined)
    if agg is not None:
        mix_sweep.fragments = agg.fragments
    return mix_sweep
