"""Registry-driven benchmark runner (the port of the repo's
``benchmarks/run.py``).

Usage:
    python -m repro_torch.benchmarks.run [--suite paper,sens,...]
                                         [--only fig4,fig5,...]
                                         [--out artifacts/torch/bench.json]
                                         [--journal PATH]
                                         [--inject-faults SPEC]
                                         [--shards N] [--mesh SPEC]
                                         [--fragments DIR]
                                         [--device cuda|cpu]
                                         [--list]

``--device`` is where every bench runs (``None`` = the card; ``cpu`` runs
the kernels' plain versions). ``--journal PATH`` (or
``REPRO_CACHE_JOURNAL``) swaps the process-wide result cache for a
journal-backed ``PersistentResultCache``: completed cells replay from disk,
so a killed run resumes instead of restarting. ``--inject-faults SPEC`` (or
``REPRO_FAULT_PLAN``; see ``repro_torch.experiments.FaultPlan.parse`` for the
grammar) injects deterministic per-bucket faults so a drill exercises the
retry/bisect/quarantine machinery on the real pipeline.

``--shards N`` / ``--mesh SPEC`` (or ``REPRO_SHARDS`` / ``REPRO_MESH``)
install a ``repro_torch.experiments.ShardPlan``: every sweep partitions its
buckets' cell axes across the mesh's devices (``--mesh auto`` = all CUDA
devices; ``gpu:2`` = the first two; ``cpu`` = torch's one CPU device, so
``cpu:4`` selects one) with bit-identical results; ``--shards N`` without
``--mesh`` puts N shards on ``--device`` when one is given. ``--fragments
DIR`` (or ``REPRO_FRAGMENTS``) streams each shard's slice of the artifact to
``DIR/<grid>/fragment-NNNN.json`` as it completes — re-mergeable and
re-checkable via ``repro_torch.benchmarks.validate --check-shards``.

Each registry entry is a module exposing ``run(device=None) -> dict`` (its
summary). Benchmarks built on the sweep subsystem share one process-wide
result cache, so overlapping cells (every mechanism's baseline, notably) are
simulated once.

Output: ``name,us_per_call,derived`` CSV rows on stdout (one per paper
table/figure entry) plus a single versioned JSON artifact (schema
``repro.bench/v1``, see docs/experiments.md) containing every summary, every
sweep's full per-cell results, and cache statistics. Its default path is
under ``artifacts/torch/``, beside (never over) the JAX runner's artifacts.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import os
import sys
import time


@dataclasses.dataclass(frozen=True)
class Bench:
    key: str
    module: str
    suites: tuple[str, ...]
    desc: str


_B = "repro_torch.benchmarks."

REGISTRY: tuple[Bench, ...] = (
    Bench("fig4", _B + "fig4_ipc", ("paper",),
          "Figure 4: IPC vs mechanism (32 workloads x 5 policies)"),
    Bench("fig5", _B + "fig5_energy", ("paper",),
          "Figure 5: dynamic energy + row-hit rate"),
    Bench("sens_subarrays", _B + "sens_subarrays", ("sens",),
          "Sec. 9.2: gains vs subarrays-per-bank (grid sweep)"),
    Bench("sens_banks", _B + "sens_banks", ("sens",),
          "Sec. 9.2/1: more-banks cost vs MASA (grid sweep)"),
    Bench("row_policy", _B + "row_policy_bench", ("sens",),
          "Sec. 9.3: open vs closed row policy"),
    Bench("refresh", _B + "refresh_bench", ("refresh",),
          "Sec. 6.1 extension: refresh ladder REFab/REFpb/DARP/SARP/DSARP "
          "x 8-32 Gb (grid sweep)"),
    Bench("memtech", _B + "memtech_bench", ("memtech",),
          "DDR3/LPDDR4/PCM-PALP technology packs — SALP ladder per "
          "memtech, PALP_RP read-priority on PCM, zero-REF PCM stream"),
    Bench("multicore", _B + "multicore_bench", ("system",),
          "Sec. 4/9.3: multicore + TCM scheduling (batched mixes)"),
    Bench("sched", _B + "sched_bench", ("system", "sched"),
          "Sec. 4/9.3: policy x scheduler x mix grid, refresh on"),
    Bench("mapping", _B + "mapping_bench", ("mapping",),
          "Frontend: address-mapping x policy sensitivity (dense footprint)"),
    Bench("perf", _B + "perf_bench", ("perf",),
          "Simulator throughput trajectory (writes "
          "artifacts/torch/BENCH_perf.json)"),
    Bench("kernels", "repro_torch.kernel_bench", ("accel", "kernel"),
          "Layer B: the five accelerator kernels vs their plain oracles "
          "(validated artifact, like smoke/mapping/perf/refresh)"),
    Bench("serving", _B + "serving_bench", ("accel",),
          "Layer C: SALP-aware scheduler"),
    Bench("smoke", _B + "smoke", ("smoke",),
          "Tiny grid through the full sweep pipeline"),
)

#: The runner's default artifact path (the JAX runner's is
#: ``artifacts/bench.json``).
OUT_DEFAULT = "artifacts/torch/bench.json"


def select(suite: str | None, only: str | None) -> list[Bench]:
    suites = set(suite.split(",")) if suite else None
    keys = set(only.split(",")) if only else None
    out = []
    for b in REGISTRY:
        if keys is not None and b.key not in keys:
            continue
        if keys is None:
            if suites is not None and not suites.intersection(b.suites):
                continue
            if suites is None and "smoke" in b.suites:
                continue  # smoke only runs when asked for
        out.append(b)
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--suite", type=str, default=None,
                    help="comma-separated suites: "
                         + ",".join(sorted({s for b in REGISTRY for s in b.suites})))
    ap.add_argument("--only", type=str, default=None,
                    help="comma-separated keys (overrides --suite): "
                         + ",".join(b.key for b in REGISTRY))
    ap.add_argument("--out", type=str, default=OUT_DEFAULT,
                    help="path for the versioned JSON artifact ('' to disable)")
    ap.add_argument("--journal", type=str,
                    default=os.environ.get("REPRO_CACHE_JOURNAL", ""),
                    help="persistent result-cache journal (JSONL); completed "
                         "cells replay from it across processes ('' = "
                         "in-memory only)")
    ap.add_argument("--inject-faults", type=str, metavar="SPEC",
                    default=os.environ.get("REPRO_FAULT_PLAN", ""),
                    help="deterministic fault plan, e.g. "
                         "'oom@b0:x1,raise@c4:p' (see "
                         "repro_torch.experiments.FaultPlan.parse)")
    ap.add_argument("--shards", type=int, metavar="N",
                    default=int(os.environ.get("REPRO_SHARDS", "0")) or None,
                    help="partition every sweep bucket into N shards across "
                         "the device mesh (default: one per mesh device when "
                         "--mesh is given, else unsharded)")
    ap.add_argument("--mesh", type=str, metavar="SPEC",
                    default=os.environ.get("REPRO_MESH", ""),
                    help="device mesh spec: 'auto' (all CUDA devices), 'N' "
                         "(first N), or 'platform[:N]' e.g. 'gpu:2' or 'cpu'")
    ap.add_argument("--fragments", type=str, metavar="DIR",
                    default=os.environ.get("REPRO_FRAGMENTS", ""),
                    help="stream per-shard repro.sweep-fragment/v1 documents "
                         "under DIR/<grid>/ ('' = in-memory only)")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu for the kernels' plain "
                         "versions")
    ap.add_argument("--list", action="store_true", help="list registry and exit")
    args = ap.parse_args(argv)

    if args.list:
        for b in REGISTRY:
            print(f"{b.key:15s} [{','.join(b.suites)}] {b.desc}")
        return {}

    known_suites = {s for b in REGISTRY for s in b.suites}
    known_keys = {b.key for b in REGISTRY}
    if args.suite and not set(args.suite.split(",")) <= known_suites:
        ap.error(f"unknown suite(s) {set(args.suite.split(',')) - known_suites}; "
                 f"choose from {sorted(known_suites)}")
    if args.only and not set(args.only.split(",")) <= known_keys:
        ap.error(f"unknown benchmark(s) {set(args.only.split(',')) - known_keys}; "
                 f"see --list")

    from repro_torch import experiments
    from repro_torch.benchmarks import common

    saved = (common.FAULT_PLAN, common.SHARD_PLAN, common.FRAGMENT_DIR,
             experiments.GLOBAL_CACHE)
    try:
        return _run(args, argv, common)
    finally:
        # main(argv) may be called repeatedly in one process: a journal, a
        # fault plan or a shard plan holds for its own invocation only
        (common.FAULT_PLAN, common.SHARD_PLAN, common.FRAGMENT_DIR,
         cache) = saved
        experiments.install_global_cache(cache)


def _run(args, argv, common) -> dict:
    from repro_torch.experiments import bench_artifact, write_artifact

    if args.journal:
        from repro_torch.experiments import (PersistentResultCache,
                                             install_global_cache)
        install_global_cache(PersistentResultCache(args.journal))
    if args.inject_faults:
        from repro_torch.experiments import FaultPlan
        common.FAULT_PLAN = FaultPlan.parse(args.inject_faults)
    if args.shards or args.mesh:
        from repro_torch.experiments import ShardPlan
        if args.mesh or args.device is None:
            common.SHARD_PLAN = ShardPlan.resolve(args.shards, args.mesh or None)
        else:
            common.SHARD_PLAN = ShardPlan(args.shards, [args.device])
    if args.fragments:
        common.FRAGMENT_DIR = args.fragments

    from repro_torch.experiments import GLOBAL_CACHE

    # scope the artifact to THIS invocation: main(argv) may be called
    # repeatedly in one process (sweeps accumulate; cache stats are cumulative)
    sweeps_start = len(common.SWEEPS)
    hits0, misses0 = GLOBAL_CACHE.hits, GLOBAL_CACHE.misses

    print("name,us_per_call,derived")
    if args.only and args.suite:
        print(f"# note: --only={args.only} overrides --suite={args.suite}")
    summaries: dict[str, dict] = {}
    for b in select(args.suite, args.only):
        try:
            mod = importlib.import_module(b.module)
        except ModuleNotFoundError as e:
            print(f"{b.key}.SKIPPED,0.0,module_missing:{e.name}")
            continue
        t0 = time.perf_counter()
        try:
            summaries[b.key] = mod.run(device=args.device)
        except Exception as e:  # a failing bench must not hide the others
            print(f"{b.key}.FAILED,0.0,{type(e).__name__}:{e}")
            continue
        print(f"{b.key}.TOTAL,{(time.perf_counter()-t0)*1e6:.0f},ok")

    run_sweeps = common.SWEEPS[sweeps_start:]
    run_cache = {"entries": len(GLOBAL_CACHE), "hits": GLOBAL_CACHE.hits - hits0,
                 "misses": GLOBAL_CACHE.misses - misses0}
    if args.journal:
        # journal provenance: where completed cells persist, how many were
        # replayed from a previous process
        run_cache.update({k: v for k, v in GLOBAL_CACHE.stats().items()
                          if k in ("journal", "loaded", "dropped")})
    sharding = None
    if common.SHARD_PLAN is not None:
        sharding = {**common.SHARD_PLAN.describe(),
                    "fragment_dir": common.FRAGMENT_DIR}
    doc = bench_artifact(results=summaries, sweeps=run_sweeps,
                         argv=list(argv) if argv is not None else sys.argv[1:],
                         cache_stats=run_cache, seed=common.SEED,
                         fault_injection=args.inject_faults or None,
                         sharding=sharding)
    if args.out:
        path = write_artifact(args.out, doc)
        print(f"\n# artifact: {path} ({doc['schema_version']}, "
              f"sha={doc['git_sha'][:12]}, seed={doc['seed']}, "
              f"{len(run_sweeps)} sweeps, cache={run_cache})")

    print("\n# ---- summary vs paper ----")
    for key, summary in summaries.items():
        print(f"# {key}: {summary}")
    return doc


if __name__ == "__main__":
    main()
