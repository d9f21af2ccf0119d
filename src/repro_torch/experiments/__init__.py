"""Batched experiment-sweep subsystem (the port of ``repro.experiments``).

Express a paper evaluation as a declarative grid (policies x workloads x
``SimConfig`` axes) and execute it as batched kernel launches with shape
bucketing and a content-hashed result cache:

    from repro_torch.experiments import SweepGrid, run_sweep
    from repro_torch.core.dram import PAPER_WORKLOADS, Policy

    sweep = run_sweep(SweepGrid(
        name="sens_subarrays",
        workloads=PAPER_WORKLOADS,
        policies=(Policy.BASELINE, Policy.SALP1, Policy.MASA),
        config_axes={"n_subarrays": (1, 8, 64)},
    ), device="cuda")                                # or device="cpu"
    sweep.speedup_pct(Policy.MASA, n_subarrays=8)   # [W] percent gains

Cell keys, grid descriptions and the ``repro.sweep/v1`` /
``repro.sweep-fragment/v1`` artifacts equal the JAX package's. See
``docs/experiments.md`` for the grid API and artifact schema reference.
"""
from repro_torch.experiments.grid import Cell, MixCell, MixGrid, SweepGrid
from repro_torch.experiments.cache import (ResultCache,
                                           PersistentResultCache,
                                           GLOBAL_CACHE, cell_key,
                                           install_global_cache)
from repro_torch.experiments.resilience import (Fault, FaultPlan,
                                                ResiliencePolicy,
                                                SimulatedOOM, SweepKilled)
from repro_torch.experiments.runner import (CellResult, MixCellResult,
                                            MixSweepResult, SweepResult,
                                            run_mix_sweep, run_sweep,
                                            trace_for, clear_trace_cache)
from repro_torch.experiments.sharding import (Shard, ShardPlan,
                                              StreamingAggregator,
                                              load_fragments,
                                              merge_fragment_dir,
                                              merge_fragments)
from repro_torch.experiments.artifact import (SWEEP_SCHEMA, FRAGMENT_SCHEMA,
                                              BENCH_SCHEMA, bench_artifact,
                                              read_artifact, write_artifact)

__all__ = [
    "Cell", "MixCell", "MixGrid", "SweepGrid",
    "ResultCache", "PersistentResultCache", "GLOBAL_CACHE", "cell_key",
    "install_global_cache",
    "Fault", "FaultPlan", "ResiliencePolicy", "SimulatedOOM", "SweepKilled",
    "CellResult", "MixCellResult", "MixSweepResult", "SweepResult",
    "run_mix_sweep", "run_sweep", "trace_for", "clear_trace_cache",
    "Shard", "ShardPlan", "StreamingAggregator",
    "load_fragments", "merge_fragment_dir", "merge_fragments",
    "SWEEP_SCHEMA", "FRAGMENT_SCHEMA", "BENCH_SCHEMA",
    "bench_artifact", "read_artifact", "write_artifact",
]
