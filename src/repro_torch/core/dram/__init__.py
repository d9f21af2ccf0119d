"""Subarray-level-parallelism DRAM timing simulator, in PyTorch + CUDA.

The port of ``repro.core.dram``, single-core path:

  * ``address_map.py``/``trace.py`` — the frontend (copied from the
                        reference): address mappings, the synthetic
                        32-workload suite, trace-file ingestion.
  * ``engine.py``     — bank/subarray timing state machine and the
                        ``simulate*`` entry points.
  * ``controller.py`` — controller steps: visibility, completion rings,
                        refresh bookkeeping, and (multicore) the
                        scheduler's argmin over the cores' heads.
  * ``schedulers.py`` — request schedulers and their ``request_key``.
  * ``multicore.py``  — multi-core shared-channel mixes and weighted
                        speedup.
  * ``cuda_step.py``  — the hand-written CUDA lane and mix kernels
                        (``csrc/lane_step.cu``, ``csrc/mix_step.cu``, both
                        on ``csrc/dram_step.cuh``) and their plain versions.
  * ``metrics.py``    — IPC / energy / latency metrics.

Command export, the checker and the sweep layer are not ported yet.
"""
from repro_torch.core.dram import registry
from repro_torch.core.dram.timing import (DramTiming, EnergyModel, CoreModel,
                                          DDR3_1066, LPDDR4_3200, PCM_PALP,
                                          MEMTECHS, resolve_memtech,
                                          DEFAULT_ENERGY, DEFAULT_CORE)
from repro_torch.core.dram.policies import Policy
from repro_torch.core.dram.refresh import RefreshPolicy, REFRESH_LADDER
from repro_torch.core.dram.schedulers import (Scheduler, ALL_SCHEDULERS,
                                              request_key)
from repro_torch.core.dram.address_map import (AddressMapping,
                                               BitSlicedMapping,
                                               ContiguousMapping,
                                               GoldenRatioMapping, XorMapping,
                                               DEFAULT_MAPPING,
                                               NAMED_MAPPINGS, mapping_for)
from repro_torch.core.dram.trace import (WorkloadProfile, Trace,
                                         generate_trace, PAPER_WORKLOADS,
                                         WORKLOADS_BY_NAME, workload,
                                         stack_traces, ROW_SPACE_STRIDE)
from repro_torch.core.dram.engine import (simulate, simulate_batch,
                                          simulate_stacked, SimConfig,
                                          SimResult)
from repro_torch.core.dram.multicore import (simulate_multicore,
                                             simulate_multicore_batch,
                                             alone_baseline_cycles,
                                             MulticoreResult)
from repro_torch.core.dram.metrics import (ipc_from_result,
                                           energy_from_result, summarize)

__all__ = [
    "registry",
    "DramTiming", "EnergyModel", "CoreModel", "DDR3_1066", "LPDDR4_3200",
    "PCM_PALP", "MEMTECHS", "resolve_memtech", "DEFAULT_ENERGY", "DEFAULT_CORE",
    "Policy", "RefreshPolicy", "REFRESH_LADDER", "Scheduler", "ALL_SCHEDULERS",
    "request_key",
    "AddressMapping", "BitSlicedMapping", "ContiguousMapping",
    "GoldenRatioMapping", "XorMapping", "DEFAULT_MAPPING", "NAMED_MAPPINGS",
    "mapping_for",
    "WorkloadProfile", "Trace", "generate_trace", "PAPER_WORKLOADS",
    "WORKLOADS_BY_NAME", "workload", "stack_traces", "ROW_SPACE_STRIDE",
    "simulate", "simulate_batch", "simulate_stacked", "SimConfig", "SimResult",
    "simulate_multicore", "simulate_multicore_batch", "alone_baseline_cycles",
    "MulticoreResult",
    "ipc_from_result", "energy_from_result", "summarize",
]
