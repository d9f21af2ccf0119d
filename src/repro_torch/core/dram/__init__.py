"""Subarray-level-parallelism DRAM timing simulator, in PyTorch + CUDA.

The port of ``repro.core.dram``, single-core path:

  * ``address_map.py``/``trace.py`` — the frontend (copied from the
                        reference): address mappings, the synthetic
                        32-workload suite, trace-file ingestion.
  * ``engine.py``     — bank/subarray timing state machine and the
                        ``simulate*`` entry points.
  * ``controller.py`` — single-core controller step: visibility, completion
                        ring, refresh bookkeeping.
  * ``cuda_step.py``  — the hand-written CUDA lane kernel
                        (``csrc/lane_step.cu``) and its plain version.
  * ``metrics.py``    — IPC / energy / latency metrics.

The multicore path, command export and the checker are not ported yet.
"""
from repro_torch.core.dram import registry
from repro_torch.core.dram.timing import (DramTiming, EnergyModel, CoreModel,
                                          DDR3_1066, LPDDR4_3200, PCM_PALP,
                                          MEMTECHS, resolve_memtech,
                                          DEFAULT_ENERGY, DEFAULT_CORE)
from repro_torch.core.dram.policies import Policy
from repro_torch.core.dram.refresh import RefreshPolicy, REFRESH_LADDER
from repro_torch.core.dram.schedulers import Scheduler, ALL_SCHEDULERS
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
from repro_torch.core.dram.metrics import (ipc_from_result,
                                           energy_from_result, summarize)

__all__ = [
    "registry",
    "DramTiming", "EnergyModel", "CoreModel", "DDR3_1066", "LPDDR4_3200",
    "PCM_PALP", "MEMTECHS", "resolve_memtech", "DEFAULT_ENERGY", "DEFAULT_CORE",
    "Policy", "RefreshPolicy", "REFRESH_LADDER", "Scheduler", "ALL_SCHEDULERS",
    "AddressMapping", "BitSlicedMapping", "ContiguousMapping",
    "GoldenRatioMapping", "XorMapping", "DEFAULT_MAPPING", "NAMED_MAPPINGS",
    "mapping_for",
    "WorkloadProfile", "Trace", "generate_trace", "PAPER_WORKLOADS",
    "WORKLOADS_BY_NAME", "workload", "stack_traces", "ROW_SPACE_STRIDE",
    "simulate", "simulate_batch", "simulate_stacked", "SimConfig", "SimResult",
    "ipc_from_result", "energy_from_result", "summarize",
]
