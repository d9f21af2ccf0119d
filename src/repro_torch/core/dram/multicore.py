"""Multi-core shared-channel simulation (paper Sec. 4 / Sec. 9.3), in PyTorch.

The port of ``repro.core.dram.multicore``. ``C`` request streams share one
channel's banks. Each core issues its own requests in program order (the
same analytic OoO core as the single-core engine); the memory controller
(:mod:`repro_torch.core.dram.controller`) picks among the cores' head
requests with the configured scheduler (``SimConfig.scheduler``): FCFS,
FR-FCFS, FR-FCFS+SALP-aware, TCM-style application-aware ranking or PALP's
read priority. Refresh and the closed-row policy apply exactly as in
single-core, via ``SimConfig``.

Execution: the entry points run on the card unless the caller asks for the
CPU (``device=None`` means ``"cuda"``). On a CUDA device the mixes go
through ONE launch of the hand-written mix kernel and the run-alone
baselines through one launch of the lane kernel
(:mod:`repro_torch.core.dram.cuda_step`); on ``device="cpu"`` both run
their plain PyTorch versions; with no card and no explicit CPU they raise.

Metrics: weighted speedup = sum_i IPC_shared(i) / IPC_alone(i).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.compat import resolve_device
from repro_torch.core.dram import cuda_step
from repro_torch.core.dram.engine import (SimConfig, SimResult, mix_inputs,
                                          simulate_batch)
from repro_torch.core.dram.policies import Policy
from repro_torch.core.dram.schedulers import Scheduler
from repro_torch.core.dram.trace import Trace, WorkloadProfile, stack_traces


@dataclasses.dataclass
class MulticoreResult:
    shared: SimResult                # 0-d int32 tensors, on the run's device
    core_cycles: np.ndarray          # per-core completion of its own stream
    alone_cycles: np.ndarray         # per-core cycles when run ALONE on the BASELINE
    profiles: list[WorkloadProfile]

    @property
    def weighted_speedup(self) -> float:
        """Sum_i IPC_shared,i / IPC_alone-baseline,i, in float64.

        The alone reference is the *baseline* memory system for every
        policy, so cross-policy WS ratios reflect the full mechanism benefit
        (the paper's multi-core system-performance metric).
        """
        return float(np.sum(self.alone_cycles / np.maximum(self.core_cycles, 1)))


def _prep_mix(traces: list[Trace]) -> tuple[dict, np.ndarray]:
    """One mix's ``[C, N]`` stacked arrays and its TCM ranks.

    IDEAL's geometry rewrite is applied later, to the packed tensor
    (:func:`repro_torch.core.dram.engine.mix_inputs`).
    """
    # TCM-style ranking: lower MPKI -> higher priority (rank 0 first). numpy's
    # default sort, exactly as the reference: torch.argsort may order ties
    # differently
    mpkis = np.array([t.profile.mpki for t in traces])
    rank = np.argsort(np.argsort(mpkis)).astype(np.int32)
    return stack_traces(traces), rank


def _scheduler_for(config: SimConfig, use_ranking: bool) -> SimConfig:
    """Fold the deprecated ``use_ranking`` flag into ``config.scheduler``."""
    if use_ranking:
        return dataclasses.replace(config, scheduler=Scheduler.TCM)
    return config


def alone_baseline_cycles(mixes: list[list[Trace]],
                          config: SimConfig = SimConfig(),
                          device=None) -> np.ndarray:
    """Per-trace run-alone BASELINE cycles for all mixes, one batched call
    (one lane-kernel launch on the card), as a float64 array.

    Policy-independent, so callers comparing several policies over the same
    mixes should compute it once and pass it to
    :func:`simulate_multicore_batch`. The scheduler is normalized to FCFS:
    with a single stream it is inert.
    """
    cfg = dataclasses.replace(config, scheduler=Scheduler.FCFS)
    flat = [t for m in mixes for t in m]
    # simulate_batch validates the windows (controller.validate_mlp_window)
    res = simulate_batch(flat, Policy.BASELINE, cfg, device=device)
    return res.total_cycles.cpu().numpy().astype(np.float64)


def simulate_multicore_batch(mixes: list[list[Trace]], policy: Policy,
                             config: SimConfig = SimConfig(),
                             use_ranking: bool = False,
                             alone_cycles: np.ndarray | None = None,
                             device=None) -> list[MulticoreResult]:
    """Batched entry point: M mixes through one mix-kernel launch.

    All mixes must have the same core count and trace length; they are
    stacked into ``[M, C, N]`` tensors. ``alone_cycles`` (flat
    ``[sum_len(mixes)]`` array from :func:`alone_baseline_cycles`) skips
    recomputing the policy-independent run-alone references on every policy
    comparison. ``use_ranking=True`` is a deprecated alias for
    ``config.scheduler = Scheduler.TCM``.
    """
    config = _scheduler_for(config, use_ranking)
    cuda_step.check_no_emit(config)
    dev = resolve_device(device)
    prepped = [_prep_mix(m) for m in mixes]
    stacked = {k: np.stack([st[k] for st, _ in prepped])
               for k in prepped[0][0] if k != "addr"}
    ranks = np.stack([r for _, r in prepped])
    # mix_inputs validates the windows (controller.validate_mlp_window)
    eff, sched, nb, ns, reqs, mlp, rank = mix_inputs(stacked, ranks, policy,
                                                     config, dev)
    shared, core_cycles = cuda_step.simulate_cores(
        eff, sched, nb, ns, config.timing, config.refresh_mode, reqs, mlp,
        rank, closed_row=config.row_policy == "closed")

    alone_all = (alone_cycles if alone_cycles is not None
                 else alone_baseline_cycles(mixes, config, device=dev))
    core_host = core_cycles.cpu().numpy().astype(np.float64)
    out, pos = [], 0
    for i, m in enumerate(mixes):
        res_i = SimResult(**{f.name: getattr(shared, f.name)[i]
                             for f in dataclasses.fields(SimResult)})
        out.append(MulticoreResult(
            shared=res_i, core_cycles=core_host[i],
            alone_cycles=np.asarray(alone_all[pos:pos + len(m)], np.float64),
            profiles=[t.profile for t in m]))
        pos += len(m)
    return out


def simulate_multicore(traces: list[Trace], policy: Policy,
                       config: SimConfig = SimConfig(),
                       use_ranking: bool = False,
                       device=None) -> MulticoreResult:
    """Simulate one mix of traces sharing a channel (a batch of one)."""
    return simulate_multicore_batch([traces], policy, config, use_ranking,
                                    device=device)[0]
