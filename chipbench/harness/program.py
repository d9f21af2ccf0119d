"""The system under test, seen from the benchmark: the port's sweep entry
points, driven with the inputs the benchmark makes, and their answers keyed
as :mod:`chipbench.reference.jobs` keys the reference's.

Everything of the program is imported inside these functions, so the
harness starts (and fails cleanly) where the program is absent.
"""
from __future__ import annotations

import dataclasses

from chipbench.harness.generator import allowed

COUNTERS = ("total_cycles", "n_requests", "n_act", "n_pre", "n_rd", "n_wr",
            "n_sasel", "n_hit", "sum_latency", "n_reads", "sa_open_cycles")


class Program:
    """The port's objects for one configuration: its system, its workload
    profiles (built from the benchmark's suite table) and its entry
    points."""

    def __init__(self, config: dict, device: str):
        from repro_torch.core.dram.engine import SimConfig
        from repro_torch.core.dram.timing import DramTiming
        from repro_torch.core.dram.trace import WorkloadProfile
        from chipbench.reference import jobs as ref_jobs

        self.config, self.device = config, device
        self.DramTiming = DramTiming
        self.base = SimConfig(
            n_banks=config["n_banks"], n_subarrays=config["n_subarrays"],
            timing=DramTiming(**config["timing"]), memtech=config["memtech"],
            row_policy=config["row_policy"], mapping=config["mapping"],
            refresh_policy=config["refresh_policy"])
        self.profiles = {name: WorkloadProfile(**fields) for name, fields
                         in ref_jobs.profile_fields(config).items()}
        self._check_defaults()

    def _check_defaults(self) -> None:
        """The sweep layer generates traces with the program's default core
        and rows a bank; the configuration states both, so they must
        agree."""
        import inspect
        from repro_torch.core.dram.timing import DEFAULT_CORE
        from repro_torch.core.dram.trace import generate_trace
        rows = inspect.signature(generate_trace).parameters[
            "rows_per_bank"].default
        have = dict(core=dataclasses.asdict(DEFAULT_CORE), rows_per_bank=rows)
        stated = {k: self.config[k] for k in have}
        if have != stated:
            raise ValueError(f"the program's defaults {have} are not the "
                             f"configuration's {stated}")

    def overrides(self, point: dict) -> dict:
        """A point's SimConfig overrides, as the program's types."""
        from repro_torch.core.dram.schedulers import Scheduler
        ov = {}
        for k, v in point.items():
            if k == "policies":
                continue
            if k == "scheduler":
                v = Scheduler[v]
            elif k == "timing":
                v = self.DramTiming(**{**self.config["timing"], **v})
            ov[k] = v
        return ov

    def grid(self, job: dict):
        from repro_torch.core.dram.policies import Policy
        from repro_torch.experiments import MixGrid, SweepGrid

        ovs = [self.overrides(p) for p in job["points"]]

        def where(pol, ov) -> bool:
            return allowed(job["points"][ovs.index(ov)], pol.name)

        common = dict(name=f"chipbench-{job['label']}",
                      policies=[Policy[p] for p in job["policies"]],
                      n_requests=job["n_requests"], seed=job["seed"],
                      base_config=self.base, configs=ovs, where=where)
        if job["kind"] == "sweep":
            return SweepGrid(workloads=[self.profiles[w]
                                        for w in job["workloads"]], **common)
        return MixGrid(mixes=[tuple(self.profiles[w] for w in m)
                              for m in job["mixes"]], **common)

    def make_traces(self, job: dict) -> None:
        """Generate the job's traces through the program's own memo, as a
        sweep's first call would."""
        from repro_torch.core.dram.trace import ROW_SPACE_STRIDE
        from repro_torch.experiments.runner import trace_for
        n, seed = job["n_requests"], job["seed"]
        if job["kind"] == "sweep":
            for w in job["workloads"]:
                trace_for(self.profiles[w], n, self.base, seed)
            return
        for m in job["mixes"]:
            for i, w in enumerate(m):
                trace_for(self.profiles[w], n, self.base, seed,
                          row_space_offset=ROW_SPACE_STRIDE * i)

    def run(self, job: dict, grid):
        """One job through the program's entry point."""
        from repro_torch.experiments import (ResultCache, run_mix_sweep,
                                             run_sweep)
        if job["kind"] == "sweep":
            return run_sweep(grid, cache=ResultCache(), device=self.device)
        return run_mix_sweep(grid, device=self.device)

    def answers(self, job: dict, result) -> tuple[dict, int]:
        """The result's answers keyed like the reference's, and the number
        of cells the program quarantined."""
        ovs = [self.overrides(p) for p in job["points"]]
        out = {}
        if job["kind"] == "sweep":
            from repro_torch.core.dram.policies import Policy
            for c in result.cells:
                k = ovs.index(c.overrides)
                out[("cell", c.workload.name, c.policy.name, k)] = tuple(
                    c.counters[f] for f in COUNTERS)
            for k, ov in enumerate(ovs):
                for pol in job["policies"]:
                    if pol == "BASELINE" or not allowed(job["points"][k],
                                                        pol):
                        continue
                    try:
                        gains = result.ipc_gain_pct(Policy[pol], **ov)
                    except ValueError:      # a quarantined cell
                        continue
                    for w, g in zip(job["workloads"], gains):
                        out[("gain", w, pol, k)] = float(g)
            return out, len(result.quarantined)
        for c in result.cells:
            k = ovs.index(c.cell.override_dict)
            key = (c.cell.mix_index, c.policy.name, k)
            out[("cell", *key)] = (tuple(c.counters[f] for f in COUNTERS)
                                   + tuple(c.core_cycles)
                                   + tuple(c.alone_cycles))
            out[("ws", *key)] = c.weighted_speedup
        return out, len(result.quarantined)

