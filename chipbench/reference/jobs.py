"""What a job should produce, worked out by the frozen reference alone.

A job is the plain dict the traffic generator makes (``chipbench.traffic``):
one sweep of single-core cells (``kind`` "sweep") or one sweep of mixes
(``kind`` "mix"). :func:`expected` returns the job's answers keyed as the
harness keys the program's:

* ``("cell", workload, policy, point)``: the cell's counters, a tuple in
  :data:`~chipbench.reference.dram.COUNTERS` order;
* ``("gain", workload, policy, point)``: IPC gain over BASELINE, percent;
* ``("cell", mix, policy, point)``: the shared channel's counters, then
  the per-core completion cycles, then the run-alone baseline cycles;
* ``("ws", mix, policy, point)``: the mix's weighted speedup.

The work is cut into independent units (a workload's trace under every
policy; one mix under one policy and point; one mix's run-alone lanes) and
spread over a pool of worker processes that import only this package and
numpy.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os

import numpy as np

from chipbench.reference import dram, frontend
from chipbench.reference import metrics as M


def _timing(system: dict, point: dict, quantum: int) -> dram.Timing:
    """The point's timing; ``quantum`` > 1 rounds every interval up to a
    multiple of it (the coarser-resolution control)."""
    t = {**system["timing"], **point.get("timing", {})}
    if quantum > 1:
        t = {k: -(-v // quantum) * quantum for k, v in t.items()}
    return dram.Timing(**t)


def _point_setting(system: dict, point: dict, key: str):
    return point.get(key, system[key])


def allowed(point: dict, policy: str) -> bool:
    return policy in point.get("policies", (policy,))


def _trace(system, profile, n, seed, offset, quantum):
    if system["mapping"] != "golden":
        raise ValueError(f"the reference decodes the golden address map "
                         f"only, not {system['mapping']!r}")
    tr = frontend.generate(profile, n, system["n_banks"],
                           system["n_subarrays"], system["rows_per_bank"],
                           frontend.Core(**system["core"]), seed, offset)
    if quantum > 1:
        tr.gap = [-(-g // quantum) * quantum for g in tr.gap]
    return tr


def _lane_unit(args):
    """Every (policy, point) cell of one workload: counters and IPC."""
    system, job, w, quantum = args
    profile = frontend.load_suite(system["suite"])[w]
    tr = _trace(system, profile, job["n_requests"], job["seed"], 0, quantum)
    out = {}
    for k, point in enumerate(job["points"]):
        t = _timing(system, point, quantum)
        refresh = dram.REFRESH[_point_setting(system, point, "refresh_policy")]
        closed = _point_setting(system, point, "row_policy") == "closed"
        for pol in job["policies"]:
            if not allowed(point, pol):
                continue
            out[("cell", w, pol, k)] = dram.run_lane(
                tr, dram.POLICIES[pol], system["n_banks"],
                system["n_subarrays"], t, refresh, closed)
    return out


def _mix_traces(system, job, m, quantum):
    suite = frontend.load_suite(system["suite"])
    return [_trace(system, suite[w], job["n_requests"], job["seed"],
                   frontend.ROW_SPACE_STRIDE * i, quantum)
            for i, w in enumerate(job["mixes"][m])]


def _mix_unit(args):
    system, job, m, pol, k, quantum = args
    point = job["points"][k]
    traces = _mix_traces(system, job, m, quantum)
    suite = frontend.load_suite(system["suite"])
    mpkis = np.array([suite[w].mpki for w in job["mixes"][m]])
    ranks = np.argsort(np.argsort(mpkis)).astype(np.int32).tolist()
    counters, core_cycles = dram.run_mix(
        traces, ranks, dram.POLICIES[pol],
        dram.SCHEDULERS[point.get("scheduler", "FCFS")], system["n_banks"],
        system["n_subarrays"], _timing(system, point, quantum),
        dram.REFRESH[_point_setting(system, point, "refresh_policy")],
        _point_setting(system, point, "row_policy") == "closed")
    return {("mix", m, pol, k): (counters, core_cycles)}


def _alone_unit(args):
    """One mix's cores, each alone on the BASELINE system of a point."""
    system, job, m, k, quantum = args
    point = job["points"][k]
    t = _timing(system, point, quantum)
    refresh = dram.REFRESH[_point_setting(system, point, "refresh_policy")]
    closed = _point_setting(system, point, "row_policy") == "closed"
    cycles = [dram.run_lane(tr, dram.BASELINE, system["n_banks"],
                            system["n_subarrays"], t, refresh,
                            closed)["total_cycles"]
              for tr in _mix_traces(system, job, m, quantum)]
    return {("alone", m, k): cycles}


def _alone_key(system: dict, point: dict):
    """Run-alone cycles depend on the point's system, not its scheduler."""
    p = {k: v for k, v in point.items() if k not in ("scheduler", "policies")}
    return repr(sorted((k, repr(v)) for k, v in p.items()))


def units(job: dict, system: dict, quantum: int = 1):
    """The job's independent units of work, largest first."""
    if job["kind"] == "sweep":
        return [(_lane_unit, (system, job, w, quantum))
                for w in job["workloads"]]
    out = []
    alone_points = {}
    for k, point in enumerate(job["points"]):
        alone_points.setdefault(_alone_key(system, point), k)
        for m in range(len(job["mixes"])):
            for pol in job["policies"]:
                if allowed(point, pol):
                    out.append((_mix_unit, (system, job, m, pol, k, quantum)))
    for k in alone_points.values():
        for m in range(len(job["mixes"])):
            out.append((_alone_unit, (system, job, m, k, quantum)))
    return out


def _cost(job: dict, unit) -> int:
    fn = unit[0]
    if fn is _lane_unit:
        return job["n_requests"] * len(job["policies"]) * len(job["points"])
    return job["n_requests"] * len(job["mixes"][0])


def _call(unit):
    fn, args = unit
    return fn(args)


def assemble(job: dict, system: dict, parts: dict) -> dict:
    """The job's keyed answers from its units' results."""
    cpu_per_dram = system["core"]["cpu_per_dram"]
    out = {}
    if job["kind"] == "sweep":
        suite = frontend.load_suite(system["suite"])
        for key, counters in parts.items():
            out[key] = tuple(counters[c] for c in dram.COUNTERS)
        for (_, w, pol, k), counters in list(parts.items()):
            if pol == "BASELINE":
                continue
            base = parts[("cell", w, "BASELINE", k)]
            mpki = suite[w].mpki
            out[("gain", w, pol, k)] = M.ipc_gain_pct(
                M.ipc(counters, mpki, cpu_per_dram),
                M.ipc(base, mpki, cpu_per_dram))
        return out
    for key, value in parts.items():
        if key[0] != "mix":
            continue
        (_, m, pol, k), (counters, core_cycles) = key, value
        alone_k = next(j for j, p in enumerate(job["points"])
                       if _alone_key(system, p)
                       == _alone_key(system, job["points"][k]))
        alone = parts[("alone", m, alone_k)]
        out[("cell", m, pol, k)] = (
            tuple(counters[c] for c in dram.COUNTERS) + tuple(core_cycles)
            + tuple(float(a) for a in alone))
        out[("ws", m, pol, k)] = M.weighted_speedup(alone, core_cycles)
    return out


def expected(jobs: list[dict], system: dict, quantum: int = 1,
             workers: int | None = None) -> list[dict]:
    """Each job's keyed answers, computed over a pool of processes."""
    plan = [(j, u) for j, job in enumerate(jobs)
            for u in units(job, system, quantum)]
    # longest first, so the pool's last units are short ones
    plan.sort(key=lambda ju: -_cost(jobs[ju[0]], ju[1]))
    workers = workers or min(len(plan), os.cpu_count() or 1)
    if workers <= 1:
        results = [_call(u) for _, u in plan]
    else:
        ctx = multiprocessing.get_context("spawn")
        pool = ctx.Pool(workers)
        try:
            results = pool.map(_call, [u for _, u in plan], chunksize=1)
            pool.close()
        finally:
            pool.terminate()
            pool.join()
    parts = [{} for _ in jobs]
    for (j, _), r in zip(plan, results):
        parts[j].update(r)
    return [assemble(job, system, p) for job, p in zip(jobs, parts)]


def profile_fields(system: dict) -> dict:
    """The suite's profiles as plain field dicts (the harness builds the
    program's profiles from them)."""
    return {name: dataclasses.asdict(p)
            for name, p in frontend.load_suite(system["suite"]).items()}
