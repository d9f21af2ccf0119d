"""The one traffic generator: a cell's configuration and traffic mix, as
data, and a seed give one pass of jobs.

A job is a plain dict that both the program's adapter
(:mod:`chipbench.harness.program`) and the frozen reference
(:mod:`chipbench.reference.jobs`) read:

* ``kind`` "sweep": the single-core cells ``workloads`` x ``policies`` x
  ``points``, every trace ``n_requests`` long (one ``run_sweep`` call);
* ``kind`` "mix": the mixes of cores sharing a channel, ``mixes`` x
  ``policies`` x ``points`` (one ``run_mix_sweep`` call).

A traffic file says how a pass is cut into jobs:

* ``"jobs": "per_workload"`` makes one sweep job a workload, in the listed
  order; each trace is ``round(instructions * MPKI / 1000)`` requests long
  (``instructions`` from the traffic file, else the configuration's
  ``instructions_per_workload``), so every workload runs for the same
  number of instructions;
* ``"jobs": "whole_grid"`` makes the whole grid one job (``mixes`` for a
  mix job, ``workloads`` for a sweep job), ``n_requests`` long a core (from
  the traffic file, else the configuration's ``requests_per_core``).

The configuration supplies the system, the ``policies`` compared and the
``points`` (SimConfig overrides such as a scheduler, each optionally
limited to some ``policies``).
"""
from __future__ import annotations

from chipbench.reference import frontend

#: int32 words of the kernels' fixed inputs and outputs
RQ_F, SC_F, TIMING_F = 6, 16, 19


def allowed(point: dict, policy: str) -> bool:
    """Is ``policy`` compared at ``point``?"""
    return policy in point.get("policies", (policy,))


def make_pass(config: dict, traffic: dict, seed: int) -> list[dict]:
    """One pass of the cell's jobs, in order."""
    base = dict(kind=traffic["entry"], policies=list(config["policies"]),
                points=list(config["points"]), seed=int(seed))
    if traffic["jobs"] == "per_workload":
        suite = frontend.load_suite(config["suite"])
        instr = traffic.get("instructions", config.get(
            "instructions_per_workload"))
        return [dict(base, label=w, workloads=[w],
                     n_requests=int(round(instr * suite[w].mpki / 1000)))
                for w in traffic["workloads"]]
    if traffic["jobs"] != "whole_grid":
        raise ValueError(f"unknown job cut {traffic['jobs']!r}")
    n = int(traffic.get("n_requests", config.get("requests_per_core")))
    job = dict(base, label="grid", n_requests=n)
    if base["kind"] == "mix":
        job["mixes"] = [list(m) for m in traffic["mixes"]]
    else:
        job["workloads"] = list(traffic["workloads"])
    return [job]


def cells(job: dict) -> list[tuple]:
    """The job's grid cells: (point, workload or mix, policy)."""
    items = job["workloads"] if job["kind"] == "sweep" else range(
        len(job["mixes"]))
    return [(k, x, pol) for k, point in enumerate(job["points"])
            for x in items for pol in job["policies"]
            if allowed(point, pol)]


def requests(job: dict) -> int:
    """Simulated requests of the job's grid cells (run-alone baselines are
    the program's own overhead and do not count)."""
    cores = 1 if job["kind"] == "sweep" else len(job["mixes"][0])
    return len(cells(job)) * cores * job["n_requests"]


def launches(job: dict) -> list[tuple]:
    """The kernel launches the job's grid asks for, from its shapes: one a
    (policy, point) bucket, and for mixes one lane launch a mix and
    distinct run-alone system. Each is ``(kernel, steps, bytes)``: the
    serial steps of the launch's chains and the bytes its inputs and
    outputs must move at least once."""
    n = job["n_requests"]
    buckets = {(k, pol) for k, _, pol in cells(job)}
    if job["kind"] == "sweep":
        b = len(job["workloads"])
        return [("lane_step", n, _lane_bytes(b, n))] * len(buckets)
    m, c = len(job["mixes"]), len(job["mixes"][0])
    mix_bytes = 4 * (m * c * n * RQ_F + 2 * m * c + TIMING_F + m * SC_F
                     + 2 * m * c)
    alone = {_alone_key(p) for p in job["points"]}
    return ([("mix_step", c * n, mix_bytes)] * len(buckets)
            + [("lane_step", n, _lane_bytes(c, n))] * (len(alone) * m))


def _lane_bytes(b: int, n: int) -> int:
    return 4 * (b * n * RQ_F + b + TIMING_F + b * (SC_F + 2))


def _alone_key(point: dict) -> str:
    return repr(sorted((k, repr(v)) for k, v in point.items()
                       if k not in ("scheduler", "policies")))
