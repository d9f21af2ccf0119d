"""Simulator-throughput benchmark: the port's perf trajectory.

Measures requests simulated a second and the first-call vs warm split of the
DRAM kernels across policies x geometries x core counts, plus a **backend
axis** (the lane kernel, ``cuda``, against its plain PyTorch version,
``plain``, on the same card and the same trace) and a per-step
microbenchmark (ns a step at two trace lengths per backend). On
``device="cpu"`` every cell runs the plain versions and the backend axis has
``plain`` alone.

Besides the CSV rows, ``run()`` writes ``artifacts/torch/BENCH_perf.json``
(:data:`OUT_PATH`), a standalone ``repro.bench/v1`` artifact (git SHA and
seed embedded): the port's throughput trajectory. Its ``trajectory`` field
carries the previous artifact's summary points forward (each run appends the
artifact it replaces). ``artifacts/BENCH_perf.json`` is the JAX package's
trajectory; nothing here reads or writes it.

The port of the repo's ``benchmarks/perf_bench.py``, with these deliberate
differences:

* the backend axis is ``cuda`` against ``plain``, and ``kernel_vs_plain``
  has the shape of the reference's ``kernel_vs_scan``;
* no scan or lanes ``unroll`` cells and no ``scan_unroll_default``: they
  tune the reference's XLA scans, which the port does not have;
* no ``REF_REQ_PER_S`` / ``speedup_vs_ref``: the reference's origin point is
  a 2-vCPU CPU host's figure, no target for the card;
* "cold" is a cell's first call in the process. ``compile_s`` (cold minus
  warm) is kept for the schema: here it is what a first call costs beyond a
  warm one (building the kernel's library with nvcc where no build is
  cached, loading it, first allocations), not a compile of the cell;
* the plain version takes about 2 ms a step on the card, so its cells keep
  the best of :data:`PLAIN_REPEATS` warm calls, the kernel's of
  :data:`WARM_REPEATS`; each cell records its count.

    python -m repro_torch.benchmarks.perf_bench [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import time

import torch

from repro_torch.benchmarks.common import COMMANDS_DIR, SEED, emit

#: requests per single-core cell / per core in multicore cells
N_PERF = 2000
#: best-of-N warm timing of a kernel cell
WARM_REPEATS = 10
#: best-of-N warm timing of a plain cell (about 2 ms a step on the card)
PLAIN_REPEATS = 2
#: the per-step microbenchmark's shorter trace (the longer is N_PERF)
N_SHORT = 500

#: Where the trajectory artifact lands (relative to the invoking CWD, like
#: every other artifact path of the port's benches).
OUT_PATH = os.path.join(COMMANDS_DIR, "BENCH_perf.json")


def _prior_trajectory() -> list[dict]:
    """The predecessor artifact's trajectory + its own summary point.

    Reading the file this run will overwrite chains the points: every
    artifact carries every earlier point, so the req/s trail survives
    regeneration without any external index."""
    try:
        with open(OUT_PATH) as f:
            prev = json.load(f)
    except (OSError, json.JSONDecodeError):
        return []
    perf = (prev.get("results") or {}).get("perf") or {}
    by_name = {c.get("name"): c.get("req_per_s")
               for c in perf.get("cells", ())}
    point = {
        "git_sha": prev.get("git_sha"),
        "created_unix": prev.get("created_unix"),
        "default_req_per_s": perf.get("default_req_per_s"),
        "batch32_req_per_s": by_name.get("batch32/MASA/8x8"),
        "multicore2_req_per_s": by_name.get("multicore2/MASA/FRFCFS/8x8"),
        "host": perf.get("host"),
    }
    return list(prev.get("trajectory") or []) + [point]


def _call(fn) -> None:
    """One call, waited for: the counters come back to the host."""
    fn().cpu()


def _warm_best(fn, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _call(fn)
        best = min(best, time.perf_counter() - t0)
    return best


def _cell(name: str, n_requests: int, fn, repeats: int) -> dict:
    """Time one benchmark cell: its first call (cold) then warm best-of-N."""
    t0 = time.perf_counter()
    _call(fn)
    cold_s = time.perf_counter() - t0
    warm_s = _warm_best(fn, repeats)
    req_per_s = n_requests / warm_s
    cell = {
        "name": name,
        "n_requests": n_requests,
        "cold_s": round(cold_s, 4),
        "warm_s": round(warm_s, 6),
        "compile_s": round(max(cold_s - warm_s, 0.0), 4),
        "req_per_s": round(req_per_s, 1),
        "repeats": repeats,
    }
    emit(f"perf.{name}", warm_s * 1e6,
         f"{req_per_s / 1e3:.1f}k_req/s;compile={cell['compile_s']}s")
    return cell


def _plain_lanes(traces, policy, config, device):
    """The lane kernel's plain version on ``device`` (the card too): what
    ``simulate_batch`` runs on a CPU device, without the kernel."""
    from repro_torch.core.dram import cuda_step, engine, stack_traces

    eff, nb, ns, xs, mlp = engine.lane_inputs(stack_traces(traces), policy,
                                              config, device)
    sc, vis, _ = cuda_step.simulate_lanes_plain(
        eff, nb, ns, config.timing, config.refresh_mode, xs, mlp,
        closed_row=config.row_policy == "closed")
    return engine.result_from_state(xs.shape[1], sc, vis).total_cycles


def run(device=None) -> dict:
    from repro_torch.compat import resolve_device
    from repro_torch.core.dram import (PAPER_WORKLOADS, ROW_SPACE_STRIDE,
                                       Policy, Scheduler, SimConfig, simulate,
                                       simulate_batch, simulate_multicore,
                                       workload)
    from repro_torch.experiments import bench_artifact, write_artifact
    from repro_torch.experiments.runner import trace_for

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    # the entry points run the kernel on the card, the plain version on a CPU
    main_backend = "cuda" if on_card else "plain"
    reps = WARM_REPEATS if on_card else PLAIN_REPEATS
    cells = []

    # ---- single-core: policy x geometry (lbm, memory-intensive) ----------
    for policy in (Policy.BASELINE, Policy.MASA):
        for nb, ns in ((8, 8), (16, 8), (8, 16)):
            if policy == Policy.BASELINE and (nb, ns) != (8, 8):
                continue  # geometry sensitivity is the mechanisms' story
            cfg = SimConfig(n_banks=nb, n_subarrays=ns)
            tr = trace_for(workload("lbm"), N_PERF, cfg, SEED)
            cells.append(_cell(
                f"single/{policy.name}/{nb}x{ns}", N_PERF,
                lambda tr=tr, policy=policy, cfg=cfg:
                    simulate(tr, policy, cfg, device=dev).total_cycles,
                reps))

    # ---- batched suite: the sweep-runner primitive ------------------------
    cfg = SimConfig()
    batch = [trace_for(p, N_PERF, cfg, SEED) for p in PAPER_WORKLOADS]
    cells.append(_cell(
        "batch32/MASA/8x8", N_PERF * len(batch),
        lambda: simulate_batch(batch, Policy.MASA, device=dev).total_cycles,
        reps))

    # ---- backend axis: the lane kernel vs its plain version ---------------
    # The main backend's rows reuse the cells above (same process, same
    # trace); on the card the plain version gets its own single + batch32
    # cells, so the kernel-vs-plain ratios come from one host state.
    by_name = {c["name"]: c for c in cells}
    backends = {main_backend: {
        "single_req_per_s": by_name["single/MASA/8x8"]["req_per_s"],
        "batch32_req_per_s": by_name["batch32/MASA/8x8"]["req_per_s"],
    }}
    tr = trace_for(workload("lbm"), N_PERF, cfg, SEED)
    if on_card:
        c_single = _cell("single/MASA/8x8/plain", N_PERF,
                         lambda: _plain_lanes([tr], Policy.MASA, cfg, dev),
                         PLAIN_REPEATS)
        c_batch = _cell("batch32/MASA/8x8/plain", N_PERF * len(batch),
                        lambda: _plain_lanes(batch, Policy.MASA, cfg, dev),
                        PLAIN_REPEATS)
        cells.extend([c_single, c_batch])
        backends["plain"] = {"single_req_per_s": c_single["req_per_s"],
                             "batch32_req_per_s": c_batch["req_per_s"]}
        by_name.update({c["name"]: c for c in (c_single, c_batch)})

    # ---- per-step microbenchmark: ns/step per backend x trace length ------
    # Fixed dispatch/launch overhead amortizes with N, so the two lengths
    # separate per-step cost from per-call cost. The N_PERF row is the
    # backend's single/MASA/8x8 cell (the same call on the same trace).
    per_step = {}
    trs = trace_for(workload("lbm"), N_SHORT, cfg, SEED)
    for backend in backends:
        plain_on_card = on_card and backend == "plain"
        fn = ((lambda: _plain_lanes([trs], Policy.MASA, cfg, dev))
              if plain_on_card else
              (lambda: simulate(trs, Policy.MASA, cfg,
                                device=dev).total_cycles))
        _call(fn)
        short_s = _warm_best(fn, PLAIN_REPEATS if plain_on_card else reps)
        long_cell = by_name["single/MASA/8x8/plain" if plain_on_card
                            else "single/MASA/8x8"]
        row = {f"n{N_SHORT}": round(short_s / N_SHORT * 1e9, 1),
               f"n{N_PERF}": round(long_cell["warm_s"] / N_PERF * 1e9, 1)}
        per_step[backend] = row
        emit(f"perf.step_ns.{backend}", 0.0,
             ";".join(f"{k}={v}ns" for k, v in row.items()))

    # ---- multicore: core-count scaling under FR-FCFS ----------------------
    for names in (("mcf", "lbm"), ("mcf", "lbm", "milc", "libquantum")):
        mix = [trace_for(workload(m), N_PERF, cfg, SEED,
                         row_space_offset=ROW_SPACE_STRIDE * i)
               for i, m in enumerate(names)]
        mcfg = SimConfig(scheduler=Scheduler.FRFCFS)
        cells.append(_cell(
            f"multicore{len(mix)}/MASA/FRFCFS/8x8", N_PERF * len(mix),
            lambda mix=mix, mcfg=mcfg: simulate_multicore(
                mix, Policy.MASA, mcfg, device=dev).shared.total_cycles,
            reps))

    host = {"platform": platform.system().lower() + "-" + platform.machine(),
            "cpu_count": os.cpu_count(),
            "device": (torch.cuda.get_device_name(dev) if on_card
                       else "cpu")}
    default_cell = by_name["single/MASA/8x8"]
    kernel_vs_plain = None
    if on_card:
        kernel_vs_plain = {
            "kernel_backend": "cuda",
            "single": round(backends["cuda"]["single_req_per_s"]
                            / backends["plain"]["single_req_per_s"], 3),
            "batch32": round(backends["cuda"]["batch32_req_per_s"]
                             / backends["plain"]["batch32_req_per_s"], 3),
        }
    summary = {
        "default_req_per_s": default_cell["req_per_s"],
        "host": host,
        "backends": backends,
        "per_step_ns": per_step,
        # same-process kernel-vs-plain ratios (validate --perf-guard reads
        # them); None where no kernel ran (a CPU device)
        "kernel_vs_plain": kernel_vs_plain,
        "warm_repeats": WARM_REPEATS,
        "plain_repeats": PLAIN_REPEATS,
        "n_cells": len(cells),
        "cells": cells,
    }

    trajectory = _prior_trajectory()
    doc = bench_artifact(results={"perf": summary}, sweeps=[],
                         argv=["perf_bench"], seed=SEED)
    doc["trajectory"] = trajectory
    path = write_artifact(OUT_PATH, doc)
    if trajectory:
        last = trajectory[-1]
        for key, cell_name in (
                ("default_req_per_s", "single/MASA/8x8"),
                ("batch32_req_per_s", "batch32/MASA/8x8"),
                ("multicore2_req_per_s", "multicore2/MASA/FRFCFS/8x8")):
            now = next((c["req_per_s"] for c in cells
                        if c["name"] == cell_name), None)
            if now and last.get(key):
                emit(f"perf.trajectory.{key}", 0.0,
                     f"{now / last[key]:.2f}x_vs_{str(last.get('git_sha'))[:8]}")
    emit("perf.artifact", 0.0, path)
    return summary


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain version")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    print(run(args.device))
