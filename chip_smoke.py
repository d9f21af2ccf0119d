#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only; it imports nothing of the JAX
package. Phases, each of which fails the run (non-zero exit, no result line)
on any mismatch:

1. card       — the device's name and count, and nvidia-smi's name and
                power limit; the kernels need compute capability 9.0 and
                nvcc.
2. build      — compile every kernel from the sources in the checkout, one
                nvcc per source, all at once (``-Xptxas -v``: registers,
                spills).
3. golden     — the 300 single-core cells of
                ``tests/data/golden_packed_state.json`` through the lane
                kernel, bit-exact.
4. plain      — lane kernel vs its plain PyTorch version on the card, random
                traces for every (config, policy) pair, all counters.
5. mc_golden  — the 88 multicore cells of the same fixture through the mix
                kernel, counters and per-core cycles bit-exact.
6. mc_plain   — mix kernel vs its plain version on the card, random mixes:
                every scheduler x policy under the default config and DARP,
                every config under FR-FCFS x {BASELINE, MASA}, geometries
                8x8 and 4x16, C = 1, 2 and 4 (a 1-core mix also equals the
                lane kernel).
7. fig4       — main path one: the paper's Fig. 4 grid (32 workloads x 5
                policies x 8000 requests, seed 7) through
                ``repro_torch.paper_repro.run_fig4`` on the card. Exactly
                one lane-kernel launch per policy; the counters equal
                ``tests/data/torch_fig4_n8000.json`` (made by the JAX
                package) and the plain version on the card.
8. multicore  — main path two: ``paper_repro.run_multicore`` (four 4-core
                mixes x 1500 requests) and ``run_sched`` (x 1000, refresh
                on) on the card. Exactly 17 mix-kernel and 2 lane-kernel
                launches; every cell equals
                ``tests/data/torch_multicore_fixture.json`` (made by the JAX
                package); MASA under FR-FCFS also equals the plain version.
9. timing     — CUDA-event times of both kernels and their plain versions at
                the main paths' shapes and at throughput shapes, beside the
                byte bound.
10. ssd       — the SSD-scan kernel vs its plain version on the card, in
                float32 (rtol = atol = 2e-4) and bfloat16 (2e-2), at
                tests/test_kernels.py's sweep, mamba2-780m's serve shape,
                jamba's SSM shape and chunk 256 with ds 128; the decay-bound
                property and no NaN at a huge dt.
11. serve     — main path three: ``repro_torch.launch.serve``'s path with
                the fixture's arguments (mamba2-780m at full width, fp32,
                4 requests x 256 prompt tokens x 16 new, MASA). Weights equal
                the fixture's numpy stream (sha256 of every leaf);
                ``EngineStats`` equal ``tests/data/torch_serve_mamba2_780m.json``
                (made by the JAX package); every request's tokens equal the
                fixture's up to its first near-tie step (top-1/top-2 gap
                under 1e-2); exactly 4 x 48 = 192 SSD-scan launches.
12. logits    — teacher-forced: the fixture's tokens through ``prefill`` and
                ``decode_step``; every step's logits at the fixture's top-8
                ids within rtol = atol = 1e-3.
13. profile   — ``torch.profiler`` trace of one request's prefill and its
                16 decode steps: the card's busy and idle share, and the
                SSD-scan and matmul kernels' device time (reported, not
                checked: the trace may hold no device activity there).
14. ssd_time  — CUDA-event times of the SSD-scan kernel and its plain
                version at the serve shape and at L = 2048, beside the bound.

Each phase prints its seconds. The last lines are nvidia-smi's name and
power limit, the per-kernel JSON record, and ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the 32-bit
#: non-tensor-core rate, the nearest table entry for the kernel's int32 ops.
HBM_BYTES_PER_S = 3.35e12
PEAK_32BIT_OPS_PER_S = 67e12
#: int32 operations of one open-row, refresh-off step of dram_step.cuh's
#: timing step with its visibility (the ACT / column max-chains, state and
#: counter updates), and of keying one more head in mix_step.cu (visibility,
#: open-row read, tiers, compare).
OPS_PER_STEP = 80
OPS_PER_HEAD = 40

FIG4_N, FIG4_SEED = 8000, 7
THROUGHPUT_SEEDS = 32
#: The mix kernel's throughput shape: the four mixes x 64 seeds, 8000
#: requests a core, MASA under FR-FCFS.
MIX_THROUGHPUT_SEEDS, MIX_THROUGHPUT_N = 64, 8000
#: Mix-kernel and lane-kernel launches of run_multicore + run_sched.
MULTICORE_LAUNCHES = {"lane_step": 2, "mix_step": 7 + 10}
#: H100 SXM fp32 (non-tensor-core) peak, for the SSD scan's FMA loops.
PEAK_FP32_FLOPS = 67e12
#: The SSD scan's timing shapes (B, L, H, hd, ds, chunk): mamba2-780m's
#: serve shape (torch_cases.SSD_SERVE) and the same at L = 2048.
SSD_LONG = (1, 2048, 48, 64, 128, 64)
#: SSD-scan launches of the serve path: one per layer per admitted request.
SERVE_SSD_LAUNCHES = 4 * 48


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str = "") -> None:
    print(msg, flush=True)


def phase_card():
    from repro_torch import compat

    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    log(f"[card] {name} x{count}; nvidia-smi: {smi}")
    log(f"[card] {compat.summary()}")
    reason = compat.kernel_unavailable_reason()
    if reason:
        fail(reason)
    return name, count, smi


def phase_build():
    from repro_torch import cuda_build
    from repro_torch.core.dram import cuda_step
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    t0 = time.perf_counter()
    built = cuda_build.build({**cuda_step.SOURCES, **ssd_kernel.SOURCES})
    for name in cuda_step.SOURCES:
        cuda_step._library(name)
    ssd_kernel._library()
    log(f"[build] {', '.join(p.name for p, _ in built.values())} in "
        f"{time.perf_counter() - t0:.2f}s")
    for name, (_, build_log) in built.items():
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {name}: {line.strip()}")


def phase_golden():
    import torch_cases as tc
    from repro_torch.core.dram import Policy, SimConfig, simulate_stacked

    bad, n = [], 0
    for (cfg, pol), cells in tc.golden_groups().items():
        res = simulate_stacked(tc.golden_stacked(cells), Policy[pol],
                               SimConfig(**tc.CONFIGS[cfg]), device="cuda")
        res_h = {f: v.cpu() for f, v in vars(res).items()}
        for b, c in enumerate(cells):
            n += 1
            got = {f: int(v[b]) for f, v in res_h.items()}
            if got != c["counters"]:
                bad.append((cfg, pol, c["seed"], got, c["counters"]))
    if bad:
        fail(f"golden: {len(bad)} of {n} cells differ, e.g. {bad[:2]}")
    log(f"[golden] {n} cells bit-exact through the lane kernel")


def phase_mc_golden():
    import torch_cases as tc
    from repro_torch.core.dram import Policy, simulate_multicore_batch
    from repro_torch.paper_repro import COUNTERS

    bad, n = [], 0
    for (cfg, sched, pol), cells in tc.golden_multicore_groups().items():
        res = simulate_multicore_batch(
            [tc.golden_mix(c["seed"]) for c in cells], Policy[pol],
            tc.golden_multicore_config(cfg, sched), device="cuda")
        for r, c in zip(res, cells):
            n += 1
            got = {f: int(getattr(r.shared, f)) for f in COUNTERS}
            core = [int(x) for x in r.core_cycles]
            if got != c["counters"] or core != c["core_cycles"]:
                bad.append((cfg, sched, pol, c["seed"], got, core))
    if bad:
        fail(f"mc_golden: {len(bad)} of {n} cells differ, e.g. {bad[:2]}")
    log(f"[mc_golden] {n} multicore cells bit-exact through the mix kernel")


def random_mix_args(config, pol, M: int, C: int, N: int, seed: int):
    """mix_inputs of M random mixes of C cores on the card."""
    import torch_cases as tc
    from repro_torch.core.dram import stack_traces
    from repro_torch.core.dram.engine import mix_inputs

    st = [stack_traces([tc.random_trace(seed + 17 * m + c, n=N,
                                        nb=config.n_banks,
                                        ns=config.n_subarrays)
                        for c in range(C)]) for m in range(M)]
    stacked = {k: np.stack([x[k] for x in st]) for k in st[0]}
    rng = np.random.default_rng(seed)
    ranks = np.stack([rng.permutation(C) for _ in range(M)]).astype(np.int32)
    return mix_inputs(stacked, ranks, pol, config, torch.device("cuda"))


def mix_kernel_result(args, config):
    from repro_torch.core.dram import cuda_step

    eff, sched, nb, ns, reqs, mlp, rank = args
    return cuda_step.simulate_cores(eff, sched, nb, ns, config.timing,
                                    config.refresh_mode, reqs, mlp, rank,
                                    closed_row=config.row_policy == "closed")


def mix_plain_result(args, config):
    from repro_torch.core.dram import cuda_step, engine

    eff, sched, nb, ns, reqs, mlp, rank = args
    sc, vis, maxc = cuda_step.simulate_cores_plain(
        eff, sched, nb, ns, config.timing, config.refresh_mode, reqs, mlp,
        rank, closed_row=config.row_policy == "closed")
    C, N = reqs.shape[1], reqs.shape[2]
    return engine.result_from_state(C * N, sc, vis.amax(dim=1)), maxc


def mix_err(got, ref) -> int:
    return max(max_abs_diff(got[0], ref[0]),
               int((got[1].long() - ref[1].long()).abs().max()))


def phase_mc_plain() -> int:
    import torch_cases as tc
    from repro_torch.core.dram import Policy, Scheduler, SimConfig

    geometries = ((8, 8), (4, 16))
    cases = []
    for cfg in ("default", "darp"):
        for sched in Scheduler:
            for pol in Policy:
                cases.append((cfg, sched, pol, 4, 24))
    for cfg in tc.CONFIGS:
        for pol in (Policy.BASELINE, Policy.MASA):
            cases.append((cfg, Scheduler.FRFCFS, pol, 2, 48))
    for cfg in ("default", "darp", "closed_refresh", "sarp"):
        cases.append((cfg, Scheduler.FRFCFS, Policy.SALP2, 1, 96))
    err, n_lane = 0, 0
    for k, (cfg, sched, pol, C, N) in enumerate(cases):
        nb, ns = geometries[k % len(geometries)]
        config = SimConfig(n_banks=nb, n_subarrays=ns, scheduler=sched,
                           **tc.CONFIGS[cfg])
        args = random_mix_args(config, pol, 8, C, N, 3000 + 11 * k)
        got = mix_kernel_result(args, config)
        e = mix_err(got, mix_plain_result(args, config))
        if e:
            fail(f"mc_plain: mix kernel != plain for config {cfg} ({nb}x{ns})"
                 f", scheduler {sched.name}, policy {pol.name}, C={C}")
        if C == 1:
            eff, _, nb_, ns_, reqs, mlp, _ = args
            lane, lane_max = kernel_result(eff, nb_, ns_, config,
                                           reqs[:, 0].contiguous(),
                                           mlp[:, 0].contiguous())
            if max_abs_diff(lane, got[0]) or not torch.equal(
                    lane_max, got[1][:, 0]):
                fail(f"mc_plain: a 1-core mix differs from the lane kernel "
                     f"for config {cfg}")
            n_lane += 1
        err = max(err, e)
    log(f"[mc_plain] mix kernel == plain on the card for {len(cases)} "
        f"(config, scheduler, policy, C) cases x 8 mixes; {n_lane} 1-core "
        f"cases also == the lane kernel")
    return err


def plain_result(eff, nb, ns, config, xs, mlp):
    from repro_torch.core.dram import cuda_step, engine

    sc, vis, maxc = cuda_step.simulate_lanes_plain(
        eff, nb, ns, config.timing, config.refresh_mode, xs, mlp,
        closed_row=config.row_policy == "closed")
    return engine.result_from_state(xs.shape[1], sc, vis), maxc


def kernel_result(eff, nb, ns, config, xs, mlp):
    from repro_torch.core.dram import cuda_step

    return cuda_step.simulate_lanes(
        eff, nb, ns, config.timing, config.refresh_mode, xs, mlp,
        closed_row=config.row_policy == "closed")


def max_abs_diff(a, b) -> int:
    from repro_torch.paper_repro import COUNTERS

    return max(int((getattr(a, f).long() - getattr(b, f).long()).abs().max())
               for f in COUNTERS)


def phase_plain():
    import torch_cases as tc
    from repro_torch.core.dram import Policy, SimConfig, stack_traces
    from repro_torch.core.dram.engine import lane_inputs

    dev = torch.device("cuda")
    geometries = ((8, 8), (4, 16), (2, 32))
    n = 0
    for k, (cfg, kw) in enumerate(tc.CONFIGS.items()):
        nb, ns = geometries[k % len(geometries)]
        config = SimConfig(n_banks=nb, n_subarrays=ns, **kw)
        for pol in Policy:
            traces = [tc.random_trace(1000 + 8 * k + j, n=256, nb=nb, ns=ns)
                      for j in range(8)]
            args = lane_inputs(stack_traces(traces), pol, config, dev)
            got, got_max = kernel_result(*args[:3], config, *args[3:])
            ref, ref_max = plain_result(*args[:3], config, *args[3:])
            if max_abs_diff(got, ref) or not torch.equal(got_max, ref_max):
                fail(f"plain: kernel != plain for config {cfg} "
                     f"({nb}x{ns}), policy {pol.name}")
            n += 1
    log(f"[plain] kernel == plain on the card for {n} (config, policy) "
        f"pairs x 8 lanes x 256 requests")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(B: int, N: int):
    """(bound_ms, bound_by) of one lane launch: inputs read once (requests,
    windows, timing), outputs written once (counters, vis, max_comp)."""
    from repro_torch.core.dram import state_layout as L

    nbytes = 4 * (B * N * L.RQ_F + B + 19 + B * (L.SC_F + 2))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = B * N * OPS_PER_STEP / PEAK_32BIT_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_fig4():
    import torch_cases as tc
    from repro_torch.core.dram import SimConfig, cuda_step, stack_traces
    from repro_torch.core.dram.engine import lane_inputs
    from repro_torch import paper_repro as pr

    # ---- the main path, counted
    cuda_step.reset_launches()
    t0 = time.perf_counter()
    results = pr.run_fig4(FIG4_N, FIG4_SEED, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_step.LAUNCHES)
    log(f"[fig4] run_fig4(n={FIG4_N}, seed={FIG4_SEED}) on the card: "
        f"{wall:.3f}s wall incl. trace generation; launches {launches}")
    if launches["lane_step"] != len(pr.POLICIES):
        fail(f"fig4: expected {len(pr.POLICIES)} lane-kernel launches, "
             f"counted {launches['lane_step']}")
    for pol, res in results.items():
        for f in pr.COUNTERS:
            v = getattr(res, f)
            if (v.shape != (len(pr.PAPER_WORKLOADS),) or v.dtype != torch.int32
                    or not v.is_cuda):
                fail(f"fig4: {pol.name}.{f} is {v.dtype} {tuple(v.shape)} "
                     f"on {v.device}")
    cells, fixture = pr.cell_counters(results), tc.fig4_fixture()
    if set(cells) != set(fixture):
        fail("fig4: cell set differs from the committed fixture")
    bad = [k for k in fixture if cells[k] != fixture[k]]
    if bad:
        fail(f"fig4: {len(bad)} of {len(fixture)} cells differ from "
             f"{Path(tc.FIG4_PATH).name}, e.g. {bad[:3]}")
    log(f"[fig4] all {len(fixture)} cells equal {Path(tc.FIG4_PATH).name}")
    log(pr.report(pr.summary(results, FIG4_N)))

    # ---- kernel vs plain on the card, same inputs; plain timed once each
    config, dev = SimConfig(), torch.device("cuda")
    stacked = stack_traces(pr.fig4_traces(FIG4_N, FIG4_SEED))
    inputs = {pol: lane_inputs(stacked, pol, config, dev) for pol in pr.POLICIES}
    err, plain_ms = 0, []
    for pol, args in inputs.items():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ref, _ = plain_result(*args[:3], config, *args[3:])
        end.record()
        torch.cuda.synchronize()
        plain_ms.append(start.elapsed_time(end))
        err = max(err, max_abs_diff(results[pol], ref))
    if err:
        fail(f"fig4: kernel and plain differ on the card by up to {err}")
    log(f"[fig4] kernel == plain on the card (max abs err {err})")

    # ---- kernel timing at the Fig. 4 shapes
    kernel_ms = [time_ms(lambda a=args: kernel_result(*a[:3], config, *a[3:]),
                         reps=20) for args in inputs.values()]
    B, N = len(pr.PAPER_WORKLOADS), FIG4_N
    for pol, k, p in zip(inputs, kernel_ms, plain_ms):
        log(f"[timing] fig4 {pol.name:8s} B={B} N={N}: kernel {k:.4f} ms, "
            f"plain {p:.1f} ms")
    return dict(launches=launches["lane_step"], max_abs_err=err,
                ms=sum(kernel_ms) / len(kernel_ms),
                plain_ms=sum(plain_ms) / len(plain_ms), B=B, N=N)


def phase_throughput(smi: str):
    from repro_torch.core.dram import (PAPER_WORKLOADS, Policy, SimConfig,
                                       generate_trace, stack_traces)
    from repro_torch.core.dram.engine import lane_inputs

    config = SimConfig()
    traces = [generate_trace(w, FIG4_N, seed=FIG4_SEED + s)
              for s in range(THROUGHPUT_SEEDS) for w in PAPER_WORKLOADS]
    args = lane_inputs(stack_traces(traces), Policy.MASA, config,
                       torch.device("cuda"))
    B, N = args[3].shape[0], args[3].shape[1]
    k_ms = time_ms(lambda: kernel_result(*args[:3], config, *args[3:]), reps=10)
    p_ms = time_ms(lambda: plain_result(*args[:3], config, *args[3:]), reps=1,
                   warmup=0)
    b_ms, _ = bound(B, N)
    log(f"[timing] throughput MASA B={B} N={N}: kernel {k_ms:.4f} ms "
        f"({B * N / k_ms * 1e3:.4e} req/s), plain {p_ms:.1f} ms "
        f"({B * N / p_ms * 1e3:.4e} req/s), byte bound {b_ms:.5f} ms; "
        f"card {smi}")
    return dict(B=B, N=N, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms)


def mix_bound(M: int, C: int, N: int):
    """(bound_ms, bound_by) of one mix launch: inputs read once (requests,
    windows, ranks, timing), outputs written once (counters, vis_prev,
    max_comp); operations C * N steps a mix, each keying C heads."""
    from repro_torch.core.dram import state_layout as L

    nbytes = 4 * (M * C * N * L.RQ_F + 2 * M * C + 19
                  + M * (L.SC_F + 2 * C))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (M * C * N * (OPS_PER_STEP + C * OPS_PER_HEAD)
             / PEAK_32BIT_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_multicore(smi: str):
    import torch_cases as tc
    from repro_torch import interop
    from repro_torch.core.dram import Policy, Scheduler, SimConfig, cuda_step
    from repro_torch.core.dram.engine import mix_inputs
    from repro_torch.core.dram.multicore import _prep_mix
    from repro_torch import paper_repro as pr

    # ---- the main path, counted
    cuda_step.reset_launches()
    t0 = time.perf_counter()
    mc = pr.run_multicore(pr.MULTICORE_N, FIG4_SEED, device="cuda")
    sc = pr.run_sched(pr.SCHED_N, FIG4_SEED, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_step.LAUNCHES)
    log(f"[multicore] run_multicore(n={pr.MULTICORE_N}) + run_sched("
        f"n={pr.SCHED_N}) on the card: {wall:.3f}s wall incl. trace "
        f"generation; launches {launches}")
    if launches != MULTICORE_LAUNCHES:
        fail(f"multicore: expected launches {MULTICORE_LAUNCHES}, counted "
             f"{launches}")
    for per_mix in list(mc.values()) + list(sc.values()):
        for r in per_mix:
            if (not r.shared.total_cycles.is_cuda
                    or r.shared.total_cycles.dtype != torch.int32
                    or r.core_cycles.shape != (len(pr.MIXES[0]),)):
                fail("multicore: a result is not an int32 card tensor with "
                     "one cycle count per core")
    fixture = tc.multicore_fixture()
    cells = {("multicore",) + k: v for k, v in pr.mix_cells(mc).items()}
    cells.update({("sched",) + k: v for k, v in pr.mix_cells(sc).items()})
    if set(cells) != set(fixture):
        fail("multicore: cell set differs from the committed fixture")
    bad = [k for k, v in fixture.items()
           if cells[k] != {f: v[f] for f in ("counters", "core_cycles",
                                             "alone_cycles")}]
    if bad:
        fail(f"multicore: {len(bad)} of {len(fixture)} cells differ from "
             f"{Path(tc.MULTICORE_PATH).name}, e.g. {bad[:3]}")
    log(f"[multicore] all {len(fixture)} cells equal "
        f"{Path(tc.MULTICORE_PATH).name}")
    log(pr.multicore_report(pr.multicore_summary(mc), pr.sched_summary(sc)))

    # ---- kernel vs plain at full size (MASA, FR-FCFS); plain timed once
    def bench_args(pol, sched, n, seeds):
        prepped = [_prep_mix(pr.mix_traces(m, n, seed))
                   for seed in seeds for m in pr.MIXES]
        stacked = {k: np.stack([p[0][k] for p in prepped])
                   for k in interop.STACKED_FIELDS}
        ranks = np.stack([p[1] for p in prepped])
        config = SimConfig(scheduler=sched)
        return mix_inputs(stacked, ranks, pol, config,
                          torch.device("cuda")), config

    args, config = bench_args(Policy.MASA, Scheduler.FRFCFS, pr.MULTICORE_N,
                              [FIG4_SEED])
    got = mix_kernel_result(args, config)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = mix_plain_result(args, config)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = mix_err(got, ref)
    if err:
        fail(f"multicore: kernel and plain differ on the card by up to {err}")
    log(f"[multicore] MASA FR-FCFS n={pr.MULTICORE_N}: kernel == plain on "
        f"the card (max abs err {err})")

    # ---- timing at the bench shape (each of run_multicore's points)
    M, C, N = len(pr.MIXES), len(pr.MIXES[0]), pr.MULTICORE_N
    points = ([(pol, Scheduler.FRFCFS) for pol in pr.POLICIES]
              + [(Policy.BASELINE, Scheduler.TCM), (Policy.MASA, Scheduler.TCM)])
    kernel_ms = []
    for pol, sched in points:
        a, cfg = bench_args(pol, sched, N, [FIG4_SEED])
        kernel_ms.append(time_ms(lambda a=a, c=cfg: mix_kernel_result(a, c),
                                 reps=10))
        log(f"[timing] multicore {pol.name:8s} {sched.name:6s} M={M} C={C} "
            f"N={N}: kernel {kernel_ms[-1]:.4f} ms")
    ms = sum(kernel_ms) / len(kernel_ms)
    b_ms, b_by = mix_bound(M, C, N)
    log(f"[timing] multicore per launch (mean of {len(points)} points): "
        f"kernel {ms:.4f} ms, plain (MASA FR-FCFS) {plain_ms:.1f} ms, bound "
        f"{b_ms:.5f} ms ({b_by}); {M * C * N / ms * 1e3:.4e} req/s; card {smi}")

    # ---- throughput shape
    seeds = range(FIG4_SEED, FIG4_SEED + MIX_THROUGHPUT_SEEDS)
    a, cfg = bench_args(Policy.MASA, Scheduler.FRFCFS, MIX_THROUGHPUT_N, seeds)
    tM, tN = a[4].shape[0], a[4].shape[2]
    t_ms = time_ms(lambda: mix_kernel_result(a, cfg), reps=3, warmup=1)
    tb_ms, _ = mix_bound(tM, C, tN)
    log(f"[timing] mix throughput MASA FR-FCFS M={tM} C={C} N={tN}: kernel "
        f"{t_ms:.4f} ms ({tM * C * tN / t_ms * 1e3:.4e} req/s), byte bound "
        f"{tb_ms:.5f} ms; card {smi}")
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, M=M, C=C, N=N,
                throughput=dict(M=tM, C=C, N=tN, ms=t_ms, bound_ms=tb_ms))


def phase_ssd():
    import torch_cases as tc
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ssd_scan import kernel as K

    shapes = tc.SSD_CARD_SHAPES
    err = {}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        tol = tc.SSD_TOLS[dname]
        for shape in shapes:
            H, chunk = shape[2], shape[5]
            args = tc.ssd_kernel_inputs(shape, dtype, "cuda")
            y_k, h_k = K.ssd_scan_kernel(*args, chunk=chunk, n_heads=H)
            y_p, h_p = K.ssd_scan_plain(*args, chunk=chunk, n_heads=H)
            torch.cuda.synchronize()
            if y_k.dtype != dtype or h_k.dtype != torch.float32:
                fail(f"ssd: kernel returned {y_k.dtype} / {h_k.dtype}")
            e = max(float((y_k.float() - y_p.float()).abs().max()),
                    float((h_k - h_p).abs().max()))
            ok = (torch.allclose(y_k.float(), y_p.float(), rtol=tol, atol=tol)
                  and torch.allclose(h_k, h_p, rtol=tol, atol=tol))
            log(f"[ssd] {dname:8s} B,L,H,hd,ds,chunk={shape}: max abs err "
                f"{e:.3e} (tol {tol})")
            if not ok:
                fail(f"ssd: kernel != plain for {shape} in {dname}")
            err[(dname, shape)] = e
    # tests/test_kernels.py's decay-bound property, through ops.ssd_scan
    L, hd, ds = 32, 16, 8
    for B, H, dts in ((1, 1, 0.1), (2, 3, 0.7), (3, 4, 2.0)):
        y, _ = ssd_scan(torch.ones((B, L, H, hd), device="cuda"),
                        torch.full((B, L, H), dts, device="cuda"),
                        torch.zeros(H, device="cuda"),
                        torch.ones((B, L, ds), device="cuda") / ds,
                        torch.ones((B, L, ds), device="cuda"),
                        torch.zeros(H, device="cuda"), chunk=16)
        if float(y.abs().max()) > (dts / (1 - np.exp(-dts)) + 1e-3) * 1.05:
            fail(f"ssd: decay bound broken at B={B} H={H} dt={dts}")
    inp = {k: torch.from_numpy(v).cuda() for k, v in
           tc.ssd_inputs(2, 64, 3, 16, 8, seed=3, dt_scale=400.0).items()}
    y, h = ssd_scan(*(inp[k] for k in ("x", "dt", "a_log", "b", "c",
                                       "d_skip")), chunk=32)
    if not (torch.isfinite(y).all() and torch.isfinite(h).all()):
        fail("ssd: NaN or inf at a huge dt")
    log(f"[ssd] kernel == plain on the card for {len(shapes)} shapes x 2 "
        f"dtypes; decay bound holds; no NaN at dt x 400")
    return err[("float32", tc.SSD_SERVE)]


def phase_serve(smi: str):
    import check_torch_serve as cs
    import torch_cases as tc
    from repro_torch.core.dram import cuda_step
    from repro_torch.kernels.ssd_scan import kernel as K

    fixture = tc.serve_fixture()
    # ---- the main path, counted
    cuda_step.reset_launches()
    K.reset_launches()
    t0 = time.perf_counter()
    try:
        res = cs.serve(fixture, "cuda")
    except cs.CheckFailed as e:
        fail(f"serve: {e}")
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    dram = dict(cuda_step.LAUNCHES)
    model = res.pop("model")
    log(f"[serve] launch.serve --arch mamba2-780m (full width, fp32) with "
        f"the fixture's arguments on the card: {wall:.2f}s incl. weights "
        f"({res['build_s']:.2f}s) and checks; engine {res['wall_s']:.3f}s; "
        f"launches {launches}, DRAM kernels {dram}")
    if launches["ssd_scan"] != SERVE_SSD_LAUNCHES:
        fail(f"serve: expected {SERVE_SSD_LAUNCHES} ssd_scan launches, "
             f"counted {launches['ssd_scan']}")
    log(f"[serve] EngineStats {res['stats']} == fixture; tokens equal the "
        f"fixture's at {res['tokens_compared']} steps; near-tie steps (gap "
        f"< {cs.NEAR_TIE}): {res['near_ties']}")
    log(f"[serve] prefill {res['prefill_calls']} calls, {res['prefill_s']:.4f}s"
        f" ({res['prefill_tok_s']:.1f} tok/s); decode {res['decode_calls']} "
        f"calls, {res['decode_s']:.4f}s ({res['decode_tok_s']:.2f} tok/s); "
        f"card {smi}")
    res.update(launches=launches["ssd_scan"], wall_with_checks_s=wall)
    return res, model, fixture


def phase_logits(model, fixture):
    import check_torch_serve as cs

    try:
        tf = cs.teacher_forced(model, fixture)
    except cs.CheckFailed as e:
        fail(f"logits: {e}")
    log(f"[logits] teacher-forced: {tf['steps']} steps' top-8 logits within "
        f"rtol = atol = {cs.LOGIT_TOL}; max abs err {tf['max_abs_err']:.3e}, "
        f"max err / limit {tf['max_err_over_limit']:.3f}; top-1 equal at "
        f"{tf['top1_same']} of {tf['steps']} steps")
    return tf


def phase_profile(model, fixture):
    import check_torch_serve as cs

    prof = cs.profile(model, fixture)
    if prof is None:
        log("[profile] the trace holds no device activity: busy share not "
            "measured")
        return None
    for name, p in prof.items():
        log(f"[profile] {name}: wall {p['wall_ms']:.2f} ms under the "
            f"profiler, card busy {p['device_ms']:.2f} ms in "
            f"{p['device_ops']} kernels and copies (idle share "
            f"{p['idle_share']:.3f}); ssd_scan {p['ssd_scan_ms']:.2f} ms, "
            f"matmul (GEMM, GEMV) {p['matmul_ms']:.2f} ms")
        for n, t, c in p["top"]:
            log(f"[profile]   {t:9.3f} ms  x{c:<5d} {n}")
    return prof


def ssd_bound(shape):
    """(bound_ms, bound_by) of one SSD-scan launch in float32: bytes of xr,
    l, b, c read once and y, hT written once; operations of the lower
    triangle of C B^T and of its product with xr, C @ S and the state
    update, per (head, chunk)."""
    B, L, H, hd, ds, Q = shape
    nbytes = 4 * (2 * B * H * L * hd + B * H * L + 2 * B * L * ds
                  + B * H * ds * hd)
    tri = Q * (Q + 1) // 2
    flops = B * H * (L // Q) * (2 * tri * ds + 2 * tri * hd + 4 * Q * ds * hd)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_ssd_time(smi: str):
    import torch_cases as tc
    from repro_torch.kernels.ssd_scan import kernel as K

    out = {}
    for name, shape in (("serve", tc.SSD_SERVE), ("long", SSD_LONG)):
        H, chunk = shape[2], shape[5]
        args = tc.ssd_kernel_inputs(shape, torch.float32, "cuda", seed=1)
        k_ms = time_ms(lambda: K.ssd_scan_kernel(*args, chunk=chunk,
                                                 n_heads=H), reps=50)
        p_ms = time_ms(lambda: K.ssd_scan_plain(*args, chunk=chunk,
                                                n_heads=H), reps=10)
        b_ms, b_by = ssd_bound(shape)
        log(f"[timing] ssd_scan {name} B,L,H,hd,ds,chunk={shape}: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms "
            f"({b_by}), kernel / bound {k_ms / b_ms:.1f}x; card {smi}")
        out[name] = dict(shape=shape, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                         bound_by=b_by)
    return out


def run_phase(name: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[{name}] phase took {time.perf_counter() - t0:.1f}s")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's smoke run needs "
             "an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    # the model runs in full fp32 (matmuls and any convolution)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name, count, smi = run_phase("card", phase_card)
    run_phase("build", phase_build)
    run_phase("golden", phase_golden)
    run_phase("plain", phase_plain)
    run_phase("mc_golden", phase_mc_golden)
    mc_plain_err = run_phase("mc_plain", phase_mc_plain)
    fig4 = run_phase("fig4", phase_fig4)
    mc = run_phase("multicore", phase_multicore, smi)
    thr = run_phase("timing", phase_throughput, smi)
    ssd_err = run_phase("ssd", phase_ssd)
    serve, model, fixture = run_phase("serve", phase_serve, smi)
    tf = run_phase("logits", phase_logits, model, fixture)
    prof = run_phase("profile", phase_profile, model, fixture)
    del model
    ssd_t = run_phase("ssd_time", phase_ssd_time, smi)
    b_ms, b_by = bound(fig4["B"], fig4["N"])
    log(f"[timing] fig4 per launch (mean of 5 policies): kernel "
        f"{fig4['ms']:.4f} ms, plain {fig4['plain_ms']:.1f} ms, bound "
        f"{b_ms:.5f} ms ({b_by}); "
        f"{fig4['B'] * fig4['N'] / fig4['ms'] * 1e3:.4e} req/s; card {smi}")
    if "jax" in sys.modules or any(m == "repro" or m.startswith("repro.")
                                   for m in sys.modules):
        fail("the JAX package was imported")
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    lane_launches = {"fig4": fig4["launches"],
                     "multicore": mc["launches"]["lane_step"]}
    record = {"kernels": [{
        "name": "lane_step", "route": "cuda",
        "source": "src/repro_torch/core/dram/csrc/lane_step.cu",
        "replaces": "src/repro/core/dram/pallas_step.py:92",
        "launches": sum(lane_launches.values()),
        "launches_by_path": lane_launches,
        "max_abs_err": fig4["max_abs_err"],
        "ms": fig4["ms"], "plain_ms": fig4["plain_ms"], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
        "shape": f"B={fig4['B']} N={fig4['N']} (Fig. 4, mean of 5 policies)",
        "throughput": thr}, {
        "name": "mix_step", "route": "cuda",
        "source": "src/repro_torch/core/dram/csrc/mix_step.cu",
        "replaces": "src/repro/core/dram/pallas_step.py:160",
        "launches": mc["launches"]["mix_step"],
        "max_abs_err": max(mc["max_abs_err"], mc_plain_err),
        "ms": mc["ms"], "plain_ms": mc["plain_ms"],
        "bound_ms": mc["bound_ms"], "bound_by": mc["bound_by"],
        "library_ms": None,
        "shape": f"M={mc['M']} C={mc['C']} N={mc['N']} (run_multicore, "
                 f"mean of 7 points; plain_ms MASA FR-FCFS)",
        "throughput": mc["throughput"]}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:67",
        "launches": serve["launches"],
        "max_abs_err": ssd_err,
        "ms": ssd_t["serve"]["ms"], "plain_ms": ssd_t["serve"]["plain_ms"],
        "bound_ms": ssd_t["serve"]["bound_ms"],
        "bound_by": ssd_t["serve"]["bound_by"], "library_ms": None,
        "shape": "B=1 L=256 H=48 hd=64 ds=128 chunk=64 float32 (one "
                 "mamba2-780m layer's prefill of a 256-token prompt)",
        "long": ssd_t["long"],
        "serve": {k: serve[k] for k in (
            "stats", "wall_s", "prefill_s", "decode_s", "prefill_tok_s",
            "decode_tok_s", "near_ties", "tokens_compared")},
        "logits": tf, "profile": prof}]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
