#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only; it imports nothing of the JAX
package. Phases, each of which fails the run (non-zero exit, no result line)
on any mismatch:

1. card       — the device's name and count, and nvidia-smi's name and
                power limit; the kernels need compute capability 9.0 and
                nvcc.
2. build      — compile all seven kernels from the sources in the checkout,
                one nvcc per source, all at once (``-Xptxas -v``: registers,
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
   Phases 3-6 fail unless every lane and mix launch ran the smem body
   (``cuda_step.BODIES``: one warp a chain, its state in shared memory),
   the body ``cuda_step.body()`` picks at every geometry they run.
7. global_body — both kernels with the global body forced (one thread a
                chain, its state in a scratch buffer) vs their plain
                versions, and 16 x 1024 (over a block's shared memory),
                which ``body()`` sends to the global body.
8. fig4       — main path one: the paper's Fig. 4 grid (32 workloads x 5
                policies x 8000 requests, seed 7) through
                ``repro_torch.paper_repro.run_fig4`` on the card. Exactly
                one lane-kernel launch per policy, each on the smem body; the
                counters equal ``tests/data/torch_fig4_n8000.json`` (made by
                the JAX package) and the plain version on the card.
9. multicore  — main path two: ``paper_repro.run_multicore`` (four 4-core
                mixes x 1500 requests) and ``run_sched`` (x 1000, refresh
                on) on the card. Exactly 17 mix-kernel and 2 lane-kernel
                launches, each on the smem body; every cell equals
                ``tests/data/torch_multicore_fixture.json`` (made by the JAX
                package); MASA under FR-FCFS also equals the plain version.
10. sweep     — main paths one and two again, through the sweep layer
                (``repro_torch.experiments``), each run with the launch counts
                set to 0 just before it: Fig. 4 through ``run_sweep``
                (``repro_torch.benchmarks.fig4_ipc.make_grid()``, a fresh
                ``ResultCache``): every cell equals
                ``tests/data/torch_fig4_n8000.json``, 160 cells in 5 batches,
                exactly 5 lane launches; the same grid journaled by a
                ``PersistentResultCache`` and replayed by a second one (160
                hits, no launch); the scheduler study through
                ``run_mix_sweep`` (``sched_bench.make_grid()``): its 40 cells
                equal the fixture's sched cells, exactly 10 mix and 4 lane
                launches (the run-alone memo, one a mix); the golden-fragment
                scenario (``tests/make_golden_shard_fragments.py``'s grid, 2
                shards on cuda:0, a persistent fault on cell 2): its fragments
                equal ``tests/data/shard_fragments`` (shard device aside) and
                their merge equals ``merged.json`` byte for byte, exactly 3
                lane launches; Fig. 4 at 4 shards on the one card (20 lane
                launches) equals the first run. Every launch runs the smem
                body, and no run but the faulted one quarantines a cell. The
                wall times print beside ``paper_repro.run_fig4``'s and
                ``run_sched``'s from phases 8 and 9.
11. timing    — CUDA-event times of both kernels, each body timed in turns
                (global, smem, smem, global), at the main paths' shapes and
                at throughput shapes, with nvidia-smi's SM clock sampled
                meanwhile: ms, us and cycles a step, req/s, beside the byte
                bound; a log line adds a chain estimate (steps a chain x
                one step's critical path as counted by hand from the smem
                bodies' code, at assumed latencies: not measured, and not
                in the result line).
12. ssd       — the SSD-scan kernel vs its plain version on the card, in
                float32 (rtol = atol = 2e-4) and bfloat16 (2e-2), at
                tests/test_kernels.py's sweep, mamba2-780m's serve shape,
                jamba's SSM shape, chunk 256 with ds 128 and the kernel's
                edges (torch_cases.SSD_EDGE: hd 4 to 128, one chunk, batch *
                head 1, ds up to 512), and on bases that are not 16-byte
                aligned; one launch a call; the decay-bound property and no
                NaN at a huge dt.
13. serve     — main path three: ``repro_torch.launch.serve``'s path with
                the fixture's arguments (mamba2-780m at full width, fp32,
                4 requests x 256 prompt tokens x 16 new, MASA). Weights equal
                the fixture's numpy stream (sha256 of every leaf);
                ``EngineStats`` equal ``tests/data/torch_serve_mamba2_780m.json``
                (made by the JAX package); every request's tokens equal the
                fixture's up to its first near-tie step (top-1/top-2 gap
                under 1e-2); exactly 4 x 48 = 192 SSD-scan launches.
14. logits    — teacher-forced: the fixture's tokens through ``prefill`` and
                ``decode_step``; every step's logits at the fixture's top-8
                ids within rtol = atol = 1e-3.
15. profile   — ``torch.profiler`` trace of one request's prefill and its
                16 decode steps: the card's busy and idle share, and the
                SSD-scan and matmul kernels' device time (reported, not
                checked: the trace may hold no device activity there).
16. serve_smollm — main path five: smollm-135m whole (30 layers, 9 query
                heads on 3 kv heads, tied embeddings), fp32, through
                ``launch.serve``'s path with the arguments of
                ``tests/data/torch_serve_smollm_135m.json`` (made by the JAX
                package; 4 requests x 128 prompt tokens x 16 new, MASA):
                ``EngineStats`` equal the fixture's, tokens equal up to a
                near tie, teacher-forced top-8 logits within rtol = atol =
                1e-3, and no kernel launched (attention is plain PyTorch, as
                the reference's is plain JAX); a profile of one request.
17. serve_moonshot — main path six: moonshot-v1-16b-a3b at full width cut
                to 2 of its 48 layers (16 heads of 128, 64 experts top-6 and
                2 shared, F 1408), the same checks against
                ``tests/data/torch_serve_moonshot_16b_l2.json``; exactly
                2 layers x 3 products (up, gate, down) moe_gemm launches a
                prefill and a decode call, each on the simt body, and no
                other kernel; a profile of one request.
18. moe_time  — the grouped GEMM at moonshot's serve shapes (64 experts x
                capacity 16 and 8, D 2048, F 1408; the up and the down
                product), fp32: kernel vs plain within 2e-4, then CUDA-event
                times of the kernel, its plain version and ``torch.bmm`` on
                the same capacity buffer, beside the bound.
19. ssd_time  — CUDA-event times of the SSD-scan kernel and its plain
                version at the serve shape and at L = 2048, beside the bound
                (C B^T counted once a batch element and chunk: B and C are
                shared by the heads).
20. kernels   — the masa_gemm (both orders, through ops and its fallback),
                moe_gemm, paged_attention and flash_attention kernels vs
                their plain versions on the card, in float32 (rtol = atol =
                2e-4) and bfloat16 (2e-2), at tests/test_kernels.py's and
                tests/test_flash_attention.py's sweep shapes (flash at both
                causal values, and at hd 96 and S 100 too); paged at
                seq_lens 0, 1, a partial page and full with out-of-range
                table entries through ops; GQA through ops.flash_attention
                (one launch, on the unexpanded kv heads [B * Hkv, S, hd]);
                flash in bf16 on bases that are not 16-byte aligned (the
                simt body, k/v of BH / g rows). Paged also on both bodies
                forced (serial; split at clusters of 1, 2, 4 and 8) at the
                sweep and at its edges (torch_cases.PAGED_EDGE: G 1, 3, 7, 8,
                lengths 0, 1, around a split's boundary and full, n_pages 1,
                a repeated page), each one launch on the body asked for.
                Each wrapper raises on a non-contiguous input, a wrong dtype
                or a refused shape, before any launch. Every masa, moe,
                paged and flash case ran the body its wrapper picks by shape
                (``body()``: wgmma for bf16 with rows of whole 16-byte
                units, moe's bt % 64 == 0 and flash's hd 64, 96 or 128;
                simt otherwise; paged: split for G 1 to 8 and rows of 1
                to 32 whole 16-byte units, serial otherwise), counted in
                ``BODIES``.
21. kernel_bench — main path four: ``repro_torch.kernel_bench.run()`` on the
                card. kernels_ok, every err below 1e-3, moe_hit 8/15, and
                exactly one launch per call as the reference times them
                (masa_gemm_os 2, masa_gemm_ws 1, ssd_scan 1, moe_gemm 1,
                paged_attention 2, flash_attention 1); no DRAM-kernel launch.
22. kernel_time — the four kernels at jamba-v0.1-52b's full width
                (``torch_cases.*_JAMBA``), in bfloat16 and float32 (TF32 off):
                kernel vs plain within the tolerances above, then CUDA-event
                times of the kernel, its plain version and the one PyTorch
                call that computes the same function (scaled_dot_product_
                attention, torch.bmm, torch.matmul; none for paged), beside
                the bound max(FLOPs / peak, bytes / 3.35 TB/s). masa_gemm's
                weight-stationary order falls back there and is also timed
                at K = 256. The flash, masa (both orders) and moe rows fail
                unless bfloat16 ran the wgmma body and float32 the simt
                body; each prints its body and TFLOP/s. Flash is also timed
                through ops.flash_attention on the 8 unexpanded kv heads
                (one launch, held to the kernel on the expanded heads),
                beside SDPA with enable_gqa. Paged fails unless both dtypes
                ran the split body; its serial body (the form before the
                split one) is timed in turns with it.

Each phase prints its seconds. The last lines are nvidia-smi's name and
power limit, the per-kernel JSON record (all seven kernels; lane_step and
mix_step also give their body, µs and cycles a step, chain bound, the
global body's time and their launches by path, the sweep phase's included;
lane_step the sweep phase's wall times; moe_gemm its launches by path,
moonshot's serve run and its times at moonshot's shapes), and ``{"ok":
true, "device": {...}}``.
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

#: One step's critical path in the smem bodies, counted by hand from their
#: code at the timed shapes (open row): dependent shared-memory reads,
#: dependent integer ops and warp collectives, at the assumed (not measured)
#: cycles below; the chain estimate it gives is logged only. Lane: the bank-
#: vector row, then the other subarray's row it names; about 25 ops (the
#: visibility's 3, the row address's 3, the ACT max-chain's 8, the column
#: command's 9, the completion's 2). Mix: the key's open row, the two rows
#: of the served step and the owner's ring read; about 35 ops (the key's 6,
#: the lowest core's 2, the served step's 22, the next visibility's 5); the
#: min-reduce, the ballot and the shuffles.
SMEM_READ_CYCLES, INT_OP_CYCLES, COLLECTIVE_CYCLES = 30, 4, 30
LANE_STEP_PATH = dict(reads=2, ops=25, collectives=0)
MIX_STEP_PATH = dict(reads=4, ops=35, collectives=3)

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
#: The attention and MoE serve phases: smollm-135m whole and
#: moonshot-v1-16b-a3b at full width cut to 2 layers, each against its JAX
#: fixture (tests/make_torch_serve_fixture.py).
SERVE_ARCHS = ("smollm-135m", "moonshot-v1-16b-a3b")
#: moonshot's grouped expert GEMMs as its serve path runs them: E experts,
#: capacity C (16 for a 128-token prefill, 8 for a decode step), D and F;
#: "up" (also "gate") multiplies [E*C, D] by [E, D, F], "down" [E*C, F]
#: by [E, F, D].
MOE_MOONSHOT = dict(E=64, D=2048, F=1408, capacities=(16, 8))
#: Cycles a second that the timing's sleep kernel counts: the H100's
#: highest SM clock (1980 MHz) rounded up.
SLEEP_CYCLES_PER_S = 2e9
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989.4e12
#: kernel_bench.run()'s oracles and launches: one call of each kernel as the
#: reference times them, plus the default-order masa_gemm of its error check.
BENCH_ERRS = {"moe_gemm", "masa_gemm", "ssd_scan", "flash_attention",
              "paged_attention/shared_prefix", "paged_attention/private"}
BENCH_LAUNCHES = {"masa_gemm_os": 2, "masa_gemm_ws": 1, "ssd_scan": 1,
                  "moe_gemm": 1, "paged_attention": 2, "flash_attention": 1}
KERNEL_TIME_SEED = 14


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str = "") -> None:
    print(msg, flush=True)


def check_smem(phase: str, *kernels: str) -> None:
    """Fail unless every launch of ``kernels`` since the last
    ``cuda_step.reset_launches()`` ran the smem body, and there was one."""
    from repro_torch.core.dram import cuda_step

    for k in kernels:
        b, n = cuda_step.BODIES[k], cuda_step.LAUNCHES[k]
        if n == 0 or b != {"global": 0, "smem": n}:
            fail(f"{phase}: {k} launches by body {b} of {n}; every one should "
                 f"run the smem body")


def chain_estimate_ms(steps: int, path: dict, mhz: float) -> float:
    """``steps`` of a chain at one step's counted critical path
    (``*_STEP_PATH``) and the sampled clock: an estimate, logged only."""
    cycles = (path["reads"] * SMEM_READ_CYCLES + path["ops"] * INT_OP_CYCLES
              + path["collectives"] * COLLECTIVE_CYCLES)
    return steps * cycles / (mhz * 1e3)


class SmClock:
    """nvidia-smi's SM clock (MHz) sampled every 100 ms while open; ``mhz``
    is the median sample."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        vals = sorted(float(x) for x in out.split()
                      if x.replace(".", "", 1).isdigit())
        if not vals:
            fail("nvidia-smi gave no SM clock samples")
        self.mhz = vals[len(vals) // 2]
        self.samples = len(vals)
        return False


def per_step(ms: float, steps: int, mhz: float) -> dict:
    """µs and cycles a step of one chain of ``steps`` steps."""
    us = ms * 1e3 / steps
    return dict(us_per_step=us, cycles_per_step=us * mhz)


def time_bodies(launch, reps: int, warmup: int = 2) -> tuple[float, float]:
    """``(global ms, smem ms)`` of ``launch(body)``, timed in turns: global,
    smem, smem, global."""
    g1 = time_ms(lambda: launch("global"), reps, warmup)
    s1 = time_ms(lambda: launch("smem"), reps, warmup)
    s2 = time_ms(lambda: launch("smem"), reps, warmup)
    g2 = time_ms(lambda: launch("global"), reps, warmup)
    return (g1 + g2) / 2, (s1 + s2) / 2


def lane_launch(eff, nb, ns, config, xs, mlp, body=None):
    """One lane-kernel launch in ``body`` (timing only)."""
    from repro_torch.core.dram import cuda_step

    return cuda_step._launch(eff, nb, ns, config.timing, config.refresh_mode,
                             xs, mlp, config.row_policy == "closed",
                             _body=body)


def mix_launch(args, config, body=None):
    """One mix-kernel launch in ``body`` (timing only)."""
    from repro_torch.core.dram import cuda_step

    eff, sched, nb, ns, reqs, mlp, rank = args
    return cuda_step._launch_cores(eff, sched, nb, ns, config.timing,
                                   config.refresh_mode, reqs, mlp, rank,
                                   config.row_policy == "closed", _body=body)


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
    from repro_torch import cuda_build, kernels
    from repro_torch.core.dram import cuda_step

    t0 = time.perf_counter()
    built = cuda_build.build({**cuda_step.SOURCES, **kernels.SOURCES})
    for name in cuda_step.SOURCES:
        cuda_step._library(name)
    kernels.load()
    log(f"[build] {', '.join(p.name for p, _ in built.values())} in "
        f"{time.perf_counter() - t0:.2f}s")
    for name, (_, build_log) in built.items():
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {name}: {line.strip()}")


def phase_golden():
    import torch_cases as tc
    from repro_torch.core.dram import Policy, SimConfig, simulate_stacked

    from repro_torch.core.dram import cuda_step

    cuda_step.reset_launches()
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
    check_smem("golden", "lane_step")
    log(f"[golden] {n} cells bit-exact through the lane kernel; bodies "
        f"{cuda_step.BODIES['lane_step']}")


def phase_mc_golden():
    import torch_cases as tc
    from repro_torch.core.dram import Policy, simulate_multicore_batch
    from repro_torch.paper_repro import COUNTERS

    from repro_torch.core.dram import cuda_step

    cuda_step.reset_launches()
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
    check_smem("mc_golden", "mix_step", "lane_step")
    log(f"[mc_golden] {n} multicore cells bit-exact through the mix kernel; "
        f"bodies {cuda_step.BODIES}")


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
    from repro_torch.core.dram import cuda_step

    cuda_step.reset_launches()
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
    check_smem("mc_plain", "mix_step", "lane_step")
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

    from repro_torch.core.dram import cuda_step

    dev = torch.device("cuda")
    geometries = ((8, 8), (4, 16), (2, 32))
    cuda_step.reset_launches()
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
    check_smem("plain", "lane_step")
    log(f"[plain] kernel == plain on the card for {n} (config, policy) "
        f"pairs x 8 lanes x 256 requests")


def phase_global_body():
    """The global body forced at one shape per config, and the 16 x 1024
    geometry body() sends to it, vs the plain versions."""
    import torch_cases as tc
    from repro_torch.core.dram import (Policy, Scheduler, SimConfig, cuda_step,
                                       stack_traces)
    from repro_torch.core.dram.engine import lane_inputs

    dev = torch.device("cuda")
    cuda_step.reset_launches()
    cases = [(cfg, 4, 16) for cfg in tc.CONFIGS]
    cases += [(cfg, 16, 1024) for cfg in ("default", "closed_refresh")]
    for k, (cfg, nb, ns) in enumerate(cases):
        config = SimConfig(n_banks=nb, n_subarrays=ns,
                           scheduler=Scheduler.FRFCFS, **tc.CONFIGS[cfg])
        forced = "global" if ns == 16 else None
        if ns == 1024 and cuda_step.body(nb, ns, config.refresh_mode) != "global":
            fail("global_body: body() does not send 16 x 1024 to the global "
                 "body")
        for pol in (Policy.BASELINE, Policy.SALP1, Policy.MASA):
            traces = [tc.random_trace(2000 + 5 * k + j, n=120, nb=nb, ns=ns)
                      for j in range(6)]
            eff, knb, kns, xs, mlp = lane_inputs(stack_traces(traces), pol,
                                                 config, dev)
            got = lane_launch(eff, knb, kns, config, xs, mlp, body=forced)
            ref = cuda_step.simulate_lanes_plain(
                eff, knb, kns, config.timing, config.refresh_mode, xs, mlp,
                closed_row=config.row_policy == "closed")
            if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                fail(f"global_body: lane kernel != plain for {cfg} "
                     f"({nb}x{ns}), {pol.name}")
            args = random_mix_args(config, pol, 4, 3, 60, 2500 + 7 * k)
            got = mix_launch(args, config, body=forced)
            eff, sched, knb, kns, reqs, mlp, rank = args
            ref = cuda_step.simulate_cores_plain(
                eff, sched, knb, kns, config.timing, config.refresh_mode,
                reqs, mlp, rank, closed_row=config.row_policy == "closed")
            if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                fail(f"global_body: mix kernel != plain for {cfg} "
                     f"({nb}x{ns}), {pol.name}")
    torch.cuda.synchronize()
    want = {"global": 3 * len(cases), "smem": 0}
    if cuda_step.BODIES != {"lane_step": want, "mix_step": want}:
        fail(f"global_body: launches by body {cuda_step.BODIES}, expected "
             f"{want} for each kernel")
    log(f"[global_body] global body == plain on the card for {len(cases)} "
        f"(config, geometry) cases x 3 policies, lane and mix; 16 x 1024 "
        f"takes it by shape")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` calls, after warm-up.
    A sleep kernel holds the stream while the host queues the calls, so a
    launch shorter than its wrapper's host time, or a plain version's loop
    of small ops, is timed on the card and not at the host's rate (a call
    that waits for the card, as a copy to the host does, is still timed
    as the host feeds it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # at most 2 GHz, so this sleeps at least 1.5x the host's time to queue
    torch.cuda._sleep(int(min(1.5 * reps * host_s, 0.5) * SLEEP_CYCLES_PER_S))
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
    check_smem("fig4", "lane_step")
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

    # ---- kernel timing at the Fig. 4 shapes: both bodies in turns
    B, N = len(pr.PAPER_WORKLOADS), FIG4_N
    global_ms, kernel_ms = [], []
    with SmClock() as clock:
        for pol, args in inputs.items():
            g, k = time_bodies(lambda b, a=args: lane_launch(
                *a[:3], config, *a[3:], body=b), reps=20)
            global_ms.append(g)
            kernel_ms.append(k)
    for pol, g, k, p in zip(inputs, global_ms, kernel_ms, plain_ms):
        log(f"[timing] fig4 {pol.name:8s} B={B} N={N}: smem {k:.4f} ms, "
            f"global {g:.4f} ms, plain {p:.1f} ms")
    n_pol = len(kernel_ms)
    return dict(launches=launches["lane_step"], max_abs_err=err,
                ms=sum(kernel_ms) / n_pol, global_ms=sum(global_ms) / n_pol,
                plain_ms=sum(plain_ms) / len(plain_ms), B=B, N=N,
                clock_mhz=clock.mhz, wall_s=wall)


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
    with SmClock() as clock:
        g_ms, k_ms = time_bodies(lambda b: lane_launch(
            *args[:3], config, *args[3:], body=b), reps=5)
    p_ms = time_ms(lambda: plain_result(*args[:3], config, *args[3:]), reps=1,
                   warmup=0)
    b_ms, _ = bound(B, N)
    row = dict(B=B, N=N, body="smem", ms=k_ms, global_ms=g_ms, plain_ms=p_ms,
               bound_ms=b_ms, req_per_s=B * N / k_ms * 1e3,
               clock_mhz=clock.mhz, **per_step(k_ms, N, clock.mhz))
    log(f"[timing] throughput MASA B={B} N={N}: smem {k_ms:.4f} ms "
        f"({row['req_per_s']:.4e} req/s, {row['us_per_step']:.4f} us, "
        f"{row['cycles_per_step']:.0f} cycles a step at {clock.mhz:.0f} MHz), "
        f"global {g_ms:.4f} ms, plain {p_ms:.1f} ms "
        f"({B * N / p_ms * 1e3:.4e} req/s), byte bound {b_ms:.5f} ms, chain "
        f"estimate {chain_estimate_ms(N, LANE_STEP_PATH, clock.mhz):.4f} ms; "
        f"card {smi}")
    return row


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


def mix_bench_args(pol, sched, n: int, seeds):
    """``(mix kernel inputs on the card, config)`` of ``run_multicore``'s
    four mixes of ``n`` requests a core, once per seed."""
    from repro_torch import interop
    from repro_torch import paper_repro as pr
    from repro_torch.core.dram import SimConfig
    from repro_torch.core.dram.engine import mix_inputs
    from repro_torch.core.dram.multicore import _prep_mix

    prepped = [_prep_mix(pr.mix_traces(m, n, seed))
               for seed in seeds for m in pr.MIXES]
    stacked = {k: np.stack([p[0][k] for p in prepped])
               for k in interop.STACKED_FIELDS}
    ranks = np.stack([p[1] for p in prepped])
    config = SimConfig(scheduler=sched)
    return mix_inputs(stacked, ranks, pol, config,
                      torch.device("cuda")), config


def phase_multicore(smi: str):
    import torch_cases as tc
    from repro_torch.core.dram import Policy, Scheduler, cuda_step
    from repro_torch import paper_repro as pr

    # ---- the main path, counted
    cuda_step.reset_launches()
    t0 = time.perf_counter()
    mc = pr.run_multicore(pr.MULTICORE_N, FIG4_SEED, device="cuda")
    t1 = time.perf_counter()
    sc = pr.run_sched(pr.SCHED_N, FIG4_SEED, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    wall, sched_wall = t2 - t0, t2 - t1
    launches = dict(cuda_step.LAUNCHES)
    log(f"[multicore] run_multicore(n={pr.MULTICORE_N}) + run_sched("
        f"n={pr.SCHED_N}) on the card: {wall:.3f}s wall incl. trace "
        f"generation (run_sched {sched_wall:.3f}s); launches {launches}")
    if launches != MULTICORE_LAUNCHES:
        fail(f"multicore: expected launches {MULTICORE_LAUNCHES}, counted "
             f"{launches}")
    check_smem("multicore", "mix_step", "lane_step")
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
    args, config = mix_bench_args(Policy.MASA, Scheduler.FRFCFS,
                                  pr.MULTICORE_N, [FIG4_SEED])
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

    # ---- timing at the bench shape (each of run_multicore's points), both
    # bodies in turns
    M, C, N = len(pr.MIXES), len(pr.MIXES[0]), pr.MULTICORE_N
    points = ([(pol, Scheduler.FRFCFS) for pol in pr.POLICIES]
              + [(Policy.BASELINE, Scheduler.TCM), (Policy.MASA, Scheduler.TCM)])
    global_ms, kernel_ms = [], []
    with SmClock() as clock:
        for pol, sched in points:
            a, cfg = mix_bench_args(pol, sched, N, [FIG4_SEED])
            g, k = time_bodies(lambda b, a=a, c=cfg: mix_launch(a, c, b),
                               reps=10)
            global_ms.append(g)
            kernel_ms.append(k)
            log(f"[timing] multicore {pol.name:8s} {sched.name:6s} M={M} C={C} "
                f"N={N}: smem {k:.4f} ms, global {g:.4f} ms")
    ms = sum(kernel_ms) / len(kernel_ms)
    b_ms, b_by = mix_bound(M, C, N)
    steps = C * N
    chain_ms = chain_estimate_ms(steps, MIX_STEP_PATH, clock.mhz)
    log(f"[timing] multicore per launch (mean of {len(points)} points): "
        f"smem {ms:.4f} ms, global {sum(global_ms) / len(global_ms):.4f} ms, "
        f"plain (MASA FR-FCFS) {plain_ms:.1f} ms, bound {b_ms:.5f} ms "
        f"({b_by}), chain estimate {chain_ms:.4f} ms; "
        f"{M * C * N / ms * 1e3:.4e} req/s; card {smi}")

    # ---- throughput shape, both bodies in turns
    seeds = range(FIG4_SEED, FIG4_SEED + MIX_THROUGHPUT_SEEDS)
    a, cfg = mix_bench_args(Policy.MASA, Scheduler.FRFCFS, MIX_THROUGHPUT_N,
                            seeds)
    tM, tN = a[4].shape[0], a[4].shape[2]
    with SmClock() as t_clock:
        tg_ms, t_ms = time_bodies(lambda b: mix_launch(a, cfg, b), reps=3,
                                  warmup=1)
    tb_ms, _ = mix_bound(tM, C, tN)
    thr = dict(M=tM, C=C, N=tN, body="smem", ms=t_ms, global_ms=tg_ms,
               bound_ms=tb_ms, req_per_s=tM * C * tN / t_ms * 1e3,
               clock_mhz=t_clock.mhz, **per_step(t_ms, C * tN, t_clock.mhz))
    log(f"[timing] mix throughput MASA FR-FCFS M={tM} C={C} N={tN}: smem "
        f"{t_ms:.4f} ms ({thr['req_per_s']:.4e} req/s, "
        f"{thr['us_per_step']:.4f} us, {thr['cycles_per_step']:.0f} cycles a "
        f"step at {t_clock.mhz:.0f} MHz), global {tg_ms:.4f} ms, byte bound "
        f"{tb_ms:.5f} ms, chain estimate "
        f"{chain_estimate_ms(C * tN, MIX_STEP_PATH, t_clock.mhz):.4f} ms; "
        f"card {smi}")
    return dict(launches=launches, max_abs_err=err, ms=ms,
                global_ms=sum(global_ms) / len(global_ms), plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, M=M, C=C, N=N, body="smem",
                clock_mhz=clock.mhz,
                req_per_s=M * C * N / ms * 1e3,
                **per_step(ms, steps, clock.mhz), throughput=thr,
                sched_wall_s=sched_wall)


#: The sweep phase's runs and the kernel launches each must make: Fig. 4
#: through run_sweep (one lane launch a policy bucket), its journal replay
#: (none), the scheduler study through run_mix_sweep (one mix launch a
#: (policy, scheduler) point; one lane launch a mix for the run-alone memo,
#: which every point shares: FCFS, refresh on), the golden fragments'
#: faulted 2-shard scenario (one lane launch a shard; cell 2's shard fails
#: before its launch) and Fig. 4 at 4 shards on the one card.
SWEEP_LAUNCHES = {"fig4": {"lane_step": 5, "mix_step": 0},
                  "replay": {"lane_step": 0, "mix_step": 0},
                  "sched": {"lane_step": 4, "mix_step": 10},
                  "golden_shards": {"lane_step": 3, "mix_step": 0},
                  "fig4_shards": {"lane_step": 20, "mix_step": 0}}
#: tests/make_golden_shard_fragments.py's scenario, rebuilt on the port.
GOLDEN_SHARD_FAULT = "raise@c2:p"


def golden_shard_grid():
    """``make_golden_shard_fragments.make_grid()`` on the port: lbm and mcf x
    BASELINE and SALP1 x 96 requests at 4 subarrays (4 cells, 2 buckets)."""
    from repro_torch.core.dram import PAPER_WORKLOADS, Policy
    from repro_torch.experiments import SweepGrid

    return SweepGrid(name="golden_shards",
                     workloads=tuple(p for p in PAPER_WORKLOADS
                                     if p.name in ("mcf", "lbm")),
                     policies=(Policy.BASELINE, Policy.SALP1), n_requests=96,
                     config_axes={"n_subarrays": (4,)})


def counted_sweep(name: str, fn, *args, **kwargs):
    """One sweep-layer run with the launch counts set to 0 just before it:
    ``(result, wall s)``. Fails unless it made exactly
    ``SWEEP_LAUNCHES[name]`` launches, each lane and mix launch on the smem
    body, and (unless it is the faulted run) quarantined no cell."""
    from repro_torch.core.dram import cuda_step

    cuda_step.reset_launches()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_step.LAUNCHES)
    if launches != SWEEP_LAUNCHES[name]:
        fail(f"sweep {name}: expected launches {SWEEP_LAUNCHES[name]}, "
             f"counted {launches}")
    for k, n in launches.items():
        if n:
            check_smem(f"sweep {name}", k)
    if name != "golden_shards" and out.stats["quarantined_cells"]:
        fail(f"sweep {name}: {out.stats['quarantined_cells']} cells "
             f"quarantined: {out.quarantined[:2]}")
    log(f"[sweep] {name}: {wall:.3f}s wall; launches {launches}; "
        f"batches {out.stats['sim_batches']}; watchdog "
        f"{out.stats.get('watchdog')}")
    return out, wall


def phase_sweep(smi: str, fig4_wall: float, sched_wall: float):
    import os
    import tempfile

    import torch_cases as tc
    from repro_torch.benchmarks import fig4_ipc, sched_bench
    from repro_torch.experiments import (FaultPlan, PersistentResultCache,
                                         ResiliencePolicy, ResultCache,
                                         clear_trace_cache, load_fragments,
                                         merge_fragment_dir, run_mix_sweep,
                                         run_sweep, write_artifact)

    walls = {}
    # ---- Fig. 4 through run_sweep, against the JAX package's counters
    clear_trace_cache()
    fig4, walls["fig4"] = counted_sweep("fig4", run_sweep,
                                        fig4_ipc.make_grid(), ResultCache())
    cells = {(c.workload.name, c.policy.name): c.counters
             for c in fig4.cells}
    fixture = tc.fig4_fixture()
    bad = [k for k in fixture if cells.get(k) != fixture[k]]
    if len(cells) != len(fixture) or bad:
        fail(f"sweep fig4: {len(bad)} of {len(fixture)} cells differ from "
             f"{Path(tc.FIG4_PATH).name}, e.g. {bad[:3]}")
    st = fig4.stats
    if (st["simulated_cells"], st["sim_batches"]) != (160, 5):
        fail(f"sweep fig4: simulated {st['simulated_cells']} cells in "
             f"{st['sim_batches']} batches, expected 160 in 5")
    log(f"[sweep] fig4 run_sweep: all {len(fixture)} cells equal "
        f"{Path(tc.FIG4_PATH).name}; {walls['fig4']:.3f}s wall beside "
        f"paper_repro.run_fig4's {fig4_wall:.3f}s (both incl. trace "
        f"generation); card {smi}")
    ref = [c.to_json() for c in fig4.cells]

    with tempfile.TemporaryDirectory() as tmp:
        # ---- journal: write it, then replay it in a second cache
        journal = os.path.join(tmp, "journal.jsonl")
        first, walls["journal_write"] = counted_sweep(
            "fig4", run_sweep, fig4_ipc.make_grid(),
            PersistentResultCache(journal))
        replay_cache = PersistentResultCache(journal)
        replay, walls["replay"] = counted_sweep(
            "replay", run_sweep, fig4_ipc.make_grid(), replay_cache)
        st = replay.stats
        if (replay_cache.loaded, st["cache_hits"], st["simulated_cells"]) \
                != (160, 160, 0):
            fail(f"sweep replay: loaded {replay_cache.loaded}, "
                 f"{st['cache_hits']} hits, {st['simulated_cells']} "
                 f"simulated; expected 160, 160, 0")
        strip = [dict(c, cache_hit=None) for c in ref]
        for run in (first, replay):
            if [dict(c.to_json(), cache_hit=None) for c in run.cells] != strip:
                fail("sweep replay: the journal's cells differ from run 1's")
        log(f"[sweep] journal: written in {walls['journal_write']:.3f}s, "
            f"replayed as 160 hits with no launch in {walls['replay']:.3f}s")

        # ---- the scheduler study through run_mix_sweep (its traces are
        # not memoised yet: generated in the run, as run_sched does)
        sched, walls["sched"] = counted_sweep(
            "sched", run_mix_sweep, sched_bench.make_grid())
        want = {k[1:]: v for k, v in tc.multicore_fixture().items()
                if k[0] == "sched"}
        got = {(c.mix_name, c.policy.name, c.config.scheduler.name):
               dict(counters=c.counters, core_cycles=c.core_cycles,
                    alone_cycles=c.alone_cycles) for c in sched.cells}
        bad = [k for k, v in want.items() if got.get(k) != {
            f: v[f] for f in ("counters", "core_cycles", "alone_cycles")}]
        if len(want) != 40 or set(got) != set(want) or bad:
            fail(f"sweep sched: {len(bad)} of {len(want)} cells differ from "
                 f"{Path(tc.MULTICORE_PATH).name}, e.g. {bad[:3]}")
        log(f"[sweep] sched run_mix_sweep: all {len(want)} cells equal "
            f"{Path(tc.MULTICORE_PATH).name}; {walls['sched']:.3f}s wall "
            f"beside paper_repro.run_sched's {sched_wall:.3f}s; card {smi}")

        # ---- the golden fragments: 2 shards, a persistent fault on cell 2
        frag_dir = os.path.join(tmp, "fragments")
        fast = ResiliencePolicy(backoff_base_s=0.0, sleep=lambda s: None)
        golden, walls["golden_shards"] = counted_sweep(
            "golden_shards", run_sweep, golden_shard_grid(), ResultCache(),
            resilience=fast, fault_plan=FaultPlan.parse(GOLDEN_SHARD_FAULT),
            shards=2, fragment_dir=frag_dir, device="cuda:0")
        if [q["index"] for q in golden.quarantined] != [2]:
            fail(f"sweep golden_shards: quarantined "
                 f"{golden.quarantined}, expected cell 2 alone")
        pinned = ROOT / "tests" / "data" / "shard_fragments"

        def no_device(frags):
            return [dict(f, shard=dict(f["shard"], device=None))
                    for f in frags]

        if no_device(load_fragments(frag_dir)) != no_device(
                load_fragments(pinned)):
            fail("sweep golden_shards: the fragments differ from "
                 "tests/data/shard_fragments")
        merged = write_artifact(os.path.join(tmp, "merged.json"),
                                merge_fragment_dir(frag_dir))
        if Path(merged).read_bytes() != (pinned / "merged.json").read_bytes():
            fail("sweep golden_shards: the merge differs from merged.json")
        log(f"[sweep] golden_shards: 4 fragments equal "
            f"tests/data/shard_fragments (devices "
            f"{sorted({f['shard']['device'] for f in golden.fragments})}), "
            f"merged.json byte for byte, cell 2 quarantined")

    # ---- Fig. 4 at 4 shards on the one card, nothing a hit (its traces
    # memoised, as for the journal write: the two walls compare)
    sharded, walls["fig4_shards"] = counted_sweep(
        "fig4_shards", run_sweep, fig4_ipc.make_grid(), ResultCache(),
        shards=4)
    if [c.to_json() for c in sharded.cells] != ref:
        fail("sweep fig4_shards: 4-shard cells differ from run 1's")
    log(f"[sweep] fig4 at 4 shards on {sharded.stats['sharding']['devices']}:"
        f" cells equal run 1's; {walls['fig4_shards']:.3f}s wall beside the "
        f"unsharded journal write's {walls['journal_write']:.3f}s (traces "
        f"memoised in both)")
    # every run above once, and Fig. 4's counts again for the journal write
    launches = {k: sum(v[k] for v in SWEEP_LAUNCHES.values())
                + SWEEP_LAUNCHES["fig4"][k] for k in ("lane_step", "mix_step")}
    return dict(launches=launches, walls=walls,
                paper_repro_walls={"fig4": fig4_wall, "sched": sched_wall})


def phase_ssd():
    import torch_cases as tc
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ssd_scan import kernel as K

    shapes = tc.SSD_CARD_SHAPES + tc.SSD_EDGE
    err = {}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        tol = tc.TOLS[dname]
        cases = [(shape, False) for shape in shapes] + [(tc.SSD_SERVE, True)]
        for shape, unaligned in cases:
            H, chunk = shape[2], shape[5]
            args = tc.ssd_kernel_inputs(shape, dtype, "cuda")
            if unaligned:   # bases one element past an allocation's
                args = [tc.shifted(t) for t in args]
            K.reset_launches()
            y_k, h_k = K.ssd_scan_kernel(*args, chunk=chunk, n_heads=H)
            if K.LAUNCHES["ssd_scan"] != 1:
                fail(f"ssd: {shape} launched {K.LAUNCHES}")
            y_p, h_p = K.ssd_scan_plain(*args, chunk=chunk, n_heads=H)
            torch.cuda.synchronize()
            if y_k.dtype != dtype or h_k.dtype != torch.float32:
                fail(f"ssd: kernel returned {y_k.dtype} / {h_k.dtype}")
            e = max(float((y_k.float() - y_p.float()).abs().max()),
                    float((h_k - h_p).abs().max()))
            ok = (torch.allclose(y_k.float(), y_p.float(), rtol=tol, atol=tol)
                  and torch.allclose(h_k, h_p, rtol=tol, atol=tol))
            where = " unaligned" if unaligned else ""
            log(f"[ssd] {dname:8s} B,L,H,hd,ds,chunk={shape}{where}: max abs "
                f"err {e:.3e} (tol {tol})")
            if not ok:
                fail(f"ssd: kernel != plain for {shape}{where} in {dname}")
            err[(dname, shape, unaligned)] = e
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
        f"dtypes and the serve shape unaligned; decay bound holds; no NaN at "
        f"dt x 400")
    return err[("float32", tc.SSD_SERVE, False)]


def serve_counted(fixture: dict, phase: str):
    """``check_torch_serve.serve`` on the card with every kernel's count
    set to 0 just before it: (result, model, wall s, kernel launches,
    moe_gemm launches by body, DRAM-kernel launches)."""
    import check_torch_serve as cs
    from repro_torch import kernels
    from repro_torch.core.dram import cuda_step
    from repro_torch.kernels.moe_gemm import kernel as EK

    kernels.reset_launches()
    cuda_step.reset_launches()
    t0 = time.perf_counter()
    try:
        res = cs.serve(fixture, "cuda")
    except cs.CheckFailed as e:
        fail(f"{phase}: {e}")
    wall = time.perf_counter() - t0
    return (res, res.pop("model"), wall, kernels.launches(), dict(EK.BODIES),
            dict(cuda_step.LAUNCHES))


def log_serve(tag: str, res: dict, smi: str) -> None:
    import check_torch_serve as cs

    log(f"{tag} EngineStats {res['stats']} == fixture; tokens equal the "
        f"fixture's at {res['tokens_compared']} steps; near-tie steps (gap "
        f"< {cs.NEAR_TIE}): {res['near_ties']}")
    log(f"{tag} prefill {res['prefill_calls']} calls, {res['prefill_s']:.4f}s"
        f" ({res['prefill_tok_s']:.1f} tok/s); decode {res['decode_calls']} "
        f"calls, {res['decode_s']:.4f}s ({res['decode_tok_s']:.2f} tok/s); "
        f"card {smi}")


def phase_serve(smi: str):
    import torch_cases as tc

    fixture = tc.serve_fixture()
    # ---- the main path, counted
    res, model, wall, launches, _, dram = serve_counted(fixture, "serve")
    log(f"[serve] launch.serve --arch mamba2-780m (full width, fp32) with "
        f"the fixture's arguments on the card: {wall:.2f}s incl. weights "
        f"({res['build_s']:.2f}s) and checks; engine {res['wall_s']:.3f}s; "
        f"launches {launches}, DRAM kernels {dram}")
    if launches["ssd_scan"] != SERVE_SSD_LAUNCHES:
        fail(f"serve: expected {SERVE_SSD_LAUNCHES} ssd_scan launches, "
             f"counted {launches['ssd_scan']}")
    log_serve("[serve]", res, smi)
    res.update(launches=launches["ssd_scan"], wall_with_checks_s=wall)
    return res, model, fixture


def phase_logits(model, fixture, tag: str = "[logits]"):
    import check_torch_serve as cs

    try:
        tf = cs.teacher_forced(model, fixture)
    except cs.CheckFailed as e:
        fail(f"logits {fixture['args']['arch']}: {e}")
    log(f"{tag} teacher-forced: {tf['steps']} steps' top-8 logits within "
        f"rtol = atol = {cs.LOGIT_TOL}; max abs err {tf['max_abs_err']:.3e}, "
        f"max err / limit {tf['max_err_over_limit']:.3f}; top-1 equal at "
        f"{tf['top1_same']} of {tf['steps']} steps")
    return tf


def phase_profile(model, fixture, smi: str, tag: str = "[profile]"):
    import check_torch_serve as cs

    prof = cs.profile(model, fixture)
    if prof is None:
        log(f"{tag} the trace holds no device activity: busy share not "
            f"measured")
        return None
    for name, p in prof.items():
        log(f"{tag} {name}: wall {p['wall_ms']:.2f} ms under the "
            f"profiler, card busy {p['device_ms']:.2f} ms in "
            f"{p['device_ops']} kernels and copies (idle share "
            f"{p['idle_share']:.3f}); ssd_scan {p['ssd_scan_ms']:.2f} ms, "
            f"moe_gemm {p['moe_gemm_ms']:.2f} ms, other matmul (GEMM, GEMV) "
            f"{p['matmul_ms']:.2f} ms; card {smi}")
        for n, t, c in p["top"]:
            log(f"{tag}   {t:9.3f} ms  x{c:<5d} {n}")
    return prof


def phase_serve_model(arch: str, smi: str):
    """Main paths five and six: ``arch`` served at full width through
    ``check_torch_serve.serve`` (the launcher's path with the fixture's
    arguments), checked as the mamba2 serve phase is, then its
    teacher-forced logits and a profile. Every kernel's count is 0 just
    before the serve and read just after: smollm's path launches no kernel
    (attention is plain PyTorch, as in the reference), moonshot's exactly
    one grouped GEMM a MoE layer and product (up, gate, down) for each
    prefill and decode call, all on the simt body (fp32)."""
    import torch_cases as tc

    tag = f"[serve {arch}]"
    fixture = tc.serve_fixture(arch)
    # ---- the main path, counted
    res, model, wall, launches, bodies, dram = serve_counted(
        fixture, f"serve {arch}")
    cfg = model.cfg
    products = 3 if cfg.mlp_glu else 2
    moe_layers = sum(spec.ffn == "moe" for spec in cfg.layer_specs())
    want = dict.fromkeys(launches, 0)
    want["moe_gemm"] = moe_layers * products * (res["prefill_calls"]
                                                + res["decode_calls"])
    log(f"{tag} full width ({cfg.n_layers} layers, fp32) with the fixture's "
        f"arguments on the card: {wall:.2f}s incl. weights "
        f"({res['build_s']:.2f}s) and checks; engine {res['wall_s']:.3f}s; "
        f"launches {launches} (moe_gemm by body {bodies}), DRAM kernels "
        f"{dram}; card {smi}")
    if launches != want or any(dram.values()):
        fail(f"serve {arch}: expected launches {want} and no DRAM kernel, "
             f"counted {launches}, {dram}")
    if bodies != {"wgmma": 0, "simt": want["moe_gemm"]}:
        fail(f"serve {arch}: moe_gemm ran bodies {bodies}, expected "
             f"{want['moe_gemm']} on simt (fp32)")
    log_serve(tag, res, smi)
    res.update(launches=launches["moe_gemm"], wall_with_checks_s=wall,
               logits=phase_logits(model, fixture, tag),
               profile=phase_profile(model, fixture, smi, tag))
    return res


def phase_moe_time(smi: str):
    """The grouped GEMM at moonshot's serve shapes (``MOE_MOONSHOT``), fp32
    as the serve path runs it: kernel vs plain within 2e-4, then CUDA-event
    times of the kernel, its plain version and ``torch.bmm`` on the same
    capacity buffer, beside the bound. Every launch on the simt body."""
    from repro_torch.kernels.moe_gemm import capacity_block_eids
    from repro_torch.kernels.moe_gemm import kernel as EK

    gen = torch.Generator(device="cuda").manual_seed(KERNEL_TIME_SEED)
    E, D, F = MOE_MOONSHOT["E"], MOE_MOONSHOT["D"], MOE_MOONSHOT["F"]
    out = {}
    for C in MOE_MOONSHOT["capacities"]:
        eids = capacity_block_eids(E, C, C, device="cuda")
        T = E * C
        for prod, (k_in, k_out) in (("up", (D, F)), ("down", (F, D))):
            x = torch.randn((T, k_in), generator=gen, device="cuda")
            w = torch.randn((E, k_in, k_out), generator=gen,
                            device="cuda") * k_in ** -0.5
            flops = 2 * T * k_in * k_out
            EK.reset_launches()
            row = timing_row(
                f"moe_gemm moonshot {prod} C={C}",
                lambda: EK.grouped_matmul_kernel(x, w, eids, bt=C),
                lambda: EK.grouped_matmul_plain(x, w, eids, bt=C),
                lambda: torch.bmm(x.view(E, C, k_in), w), flops,
                4 * (T * k_in + E * k_in * k_out + T * k_out)
                + 4 * eids.numel(), "float32", reps=20)
            out[f"{prod}_c{C}"] = with_body(
                row, EK, f"moe_gemm moonshot {prod} C={C}", "float32", flops)
            del x, w
    log(f"[timing] moe_gemm at moonshot's serve shapes, card {smi}")
    return out


def ssd_bound(shape):
    """(bound_ms, bound_by) of one SSD-scan launch in float32: bytes of xr,
    l, b, c read once and y, hT written once; operations of the per-step
    recurrence, S_t = a_t S_{t-1} + B_t xr_t^T and y_t = C_t S_t, one FMA a
    state element for each, a head and step (4 L H ds hd FLOP a batch
    element). That is the least work of the function: a chunked walk does
    the same two products once a step and adds the masked C B^T of its
    chunks on top (16-step sub-chunks, as the kernel walks, add 3.5% at
    the serve shape), so the chunk length does not enter the bound."""
    B, L, H, hd, ds, _ = shape
    nbytes = 4 * (2 * B * H * L * hd + B * H * L + 2 * B * L * ds
                  + B * H * ds * hd)
    flops = 4 * B * L * H * ds * hd
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


# ---------------------------------------------------------------- kernels
def card_inputs(arrays, dtype):
    return [torch.from_numpy(a).to(device="cuda", dtype=dtype)
            for a in arrays]


def kernel_err(name: str, got, want, dname: str) -> float:
    """|kernel - plain|, failing the run outside the dtype's tolerance."""
    import torch_cases as tc

    tol = tc.TOLS[dname]
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{name}: kernel gave {got.dtype} {tuple(got.shape)}, plain "
             f"{want.dtype} {tuple(want.shape)}")
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        fail(f"{name}: kernel != plain in {dname} (rtol = atol = {tol})")
    return float((got.float() - want.float()).abs().max())


def refuses(name: str, exc, fn) -> None:
    """Fail unless ``fn`` raises ``exc`` before any launch."""
    from repro_torch import kernels

    before = kernels.launches()
    try:
        fn()
    except exc:
        if kernels.launches() != before:
            fail(f"kernels: {name} raised after launching")
        return
    fail(f"kernels: {name} did not raise {exc.__name__}")


def launch_shapes(mod, fn):
    """Run ``fn`` with ``mod._launch`` recording the shapes of its
    tensor arguments at every launch: (``fn()``, [shapes])."""
    seen, launch = [], mod._launch

    def spy(*args):
        seen.append(tuple(tuple(a.shape) for a in args
                          if isinstance(a, torch.Tensor)))
        return launch(*args)

    mod._launch = spy
    try:
        return fn(), seen
    finally:
        mod._launch = launch


def phase_kernels():
    import torch_cases as tc
    from repro_torch import cuda_build, kernels
    from repro_torch.kernels import (flash_attention, grouped_matmul,
                                     masa_gemm, paged_attention)
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.masa_gemm import kernel as MK
    from repro_torch.kernels.moe_gemm import capacity_block_eids
    from repro_torch.kernels.moe_gemm import kernel as EK
    from repro_torch.kernels.paged_attention import kernel as PK

    err = {k: {} for k in ("masa_gemm", "moe_gemm", "paged_attention",
                           "flash_attention")}
    bodies = {"masa_gemm": {}, "moe_gemm": {}, "paged_attention": {},
              "flash_attention": {}}
    n = 0

    def record(kernel, dname, e):
        nonlocal n
        n += 1
        err[kernel][dname] = max(err[kernel].get(dname, 0.0), e)

    def ran(kernel, mod, want, case):
        """Count the body of ``mod``'s one launch since its reset, failing
        unless it is ``want`` (the wrapper's choice by shape)."""
        if mod.BODIES != {b: int(b == want) for b in mod.BODIES}:
            fail(f"kernels: {kernel} {case} ran bodies {mod.BODIES}, "
                 f"expected one {want}")
        bodies[kernel][want] = bodies[kernel].get(want, 0) + 1

    # weight-stationary takes a K that is no multiple of bk, as the
    # reference does, on both sides of the fallback
    for m, k, nn, dname in tc.MASA_WS_ODD_K:
        a, b = card_inputs(tc.masa_inputs(m, k, nn), getattr(torch, dname))
        kernels.reset_launches()
        got = masa_gemm(a, b, order="weight_stationary")
        ws = MK.ws_panel_bytes(k, a.dtype) <= cuda_build.MAX_SMEM_BYTES
        if MK.LAUNCHES != {"masa_gemm_os": int(not ws), "masa_gemm_ws": int(ws)}:
            fail(f"kernels: masa_gemm weight_stationary at K={k} {dname} "
                 f"launched {MK.LAUNCHES}")
        ran("masa_gemm", MK, MK.body(a, b), f"K={k} {dname}")
        record("masa_gemm", dname, kernel_err(
            f"masa_gemm weight_stationary {m}x{k}x{nn}", got,
            MK.masa_gemm_plain(a, b), dname))

    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for m, k, nn in tc.MASA_SHAPES:
            a, b = card_inputs(tc.masa_inputs(m, k, nn), dtype)
            for order in MK.ORDERS:
                kernels.reset_launches()
                got = masa_gemm(a, b, order=order)
                ws = (order == "weight_stationary" and MK.ws_panel_bytes(
                    k, dtype) <= cuda_build.MAX_SMEM_BYTES)
                if MK.LAUNCHES != {"masa_gemm_os": int(not ws),
                                   "masa_gemm_ws": int(ws)}:
                    fail(f"kernels: masa_gemm {order} at K={k} launched "
                         f"{MK.LAUNCHES}")
                ran("masa_gemm", MK, MK.body(a, b),
                    f"{order} {m}x{k}x{nn} {dname}")
                record("masa_gemm", dname, kernel_err(
                    f"masa_gemm {order} {m}x{k}x{nn}", got,
                    MK.masa_gemm_plain(a, b), dname))
        for E, C, D, F, bt, bf in tc.MOE_SHAPES:
            x, w = card_inputs(tc.moe_inputs(E, C, D, F, seed=1), dtype)
            eids = capacity_block_eids(E, C, bt, device="cuda")
            for ids in (eids, eids.flip(0).contiguous()):
                EK.reset_launches()
                got = grouped_matmul(x, w, ids, bt=bt, bf=bf)
                ran("moe_gemm", EK, EK.body(x, w, bt),
                    f"{(E, C, D, F, bt)} {dname}")
                record("moe_gemm", dname, kernel_err(
                    f"moe_gemm {(E, C, D, F, bt)}", got,
                    EK.grouped_matmul_plain(x, w, ids, bt=bt), dname))
        paged_cases = (
            [(f"{shape}", tc.paged_inputs(*shape, seed=3))
             for shape in tc.PAGED_SHAPES]
            + [(f"edge {case[0]} lens {case[1]} page {case[2]}",
                tc.paged_edge_inputs(*case)) for case in tc.PAGED_EDGE])
        for name, (q, kp, vp, table, lens) in paged_cases:
            args = card_inputs((q, kp, vp), dtype) + [
                torch.from_numpy(t).cuda() for t in (table, lens)]
            want = PK.paged_attention_plain(*args)
            PK.reset_launches()
            got = paged_attention(*args)
            ran("paged_attention", PK, PK.body(*args[:3]),
                f"{name} {dname}")
            record("paged_attention", dname, kernel_err(
                f"paged_attention {name}", got, want, dname))
            # both bodies forced, the split one at every cluster size
            for which, n_split in (("serial", None), ("split", 1),
                                   ("split", 2), ("split", 4), ("split", 8)):
                PK.reset_launches()
                got = PK._launch(*args, which, n_split)
                if PK.BODIES != {b: int(b == which) for b in PK.BODIES}:
                    fail(f"kernels: paged_attention {name} {which} "
                         f"{n_split} ran {PK.BODIES}")
                record("paged_attention", dname, kernel_err(
                    f"paged_attention {name} {which} x{n_split}", got, want,
                    dname))
        # seq_lens 0, 1, a partial page and full; out-of-range table
        # entries, clamped by ops as in the reference
        q, kp, vp, table, _ = tc.paged_inputs(4, 2, 4, 64, 16, 16, 4, seed=5)
        table = table.copy()
        table[0, 3], table[1, 0], table[2, 2] = -7, 16, 1000
        args = card_inputs((q, kp, vp), dtype) + [
            torch.from_numpy(table).cuda(),
            torch.tensor([0, 1, 21, 64], dtype=torch.int32, device="cuda")]
        clamped = args[3].clamp(0, 15).to(torch.int32)
        PK.reset_launches()
        got = paged_attention(*args)
        ran("paged_attention", PK, "split", f"clamped table {dname}")
        record("paged_attention", dname, kernel_err(
            "paged_attention lengths 0/1/21/64, clamped table", got,
            PK.paged_attention_plain(*args[:3], clamped, args[4]), dname))
        for bh, s, hd, bq, bk in tc.FLASH_SHAPES + ((2, 128, 96, 128, 128),
                                                    (1, 100, 64, 100, 50)):
            t = card_inputs(tc.flash_inputs(bh, s, hd), dtype)
            for causal in (True, False):
                case = f"flash_attention {(bh, s, hd)} causal={causal}"
                FK.reset_launches()
                got = FK.flash_attention_kernel(*t, causal=causal, bq=bq,
                                                bk=bk)
                ran("flash_attention", FK, FK.body(*t), f"{case} {dname}")
                record("flash_attention", dname, kernel_err(
                    case, got,
                    FK.flash_attention_plain(*t, causal=causal, bk=bk),
                    dname))
        # GQA through ops (8 query heads on 2 kv heads of 128): one launch,
        # on the unexpanded kv heads
        rng = np.random.default_rng(11)
        q, k, v = card_inputs([rng.standard_normal(sh).astype(np.float32)
                               for sh in ((2, 256, 8, 128), (2, 256, 2, 128),
                                          (2, 256, 2, 128))], dtype)
        flat = [t.repeat_interleave(8 // t.shape[2], dim=2).transpose(1, 2)
                .reshape(16, 256, 128) for t in (q, k, v)]
        want = FK.flash_attention_plain(*flat, causal=True)
        FK.reset_launches()
        got, shapes = launch_shapes(FK, lambda: flash_attention(q, k, v))
        if shapes != [((16, 256, 128), (4, 256, 128), (4, 256, 128))]:
            fail(f"kernels: flash_attention GQA through ops launched on "
                 f"{shapes}, expected one launch on kv [4, 256, 128]")
        ran("flash_attention", FK, FK.body(q, k, v),
            f"GQA through ops {dname}")
        record("flash_attention", dname, kernel_err(
            "flash_attention GQA through ops", got,
            want.reshape(2, 8, 256, 128).transpose(1, 2), dname))
    # bf16 on bases that are not 16-byte aligned takes the simt body, with
    # k/v of BH / g rows read in the kernel
    for bh, s, hd, bq, bk, g in tc.FLASH_SHIFTED:
        q, k, v = (tc.shifted(t) for t in card_inputs(
            tc.flash_inputs(bh, s, hd, seed=6), torch.bfloat16))
        k, v = tc.shifted(k[:bh // g]), tc.shifted(v[:bh // g])
        FK.check_blocks(s, bq, bk)
        for causal in (True, False):
            case = f"flash_attention unaligned {(bh, s, hd)} g={g} " \
                   f"causal={causal}"
            FK.reset_launches()
            got = FK.run(q, k, v, causal=causal, bk=bk)
            ran("flash_attention", FK, "simt", f"{case} bfloat16")
            record("flash_attention", "bfloat16", kernel_err(
                case, got,
                FK.flash_attention_plain(q, k, v, causal=causal, bk=bk),
                "bfloat16"))
    torch.cuda.synchronize()

    # ---- refusals: no fallback to the plain version
    a = torch.randn((128, 256), device="cuda")
    x = torch.randn((256, 64), device="cuda")
    w = torch.randn((2, 64, 128), device="cuda")
    ids = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    q = torch.randn((2, 2, 4, 64), device="cuda")
    kp = torch.randn((8, 16, 2, 64), device="cuda")
    tab = torch.zeros((2, 4), dtype=torch.int32, device="cuda")
    lens = torch.ones(2, dtype=torch.int32, device="cuda")
    big = torch.randn((1, 1, 256, 256), device="cuda")
    pages = torch.randn((2, 16, 1, 256), device="cuda")
    one = torch.ones((1, 1), dtype=torch.int32, device="cuda")
    f48 = torch.randn((2, 128, 48), device="cuda")
    f64 = torch.randn((2, 128, 64), device="cuda")
    refusals = [
        ("masa_gemm non-contiguous", ValueError,
         lambda: MK.masa_gemm_kernel(a, a.t())),
        ("masa_gemm float64", TypeError,
         lambda: MK.masa_gemm_kernel(a.double(), a.t().contiguous().double())),
        ("masa_gemm weight-stationary K=512 float32", ValueError,
         lambda: MK.masa_gemm_kernel(torch.randn((128, 512), device="cuda"),
                                     torch.randn((512, 128), device="cuda"),
                                     order="weight_stationary")),
        ("moe_gemm int64 ids", TypeError,
         lambda: EK.grouped_matmul_kernel(x, w, ids.long())),
        ("moe_gemm mixed dtypes", TypeError,
         lambda: EK.grouped_matmul_kernel(x.bfloat16(), w, ids)),
        ("moe_gemm non-contiguous", ValueError,
         lambda: EK.grouped_matmul_kernel(
             x, w.transpose(1, 2).contiguous().transpose(1, 2), ids)),
        ("moe_gemm id out of range", ValueError,
         lambda: grouped_matmul(x, w, ids + 1)),
        ("paged_attention int64 table", TypeError,
         lambda: PK.paged_attention_kernel(q, kp, kp, tab.long(), lens)),
        ("paged_attention non-contiguous", ValueError,
         lambda: PK.paged_attention_kernel(
             q.transpose(2, 3).contiguous().transpose(2, 3), kp, kp, tab,
             lens)),
        ("paged_attention G=256 hd=256 (the serial body's shared memory)",
         ValueError,
         lambda: PK.paged_attention_kernel(big, pages, pages, one, one[0])),
        ("paged_attention split body forced at G=9", ValueError,
         lambda: PK._launch(q.repeat(1, 1, 3, 1)[:, :, :9].contiguous(), kp,
                            kp, tab, lens, "split")),
        ("paged_attention 3 splits", ValueError,
         lambda: PK._launch(q, kp, kp, tab, lens, "split", 3)),
        ("flash_attention hd=48", ValueError,
         lambda: FK.flash_attention_kernel(f48, f48, f48)),
        ("flash_attention float16", TypeError,
         lambda: FK.flash_attention_kernel(f64.half(), f64.half(),
                                           f64.half())),
        ("flash_attention non-contiguous", ValueError,
         lambda: FK.flash_attention_kernel(
             f64.transpose(1, 2).contiguous().transpose(1, 2), f64, f64)),
    ]
    for name, exc, fn in refusals:
        refuses(name, exc, fn)
    for kernel, e in err.items():
        log(f"[kernels] {kernel}: kernel == plain on the card, max abs err "
            f"float32 {e['float32']:.3e}, bfloat16 {e['bfloat16']:.3e}")
    log(f"[kernels] {n} cases in float32 (rtol = atol = "
        f"{tc.TOLS['float32']}) and bfloat16 ({tc.TOLS['bfloat16']}); "
        f"{len(refusals)} refusals raised before any launch; bodies by "
        f"case {bodies}")
    return err, bodies


# ----------------------------------------------------------- kernel_bench
def phase_kernel_bench():
    from repro_torch import kernel_bench, kernels
    from repro_torch.core.dram import cuda_step

    # ---- main path four, counted
    kernels.reset_launches()
    cuda_step.reset_launches()
    t0 = time.perf_counter()
    res = kernel_bench.run()
    wall = time.perf_counter() - t0
    launches, dram = kernels.launches(), dict(cuda_step.LAUNCHES)
    log(f"[kernel_bench] kernel_bench.run() on the card: {wall:.3f}s; "
        f"launches {launches}, DRAM kernels {dram}")
    if res["device"] != "cuda" or res["kernels_ok"] is not True:
        fail(f"kernel_bench: kernels_ok {res['kernels_ok']} on "
             f"{res['device']}")
    bad = {k: e for k, e in res["errs"].items()
           if not 0 <= e < kernel_bench.ERR_TOL}
    if set(res["errs"]) != BENCH_ERRS or bad:
        fail(f"kernel_bench: errs {res['errs']}")
    if res["moe_hit"] != 8 / 15:
        fail(f"kernel_bench: moe_hit {res['moe_hit']}, expected 8/15")
    if launches != BENCH_LAUNCHES or any(dram.values()):
        fail(f"kernel_bench: expected launches {BENCH_LAUNCHES} and no DRAM "
             f"kernel, counted {launches}, {dram}")
    ladder = res["ladder"]
    if not ladder["masa"] >= ladder["salp1"] > 1.0 == ladder["baseline"]:
        fail(f"kernel_bench: ladder {ladder}")
    log(f"[kernel_bench] errs {res['errs']} (< {kernel_bench.ERR_TOL}); "
        f"moe_hit {res['moe_hit']:.4f}; ladder {ladder}")
    res["wall_s"] = wall
    return res


# ------------------------------------------------------------ kernel_time
def bound_of(flops: float, nbytes: float, dname: str):
    """(bound_ms, bound_by): the larger of operations over the dtype's peak
    and bytes over the HBM rate."""
    peak = PEAK_BF16_FLOPS if dname == "bfloat16" else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def timing_row(name, kernel, plain, library, flops, nbytes, dname, reps):
    """Kernel vs plain at one shape (the run fails outside tolerance), then
    CUDA-event times of the kernel, its plain version and the library
    call, beside the bound."""
    e = kernel_err(name, kernel(), plain(), dname)
    row = dict(max_abs_err=e,
               ms=time_ms(kernel, reps, warmup=1),
               plain_ms=time_ms(plain, 2, warmup=1),
               library_ms=(time_ms(library, reps, warmup=1)
                           if library else None))
    row["bound_ms"], row["bound_by"] = bound_of(flops, nbytes, dname)
    lib = f"{row['library_ms']:.4f} ms" if library else "none"
    log(f"[timing] {name} {dname}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, library {lib}, bound "
        f"{row['bound_ms']:.5f} ms ({row['bound_by']}), kernel / bound "
        f"{row['ms'] / row['bound_ms']:.1f}x; max abs err {e:.3e}")
    return row


def body_ran(mod, name: str, dname: str) -> str:
    """The body of ``mod``'s launches since its reset: fails unless all took
    wgmma in bfloat16 and simt in float32 (the jamba shapes suit wgmma)."""
    want = "wgmma" if dname == "bfloat16" else "simt"
    if not mod.BODIES[want] or any(c for b, c in mod.BODIES.items()
                                   if b != want):
        fail(f"kernel_time: {name} {dname} ran bodies {mod.BODIES}, "
             f"expected only {want}")
    return want


def with_body(row: dict, mod, name: str, dname: str, flops: float) -> dict:
    """Add the body that ran and the achieved TFLOP/s to a timing row."""
    row["body"] = body_ran(mod, name, dname)
    row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
    log(f"[timing] {name} {dname}: {row['body']} body, "
        f"{row['tflops']:.1f} TFLOP/s")
    return row


def moe_raster_study(x, w, eids, bt: int, reps: int) -> dict:
    """The designation's hit moved to L2, at jamba's MoE shape: wgmma times
    with the launch raster's groups of ``GROUP_M`` row tiles (the default),
    with groups of 1 (each row tile across all of F before the next), and
    with a scattered designation (token block i takes expert i % E, so the
    blocks that share a W tile launch E token blocks apart). Each is
    held to the plain version."""
    from repro_torch.kernels.moe_gemm import kernel as EK

    E = w.shape[0]
    scattered = (torch.arange(eids.numel(), device="cuda") % E).to(torch.int32)
    out = {"group_m": EK.GROUP_M}
    for name, ids, group_m in (("capacity", eids, EK.GROUP_M),
                               ("capacity_group_m_1", eids, 1),
                               ("scattered", scattered, EK.GROUP_M)):
        default, EK.GROUP_M = EK.GROUP_M, group_m
        try:
            kernel_err(f"moe_gemm {name}", EK.grouped_matmul_kernel(
                x, w, ids, bt=bt), EK.grouped_matmul_plain(x, w, ids, bt=bt),
                "bfloat16")
            out[f"{name}_ms"] = time_ms(
                lambda: EK.grouped_matmul_kernel(x, w, ids, bt=bt), reps, 1)
        finally:
            EK.GROUP_M = default
    log(f"[timing] moe_gemm raster bfloat16: capacity layout in groups of "
        f"{out['group_m']} {out['capacity_ms']:.4f} ms, in groups of 1 "
        f"{out['capacity_group_m_1_ms']:.4f} ms, scattered designation "
        f"{out['scattered_ms']:.4f} ms")
    return out


def phase_kernel_time(smi: str):
    import torch_cases as tc
    import torch.nn.functional as Fn
    from repro_torch import cuda_build
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention as flash_ops)
    from repro_torch.kernels.masa_gemm import kernel as MK, ops as masa_ops
    from repro_torch.kernels.moe_gemm import capacity_block_eids
    from repro_torch.kernels.moe_gemm import kernel as EK
    from repro_torch.kernels.paged_attention import kernel as PK

    gen = torch.Generator(device="cuda").manual_seed(KERNEL_TIME_SEED)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    out = {k: {} for k in ("flash_attention", "paged_attention", "moe_gemm",
                           "masa_gemm")}
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        es = dtype.itemsize
        # the GEMMs' launches timed: the fp32 simt bodies take ~10 ms each
        reps = 10 if dname == "bfloat16" else 3
        # ---- flash: jamba's attention layer, causal prefill of 2048
        s = tc.FLASH_JAMBA
        B, S, H, Hkv, hd = s["B"], s["S"], s["H"], s["Hkv"], s["hd"]
        q = randn((B, H, S, hd), dtype)
        k, v = randn((B, Hkv, S, hd), dtype), randn((B, Hkv, S, hd), dtype)
        ke, ve = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
        qf, kf, vf = (t.reshape(B * H, S, hd) for t in (q, ke, ve))
        pairs = B * H * S * (S + 1) // 2
        FK.reset_launches()
        row = timing_row(
            "flash_attention", lambda: FK.flash_attention_kernel(qf, kf, vf),
            lambda: FK.flash_attention_plain(qf, kf, vf),
            lambda: Fn.scaled_dot_product_attention(q, ke, ve,
                                                    is_causal=True),
            4 * hd * pairs, es * 4 * B * H * S * hd, dname, reps=10)
        with_body(row, FK, "flash_attention", dname, 4 * hd * pairs)
        row["library_gqa_ms"] = time_ms(
            lambda: Fn.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                    enable_gqa=True), 10, 1)
        # ops on the 8 unexpanded kv heads, in the model's [B, S, H, hd]
        # layout (views of the same storage: ops copies nothing)
        gqa = lambda: flash_ops(*(t.transpose(1, 2) for t in (q, k, v)))
        FK.reset_launches()
        got, shapes = launch_shapes(FK, gqa)
        if shapes != [((B * H, S, hd), (B * Hkv, S, hd), (B * Hkv, S, hd))]:
            fail(f"kernel_time: flash_attention through ops launched on "
                 f"{shapes}, expected one launch on the {B * Hkv} kv heads")
        row["ops_gqa_max_abs_err"] = kernel_err(
            "flash_attention through ops (8 kv heads)",
            got.transpose(1, 2).reshape(B * H, S, hd),
            FK.flash_attention_kernel(qf, kf, vf), dname)
        row["ops_gqa_ms"] = time_ms(gqa, 10, 1)
        body_ran(FK, "flash_attention through ops", dname)
        log(f"[timing] flash_attention through ops on {Hkv} kv heads "
            f"{dname}: {row['ops_gqa_ms']:.4f} ms, "
            f"{4 * hd * pairs / (row['ops_gqa_ms'] * 1e-3) / 1e12:.1f} "
            f"TFLOP/s; SDPA enable_gqa {row['library_gqa_ms']:.4f} ms")
        out["flash_attention"][dname] = row
        del q, k, v, ke, ve, qf, kf, vf
        # ---- paged: one decode step at batch 32, 2048 tokens, private pages
        s = tc.PAGED_JAMBA
        B, KVH, G, hd, page, P = (s["B"], s["KVH"], s["G"], s["hd"],
                                  s["page"], s["P"])
        npg = s["seq"] // page
        q = randn((B, KVH, G, hd), dtype)
        kp, vp = randn((P, page, KVH, hd), dtype), randn((P, page, KVH, hd),
                                                        dtype)
        table = torch.randperm(P, generator=gen, device="cuda").to(
            torch.int32).reshape(B, npg)
        lens = torch.full((B,), s["seq"], dtype=torch.int32, device="cuda")
        kv_bytes = 2 * es * B * npg * page * KVH * hd
        PK.reset_launches()
        row = timing_row(
            "paged_attention",
            lambda: PK.paged_attention_kernel(q, kp, vp, table, lens),
            lambda: PK.paged_attention_plain(q, kp, vp, table, lens), None,
            4 * B * KVH * G * s["seq"] * hd,
            kv_bytes + es * 2 * q.numel() + 4 * (table.numel() + B), dname,
            reps=20)
        if not PK.BODIES["split"] or PK.BODIES["serial"]:
            fail(f"kernel_time: paged_attention {dname} ran bodies "
                 f"{PK.BODIES}, expected only split")
        # the serial body (the kernel before the split one), in turns
        serial = lambda: PK._launch(q, kp, vp, table, lens, "serial")
        split = lambda: PK.paged_attention_kernel(q, kp, vp, table, lens)
        turns = [time_ms(f, 20, 1) for f in (serial, split, split, serial)]
        row.update(kv_bytes=kv_bytes, body="split",
                   splits=PK.splits(B, KVH, npg * page),
                   split_ms=(turns[1] + turns[2]) / 2,
                   serial_ms=(turns[0] + turns[3]) / 2)
        log(f"[timing] paged_attention {dname}: split body ({row['splits']} "
            f"block(s) a pair) {row['split_ms']:.4f} ms, serial body "
            f"{row['serial_ms']:.4f} ms, in turns")
        out["paged_attention"][dname] = row
        del q, kp, vp
        # ---- moe: jamba's expert FFN up-projection, capacity layout
        s = tc.MOE_JAMBA
        E, C, D, F, bt = s["E"], s["C"], s["D"], s["F"], s["bt"]
        x, w = randn((E * C, D), dtype), randn((E, D, F), dtype, D ** -0.5)
        eids = capacity_block_eids(E, C, bt, device="cuda")
        T = E * C
        EK.reset_launches()
        row = timing_row(
            "moe_gemm", lambda: EK.grouped_matmul_kernel(x, w, eids, bt=bt),
            lambda: EK.grouped_matmul_plain(x, w, eids, bt=bt),
            lambda: torch.bmm(x.view(E, C, D), w), 2 * T * D * F,
            es * (T * D + E * D * F + T * F) + 4 * eids.numel(), dname,
            reps=reps)
        out["moe_gemm"][dname] = with_body(row, EK, "moe_gemm", dname,
                                           2 * T * D * F)
        if dname == "bfloat16":
            row["raster"] = moe_raster_study(x, w, eids, bt, reps)
        del x, w
        torch.cuda.empty_cache()
        # ---- masa: a dense FFN up-projection of 2048 tokens, both orders
        s = tc.MASA_JAMBA
        M, K, N = s["M"], s["K"], s["N"]
        a, b = randn((M, K), dtype), randn((K, N), dtype, K ** -0.5)
        MK.reset_launches()
        masa_ops.masa_gemm(a, b, order="weight_stationary")
        if MK.LAUNCHES != {"masa_gemm_os": 1, "masa_gemm_ws": 0}:
            fail(f"kernel_time: weight-stationary at K={K} launched "
                 f"{MK.LAUNCHES}, not the output-stationary fallback")
        log(f"[timing] masa_gemm weight_stationary at K={K} {dname}: the "
            f"panel needs {MK.ws_panel_bytes(K, dtype)} bytes of "
            f"shared memory (> {cuda_build.MAX_SMEM_BYTES}), so ops.masa_gemm ran "
            f"output_stationary")
        MK.reset_launches()
        row = timing_row(
            "masa_gemm output_stationary",
            lambda: MK.masa_gemm_kernel(a, b), lambda: MK.masa_gemm_plain(a, b),
            lambda: torch.matmul(a, b), 2 * M * K * N,
            es * (M * K + K * N + M * N), dname, reps=reps)
        with_body(row, MK, "masa_gemm output_stationary", dname, 2 * M * K * N)
        s = tc.MASA_WS_JAMBA
        M, K, N = s["M"], s["K"], s["N"]
        a, b = randn((M, K), dtype), randn((K, N), dtype, K ** -0.5)
        MK.reset_launches()
        ws = timing_row(
            "masa_gemm weight_stationary",
            lambda: MK.masa_gemm_kernel(a, b, order="weight_stationary"),
            lambda: MK.masa_gemm_plain(a, b), lambda: torch.matmul(a, b),
            2 * M * K * N, es * (M * K + K * N + M * N), dname, reps=2 * reps)
        with_body(ws, MK, "masa_gemm weight_stationary", dname, 2 * M * K * N)
        ws["output_stationary_ms"] = time_ms(lambda: MK.masa_gemm_kernel(a, b),
                                             2 * reps, 1)
        log(f"[timing] masa_gemm at M={M} K={K} N={N} {dname}: "
            f"weight_stationary {ws['ms']:.4f} ms, output_stationary "
            f"{ws['output_stationary_ms']:.4f} ms")
        row["weight_stationary"] = ws
        out["masa_gemm"][dname] = row
        del a, b
        torch.cuda.empty_cache()
    log(f"[timing] kernel_time card {smi}")
    return out


#: The accelerator layer's kernels: (name, source, the TPU kernel it
#: replaces, the jamba shape timed and, for flash and the GEMMs, their
#: bodies).
LAYER_KERNELS = (
    ("flash_attention",
     "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention/kernel.py:60",
     "B=1 S=2048 H=32 Hkv=8 hd=128 causal, kernel on the GQA-expanded "
     "[32, 2048, 128] (jamba-v0.1-52b attention prefill; ops_gqa_ms: "
     "through ops on the 8 kv heads, indexed in the kernel); bf16 on the "
     "wgmma body (128 query rows a block in two consumer warpgroups, K/V "
     "tiles of 128 through a 2-stage TMA ring, S = Q K^T and O += P V on "
     "wgmma, P from registers, the online softmax on the accumulator "
     "fragment), fp32 on the simt body"),
    ("paged_attention",
     "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention/kernel.py:67",
     "B=32 KVH=8 G=4 hd=128 page=16 seq=2048 private pages P=4096 "
     "(jamba-v0.1-52b decode step); the split body (kernel.splits blocks "
     "a sequence x kv head in one cluster, four warps a block streaming "
     "K/V rows through cp.async rings, the online softmax in registers); "
     "serial_ms the serial body, in turns"),
    ("moe_gemm", "src/repro_torch/kernels/moe_gemm/csrc/moe_gemm.cu",
     "src/repro/kernels/moe_gemm/kernel.py:28",
     "E=16 C=384 D=4096 F=14336 bt=128 (jamba-v0.1-52b MoE up-projection "
     "of 2048 tokens); bf16 on the wgmma body (128 x 256 tiles, TMA ring of "
     "4 stages, W through a rank-3 tensor map at the block's expert, tiles "
     "rastered M fastest in groups of 12 row tiles), fp32 on the simt "
     "body"),
    ("masa_gemm", "src/repro_torch/kernels/masa_gemm/csrc/masa_gemm.cu",
     "src/repro/kernels/masa_gemm/kernel.py:53",
     "M=2048 K=4096 N=14336 output_stationary (weight_stationary falls back "
     "there; timed at K=256) (jamba-v0.1-52b dense FFN up-projection); "
     "bf16 on the wgmma body (output-stationary 128 x 256 tiles, TMA ring "
     "of 4 stages; weight-stationary a resident [K, 128] panel with A "
     "through a ring per consumer warpgroup), fp32 on the simt body"),
)


def layer_records(sweep, bench, ktime) -> list[dict]:
    """The record line's entries of the four accelerator-layer kernels:
    launches from main path four (kernel_bench.run), times at the jamba
    shapes in bfloat16 (float32 beside them), and the bodies of the GEMMs
    and flash by sweep case."""
    sweep_err, bodies = sweep
    out = []
    for name, source, replaces, shape in LAYER_KERNELS:
        launches = {k: v for k, v in bench["launches"].items()
                    if k.startswith(name)}
        bf, f32 = ktime[name]["bfloat16"], ktime[name]["float32"]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": sum(launches.values()),
                 "max_abs_err": bf["max_abs_err"],
                 **{k: bf[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
                 "shape": shape + "; ms, plain_ms, library_ms and bound_ms "
                          "in bfloat16",
                 "bfloat16": bf, "float32": f32,
                 "sweep_max_abs_err": sweep_err[name]}
        if name == "masa_gemm":
            entry["launches_by_order"] = launches
        if name in bodies:
            entry["sweep_bodies"] = bodies[name]
        out.append(entry)
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
    run_phase("global_body", phase_global_body)
    fig4 = run_phase("fig4", phase_fig4)
    mc = run_phase("multicore", phase_multicore, smi)
    sw = run_phase("sweep", phase_sweep, smi, fig4["wall_s"],
                   mc["sched_wall_s"])
    thr = run_phase("timing", phase_throughput, smi)
    ssd_err = run_phase("ssd", phase_ssd)
    serve, model, fixture = run_phase("serve", phase_serve, smi)
    tf = run_phase("logits", phase_logits, model, fixture)
    prof = run_phase("profile", phase_profile, model, fixture, smi)
    del model
    served = {arch: run_phase(f"serve_{arch.split('-')[0]}",
                              phase_serve_model, arch, smi)
              for arch in SERVE_ARCHS}
    moe_t = run_phase("moe_time", phase_moe_time, smi)
    ssd_t = run_phase("ssd_time", phase_ssd_time, smi)
    sweep = run_phase("kernels", phase_kernels)
    bench = run_phase("kernel_bench", phase_kernel_bench)
    ktime = run_phase("kernel_time", phase_kernel_time, smi)
    b_ms, b_by = bound(fig4["B"], fig4["N"])
    fig4.update(per_step(fig4["ms"], fig4["N"], fig4["clock_mhz"]),
                req_per_s=fig4["B"] * fig4["N"] / fig4["ms"] * 1e3)
    chain_ms = chain_estimate_ms(fig4["N"], LANE_STEP_PATH, fig4["clock_mhz"])
    log(f"[timing] fig4 per launch (mean of 5 policies): smem "
        f"{fig4['ms']:.4f} ms ({fig4['us_per_step']:.4f} us, "
        f"{fig4['cycles_per_step']:.0f} cycles a step at "
        f"{fig4['clock_mhz']:.0f} MHz), global {fig4['global_ms']:.4f} ms, "
        f"plain {fig4['plain_ms']:.1f} ms, bound {b_ms:.5f} ms ({b_by}), "
        f"chain estimate {chain_ms:.4f} ms; "
        f"{fig4['req_per_s']:.4e} req/s; card {smi}")
    if "jax" in sys.modules or any(m.split(".")[0] in ("repro", "benchmarks")
                                   for m in sys.modules):
        fail("the JAX package or its benches were imported")
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    lane_launches = {"fig4": fig4["launches"],
                     "multicore": mc["launches"]["lane_step"],
                     "sweep": sw["launches"]["lane_step"]}
    mix_launches = {"multicore": mc["launches"]["mix_step"],
                    "sweep": sw["launches"]["mix_step"]}
    record = {"kernels": [{
        "name": "lane_step", "route": "cuda",
        "source": "src/repro_torch/core/dram/csrc/lane_step.cu",
        "replaces": "src/repro/core/dram/pallas_step.py:92",
        "launches": sum(lane_launches.values()),
        "launches_by_path": lane_launches,
        "max_abs_err": fig4["max_abs_err"],
        "ms": fig4["ms"], "plain_ms": fig4["plain_ms"], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None, "body": "smem",
        **{k: fig4[k] for k in ("global_ms", "us_per_step", "cycles_per_step",
                                "clock_mhz", "req_per_s")},
        "shape": f"B={fig4['B']} N={fig4['N']} (Fig. 4, mean of 5 policies; "
                 f"ms the smem body, global_ms the global body, in turns)",
        "throughput": thr, "sweep": sw}, {
        "name": "mix_step", "route": "cuda",
        "source": "src/repro_torch/core/dram/csrc/mix_step.cu",
        "replaces": "src/repro/core/dram/pallas_step.py:160",
        "launches": sum(mix_launches.values()),
        "launches_by_path": mix_launches,
        "max_abs_err": max(mc["max_abs_err"], mc_plain_err),
        "ms": mc["ms"], "plain_ms": mc["plain_ms"],
        "bound_ms": mc["bound_ms"], "bound_by": mc["bound_by"],
        "library_ms": None, "body": "smem",
        **{k: mc[k] for k in ("global_ms", "us_per_step", "cycles_per_step",
                              "clock_mhz", "req_per_s")},
        "shape": f"M={mc['M']} C={mc['C']} N={mc['N']} (run_multicore, "
                 f"mean of 7 points; plain_ms MASA FR-FCFS; ms the smem body, "
                 f"global_ms the global body, in turns)",
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
    record["kernels"] += layer_records(sweep, bench, ktime)
    moe = next(k for k in record["kernels"] if k["name"] == "moe_gemm")
    moe["launches_by_path"] = {"kernel_bench": moe["launches"],
                               "serve_moonshot": served[SERVE_ARCHS[1]][
                                   "launches"]}
    moe["launches"] = sum(moe["launches_by_path"].values())
    moe["moonshot_float32"] = moe_t
    moe["serve_moonshot"] = {k: served[SERVE_ARCHS[1]][k] for k in (
        "stats", "build_s", "wall_s", "prefill_s", "decode_s",
        "prefill_tok_s", "decode_tok_s", "near_ties", "tokens_compared",
        "logits", "profile")}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
