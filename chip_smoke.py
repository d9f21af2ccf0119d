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
11. commands  — the DRAM command stream on the card: the 50 single-core
                and 4 multicore cells of ``tests/data/golden_commands.json``
                exported by the plain emitting step (``simulate_commands``,
                ``simulate_mix_commands``): every sha256 pin and the 3 texts
                equal, zero JEDEC checker violations; the lane and mix
                kernels on the same traces (50 lane launches, 4 mix + 4
                lane): every counter but ``sa_open_cycles`` equals
                ``counters_from_commands``, completions equal
                ``completions_from_commands`` and per-core cycles the
                stream's last completions; then ``refresh_bench.run()`` (33
                lane launches) and ``memtech_bench.run()`` (17 lane, 4 mix)
                at full size: their artifacts pass the port's validators and
                ``check_commands_file``, every cell, PALP latency and command
                slice equals ``tests/data/torch_refresh_memtech_fixture.json``
                (made by the JAX package), ``DDR3_PIN_WANT`` holds. Prints
                the export's ms a step, the checker's µs a command and each
                bench's wall and launches.
12. benches   — the paper's remaining benches through the port's runner
                (``repro_torch.benchmarks.run.main``, ``--suite
                paper,sens,system,mapping,accel,smoke``) on the card, from a
                fresh result cache, each bench's launch counts set to 0 just
                before it and read just after: every bench returns a
                summary, and each equals the JAX fixture's
                (``tests/data/torch_paper_benches_fixture.json``; the
                kernels entry is held to its tolerance instead); every sweep
                cell equals the fixtures (Fig. 4 ``torch_fig4_n8000.json``,
                sched ``torch_multicore_fixture.json``, sens_subarrays,
                sens_banks, mapping and smoke the new fixture), and so do
                fig5's and row_policy's ``simulate_batch`` counters and the
                multicore bench's mixes; the smoke, mapping and kernels
                suites validate (smoke with ``--check-commands``); exact
                lane and mix launches per bench, all on the smem body
                (``BENCH_RUN_LAUNCHES``), and the kernels entry's accelerator
                launches. Then ``--only perf`` (its launches from its cells,
                ``perf_launches``) validated with ``--perf-guard``, printing
                every cell's req/s, the kernel's beside the plain
                version's; then the smoke drills, each from a fresh cache:
                ``--inject-faults raise@c4:p`` + ``--expect-quarantine``, a
                journal run twice + ``--expect-resume``, and ``--shards 2
                --fragments`` + ``--check-shards`` (``DRILL_LAUNCHES``).
13. timing    — CUDA-event times of both kernels, each body timed in turns
                (global, smem, smem, global), at the main paths' shapes and
                at throughput shapes, with nvidia-smi's SM clock sampled
                meanwhile: ms, us and cycles a step, req/s, beside the byte
                bound; a log line adds a chain estimate (steps a chain x
                one step's critical path as counted by hand from the smem
                bodies' code, at assumed latencies: not measured, and not
                in the result line).
14. ssd       — the SSD-scan kernel vs its plain version on the card, in
                float32 (rtol = atol = 2e-4) and bfloat16 (2e-2), at
                tests/test_kernels.py's sweep, mamba2-780m's serve shape,
                jamba's SSM shape, chunk 256 with ds 128 and the kernel's
                edges (torch_cases.SSD_EDGE: hd 4 to 128, one chunk, batch *
                head 1, ds up to 512), and on bases that are not 16-byte
                aligned; one launch a call; the decay-bound property and no
                NaN at a huge dt.
15. serve     — main path three: ``repro_torch.launch.serve``'s path with
                the fixture's arguments (mamba2-780m at full width, fp32,
                4 requests x 256 prompt tokens x 16 new, MASA). Weights equal
                the fixture's numpy stream (sha256 of every leaf);
                ``EngineStats`` equal ``tests/data/torch_serve_mamba2_780m.json``
                (made by the JAX package); every request's tokens equal the
                fixture's up to its first near-tie step (top-1/top-2 gap
                under 1e-2); exactly 4 x 48 = 192 SSD-scan launches.
16. logits    — teacher-forced: the fixture's tokens through ``prefill`` and
                ``decode_step``; every step's logits at the fixture's top-8
                ids within rtol = atol = 1e-3.
17. profile   — ``torch.profiler`` trace of one request's prefill and its
                16 decode steps: the card's busy and idle share, and the
                SSD-scan and matmul kernels' device time (reported, not
                checked: the trace may hold no device activity there).
18. serve_smollm — main path five: smollm-135m whole (30 layers, 9 query
                heads on 3 kv heads, tied embeddings), fp32, through
                ``launch.serve``'s path with the arguments of
                ``tests/data/torch_serve_smollm_135m.json`` (made by the JAX
                package; 4 requests x 128 prompt tokens x 16 new, MASA):
                ``EngineStats`` equal the fixture's, tokens equal up to a
                near tie, teacher-forced top-8 logits within rtol = atol =
                1e-3, and no kernel launched (attention is plain PyTorch, as
                the reference's is plain JAX); a profile of one request.
19. serve_moonshot — main path six: moonshot-v1-16b-a3b at full width cut
                to 2 of its 48 layers (16 heads of 128, 64 experts top-6 and
                2 shared, F 1408), the same checks against
                ``tests/data/torch_serve_moonshot_16b_l2.json``; exactly
                2 layers x 3 products (up, gate, down) moe_gemm launches a
                prefill and a decode call, each on the stream body (bt =
                capacity 16 or 8), and no other kernel; a profile of one
                request. Then a long prefill on the same model: one prompt
                of 1024 seeded tokens (capacity 120), its counts set to 0
                just before and read just after: exactly 2 x 3 moe_gemm
                launches, all on the tf32x3 body, and no other kernel; its
                last-position logits within rtol = atol = 1e-3 of the same
                model's plain route (``Layout.kernels`` off: the einsum
                experts), which launches no kernel.
20. train     — main path seven: training on the card, the train route
                (no kernel: ``Model.loss`` runs ``ssd_chunked`` and the
                einsum experts in autograd, as the reference does). Every
                kernel's count is 0 before each part and still 0 after it.
                mamba2-780m whole in fp32 on the serve phase's weights
                (``numpy_reference_params(cfg, 0)``, drawn once in the run;
                sha256 of every leaf as the fixture's), 4 steps of
                ``make_train_step`` on ``DataPipeline(cfg, 2, 128, seed=0)``
                and AdamW (lr 1e-3, warmup 2, total 4) against
                ``tests/data/torch_train_mamba2_780m.json`` (made by the JAX
                package): loss and ce within rtol 1e-4, grad_norm 1e-3, lr,
                and five named leaves after each step within a relative norm
                of difference of 1e-4 (sampled values and whole-leaf norm);
                where the fixture holds NaN (the reference's step-3
                gradient), the port's number must be finite. Then the loss
                and gradient, the whole step and one profiled step (busy and
                idle share). ``python -m repro_torch.launch.train --arch
                mamba2-780m --steps 10`` (bf16, batch 8, seq 128, on the same
                weights): step ms after 2 steps, tokens/s, peak memory,
                finite first and last loss. ``launch.train --reduced`` 4
                steps with a checkpoint every 2 and a crash at step 2: the
                losses equal an uninterrupted run's. Every registry
                architecture at ``reduced()``: loss and every gradient leaf
                on the card against the CPU's plain path (rtol 1e-4; rtol =
                atol 2e-4), then one finite step. The numbers print on
                ``[train]`` lines.
21. distributed — the distributed stack (``repro_torch.distributed``,
                ``launch/{train,dryrun}.py``); no kernel launches.
                mamba2-780m whole in fp32 on the same weights through
                ``make_sharded_train_step`` on a 1x1 NCCL mesh (every leaf a
                DTensor): the train phase's 4 fixture steps at its
                tolerances and NaN rule, step ms and peak memory. ``launch.
                train --arch mamba2-780m --steps 10 --distributed`` at world
                1 (torchrun's environment set here, NCCL): its losses equal
                the train phase's non-distributed run's bit for bit. The
                cases of ``tests/torch_dist_cases.py`` on 4 gloo ranks (2x2,
                child processes, on the CPU: ``DIST_RANK_DEVICE`` says
                why): the sharded AdamW and Adafactor steps and the
                sharded decode against the single rank's on the same device
                (loss 1e-5, parameters 5e-4, logits 2e-4; replicas
                identical), ``collective_matmul`` against x @ w (2e-4),
                ``compressed_mean`` within 16 quantization steps (error
                feedback 2) and bit for bit the ring played out in one
                process. ``python -m repro_torch.launch.dryrun --arch
                mamba2-780m --shape train_4k`` in a subprocess prints OK.
22. moe_time  — the grouped GEMM at moonshot's serve shapes (64 experts x
                capacity 16 and 8, and 120 of a 1024-token prefill, D 2048,
                F 1408; the up and the down product), fp32: kernel vs plain
                within 2e-4, then CUDA-event times of the kernel (the stream
                body at 16 and 8, tf32x3 at 120), its plain version and
                ``torch.bmm`` on the same capacity buffer, beside the bound;
                the simt body timed in turns with that body on the same
                buffers, each with its TB/s, TFLOP/s and fraction of the
                bound; two launches bit-equal.
23. ssd_time  — CUDA-event times of the SSD-scan kernel and its plain
                version at the serve shape and at L = 2048, beside the bound
                (C B^T counted once a batch element and chunk: B and C are
                shared by the heads).
24. kernels   — the masa_gemm (both orders, through ops and its fallback),
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
                Moe's stream body at ``torch_cases.MOE_STREAM_SHAPES``
                (moonshot's four and the edges: bt 8, 16, 24, 32, ragged D,
                F past the last 128 columns), capacity and scattered
                designations, one launch each, and a second launch
                bit-equal; its tf32x3 body likewise in float32 at
                ``torch_cases.MOE_TF32X3_SHAPES`` (the sweep's bt 128 and
                64, bt 40 and 120 with rows masked, ragged D and F, bt 192
                and 384), on the capacity, flipped and scattered
                designations. Each wrapper raises on a non-contiguous
                input, a wrong dtype or a refused shape, before any launch,
                and a tf32x3 body forced on a shape it does not take (masa
                K 250, flash bf16, moe bf16 and bt 16) raises. Every masa, moe, paged and flash case
                ran the body its wrapper picks by shape (``body()``: wgmma
                for bf16 with rows of whole 16-byte units, moe's bt % 64 ==
                0 and flash's hd 64, 96 or 128; masa's and flash's tf32x3
                for fp32 with rows of whole 16-byte units (flash: hd 64, 96
                or 128) and aligned bases; moe's stream for bt a multiple
                of 8 up to 32 with F's rows whole 16-byte units, and its
                tf32x3 for fp32 at bt a multiple of 8 past 32 with D and F
                multiples of 4; simt otherwise (the float32 sweep of moe
                fails unless it takes tf32x3); paged: split for G 1 to 8 and rows of 1 to 32
                whole 16-byte units, serial otherwise), counted in
                ``BODIES``.
25. kernel_bench — main path four: ``repro_torch.kernel_bench.run()`` on the
                card. kernels_ok, every err below 1e-3, moe_hit 8/15, and
                exactly one launch per call as the reference times them
                (masa_gemm_os 2, masa_gemm_ws 1, ssd_scan 1, moe_gemm 1,
                paged_attention 2, flash_attention 1); no DRAM-kernel
                launch; its fp32 masa, moe (bt 128) and flash launches all
                on tf32x3.
26. kernel_time — the four kernels at jamba-v0.1-52b's full width
                (``torch_cases.*_JAMBA``), in bfloat16 and float32 (TF32 off):
                kernel vs plain within the tolerances above, then CUDA-event
                times of the kernel, its plain version and the one PyTorch
                call that computes the same function (scaled_dot_product_
                attention, torch.bmm, torch.matmul; none for paged), beside
                the bound max(FLOPs / peak, bytes / 3.35 TB/s); in float32
                the peak is the lesser of two times, FLOPs / 67 TFLOP/s
                (the CUDA cores) and 3 FLOPs / 494.7 TFLOP/s (three TF32
                products a product), both printed. masa_gemm's
                weight-stationary order falls back there and is also timed
                at K = 256. The flash, masa (both orders) and moe rows fail
                unless bfloat16 ran the wgmma body and float32 tf32x3;
                each prints its body and TFLOP/s. The float32 flash, moe
                and masa rows fail above a max abs error of 1e-4
                (``TF32X3_MAX_ERR``) and time the simt body in turns with
                tf32x3 (simt, tf32x3, tf32x3, simt), beside the library
                call and both fp32 operation bounds.
                Flash is also timed
                through ops.flash_attention on the 8 unexpanded kv heads
                (one launch, held to the kernel on the expanded heads),
                beside SDPA with enable_gqa. Paged fails unless both dtypes
                ran the split body; its serial body (the form before the
                split one) is timed in turns with it.

Each phase prints its seconds. The last lines are nvidia-smi's name and
power limit, the per-kernel JSON record (all seven kernels; lane_step and
mix_step also give their body, µs and cycles a step, chain bound, the
global body's time and their launches by path, the sweep, commands and
benches phases' included;
lane_step the sweep phase's wall times; moe_gemm its launches by path
and by body, moonshot's serve run and long prefill and its times at
moonshot's shapes),
and ``{"ok":
true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
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
#: capacity C (16 for a 128-token prefill, 8 for a decode step, 120 for a
#: 1024-token prefill), D and F;
#: "up" (also "gate") multiplies [E*C, D] by [E, D, F], "down" [E*C, F]
#: by [E, F, D].
MOE_MOONSHOT = dict(E=64, D=2048, F=1408, capacities=(16, 8, 120))
#: The long moonshot prefill: one prompt of this many seeded tokens, whose
#: capacity (120) sends the expert products to the tf32x3 body; its logits
#: are held to the plain route's within rtol = atol = LONG_PREFILL_TOL.
LONG_PREFILL_TOKENS = 1024
LONG_PREFILL_TOL = 1e-3
#: Cycles a second that the timing's sleep kernel counts: the H100's
#: highest SM clock (1980 MHz) rounded up.
SLEEP_CYCLES_PER_S = 2e9
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989.4e12
#: H100 SXM dense TF32 tensor-core peak (NVIDIA data sheet): an fp32
#: product taken as three TF32 products (the tf32x3 bodies) runs at up to
#: a third of it.
PEAK_TF32_FLOPS = 494.7e12
#: The largest max abs error, against the plain version, of a tf32x3 row
#: at jamba's width: one TF32 product alone errs by about 1e-3 at K 4096,
#: so this shows that all three products ran.
TF32X3_MAX_ERR = 1e-4
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
        if not out.split():
            # a terminated nvidia-smi can lose its buffered samples: read
            # the clock once more
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=30).stdout
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
        entry = ""
        for line in build_log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            elif "registers" in line or "spill" in line:
                log(f"[build]   {name}: {entry}: {line.strip()}")


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


def counted(tag: str, want: dict, fn, *args, **kwargs):
    """``fn`` with the DRAM kernels' launch counts set to 0 just before it:
    ``(result, wall s, launches)``. Fails unless it made exactly ``want``
    launches, each lane and mix launch on the smem body."""
    from repro_torch.core.dram import cuda_step

    cuda_step.reset_launches()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_step.LAUNCHES)
    if launches != want:
        fail(f"{tag}: expected launches {want}, counted {launches}")
    for k, n in launches.items():
        if n:
            check_smem(tag, k)
    return out, wall, launches


def counted_sweep(name: str, fn, *args, **kwargs):
    """One sweep-layer run through :func:`counted`: ``(result, wall s)``.
    Fails unless it made exactly ``SWEEP_LAUNCHES[name]`` launches and
    (unless it is the faulted run) quarantined no cell."""
    out, wall, launches = counted(f"sweep {name}", SWEEP_LAUNCHES[name], fn,
                                  *args, **kwargs)
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


#: The commands phase's launches by step: the golden grid's exports (the
#: plain emitting step; the 4 mixes' run-alone baselines through the lane
#: kernel), the kernels on the same traces (one lane launch a single-core
#: cell, one mix and one lane launch a mix), refresh_bench.run() (one lane
#: launch a (policy, config) bucket) and memtech_bench.run() (12 buckets, the
#: DDR3 pin, and one mix and one lane launch for each of the 4 PALP mixes).
COMMANDS_LAUNCHES = {"exports": {"lane_step": 4, "mix_step": 0},
                     "kernels": {"lane_step": 50 + 4, "mix_step": 4},
                     "refresh": {"lane_step": 33, "mix_step": 0},
                     "memtech": {"lane_step": 12 + 1 + 4, "mix_step": 4}}



def tree_id() -> str:
    """The checkout's git commit, or, where the copy has no ``.git``, the
    sha256 of its ``src/`` files (an artifact must name its code)."""
    import hashlib

    from repro_torch.experiments.artifact import git_sha

    sha = git_sha(str(ROOT))
    if sha != "unknown":
        return sha
    h = hashlib.sha256()
    for path in sorted((ROOT / "src").rglob("*.py")):
        h.update(str(path.relative_to(ROOT)).encode())
        h.update(path.read_bytes())
    return "tree-sha256-" + h.hexdigest()


def phase_commands(smi: str):
    """The command stream on the card: the golden pins, the lane and mix
    kernels held to the stream, and the refresh and memtech benches at full
    size against the JAX fixture."""
    import dataclasses
    import hashlib

    import torch_cases as tc
    from repro_torch.benchmarks import (common, memtech_bench, refresh_bench,
                                        validate)
    from repro_torch.core.dram import (Policy, SimConfig, check_trace,
                                       completions_from_commands,
                                       counters_from_commands,
                                       simulate_commands,
                                       simulate_mix_commands,
                                       simulate_multicore, simulate_stacked,
                                       stack_traces, state_layout as L)
    from repro_torch.experiments import (ResultCache, bench_artifact,
                                         install_global_cache)

    t_phase = time.perf_counter()
    golden = json.loads(Path(tc.GOLDEN_COMMANDS_PATH).read_text())
    fixture = tc.refresh_memtech_fixture()

    # ---- 1. the golden pins: export every cell on the card
    trace = tc.random_trace(tc.GOLDEN_COMMANDS_SEED)
    mix = tc.golden_commands_mix()
    singles = [(c["config"], c["policy"]) for c in golden["single"]]

    def export_all():
        out = {}
        for cfg, pol in singles:
            out[(cfg, pol)] = simulate_commands(
                trace, Policy[pol], SimConfig(**tc.CONFIGS[cfg]),
                device="cuda")
        for cfg, pol in tc.GOLDEN_COMMANDS_MIX_CELLS:
            out[("mix", cfg, pol)] = simulate_mix_commands(
                mix, Policy[pol], tc.golden_commands_mix_config(cfg),
                device="cuda")
        return out

    exports, export_s, export_launches = counted(
        "commands exports", COMMANDS_LAUNCHES["exports"], export_all)
    steps = sum(ct.meta["n_steps"] for _, ct in exports.values())
    bad = []
    for c in golden["single"]:
        ct = exports[(c["config"], c["policy"])][1]
        if (hashlib.sha256(ct.dumps().encode()).hexdigest(), len(ct),
                ct.counts()) != (c["sha256"], c["n_commands"], c["ops"]):
            bad.append((c["config"], c["policy"]))
    for c in golden["multicore"]:
        ct = exports[("mix", c["config"], c["policy"])][1]
        if hashlib.sha256(ct.dumps().encode()).hexdigest() != c["sha256"]:
            bad.append(("mix", c["config"], c["policy"]))
    texts = [k for k, v in golden["texts"].items()
             if exports[tuple(k.split("/"))][1].dumps() != v]
    if bad or texts:
        fail(f"commands: {len(bad)} golden cells and {len(texts)} texts "
             f"differ from golden_commands.json, e.g. {(bad + texts)[:3]}")
    t0 = time.perf_counter()
    checks = {k: check_trace(ct) for k, (_, ct) in exports.items()}
    check_s = time.perf_counter() - t0
    n_cmds = sum(r.n_commands for r in checks.values())
    illegal = {k: r.summary() for k, r in checks.items() if not r.ok}
    if illegal:
        fail(f"commands: checker violations {list(illegal.items())[:2]}")
    log(f"[commands] {len(singles)} single + {len(golden['multicore'])} "
        f"multicore golden cells exported on the card: every sha256 pin and "
        f"the {len(golden['texts'])} texts equal; {n_cmds} commands, zero "
        f"violations. Export {export_s:.2f}s for {steps} steps "
        f"({export_s / steps * 1e3:.3f} ms a step, the plain emitting step); "
        f"checker {check_s:.3f}s ({check_s / n_cmds * 1e6:.2f} us a "
        f"command); launches {export_launches}; card {smi}")

    # ---- 2. the lane and mix kernels against the stream
    def kernels_all():
        out = {}
        for cfg, pol in singles:
            out[(cfg, pol)] = simulate_stacked(
                stack_traces([trace]), Policy[pol],
                SimConfig(**tc.CONFIGS[cfg]), device="cuda")
        for cfg, pol in tc.GOLDEN_COMMANDS_MIX_CELLS:
            out[("mix", cfg, pol)] = simulate_multicore(
                mix, Policy[pol], tc.golden_commands_mix_config(cfg),
                device="cuda")
        return out

    kernels, kernel_s, kernel_launches = counted(
        "commands kernels", COMMANDS_LAUNCHES["kernels"], kernels_all)
    fields = [f.name for f in dataclasses.fields(type(
        exports[singles[0]][0])) if f.name != "sa_open_cycles"]
    bad = []
    for key, (_, ct) in exports.items():
        res = kernels[key]
        mc = key[0] == "mix"
        shared = res.shared if mc else res
        got = {f: int(getattr(shared, f).reshape(-1)[0]) for f in fields}
        comp = completions_from_commands(ct)
        ok = (got == counters_from_commands(ct)
              and np.array_equal(comp, ct.step_comp))
        if mc:
            col = np.isin(ct.op, (L.OP_RD, L.OP_WR))
            per_core = [int(comp[ct.step[col & (ct.core == c)]].max())
                        for c in range(len(mix))]
            ok = ok and per_core == [int(x) for x in res.core_cycles]
        if not ok:
            bad.append(key)
    if bad:
        fail(f"commands: kernel counters or completions differ from the "
             f"stream's for {len(bad)} cells, e.g. {bad[:3]}")
    log(f"[commands] lane and mix kernels on the same traces: every counter "
        f"but sa_open_cycles equals counters_from_commands, completions "
        f"equal completions_from_commands, per-core cycles the stream's last "
        f"completions ({len(exports)} cells; launches {kernel_launches}; "
        f"{kernel_s:.3f}s)")

    # ---- 3. the two benches at full size
    install_global_cache(ResultCache())
    sha = tree_id()
    benches, summary = {}, {}
    for name, bench in (("refresh", refresh_bench), ("memtech",
                                                      memtech_bench)):
        common.SWEEPS.clear()
        result, wall, launches = counted(
            f"commands {name}", COMMANDS_LAUNCHES[name], bench.run,
            device="cuda")
        doc = bench_artifact({name: result}, list(common.SWEEPS),
                             seed=common.SEED)
        doc["git_sha"] = sha
        try:
            msg = getattr(validate, f"validate_{name}")(doc)
            paths = [result["commands"]["path"]]
            msg += "; " + validate.check_commands_file(paths[0], doc, name)
            if name == "memtech":
                paths.append(result["commands_lpddr4"]["path"])
                msg += "; " + validate.check_commands_file(paths[1])
        except validate.ValidationError as e:
            fail(f"commands {name}: {e}")
        want = {c["key"]: c["counters"] for c in fixture["cells"]
                if c["grid"] == name}
        got = {c["key"]: c["counters"] for c in common.SWEEPS[-1]["cells"]}
        diff = [k for k in want if got.get(k) != want[k]]
        if set(got) != set(want) or diff:
            fail(f"commands {name}: {len(diff)} of {len(want)} cells differ "
                 f"from {Path(tc.REFRESH_MEMTECH_PATH).name}")
        slices = {"refresh": result["commands"]} if name == "refresh" else {
            "memtech_pcm": result["commands"],
            "memtech_lpddr4": result["commands_lpddr4"]}
        for sname, rec in slices.items():
            keys = ("sha256", "n_commands", "ops", "n_rules")
            if {k: rec[k] for k in keys} != fixture["commands"][sname]:
                fail(f"commands {name}: slice {sname} {rec} differs from the "
                     f"fixture's {fixture['commands'][sname]}")
        if name == "memtech":
            if tuple(result["ddr3_pin"]["got"]) != memtech_bench.DDR3_PIN_WANT:
                fail(f"commands memtech: ddr3 pin {result['ddr3_pin']}")
            palp = {t: {"FRFCFS": v["frfcfs_read_lat"],
                        "PALP_RP": v["palp_rp_read_lat"]}
                    for t, v in result["palp"].items()}
            if palp != fixture["palp"]:
                fail(f"commands memtech: PALP latencies {palp} differ from "
                     f"the fixture's {fixture['palp']}")
        benches[name] = result
        summary[name] = dict(wall_s=wall, launches=launches,
                             cells=len(got))
        log(f"[commands] {name}_bench.run() on the card: {wall:.2f}s wall, "
            f"launches {launches}; {len(got)} cells and "
            f"{', '.join(slices)} equal the JAX fixture; {msg}")
    measured = (export_launches, kernel_launches,
                summary["refresh"]["launches"], summary["memtech"]["launches"])
    launches = {k: sum(m.get(k, 0) for m in measured)
                for k in ("lane_step", "mix_step")}
    wall = time.perf_counter() - t_phase
    log(f"[commands] phase {wall:.1f}s; card {smi}")
    return dict(wall_s=wall, export_s=export_s, export_steps=steps,
                export_ms_per_step=export_s / steps * 1e3,
                checker_s=check_s, checker_commands=n_cmds,
                checker_us_per_command=check_s / n_cmds * 1e6,
                kernels_s=kernel_s, benches=summary, launches=launches,
                ddr3_pin=benches["memtech"]["ddr3_pin"]["got"])


# ---------------------------------------------------------------- benches
#: run.py's suites the benches phase runs (every registry entry but
#: refresh, memtech and perf: the commands phase runs the first two; perf
#: runs on its own), and the lane and mix launches each bench must make,
#: in that order, from a fresh result cache (counted in a CPU rehearsal
#: that stands a counting wrapper in for both kernels): one lane launch a
#: (policy, config) bucket of a sweep (sens_banks: its 8-bank cells are
#: sens_subarrays' cache hits), one per simulate_batch call (fig5,
#: row_policy), one mix launch a (policy, scheduler) point and one lane
#: launch a mix's run-alone baselines (multicore once, sched and smoke's
#: mix grid once a mix).
BENCH_SUITES = "paper,sens,system,mapping,accel,smoke"
BENCH_RUN_LAUNCHES = {
    "fig4": {"lane_step": 5, "mix_step": 0},
    "fig5": {"lane_step": 2, "mix_step": 0},
    "sens_subarrays": {"lane_step": 21, "mix_step": 0},
    "sens_banks": {"lane_step": 3, "mix_step": 0},
    "row_policy": {"lane_step": 8, "mix_step": 0},
    "multicore": {"lane_step": 1, "mix_step": 7},
    "sched": {"lane_step": 4, "mix_step": 10},
    "mapping": {"lane_step": 12, "mix_step": 0},
    "kernels": {"lane_step": 0, "mix_step": 0},
    "serving": {"lane_step": 0, "mix_step": 0},
    "smoke": {"lane_step": 8, "mix_step": 4},
}
#: The smoke drills' launches, each from a fresh cache (counted in the same
#: rehearsal): the fault drill (``raise@c4:p``: the faulted bucket's
#: bisected halves that ran, 7 lane launches for the grid's 6 buckets, and
#: 2 run-alone), a journal's first run and its replay (grid cells replayed;
#: the mix grid, which has no cache, runs again: 4 mix and 2 run-alone),
#: and 2 shards on the one card (6 buckets and 4 mix buckets, each in 2
#: launches, and 2 run-alone).
DRILL_LAUNCHES = {
    "fault": {"lane_step": 9, "mix_step": 4},
    "journal": {"lane_step": 8, "mix_step": 4},
    "resume": {"lane_step": 2, "mix_step": 4},
    "shards": {"lane_step": 14, "mix_step": 8},
}
DRILL_FAULT = "raise@c4:p"


def perf_launches() -> dict:
    """perf_bench.run()'s launches on the card, from its cells: every
    kernel cell and the per-step row make one cold and WARM_REPEATS warm
    calls; single-core cells (4 geometries x policies, batch32, the
    per-step row) one lane launch a call, multicore cells one lane (the
    run-alone baselines) and one mix launch a call; plain cells none."""
    from repro_torch.benchmarks import perf_bench

    calls = 1 + perf_bench.WARM_REPEATS
    return {"lane_step": (4 + 1 + 1 + 2) * calls, "mix_step": 2 * calls}


class Spy:
    """Stand a recording wrapper in for ``module.name``: every call's
    arguments and result, until :meth:`restore`."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.orig, self.calls = getattr(module, name), []

        def spy(*args, **kwargs):
            out = self.orig(*args, **kwargs)
            self.calls.append((args, kwargs, out))
            return out

        setattr(module, name, spy)

    def restore(self):
        setattr(self.module, self.name, self.orig)


def counting_benches(keys) -> tuple[dict, list]:
    """Stand a counting wrapper in for each selected bench's ``run``: its
    lane and mix launches (counts set to 0 just before it, read just
    after), smem bodies and wall. Returns the record and the spies to
    restore."""
    import importlib

    from repro_torch.benchmarks import run as runner
    from repro_torch.core.dram import cuda_step

    record, spies = {}, []
    for b in runner.REGISTRY:
        if b.key not in keys:
            continue
        mod = importlib.import_module(b.module)
        orig = mod.run

        def counted_run(device=None, _orig=orig, _key=b.key):
            cuda_step.reset_launches()
            t0 = time.perf_counter()
            try:
                return _orig(device=device)
            finally:
                torch.cuda.synchronize()
                record[_key] = dict(
                    wall_s=time.perf_counter() - t0,
                    launches=dict(cuda_step.LAUNCHES),
                    smem={k: cuda_step.BODIES[k]["smem"]
                          for k in cuda_step.LAUNCHES})

        mod.run = counted_run
        spies.append((mod, orig))
    return record, spies


def fixture_cells_equal(doc: dict, fixture: dict) -> dict:
    """Every sweep cell of a run.py artifact against the JAX fixtures: Fig.
    4's by (workload, policy), the sched study's by (mix, policy,
    scheduler), the rest by key (single-core) or mix and overrides.
    Returns cells compared by sweep; fails on a difference."""
    import torch_cases as tc

    fig4 = tc.fig4_fixture()
    sched = {k[1:]: v for k, v in tc.multicore_fixture().items()
             if k[0] == "sched"}
    by_grid = {}
    for c in fixture["cells"]:
        by_grid.setdefault(c["grid"], []).append(c)
    compared = {}
    for s in doc["sweeps"]:
        name, cells = s["grid"]["name"], s["cells"]
        if name == "fig4":
            want = {f"{w}/{p}": v for (w, p), v in fig4.items()}
            got = {f"{c['workload']}/{c['policy']}": c["counters"]
                   for c in cells}
        elif name == "sched":
            want = {"/".join(k): {f: v[f] for f in ("counters",
                                                     "core_cycles",
                                                     "alone_cycles")}
                    for k, v in sched.items()}
            got = {f"{c['mix']}/{c['policy']}/{c['overrides']['scheduler']}":
                   {f: c[f] for f in ("counters", "core_cycles",
                                      "alone_cycles")} for c in cells}
        elif name in by_grid:
            rows = by_grid[name]
            want = {json.dumps([c.get("key"), c.get("mix"), c["policy"],
                                c["overrides"]]): c for c in rows}
            got = {json.dumps([c.get("key"), c.get("mix"), c["policy"],
                               c["overrides"]]):
                   {"grid": name, **{k: c[k] for k in rows[0] if k != "grid"}}
                   for c in cells}
        else:
            fail(f"benches: sweep {name!r} has no fixture")
        bad = [k for k in want if got.get(k) != want[k]]
        if set(got) != set(want) or bad:
            fail(f"benches: {name}: {len(bad)} of {len(want)} cells differ "
                 f"from the JAX fixture (or the cell sets differ), e.g. "
                 f"{bad[:2]}")
        compared[name] = len(want)
    return compared


def run_main(argv: list[str], out: str) -> tuple[dict, str]:
    """``repro_torch.benchmarks.run.main`` with its CSV rows kept in a file
    beside its artifact: ``(artifact, stdout text)``."""
    import contextlib
    import io

    from repro_torch.benchmarks import run as runner

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        doc = runner.main(argv + ["--device", "cuda", "--out", out])
    Path(out).with_suffix(".csv").write_text(buf.getvalue())
    return doc, buf.getvalue()


def validated(path: str, *flags: str) -> str:
    """``repro_torch.benchmarks.validate`` on ``path``: its VALID line;
    fails on any other exit."""
    import contextlib
    import io

    from repro_torch.benchmarks import validate

    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = validate.main([path, *flags])
    if rc != 0:
        fail(f"benches: validate {path} {' '.join(flags)}: exit {rc}: "
             f"{err.getvalue().strip()}")
    return buf.getvalue().strip().splitlines()[-1]


def phase_benches(smi: str):
    """The paper's remaining benches through the port's runner on the card:
    every cell and summary against the JAX fixtures, the validators, perf,
    and the smoke drills, with every bench's lane and mix launches
    pinned."""
    import os

    from repro_torch.experiments import artifact

    t_phase = time.perf_counter()
    sha = tree_id()
    git_sha = artifact.git_sha
    artifact.git_sha = lambda cwd=None: sha   # a copy may have no .git
    os.makedirs("artifacts/torch", exist_ok=True)
    try:
        suites = bench_suites(smi)
        perf = bench_perf(smi)
        drills = bench_drills()
    finally:
        artifact.git_sha = git_sha
    runs = ([r["launches"] for r in suites["benches"].values()]
            + [perf["launches"]] + [d["launches"] for d in drills.values()])
    launches = {k: sum(r.get(k, 0) for r in runs)
                for k in ("lane_step", "mix_step")}
    wall = time.perf_counter() - t_phase
    log(f"[benches] phase {wall:.1f}s; launches {launches}; card {smi}")
    return dict(wall_s=wall, launches=launches, **suites, perf=perf,
                drills=drills)


def bench_suites(smi: str) -> dict:
    """``run.py --suite BENCH_SUITES`` from a fresh cache and no memoised
    trace: summaries, cells and launches against the fixtures."""
    import torch_cases as tc
    from repro_torch import kernel_bench, kernels
    from repro_torch.benchmarks import (fig5_energy, multicore_bench,
                                        row_policy_bench)
    from repro_torch.benchmarks import run as runner
    from repro_torch.experiments import (ResultCache, clear_trace_cache,
                                         install_global_cache)
    from repro_torch.paper_repro import mix_cells

    fixture = tc.paper_benches_fixture()
    keys = [b.key for b in runner.select(BENCH_SUITES, None)]
    if set(keys) != set(BENCH_RUN_LAUNCHES):
        fail(f"benches: suites {BENCH_SUITES} select {keys}")
    install_global_cache(ResultCache())
    clear_trace_cache()
    record, wrapped = counting_benches(keys)
    spies = [Spy(fig5_energy, "simulate_batch"),
             Spy(row_policy_bench, "simulate_batch"),
             Spy(multicore_bench, "run_multicore")]
    kernels.reset_launches()
    out = "artifacts/torch/bench.json"
    try:
        t0 = time.perf_counter()
        doc, text = run_main(["--suite", BENCH_SUITES], out)
        suites_s = time.perf_counter() - t0
    finally:
        for mod, orig in wrapped:
            mod.run = orig
        for s in spies:
            s.restore()
    accel = kernels.launches()
    failed = [line for line in text.splitlines()
              if ".FAILED," in line or ".SKIPPED," in line]
    if failed or set(doc["results"]) != set(keys):
        fail(f"benches: summaries for {sorted(doc['results'])} of {keys}; "
             f"{failed}")
    for key, rec in record.items():
        if rec["launches"] != BENCH_RUN_LAUNCHES[key]:
            fail(f"benches: {key}: expected launches "
                 f"{BENCH_RUN_LAUNCHES[key]}, counted {rec['launches']}")
        if rec["smem"] != rec["launches"]:
            fail(f"benches: {key}: launches by smem body {rec['smem']} of "
                 f"{rec['launches']}")
    if accel != BENCH_LAUNCHES:
        fail(f"benches: kernels entry launched {accel}, expected "
             f"{BENCH_LAUNCHES}")

    # ---- every cell and summary against the JAX fixtures
    compared = fixture_cells_equal(doc, fixture)
    fig4 = tc.fig4_fixture()
    fig5 = fig5_counters(spies[0].calls, ["BASELINE", "MASA"])
    if fig5 != {(w, p): c for (w, p), c in fig4.items()
                if p in ("BASELINE", "MASA")}:
        fail("benches: fig5's counters differ from torch_fig4_n8000.json")
    rows = {(r["row_policy"], r["policy"], r["workload"]): r["counters"]
            for r in fixture["row_policy"]}
    got_rows = {}
    for args, kwargs, res in spies[1].calls:
        rp = args[2].row_policy
        for i, p in enumerate(row_policy_bench.SUBSET):
            got_rows[(rp, args[1].name, p.name)] = lane_counters(res, i)
    if got_rows != rows:
        fail(f"benches: row_policy's counters differ from the fixture's "
             f"{len(rows)} rows")
    mc = {k: v for k, v in tc.multicore_fixture().items()
          if k[0] == "multicore"}
    got_mc = {("multicore",) + k: v
              for k, v in mix_cells(spies[2].calls[0][2]).items()}
    if got_mc != {k: {f: v[f] for f in ("counters", "core_cycles",
                                        "alone_cycles")}
                  for k, v in mc.items()}:
        fail("benches: multicore's cells differ from "
             "torch_multicore_fixture.json")
    summaries = json.loads(json.dumps(doc["results"]))
    cmd = summaries["smoke"].pop("commands")
    kb = summaries.pop("kernels")
    if summaries != fixture["summaries"]:
        diff = [k for k in fixture["summaries"]
                if summaries.get(k) != fixture["summaries"][k]]
        fail(f"benches: summaries {diff} differ from the JAX fixture's")
    if {k: v for k, v in cmd.items() if k != "path"} != \
            fixture["smoke_commands"]:
        fail(f"benches: smoke's command slice {cmd} differs from the "
             f"fixture's {fixture['smoke_commands']}")
    msgs = [validated(out, "--suite", s) for s in ("mapping", "kernels")]
    msgs.append(validated(out, "--suite", "smoke", "--check-commands",
                          cmd["path"]))
    if not (kb["kernels_ok"] and max(kb["errs"].values())
            < kernel_bench.ERR_TOL):
        fail(f"benches: kernels {kb['errs']}")
    log(f"[benches] run.py --suite {BENCH_SUITES} on the card: "
        f"{suites_s:.2f}s; {len(keys)} summaries equal the JAX fixture's "
        f"(kernels: errs below {kernel_bench.ERR_TOL}); cells equal the "
        f"fixtures {compared}; fig5's {len(fig5)} and row_policy's "
        f"{len(rows)} counter sets, multicore's {len(mc)} cells too; card "
        f"{smi}")
    for m in msgs:
        log(f"[benches]   {m}")
    for key in keys:
        rec = record[key]
        log(f"[benches]   {key}: {rec['wall_s']:.3f}s wall, launches "
            f"{rec['launches']}")
    return dict(suites_s=suites_s, benches=record)


def bench_perf(smi: str) -> dict:
    """``run.py --only perf``, counted, validated with its guard; every
    cell's req/s, the kernel's beside the plain version's."""
    perf, perf_s, perf_launches_ = counted(
        "benches perf", perf_launches(), run_main,
        ["--only", "perf"], "artifacts/torch/perf_run.json")
    p = perf[0]["results"]["perf"]
    msgs = [validated("artifacts/torch/BENCH_perf.json", "--perf-guard")]
    cells = {c["name"]: c for c in p["cells"]}
    if set(p["backends"]) != {"cuda", "plain"}:
        fail(f"benches: perf backends {sorted(p['backends'])}")
    for name, c in cells.items():
        log(f"[benches] perf {name}: {c['req_per_s']:.1f} req/s (warm "
            f"{c['warm_s']:.6f}s, best of {c['repeats']}; cold "
            f"{c['cold_s']:.4f}s); card {smi}")
    log(f"[benches] perf ns a step {p['per_step_ns']}; kernel_vs_plain "
        f"{p['kernel_vs_plain']}; {perf_s:.2f}s; launches {perf_launches_}; "
        f"{msgs[0]}")
    return dict(perf_s=perf_s, launches=perf_launches_,
                req_per_s={n: c["req_per_s"] for n, c in cells.items()},
                **{k: p[k] for k in ("backends", "per_step_ns",
                                     "kernel_vs_plain")})


def bench_drills() -> dict:
    """The smoke drills, each from a fresh cache, each validated: a fault
    drill, a journal's resume and a sharded run's fragments. Their
    artifacts, journal and fragments go under ``artifacts/torch/drills/``
    (emptied first)."""
    import os
    import shutil

    from repro_torch.experiments import ResultCache, install_global_cache

    root = "artifacts/torch/drills"
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    drills = {}

    def drill(name, *flags):
        install_global_cache(ResultCache())
        path = os.path.join(root, f"{name}.json")
        _, wall, launches = counted(
            f"benches drill {name}", DRILL_LAUNCHES[name], run_main,
            ["--suite", "smoke", *flags], path)
        drills[name] = dict(wall_s=wall, launches=launches)
        return path

    msgs = [validated(drill("fault", "--inject-faults", DRILL_FAULT),
                      "--expect-quarantine")]
    journal = os.path.join(root, "cache.jsonl")
    drill("journal", "--journal", journal)
    msgs.append(validated(drill("resume", "--journal", journal),
                          "--expect-resume"))
    frags = os.path.join(root, "fragments")
    msgs.append(validated(drill("shards", "--shards", "2", "--fragments",
                                frags), "--check-shards", frags))
    for m in msgs:
        log(f"[benches] drill: {m}")
    log(f"[benches] drills {drills}")
    install_global_cache(ResultCache())
    return drills


def fig5_counters(calls, policies) -> dict:
    """``{(workload, policy): counters}`` of fig5's simulate_batch calls
    over the 32 suite traces, one call a policy in ``policies``' order."""
    from repro_torch.core.dram import PAPER_WORKLOADS

    out = {}
    for (args, kwargs, res), pol in zip(calls, policies):
        if args[1].name != pol:
            fail(f"benches: fig5 called {args[1].name}, expected {pol}")
        for i, p in enumerate(PAPER_WORKLOADS):
            out[(p.name, pol)] = lane_counters(res, i)
    return out


def lane_counters(res, i: int) -> dict:
    """Lane ``i``'s counters of a batched result, as plain ints."""
    from repro_torch.paper_repro import COUNTERS

    return {f: int(getattr(res, f)[i]) for f in COUNTERS}


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
    prefill and decode call, all on the stream body (fp32, bt = capacity
    16 or 8)."""
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
    if bodies != {b: want["moe_gemm"] * (b == "stream") for b in bodies}:
        fail(f"serve {arch}: moe_gemm ran bodies {bodies}, expected "
             f"{want['moe_gemm']} on stream")
    log_serve(tag, res, smi)
    res.update(launches=launches["moe_gemm"], bodies=bodies,
               wall_with_checks_s=wall,
               logits=phase_logits(model, fixture, tag),
               profile=phase_profile(model, fixture, smi, tag))
    if moe_layers:
        res["long_prefill"] = long_prefill(model, moe_layers * products, smi)
    return res


def long_prefill(model, want: int, smi: str) -> dict:
    """Main path six at a long prompt: the served model (moonshot's 2 of 48
    layers at full width, fp32) prefills one prompt of
    ``LONG_PREFILL_TOKENS`` seeded tokens. Every count is 0 just before and
    read just after: exactly ``want`` moe_gemm launches (one a MoE layer
    and product), all on tf32x3 at bt = capacity (past the stream body's
    32), and no other kernel. Its last-position logits are held within
    rtol = atol = ``LONG_PREFILL_TOL`` to the same model's plain route
    (``Layout.kernels`` off: the reference's einsum experts), which
    launches no kernel. Then both routes are timed warm, in turns (plain,
    kernels, kernels, plain; host clock around a synchronised call, the
    mean of 3)."""
    from repro_torch import kernels
    from repro_torch.core.dram import cuda_step
    from repro_torch.kernels.moe_gemm import kernel as EK
    from repro_torch.models.moe import expert_capacity

    cfg = model.cfg
    gen = torch.Generator().manual_seed(KERNEL_TIME_SEED)
    toks = torch.randint(0, cfg.vocab_size, (1, LONG_PREFILL_TOKENS),
                         generator=gen).to(model.device)
    cap = expert_capacity(LONG_PREFILL_TOKENS, cfg.moe)
    # ---- the main path, counted
    reset_all_launches()
    logits, _ = model.prefill({"tokens": toks})
    sync("cuda")
    launches = {**kernels.launches(), **cuda_step.LAUNCHES}
    bodies = dict(EK.BODIES)
    expect = {k: want * (k == "moe_gemm") for k in launches}
    if (launches != expect or bodies != {b: want * (b == "tf32x3")
                                         for b in bodies}):
        fail(f"long prefill: {LONG_PREFILL_TOKENS} tokens (capacity {cap}) "
             f"launched {launches}, moe_gemm by body {bodies}; expected "
             f"{want} moe_gemm launches, all on tf32x3, and no other kernel")
    # ---- the plain route on the same model and prompt
    plain = model.layout()
    plain.kernels = False
    reset_all_launches()
    ref, _ = model.prefill({"tokens": toks}, plain)
    no_launches("long prefill, plain route")
    err = float((logits - ref).abs().max())
    if not torch.allclose(logits, ref, rtol=LONG_PREFILL_TOL,
                          atol=LONG_PREFILL_TOL):
        fail(f"long prefill: logits differ from the plain route's by up to "
             f"{err:.4g} (rtol = atol = {LONG_PREFILL_TOL})")

    def wall_ms(layout, reps=3):
        model.prefill({"tokens": toks}, layout)
        sync("cuda")
        t0 = time.perf_counter()
        for _ in range(reps):
            model.prefill({"tokens": toks}, layout)
        sync("cuda")
        return (time.perf_counter() - t0) / reps * 1e3

    turns = [wall_ms(lay) for lay in (plain, None, None, plain)]
    ms, plain_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    log(f"[long prefill] {cfg.name} ({cfg.n_layers} layers, fp32), one "
        f"prompt of {LONG_PREFILL_TOKENS} tokens, capacity {cap}: {want} "
        f"moe_gemm launches by body {bodies}, no other kernel; "
        f"last-position logits within rtol = atol = {LONG_PREFILL_TOL} of "
        f"the plain route, max abs err {err:.3e}; in turns {ms:.2f} ms "
        f"({LONG_PREFILL_TOKENS / ms * 1e3:.1f} tok/s), plain route "
        f"{plain_ms:.2f} ms; card {smi}")
    return dict(tokens=LONG_PREFILL_TOKENS, capacity=cap, launches=want,
                bodies=bodies, ms=ms, plain_ms=plain_ms, turns_ms=turns,
                max_abs_err=err)


def phase_moe_time(smi: str):
    """The grouped GEMM at moonshot's serve shapes (``MOE_MOONSHOT``), fp32
    as the serve path runs it: kernel vs plain within 2e-4, then CUDA-event
    times of the kernel, its plain version and ``torch.bmm`` on the same
    capacity buffer, beside the bound. Every launch through the wrapper on
    the body its shape takes (stream at capacities 16 and 8, tf32x3 at the
    long prefill's 120), two of them bit-equal; then the simt body and that
    body in turns (simt, body, body, simt) on the same buffers, each with
    its TB/s, TFLOP/s and fraction of the bound."""
    from repro_torch.kernels.moe_gemm import capacity_block_eids
    from repro_torch.kernels.moe_gemm import kernel as EK

    gen = torch.Generator(device="cuda").manual_seed(KERNEL_TIME_SEED)
    E, D, F = MOE_MOONSHOT["E"], MOE_MOONSHOT["D"], MOE_MOONSHOT["F"]
    out = {}
    for C in MOE_MOONSHOT["capacities"]:
        eids = capacity_block_eids(E, C, C, device="cuda")
        T = E * C
        for prod, (k_in, k_out) in (("up", (D, F)), ("down", (F, D))):
            name = f"moe_gemm moonshot {prod} C={C}"
            x = torch.randn((T, k_in), generator=gen, device="cuda")
            w = torch.randn((E, k_in, k_out), generator=gen,
                            device="cuda") * k_in ** -0.5
            flops = 2 * T * k_in * k_out
            nbytes = (4 * (T * k_in + E * k_in * k_out + T * k_out)
                      + 4 * eids.numel())
            body = "stream" if C <= EK.STREAM_MAX_BT else "tf32x3"
            if EK.body(x, w, C) != body:
                fail(f"moe_time: {name} takes {EK.body(x, w, C)}, not {body}")
            EK.reset_launches()
            kernel = lambda: EK.grouped_matmul_kernel(x, w, eids, bt=C)
            row = timing_row(
                name, kernel,
                lambda: EK.grouped_matmul_plain(x, w, eids, bt=C),
                lambda: torch.bmm(x.view(E, C, k_in), w), flops, nbytes,
                "float32", reps=20)
            if EK.BODIES != {b: EK.BODIES[body] * (b == body)
                             for b in EK.BODIES} or not EK.BODIES[body]:
                fail(f"moe_time: {name} ran bodies {EK.BODIES}, expected "
                     f"only {body}")
            if not torch.equal(kernel(), kernel()):
                fail(f"moe_time: {name}: two {body} launches differ")
            simt = lambda: EK._launch(x, w, eids, C, "simt")
            row["simt_max_abs_err"] = kernel_err(
                f"{name} simt", simt(), EK.grouped_matmul_plain(
                    x, w, eids, bt=C), "float32")
            turns = [time_ms(f, 20, 1) for f in (simt, kernel, kernel, simt)]
            row.update(body=body, tflops=flops / (row["ms"] * 1e-3) / 1e12,
                       simt_ms=(turns[0] + turns[3]) / 2, turns_ms=turns)
            row[f"{body}_ms"] = (turns[1] + turns[2]) / 2
            for b in (body, "simt"):
                ms = row[f"{b}_ms"]
                row[f"{b}_tbps"] = nbytes / (ms * 1e-3) / 1e12
                row[f"{b}_tflops"] = flops / (ms * 1e-3) / 1e12
                row[f"{b}_of_bound"] = row["bound_ms"] / ms
            log(f"[timing] {name} float32: {body} body {row['ms']:.4f} ms "
                f"({row[f'{body}_tbps']:.3f} TB/s, "
                f"{row[f'{body}_tflops']:.1f} TFLOP/s in turns, "
                f"{row[f'{body}_of_bound']:.3f} of the bound "
                f"({row['bound_by']})); in turns {body} "
                f"{row[f'{body}_ms']:.4f} ms, simt {row['simt_ms']:.4f} ms "
                f"({row['simt_tbps']:.3f} TB/s, "
                f"{row['simt_tflops']:.1f} TFLOP/s, "
                f"{row['simt_of_bound']:.3f} of the bound); torch.bmm "
                f"{row['library_ms']:.4f} ms; bit-equal")
            out[f"{prod}_c{C}"] = row
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
            if dname == "float32" and EK.body(x, w, bt) != "tf32x3":
                fail(f"kernels: moe_gemm {(E, C, D, F, bt)} float32 picks "
                     f"{EK.body(x, w, bt)}, not tf32x3")
            for ids in (eids, eids.flip(0).contiguous()):
                EK.reset_launches()
                got = grouped_matmul(x, w, ids, bt=bt, bf=bf)
                ran("moe_gemm", EK, EK.body(x, w, bt),
                    f"{(E, C, D, F, bt)} {dname}")
                record("moe_gemm", dname, kernel_err(
                    f"moe_gemm {(E, C, D, F, bt)}", got,
                    EK.grouped_matmul_plain(x, w, ids, bt=bt), dname))
        # the stream body at moonshot's shapes and its edges, bit-equal
        # when launched twice
        for E, C, D, F, bt in tc.MOE_STREAM_SHAPES:
            x, w, designations = tc.moe_stream_case(E, C, D, F, bt, dtype,
                                                    "cuda")
            for how, ids in designations.items():
                case = f"stream {(E, C, D, F, bt)} {how} {dname}"
                if EK.body(x, w, bt) != "stream":
                    fail(f"kernels: moe_gemm {case} picks "
                         f"{EK.body(x, w, bt)}")
                bf = math.gcd(F, 128)
                EK.reset_launches()
                got = grouped_matmul(x, w, ids, bt=bt, bf=bf)
                ran("moe_gemm", EK, "stream", case)
                record("moe_gemm", dname, kernel_err(
                    f"moe_gemm {case}", got,
                    EK.grouped_matmul_plain(x, w, ids, bt=bt), dname))
                if not torch.equal(got, EK.grouped_matmul_kernel(
                        x, w, ids, bt=bt, bf=bf)):
                    fail(f"kernels: moe_gemm {case}: two launches differ")
            del x, w
        # the tf32x3 body (fp32 token blocks past 32 rows) at its edges,
        # bit-equal when launched twice
        tf32x3_cases = tc.MOE_TF32X3_SHAPES if dname == "float32" else ()
        for E, C, D, F, bt in tf32x3_cases:
            x, w, designations = tc.moe_stream_case(E, C, D, F, bt, dtype,
                                                    "cuda")
            designations["flipped"] = designations["capacity"].flip(0)
            for how, ids in designations.items():
                case = f"tf32x3 {(E, C, D, F, bt)} {how}"
                if EK.body(x, w, bt) != "tf32x3":
                    fail(f"kernels: moe_gemm {case} picks "
                         f"{EK.body(x, w, bt)}")
                ids = ids.contiguous()
                EK.reset_launches()
                got = grouped_matmul(x, w, ids, bt=bt, bf=4)
                ran("moe_gemm", EK, "tf32x3", case)
                record("moe_gemm", dname, kernel_err(
                    f"moe_gemm {case}", got,
                    EK.grouped_matmul_plain(x, w, ids, bt=bt), dname))
                if not torch.equal(got, EK.grouped_matmul_kernel(
                        x, w, ids, bt=bt, bf=4)):
                    fail(f"kernels: moe_gemm {case}: two launches differ")
            del x, w
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
        ("masa_gemm tf32x3 forced at K=250", ValueError,
         lambda: MK._launch(torch.randn((128, 250), device="cuda"),
                            torch.randn((250, 128), device="cuda"),
                            "output_stationary", "tf32x3")),
        ("moe_gemm tf32x3 forced on bfloat16", ValueError,
         lambda: EK._launch(*(torch.randn(s, device="cuda").bfloat16()
                              for s in ((128, 64), (2, 64, 128))),
                            torch.zeros(2, dtype=torch.int32, device="cuda"),
                            64, "tf32x3")),
        ("moe_gemm tf32x3 forced at bt 16", ValueError,
         lambda: EK._launch(torch.randn((128, 64), device="cuda"),
                            torch.randn((2, 64, 128), device="cuda"),
                            torch.zeros(8, dtype=torch.int32, device="cuda"),
                            16, "tf32x3")),
        ("flash_attention tf32x3 forced on bfloat16", ValueError,
         lambda: FK._launch(f64.bfloat16(), f64.bfloat16(), f64.bfloat16(),
                            True, "tf32x3")),
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
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.masa_gemm import kernel as MK
    from repro_torch.kernels.moe_gemm import kernel as EK

    # ---- main path four, counted
    kernels.reset_launches()
    cuda_step.reset_launches()
    t0 = time.perf_counter()
    res = kernel_bench.run()
    wall = time.perf_counter() - t0
    launches, dram = kernels.launches(), dict(cuda_step.LAUNCHES)
    res["moe_bodies"] = dict(EK.BODIES)
    res["masa_bodies"], res["flash_bodies"] = dict(MK.BODIES), dict(FK.BODIES)
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
    # its fp32 launches at the JAX bench's shapes take the tf32x3 bodies
    # (moe's at bt 128)
    for kernel, bodies, n in (
            ("masa_gemm", res["masa_bodies"],
             BENCH_LAUNCHES["masa_gemm_os"] + BENCH_LAUNCHES["masa_gemm_ws"]),
            ("moe_gemm", res["moe_bodies"], BENCH_LAUNCHES["moe_gemm"]),
            ("flash_attention", res["flash_bodies"],
             BENCH_LAUNCHES["flash_attention"])):
        if bodies != {b: n * (b == "tf32x3") for b in bodies}:
            fail(f"kernel_bench: {kernel} ran bodies {bodies}, expected "
                 f"{n} tf32x3")
    log(f"[kernel_bench] bodies: masa_gemm {res['masa_bodies']}, "
        f"flash_attention {res['flash_bodies']}, moe_gemm "
        f"{res['moe_bodies']}")
    ladder = res["ladder"]
    if not ladder["masa"] >= ladder["salp1"] > 1.0 == ladder["baseline"]:
        fail(f"kernel_bench: ladder {ladder}")
    log(f"[kernel_bench] errs {res['errs']} (< {kernel_bench.ERR_TOL}); "
        f"moe_hit {res['moe_hit']:.4f}; ladder {ladder}")
    res["wall_s"] = wall
    return res


# ------------------------------------------------------------ kernel_time
def fp32_op_bounds(flops: float) -> dict:
    """The two least times (ms) of ``flops`` fp32-accurate operations: on
    the CUDA cores (67 TFLOP/s), and as three TF32 products each on the
    tensor cores (3 FLOPs over 494.7 TFLOP/s, the tf32x3 bodies' split)."""
    return {"cuda_cores": flops / PEAK_FP32_FLOPS * 1e3,
            "tf32x3": 3 * flops / PEAK_TF32_FLOPS * 1e3}


def bound_of(flops: float, nbytes: float, dname: str):
    """(bound_ms, bound_by): the larger of operations over the dtype's peak
    and bytes over the HBM rate. In float32 the operations take the lesser
    of :func:`fp32_op_bounds`' two times."""
    if dname == "bfloat16":
        t_ops = flops / PEAK_BF16_FLOPS
    else:
        t_ops = min(fp32_op_bounds(flops).values()) * 1e-3
    t_bytes = nbytes / HBM_BYTES_PER_S
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
    both = ""
    if dname == "float32":
        row["op_bounds_ms"] = fp32_op_bounds(flops)
        both = (f" (operations: {row['op_bounds_ms']['tf32x3']:.5f} ms as "
                f"3xTF32, {row['op_bounds_ms']['cuda_cores']:.5f} ms on the "
                f"CUDA cores)")
    log(f"[timing] {name} {dname}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, library {lib}, bound "
        f"{row['bound_ms']:.5f} ms ({row['bound_by']}){both}, kernel / "
        f"bound {row['ms'] / row['bound_ms']:.1f}x; max abs err {e:.3e}")
    return row


def body_ran(mod, name: str, dname: str, fp32: str = "tf32x3") -> str:
    """The body of ``mod``'s launches since its reset: fails unless all took
    wgmma in bfloat16 (the jamba shapes suit wgmma) and ``fp32`` in float32
    (tf32x3 for flash, masa and moe at bt 128)."""
    want = "wgmma" if dname == "bfloat16" else fp32
    if not mod.BODIES[want] or any(c for b, c in mod.BODIES.items()
                                   if b != want):
        fail(f"kernel_time: {name} {dname} ran bodies {mod.BODIES}, "
             f"expected only {want}")
    return want


def with_body(row: dict, mod, name: str, dname: str, flops: float,
              fp32: str = "tf32x3") -> dict:
    """Add the body that ran and the achieved TFLOP/s to a timing row."""
    row["body"] = body_ran(mod, name, dname, fp32)
    row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
    log(f"[timing] {name} {dname}: {row['body']} body, "
        f"{row['tflops']:.1f} TFLOP/s")
    return row


def tf32x3_in_turns(row: dict, name: str, tf32x3, simt, want,
                    flops: float, reps: int) -> dict:
    """A float32 row of a tf32x3 body: fail unless its max abs error is at
    most ``TF32X3_MAX_ERR`` (one TF32 product alone would miss it); then
    hold the simt body (the form before tf32x3) to the plain output
    ``want`` and time both bodies in turns (simt, tf32x3, tf32x3, simt)."""
    if not row["max_abs_err"] <= TF32X3_MAX_ERR:
        fail(f"kernel_time: {name} float32 tf32x3 max abs err "
             f"{row['max_abs_err']:.3e} > {TF32X3_MAX_ERR}")
    row["simt_max_abs_err"] = kernel_err(f"{name} simt", simt(), want,
                                         "float32")
    turns = [time_ms(f, reps, 1) for f in (simt, tf32x3, tf32x3, simt)]
    row.update(tf32x3_ms=(turns[1] + turns[2]) / 2,
               simt_ms=(turns[0] + turns[3]) / 2, turns_ms=turns)
    for b in ("tf32x3", "simt"):
        row[f"{b}_tflops"] = flops / (row[f"{b}_ms"] * 1e-3) / 1e12
    log(f"[timing] {name} float32 in turns: tf32x3 {row['tf32x3_ms']:.4f} "
        f"ms ({row['tf32x3_tflops']:.1f} TFLOP/s), simt {row['simt_ms']:.4f}"
        f" ms ({row['simt_tflops']:.1f} TFLOP/s); library "
        f"{row['library_ms']:.4f} ms; max abs err tf32x3 "
        f"{row['max_abs_err']:.3e}, simt {row['simt_max_abs_err']:.3e}")
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
        with_body(row, FK, "flash_attention", dname, 4 * hd * pairs,
                  "tf32x3")
        if dname == "float32":
            tf32x3_in_turns(
                row, "flash_attention",
                lambda: FK.flash_attention_kernel(qf, kf, vf),
                lambda: FK._launch(qf, kf, vf, True, "simt"),
                FK.flash_attention_plain(qf, kf, vf), 4 * hd * pairs, 10)
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
        body_ran(FK, "flash_attention through ops", dname, "tf32x3")
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
        if dname == "float32":
            tf32x3_in_turns(
                row, "moe_gemm",
                lambda: EK.grouped_matmul_kernel(x, w, eids, bt=bt),
                lambda: EK._launch(x, w, eids, bt, "simt"),
                EK.grouped_matmul_plain(x, w, eids, bt=bt), 2 * T * D * F,
                reps)
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
        with_body(row, MK, "masa_gemm output_stationary", dname,
                  2 * M * K * N, "tf32x3")
        if dname == "float32":
            tf32x3_in_turns(
                row, "masa_gemm output_stationary",
                lambda: MK.masa_gemm_kernel(a, b),
                lambda: MK._launch(a, b, "output_stationary", "simt"),
                MK.masa_gemm_plain(a, b), 2 * M * K * N, reps)
        s = tc.MASA_WS_JAMBA
        M, K, N = s["M"], s["K"], s["N"]
        a, b = randn((M, K), dtype), randn((K, N), dtype, K ** -0.5)
        MK.reset_launches()
        ws = timing_row(
            "masa_gemm weight_stationary",
            lambda: MK.masa_gemm_kernel(a, b, order="weight_stationary"),
            lambda: MK.masa_gemm_plain(a, b), lambda: torch.matmul(a, b),
            2 * M * K * N, es * (M * K + K * N + M * N), dname, reps=2 * reps)
        with_body(ws, MK, "masa_gemm weight_stationary", dname,
                  2 * M * K * N, "tf32x3")
        if dname == "float32":
            tf32x3_in_turns(
                ws, "masa_gemm weight_stationary",
                lambda: MK.masa_gemm_kernel(a, b, order="weight_stationary"),
                lambda: MK._launch(a, b, "weight_stationary", "simt"),
                MK.masa_gemm_plain(a, b), 2 * M * K * N, 2 * reps)
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
     "fragment), fp32 on the tf32x3 body (8 warps of 16 query rows, K and "
     "V tiles of 64 keys through cp.async double buffers, both products "
     "by three TF32 mma.sync m16n8k8 each, the softmax on the accumulator "
     "fragment); simt_ms the simt body, in turns"),
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
     "rastered M fastest in groups of 12 row tiles), fp32 on the tf32x3 "
     "body (three TF32 mma.sync m16n8k8 a product, 8 warps of 64 x 32 on "
     "128 x 128 tiles that never straddle a token block, a 4-stage "
     "cp.async ring, the same raster); simt_ms the simt body, in turns; "
     "moonshot_float32: the stream body at moonshot's capacities (bt 16 "
     "and 8) and the tf32x3 body at a 1024-token prefill's (bt 120), the "
     "simt body in turns"),
    ("masa_gemm", "src/repro_torch/kernels/masa_gemm/csrc/masa_gemm.cu",
     "src/repro/kernels/masa_gemm/kernel.py:53",
     "M=2048 K=4096 N=14336 output_stationary (weight_stationary falls back "
     "there; timed at K=256) (jamba-v0.1-52b dense FFN up-projection); "
     "bf16 on the wgmma body (output-stationary 128 x 256 tiles, TMA ring "
     "of 4 stages; weight-stationary a resident [K, 128] panel with A "
     "through a ring per consumer warpgroup), fp32 on the tf32x3 body "
     "(three TF32 mma.sync m16n8k8 a product, 8 warps of 64 x 32, "
     "output-stationary 128 x 128 tiles through a 4-stage cp.async ring, "
     "weight-stationary the resident panel with A through a 3-stage "
     "ring); simt_ms the simt body, in turns"),
)


def layer_records(sweep, bench, ktime) -> list[dict]:
    """The record line's entries of the four accelerator-layer kernels:
    launches from main path four (kernel_bench.run), times at the jamba
    shapes in bfloat16 (float32 beside them), and the bodies of the GEMMs
    and flash by sweep case and, for masa and flash, in main path four."""
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
        if name in ("masa_gemm", "flash_attention"):
            entry["bench_bodies"] = bench[f"{name.split('_')[0]}_bodies"]
        out.append(entry)
    return out


#: The train phase's tolerances: a step's loss and ce (rtol), its
#: grad_norm (rtol), a named leaf's relative norm of difference, and the
#: registry's card-vs-CPU step (loss rtol; gradients rtol = atol).
TRAIN_TOL = dict(loss=1e-4, grad_norm=1e-3, leaf=1e-4, grad=2e-4)
#: ``python -m repro_torch.launch.train`` at its own defaults (bf16, batch
#: 8, seq 128), and the steps left out of its step time as warm-up.
TRAIN_LAUNCH = ["--arch", "mamba2-780m", "--steps", "10"]
TRAIN_WARM = 2


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_all_launches() -> None:
    from repro_torch import kernels
    from repro_torch.core.dram import cuda_step

    kernels.reset_launches()
    cuda_step.reset_launches()


def no_launches(tag: str) -> None:
    """Fail unless no kernel launched since ``reset_all_launches``: the
    train route runs none."""
    from repro_torch import kernels
    from repro_torch.core.dram import cuda_step

    got = {**kernels.launches(), **cuda_step.LAUNCHES}
    if any(got.values()):
        fail(f"{tag}: the train route launched kernels {got}")


def rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def parity_row(tag: str, step: int, m: dict, want: dict, params: dict,
               index: dict, ms: float) -> dict:
    """One step's metrics ``m`` and parameters ``params`` (whole tensors)
    held to the fixture's step ``want``: loss and ce, grad_norm, lr, and
    the named leaves after the step (sampled values by relative norm of
    difference, and the whole leaf's norm). Where the reference's number
    is NaN (its ``ssd_chunked`` gradient; see
    tests/make_torch_train_fixture.py), the port's must be finite."""
    got = {k: float(m[k]) for k in ("loss", "ce", "aux", "grad_norm", "lr")}
    row = dict(step=step, ms=ms, **got, leaves={})
    for k, tol in (("loss", "loss"), ("ce", "loss"),
                   ("grad_norm", "grad_norm")):
        if not np.isfinite(got[k]):
            fail(f"{tag}: step {step} {k} is {got[k]}")
        if not np.isfinite(want[k]):
            row[f"reference_{k}"] = "nan"
        elif rel(got[k], want[k]) > TRAIN_TOL[tol]:
            fail(f"{tag}: step {step} {k} {got[k]!r} vs the fixture's "
                 f"{want[k]!r} (rtol {TRAIN_TOL[tol]})")
    if abs(got["aux"] - want["aux"]) > 1e-7 or rel(got["lr"],
                                                    want["lr"]) > 1e-6:
        fail(f"{tag}: step {step} aux / lr {got} vs {want}")
    for path, w in want["params"].items():
        leaf = params
        for k in path.split("/"):
            leaf = leaf[k]
        leaf = leaf.detach()
        if not bool(torch.isfinite(leaf).all()):
            fail(f"{tag}: step {step} {path} is not finite")
        if not np.isfinite(w["norm"]):
            row["leaves"][path] = "reference nan"
            continue
        vals = leaf.reshape(-1)[index[path]].double().cpu().numpy()
        ref = np.asarray(w["values"])
        d_sample = float(np.linalg.norm(vals - ref) / np.linalg.norm(ref))
        d_norm = rel(float(leaf.double().norm()), w["norm"])
        row["leaves"][path] = dict(sample=d_sample, norm=d_norm)
        if max(d_sample, d_norm) > TRAIN_TOL["leaf"]:
            fail(f"{tag}: step {step} {path}: relative difference "
                 f"{d_sample:.3e} (sampled), {d_norm:.3e} (norm) over "
                 f"{TRAIN_TOL['leaf']}")
    return row


def train_parity(fixture: dict, cfg, tree: dict, device="cuda") -> list:
    """The fixture's steps through ``make_train_step`` on ``device`` from
    ``tree``, each held to the JAX package's (``parity_row``)."""
    from repro_torch import interop
    from repro_torch.data import DataPipeline
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step

    a = fixture["args"]
    model = build_model(cfg, interop.params_from_reference(cfg, tree),
                        dtype=torch.float32, device=device)
    opt = make_optimizer(a["optimizer"], lr=a["lr"], warmup=a["warmup"],
                         total_steps=a["total_steps"])
    pipe = DataPipeline(cfg, a["batch"], a["seq"], seed=a["data_seed"],
                        device=device)
    step_fn = make_train_step(model, opt)
    params = model.param_tree()
    state = opt.init(params)
    index = {k: torch.tensor(v, device=device)
             for k, v in fixture["index"].items()}
    rows = []
    for step, want in enumerate(fixture["steps"]):
        sync(device)
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, pipe.batch_at(step), step)
        float(m["loss"])
        sync(device)
        rows.append(parity_row("train", step, m, want, params, index,
                               1e3 * (time.perf_counter() - t0)))
    return rows, train_breakdown(model, step_fn, params, state,
                                 pipe.batch_at(0), len(rows), device)


def train_breakdown(model, step_fn, params, state, batch, step: int,
                    device="cuda", reps: int = 3) -> dict:
    """Where a step's time goes, after the checked steps: the loss and its
    gradient (``value_and_grad``) and the whole step, host clock after a
    sync, mean of ``reps``; the optimizer's share is their difference.
    Then a ``torch.profiler`` trace of one step: the card's busy time
    (kernels and copies) and idle share, and the six costliest kernels
    (None in a trace without device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.step import value_and_grad

    def timed(fn) -> float:
        sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync(device)
        return 1e3 * (time.perf_counter() - t0) / reps

    vag_ms = timed(lambda: value_and_grad(model, batch))
    step_ms = timed(lambda: step_fn(params, state, batch, step))
    out = dict(value_and_grad_ms=vag_ms, step_ms=step_ms,
               optimizer_ms=step_ms - vag_ms, trace=None)
    if torch.device(device).type != "cuda":
        return out
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, state, batch, step)
        sync(device)
        wall = 1e3 * (time.perf_counter() - t0)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t = by_name.setdefault(e.name, [0.0, 0])
            t[0] += e.time_range.elapsed_us() / 1e3
            t[1] += 1
    if by_name:
        busy = sum(t for t, _ in by_name.values())
        out["trace"] = dict(
            wall_ms=wall, device_ms=busy, idle_share=1.0 - busy / wall,
            device_ops=sum(c for _, c in by_name.values()),
            top=[(n[:60], t, c) for n, (t, c) in sorted(
                by_name.items(), key=lambda kv: -kv[1][0])[:6]])
    return out


def train_launcher(tree: dict, device="cuda") -> dict:
    """``launch.train`` at its defaults (``TRAIN_LAUNCH``), on ``tree``:
    step ms after ``TRAIN_WARM`` steps, tokens/s, peak memory, first and
    last loss (both finite)."""
    from repro_torch.launch import train as launch_train

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    args = launch_train.parse_args(TRAIN_LAUNCH + ["--device", device])
    res = launch_train.main(TRAIN_LAUNCH + ["--device", device], params=tree)
    if res.final_step != args.steps or not np.isfinite(res.losses).all():
        fail(f"train: launch.train ended at {res.final_step} with losses "
             f"{res.losses}")
    warm = res.step_s[TRAIN_WARM:]
    ms = 1e3 * float(np.mean(warm))
    return dict(
        argv=TRAIN_LAUNCH, batch=args.batch, seq=args.seq,
        dtype="float32" if args.reduced else "bfloat16",
        step_ms=ms, step_ms_median=1e3 * float(np.median(warm)),
        first_step_ms=1e3 * res.step_s[0],
        tokens_per_s=args.batch * args.seq / (ms / 1e3),
        peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                  if torch.device(device).type == "cuda" else None),
        first_loss=res.losses[0], last_loss=res.losses[-1],
        losses=res.losses)


def train_resume(device="cuda") -> dict:
    """Reduced mamba2 through ``launch.train`` for 4 steps, uninterrupted
    and with a checkpoint every 2 steps and a crash at step 2: the same
    losses, one restart."""
    import tempfile

    from repro_torch.launch import train as launch_train

    base = ["--arch", "mamba2-780m", "--reduced", "--steps", "4",
            "--device", device]
    clean = launch_train.main(base)
    with tempfile.TemporaryDirectory() as d:
        failed = launch_train.main(base + ["--ckpt-dir", d, "--ckpt-every",
                                           "2", "--fail-at-step", "2"])
    if (failed.restarts, failed.final_step) != (1, 4) or \
            failed.losses != clean.losses:
        fail(f"train: the resumed run's losses {failed.losses} (restarts "
             f"{failed.restarts}) differ from the uninterrupted "
             f"{clean.losses}")
    return dict(losses=clean.losses, restarts=failed.restarts)


def train_registry(device="cuda") -> dict:
    """Every registry architecture at ``reduced()``: the loss and every
    gradient leaf on ``device`` against the CPU's plain path on the same
    weights and batch, then one ``make_train_step`` step on ``device``
    (a finite loss and finite parameters). A leaf the graph does not reach
    raises in ``torch.autograd.grad``; a kernel on the route raises in its
    wrapper. Neither is caught."""
    from repro_torch import interop
    from repro_torch.configs import get_config, list_archs
    from repro_torch.data import make_batch
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step, value_and_grad

    out = {}
    for arch in list_archs():
        cfg = get_config(arch).reduced()
        tree = interop.numpy_reference_params(cfg, 0)
        batch = make_batch(cfg, 2, 32, seed=3, dtype=torch.float32,
                           device="cpu")
        res = {}
        for dev in ("cpu", device):
            model = build_model(cfg, interop.params_from_reference(cfg, tree),
                                dtype=torch.float32, device=dev)
            model.requires_grad_(True)
            b = {k: v.to(dev) for k, v in batch.items()}
            loss, _, grads = value_and_grad(model, b)
            res[dev] = (float(loss), {k: g.cpu() for k, g in grads.items()})
        (l_c, g_c), (l_d, g_d) = res["cpu"], res[device]
        worst = 0.0
        for k, g in g_c.items():
            if g_d.get(k) is None:
                fail(f"train {arch}: no gradient for {k}")
            tol = TRAIN_TOL["grad"] * (1 + g.abs())
            worst = max(worst, float(((g_d[k] - g).abs() / tol).max()))
        opt = make_optimizer(cfg.optimizer_mode, lr=1e-3, warmup=0,
                             total_steps=10)
        params, _, m = make_train_step(model, opt)(
            model.param_tree(), opt.init(model.param_tree()), b, 0)
        finite = np.isfinite(float(m["loss"])) and all(
            bool(torch.isfinite(p).all()) for p in model.parameters())
        out[arch] = dict(loss=l_d, loss_rel=rel(l_d, l_c),
                         grad_err_over_tol=worst, leaves=len(g_c))
        if rel(l_d, l_c) > TRAIN_TOL["loss"] or worst > 1.0 or not finite:
            fail(f"train {arch}: the card's step differs from the CPU's "
                 f"or is not finite: {out[arch]}")
    return out


def phase_train(smi: str, tree: dict | None = None):
    """The train route on the card: mamba2-780m whole against the JAX
    fixture, ``launch.train`` at its defaults, a resumed run, and every
    architecture's reduced step against the CPU's; no kernel launches.
    ``tree`` is mamba2-780m's weights as the serve phase had them (numpy,
    the reference's layout), so that the run draws them once; without it
    the phase draws them."""
    import hashlib

    import torch_cases as tc
    from repro_torch import interop
    from repro_torch.configs import get_config

    fixture = tc.train_fixture()
    cfg = get_config(fixture["args"]["arch"])
    t0 = time.perf_counter()
    if tree is None:
        tree = interop.numpy_reference_params(cfg, fixture["args"]["seed"])
    weights_s = time.perf_counter() - t0
    digests = {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
               for k, v in interop.flatten(tree).items()}
    if digests != fixture["weights"]["sha256"]:
        fail("train: the weights differ from the fixture's numpy stream")
    reset_all_launches()
    t0 = time.perf_counter()
    rows, breakdown = train_parity(fixture, cfg, tree)
    no_launches("train parity")
    parity_s = time.perf_counter() - t0
    for r in rows:
        log(f"[train] mamba2-780m fp32 step {r['step']}: loss {r['loss']:.6f}"
            f" grad_norm {r['grad_norm']:.4f} lr {r['lr']:.3e} "
            f"({r['ms']:.1f} ms); leaves {r['leaves']}"
            + (f"; the fixture's grad_norm is NaN" if "reference_grad_norm"
               in r else ""))
    log(f"[train] mamba2-780m fp32 B 2 x 128, mean of 3: loss and grads "
        f"{breakdown['value_and_grad_ms']:.1f} ms, the step "
        f"{breakdown['step_ms']:.1f} ms (optimizer "
        f"{breakdown['optimizer_ms']:.1f}); card {smi}")
    tr = breakdown["trace"]
    if tr is None:
        log("[train] the trace holds no device activity: idle share not "
            "measured")
    else:
        log(f"[train] one step under the profiler: wall {tr['wall_ms']:.1f}"
            f" ms, card busy {tr['device_ms']:.1f} ms in {tr['device_ops']}"
            f" kernels and copies (idle share {tr['idle_share']:.3f})")
        for n, t, c in tr["top"]:
            log(f"[train]   {t:9.3f} ms  x{c:<5d} {n}")
    torch.cuda.empty_cache()
    reset_all_launches()
    launcher = train_launcher(tree)
    no_launches("train launcher")
    del tree
    log(f"[train] launch.train {' '.join(TRAIN_LAUNCH)} (bf16, batch "
        f"{launcher['batch']}, seq {launcher['seq']}): "
        f"{launcher['step_ms']:.2f} ms a step after {TRAIN_WARM} (median "
        f"{launcher['step_ms_median']:.2f}, first {launcher['first_step_ms']:.1f}"
        f"), {launcher['tokens_per_s']:.1f} tokens/s, peak "
        f"{launcher['peak_gib']:.2f} GiB, loss {launcher['first_loss']:.4f} "
        f"-> {launcher['last_loss']:.4f}; card {smi}")
    torch.cuda.empty_cache()
    reset_all_launches()
    resume = train_resume()
    no_launches("train resume")
    log(f"[train] launch.train --reduced, crash at step 2, resumed from the "
        f"step-2 checkpoint: losses equal the uninterrupted run's "
        f"{resume['losses']}")
    reset_all_launches()
    registry = train_registry()
    no_launches("train registry")
    for arch, r in registry.items():
        log(f"[train] {arch} reduced: card vs CPU loss rel {r['loss_rel']:.2e}"
            f", grads {r['leaves']} leaves, max err / tol "
            f"{r['grad_err_over_tol']:.3f}; a step on the card finite")
    summary = dict(weights_s=weights_s, parity_s=parity_s, parity=rows,
                   breakdown=breakdown, launcher=launcher, resume=resume, registry=registry,
                   card=smi)
    log("[train] " + json.dumps(summary))
    return summary


#: Where the distributed phase's multi-rank cases (``tests/
#: torch_dist_cases.py``, 4 gloo ranks on a 2x2 mesh, child processes)
#: run: the CPU. NCCL refuses two ranks on one device and the machine has
#: one card, so ranks sharing it would talk over gloo. On the H100 machine
#: (torch 2.11; measured with this phase's first runs) gloo's all_reduce,
#: all_gather_into_tensor, reduce_scatter_tensor and broadcast took CUDA
#: tensors alone, but its send / recv failed on them ("writev ... Bad
#: address"), and 4 ranks running the sharded train and decode cases on
#: cuda:0 all died of SIGSEGV within 18 s. The card runs the distributed
#: stack at world 1 over NCCL (``dist_parity``, ``dist_launcher``).
DIST_RANK_DEVICE = "cpu"
DIST_RANKS = 4
#: ``launch.train --distributed`` at world 1: ``TRAIN_LAUNCH`` as the train
#: phase ran it, whose losses it must equal bit for bit.
DIST_LAUNCH = TRAIN_LAUNCH + ["--distributed"]
#: The dry-run's cells (16x16, shapes only): a train cell and a decode
#: cell, whose cache stays in its ``cache_pspecs`` shards.
DRYRUNS = (["--arch", "mamba2-780m", "--shape", "train_4k"],
           ["--arch", "phi3-mini-3.8b", "--shape", "decode_32k"])
#: The world-1 sharded decode of mamba2-780m whole (fp32): batch, prompt
#: (one SSD chunk) and greedy steps.
DIST_DECODE = dict(batch=4, prompt=64, steps=4, seed=2)
#: The world-1 sharded step's peak when its rank model held a whole copy
#: of the parameters beside their shards (H100 80GB HBM3, 700 W; PERF.md).
DIST_PEAK_BEFORE_GIB = 21.35


@contextlib.contextmanager
def one_rank_env():
    """torchrun's environment for a world of one (a free port), for the
    ``with`` block only: the variables are restored on exit, so later
    phases and their child processes see none of it."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dist_parity(fixture: dict, cfg, tree: dict) -> dict:
    """The fixture's steps through ``make_sharded_train_step`` on a 1x1
    NCCL mesh on the card, each held to the JAX package's
    (``parity_row``), then the step's time and peak memory. The rank's
    model lives on ``meta``: the step reads only its shards."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import interop
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import DataPipeline
    from repro_torch.distributed.sharding import (batch_pspecs, gather_tree,
                                                  param_pspecs, shard_tree)
    from repro_torch.distributed.step import (make_sharded_train_step,
                                              shard_opt_state, shard_params)
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.tree import unflatten

    a = fixture["args"]
    with one_rank_env():
        dist.init_process_group("nccl")
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        weights = interop.params_from_reference(cfg, tree)
        model = build_model(cfg, weights, dtype=torch.float32, device="meta")
        opt = make_optimizer(a["optimizer"], lr=a["lr"], warmup=a["warmup"],
                             total_steps=a["total_steps"])
        full = unflatten({k: v.to("cuda") for k, v in weights.items()}, ".")
        specs = param_pspecs(cfg, full, mesh)
        params = shard_params(full, specs, mesh)
        state = shard_opt_state(opt, full, specs, mesh)
        del full, weights
        step_fn = make_sharded_train_step(model, opt, mesh, specs)
        pipe = DataPipeline(cfg, a["batch"], a["seq"], seed=a["data_seed"],
                            device="cuda")
        bspecs = batch_pspecs(cfg, mesh, ShapeSpec("t", a["seq"], a["batch"],
                                                   "train"))
        index = {k: torch.tensor(v, device="cuda")
                 for k, v in fixture["index"].items()}
        torch.cuda.reset_peak_memory_stats()
        rows = []
        for step, want in enumerate(fixture["steps"]):
            sync("cuda")
            t0 = time.perf_counter()
            params, state, m = step_fn(
                params, state, shard_tree(pipe.batch_at(step), bspecs, mesh),
                step)
            float(m["loss"])
            sync("cuda")
            ms = 1e3 * (time.perf_counter() - t0)
            rows.append(parity_row("distributed", step, m, want,
                                   gather_tree(params), index, ms))
        return dict(rows=rows, peak_gib=torch.cuda.max_memory_allocated()
                    / 2**30, gathered=step_fn.meter.peak,
                    placements=str(params["embed"]["table"].placements))
    finally:
        dist.destroy_process_group()


def dist_decode(cfg, tree: dict) -> dict:
    """The sharded prefill and ``DIST_DECODE["steps"]`` greedy sharded
    decode steps of ``cfg`` (mamba2-780m whole, fp32) on a 1x1 NCCL mesh,
    the cache laid out by ``cache_pspecs``; each decode step's logits and
    cache held to the unsharded ``decode_step``'s on the same weights,
    tokens and cache (rtol = atol = ``TOLS["decode"]``), and both timed.
    Neither launches a kernel: the unsharded model is prefilled by the
    sharded step (the unsharded prefill would run the SSD-scan kernel)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import torch_dist_cases as tdc
    from repro_torch import interop
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.synth import make_batch
    from repro_torch.distributed.sharding import (PSpec, batch_pspecs,
                                                  cache_pspecs, gather,
                                                  is_spec, map_tree,
                                                  param_pspecs, placements,
                                                  shard, shard_tree)
    from repro_torch.distributed.step import (make_sharded_decode_step,
                                              make_sharded_prefill_step,
                                              shard_params)
    from repro_torch.models import build_model

    a = DIST_DECODE
    with one_rank_env():
        dist.init_process_group("nccl")
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        model = build_model(cfg, interop.params_from_reference(cfg, tree),
                            dtype=torch.float32, device="cuda")
        full = model.param_tree()
        params = shard_params(full, param_pspecs(cfg, full, mesh), mesh)
        batch = make_batch(cfg, a["batch"], a["prompt"], seed=a["seed"],
                           dtype=torch.float32, device="cuda")
        prefill = make_sharded_prefill_step(model, mesh)
        logits, cache = prefill(params, shard_tree(batch, batch_pspecs(
            cfg, mesh, ShapeSpec("p", a["prompt"], a["batch"], "prefill")),
            mesh))
        cache = map_tree(lambda spec, t: t.redistribute(
            mesh, placements(spec, mesh)), cache_pspecs(
                cfg, mesh, a["batch"]), cache, is_leaf=is_spec)
        whole = map_tree(gather, cache)
        decode = make_sharded_decode_step(model, mesh)
        rows, errs, ms, ms_plain = [], [], [], []
        tok = gather(logits).argmax(-1).int()
        for step in range(a["steps"]):
            cur = a["prompt"] + step
            sync("cuda")
            t0 = time.perf_counter()
            got, cache = decode(params, shard(tok, PSpec("data", None),
                                              mesh), cache, cur)
            got = gather(got)
            sync("cuda")
            ms.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            want, whole = model.decode_step(tok, whole, cur)
            sync("cuda")
            ms_plain.append(1e3 * (time.perf_counter() - t0))
            errs.append(dict(
                logits=tdc.max_rel(got, want, tdc.TOLS["decode"]),
                cache=max(tdc.max_rel(gather(n), w, tdc.TOLS["decode"])
                          for n, w in zip(
                              (x for c in cache.values() for x in c),
                              (x for c in whole.values() for x in c)))))
            rows.append(tok[:, 0].tolist())
            tok = want.argmax(-1).int()
        bad = [e for e in errs if e["logits"] > 1 or e["cache"] > 1]
        if bad:
            fail(f"distributed: the sharded decode of {cfg.name} differs "
                 f"from the unsharded decode_step: {errs}")
        return dict(errs=errs, tokens=rows, ms=ms, plain_ms=ms_plain,
                    gathered=decode.meter.peak,
                    model_gathers=decode.meter.over_model,
                    placements=[str(p) for p in
                                cache["pos0"].ssd.placements])
    finally:
        dist.destroy_process_group()


def dist_launcher(tree: dict, want: list) -> dict:
    """``launch.train --distributed`` at world 1 on NCCL (``DIST_LAUNCH``):
    its losses equal ``want``, the non-distributed run's, bit for bit."""
    from repro_torch.launch import train as launch_train

    torch.cuda.reset_peak_memory_stats()
    with one_rank_env():
        res = launch_train.main(DIST_LAUNCH, params=tree)
    if res.losses != want:
        fail(f"distributed: launch.train --distributed losses {res.losses} "
             f"differ from the non-distributed run's {want}")
    warm = res.step_s[TRAIN_WARM:]
    return dict(argv=DIST_LAUNCH, step_ms=1e3 * float(np.mean(warm)),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                losses=res.losses)


def dist_ranks() -> dict:
    """The 4-rank cases on ``DIST_RANK_DEVICE``, each held to the
    single-rank result at the CPU tests' tolerances (every train case, its
    gradients leaf by leaf, the prefill and decode cases, their gathered
    bytes within two blocks split over "model", no leaf gathered over
    "model" and no cache leaf redistributed in decode); the ring's
    ``compressed_mean`` bit for bit to the same ring played out in one
    process."""
    import tempfile

    import torch_dist_cases as tdc

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        out = tdc.run_ranks(DIST_RANKS, d, DIST_RANK_DEVICE,
                            [*tdc.TRAIN, "grads", *tdc.DECODES, "cmm",
                             "cmean"], timeout=240)
    out["wall_s"] = time.perf_counter() - t0
    for name in tdc.TRAIN:
        r = out[name]
        state = ("state_err_first" if name in tdc.STATE_AFTER_FIRST
                 else "state_err")
        if r["replica_mismatches"] or r["state_leaves"] <= 0 or any(
                r[k] > 1 for k in ("loss_err", "grad_norm_err", "param_err",
                                   state)):
            fail(f"distributed: the sharded {name} steps differ from the "
                 f"single rank's or between replicas: {r}")
        if r["params_moved"] <= tdc.TOLS["param"]:
            fail(f"distributed: the {name} steps left the parameters "
                 f"within their tolerance of the start: {r}")
    for arch, r in out["grads"].items():
        if arch not in ("world", "device") and (
                r["err"] > 1 or not r["same_leaves"]):
            fail(f"distributed: {arch}'s sharded gradients differ: {r}")
    for name in tdc.DECODES:
        r = out[name]
        if any(r[k] > 1 for k in ("logits_err", "cache_err",
                                  "prefill_logits_err", "prefill_cache_err")
               ) or not r["cache_layout_kept"] or r["cache_redistributes"] \
                or r["decode_model_gathers"] or not (
                0 < r["prefill_gathered"] <= 2 * r["block_bytes"]
                and 0 < r["decode_gathered"] <= 2 * r["block_bytes"]):
            fail(f"distributed: the sharded {name} differs: {r}")
    if out["cmm"]["err"] > 1:
        fail(f"distributed: collective_matmul differs: {out['cmm']}")
    r = out["cmean"]
    if r["err_over_scale"] > 16 or r["ef_err_over_scale"] > 2 or \
            not r["serial_equal"]:
        fail(f"distributed: compressed_mean out of bounds: {r}")
    return out


def dist_dryrun(run) -> dict:
    """``python -m repro_torch.launch.dryrun`` on each of ``DRYRUNS`` in a
    subprocess, all beside ``run()`` (the rank cases, CPU work too): each
    must print its OK line. Returns ({cell: its record's figures},
    ``run()``'s result)."""
    import os

    from repro_torch.launch import roofline

    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *cell],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        for cell in DRYRUNS]
    try:
        beside = run()
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    cells = {}
    for cell, proc, (out, err) in zip(DRYRUNS, procs, outs):
        ok = [l for l in out.splitlines() if l.startswith("[dryrun] OK")]
        if proc.returncode or not ok:
            fail(f"distributed: the dry-run of {cell} failed (rc "
                 f"{proc.returncode}): {out[-2000:]} {err[-2000:]}")
        rec = json.loads((roofline.RESULTS / (
            f"{cell[1]}_{cell[3]}_16x16.json")).read_text())
        mem = rec["memory"]
        cells[f"{cell[1]} {cell[3]}"] = dict(
            line=ok[-1], peak_bytes=mem["peak_bytes"],
            gathered_bytes=mem["gathered_bytes"],
            argument_bytes=mem["argument_bytes"],
            collective_bytes=rec["collectives"]["total"],
            useful=roofline.analyze(rec)["useful_ratio"])
    return dict(cells=cells, wall_s=time.perf_counter() - t0), beside


def phase_distributed(smi: str, tree: dict, launcher_losses: list):
    """The distributed stack on the card: mamba2-780m whole through the
    sharded step on a 1x1 NCCL mesh against the JAX fixture, its sharded
    prefill and decode against the unsharded ``decode_step``,
    ``launch.train --distributed`` at world 1 against the non-distributed
    run, the 4-rank cases (``DIST_RANK_DEVICE``) and the dry-run cells; no
    kernel launches."""
    import torch_cases as tc
    from repro_torch.configs import get_config

    fixture = tc.train_fixture()
    cfg = get_config(fixture["args"]["arch"])
    reset_all_launches()
    no_launches("distributed (before)")
    t0 = time.perf_counter()
    parity = dist_parity(fixture, cfg, tree)
    for r in parity["rows"]:
        log(f"[distributed] mamba2-780m fp32 sharded step {r['step']} on a "
            f"1x1 NCCL mesh: loss {r['loss']:.6f} grad_norm "
            f"{r['grad_norm']:.4f} ({r['ms']:.1f} ms); leaves {r['leaves']}"
            + ("; the fixture's grad_norm is NaN" if "reference_grad_norm"
               in r else ""))
    log(f"[distributed] sharded step peak {parity['peak_gib']:.2f} GiB "
        f"(with a whole copy beside the shards it was "
        f"{DIST_PEAK_BEFORE_GIB:.2f} GiB; embed table "
        f"{parity['placements']}, gathered {parity['gathered']} B); "
        f"card {smi}")
    torch.cuda.empty_cache()
    dec = dist_decode(cfg, tree)
    log(f"[distributed] mamba2-780m fp32 sharded prefill and "
        f"{DIST_DECODE['steps']} decode steps on a 1x1 NCCL mesh (B "
        f"{DIST_DECODE['batch']}, prompt {DIST_DECODE['prompt']}; ssd "
        f"{dec['placements']}): logits / cache within "
        + ", ".join(f"{e['logits']:.4f} / {e['cache']:.4f}"
                    for e in dec["errs"])
        + f" of 2e-4 against the unsharded decode_step; sharded "
        + ", ".join(f"{t:.1f}" for t in dec["ms"]) + " ms, unsharded "
        + ", ".join(f"{t:.1f}" for t in dec["plain_ms"])
        + f" ms a step; gathered {dec['gathered']} B; card {smi}")
    torch.cuda.empty_cache()
    launcher = dist_launcher(tree, launcher_losses)
    log(f"[distributed] launch.train {' '.join(DIST_LAUNCH)} at world 1 "
        f"(NCCL): losses equal the non-distributed run's bit for bit; "
        f"{launcher['step_ms']:.2f} ms a step after {TRAIN_WARM}, peak "
        f"{launcher['peak_gib']:.2f} GiB; card {smi}")
    torch.cuda.empty_cache()
    no_launches("distributed")
    dry, ranks = dist_dryrun(dist_ranks)
    log(f"[distributed] {DIST_RANKS} gloo ranks (2x2) on {DIST_RANK_DEVICE}: "
        + json.dumps(ranks))
    for c in dry["cells"].values():
        log(f"[distributed] {c['line']} ({dry['wall_s']:.1f} s, beside the "
            f"ranks): peak_bytes {c['peak_bytes']} "
            f"({c['peak_bytes'] / 2**30:.2f} GiB), gathered_bytes "
            f"{c['gathered_bytes']}, collective bytes "
            f"{c['collective_bytes']:.4e}, useful {c['useful']:.4f}")
    summary = dict(parity=parity, decode=dec, launcher=launcher, ranks=ranks,
                   dryrun=dry, wall_s=time.perf_counter() - t0,
                   rank_device=DIST_RANK_DEVICE, card=smi)
    log("[distributed] " + json.dumps(summary))
    return summary


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
    cmds = run_phase("commands", phase_commands, smi)
    benches = run_phase("benches", phase_benches, smi)
    thr = run_phase("timing", phase_throughput, smi)
    ssd_err = run_phase("ssd", phase_ssd)
    serve, model, fixture = run_phase("serve", phase_serve, smi)
    tf = run_phase("logits", phase_logits, model, fixture)
    prof = run_phase("profile", phase_profile, model, fixture, smi)
    from repro_torch.tree import unflatten
    mamba2 = unflatten({k: v.detach().cpu().numpy()
                        for k, v in model.state_dict().items()}, ".")
    del model
    served = {arch: run_phase(f"serve_{arch.split('-')[0]}",
                              phase_serve_model, arch, smi)
              for arch in SERVE_ARCHS}
    trained = run_phase("train", phase_train, smi, mamba2)
    run_phase("distributed", phase_distributed, smi, mamba2,
              trained["launcher"]["losses"])
    del mamba2
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
                     "sweep": sw["launches"]["lane_step"],
                     "commands": cmds["launches"]["lane_step"],
                     "benches": benches["launches"]["lane_step"]}
    mix_launches = {"multicore": mc["launches"]["mix_step"],
                    "sweep": sw["launches"]["mix_step"],
                    "commands": cmds["launches"]["mix_step"],
                    "benches": benches["launches"]["mix_step"]}
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
        "throughput": thr, "sweep": sw, "commands": cmds,
        "benches": benches}, {
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
    moon = served[SERVE_ARCHS[1]]
    moe["launches_by_path"] = {"kernel_bench": moe["launches"],
                               "serve_moonshot": moon["launches"],
                               "long_prefill": moon["long_prefill"][
                                   "launches"]}
    moe["launches"] = sum(moe["launches_by_path"].values())
    moe["launches_by_body"] = {"kernel_bench": bench["moe_bodies"],
                               "serve_moonshot": moon["bodies"],
                               "long_prefill": moon["long_prefill"]["bodies"]}
    moe["moonshot_float32"] = moe_t
    moe["serve_moonshot"] = {k: moon[k] for k in (
        "stats", "build_s", "wall_s", "prefill_s", "decode_s",
        "prefill_tok_s", "decode_tok_s", "near_ties", "tokens_compared",
        "logits", "profile", "long_prefill")}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
