#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only; it imports nothing of the JAX
package. Phases, each of which fails the run (non-zero exit, no result line)
on any mismatch:

1. card     — the device's name and count, and nvidia-smi's name and power
              limit; the kernels need compute capability 9.0 and nvcc.
2. build    — compile every kernel of the path from the sources in the
              checkout (``-Xptxas -v``: registers, spills).
3. golden   — the 300 single-core cells of
              ``tests/data/golden_packed_state.json`` through the lane
              kernel, bit-exact.
4. plain    — kernel vs its plain PyTorch version on the card, random traces
              for every (config, policy) pair, all counters.
5. fig4     — the main path: the paper's Fig. 4 grid (32 workloads x 5
              policies x 8000 requests, seed 7) through
              ``repro_torch.paper_repro.run_fig4`` on the card. Exactly one
              lane-kernel launch per policy; the counters equal
              ``tests/data/torch_fig4_n8000.json`` (made by the JAX package)
              and the plain version on the card.
6. timing   — CUDA-event times of the kernel and its plain version at the
              Fig. 4 shapes and at a throughput shape (1024 lanes x 8000
              requests under MASA), beside the byte bound.

The last lines are nvidia-smi's name and power limit, the per-kernel JSON
record, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the 32-bit
#: non-tensor-core rate, the nearest table entry for the kernel's int32 ops.
HBM_BYTES_PER_S = 3.35e12
PEAK_32BIT_OPS_PER_S = 67e12
#: int32 operations of one open-row, refresh-off step of lane_step.cu
#: (visibility, the ACT / column max-chains, state and counter updates).
OPS_PER_STEP = 80

FIG4_N, FIG4_SEED = 8000, 7
THROUGHPUT_SEEDS = 32


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
    from repro_torch.core.dram import cuda_step

    t0 = time.perf_counter()
    path, build_log = cuda_step.build()
    cuda_step._library()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f}s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's smoke run needs "
             "an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    t_start = time.perf_counter()
    name, count, smi = phase_card()
    phase_build()
    phase_golden()
    phase_plain()
    fig4 = phase_fig4()
    thr = phase_throughput(smi)
    b_ms, b_by = bound(fig4["B"], fig4["N"])
    log(f"[timing] fig4 per launch (mean of 5 policies): kernel "
        f"{fig4['ms']:.4f} ms, plain {fig4['plain_ms']:.1f} ms, bound "
        f"{b_ms:.5f} ms ({b_by}); "
        f"{fig4['B'] * fig4['N'] / fig4['ms'] * 1e3:.4e} req/s; card {smi}")
    if "jax" in sys.modules or any(m == "repro" or m.startswith("repro.")
                                   for m in sys.modules):
        fail("the JAX package was imported")
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    record = {"kernels": [{
        "name": "lane_step", "route": "cuda",
        "source": "src/repro_torch/core/dram/csrc/lane_step.cu",
        "replaces": "src/repro/core/dram/pallas_step.py:92",
        "launches": fig4["launches"], "max_abs_err": fig4["max_abs_err"],
        "ms": fig4["ms"], "plain_ms": fig4["plain_ms"], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
        "shape": f"B={fig4['B']} N={fig4['N']} (Fig. 4, mean of 5 policies)",
        "throughput": thr}]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
