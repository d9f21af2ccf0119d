"""Quickstart: the three layers of the port in one script.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

The port of ``examples/quickstart.py``:

1. Layer A: run the DRAM simulator on one workload under all policies
   (the paper's mechanisms) and print the IPC ladder, then a 4-core mix
   under three schedulers.
2. Layer B: call the grouped expert GEMM kernel (SA_SEL-style
   designation) and check it against the oracle.
3. Layer C: three train steps of reduced phi3-mini, then serving decode
   with the SALP-aware scheduler.

On the card layer B launches the CUDA kernel; with ``--device cpu``
every layer runs the plain versions. Where the example draws layer B's
inputs and layer C's weights from ``jax.random``, the port draws them
from numpy (``interop.numpy_reference_params`` for the weights).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import interop
from repro_torch.compat import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.dram import (ROW_SPACE_STRIDE, Policy, Scheduler,
                                   SimConfig, generate_trace, simulate,
                                   summarize, workload)
from repro_torch.core.dram.multicore import simulate_multicore
from repro_torch.data.synth import make_batch
from repro_torch.kernels.moe_gemm.ops import capacity_block_eids, grouped_matmul
from repro_torch.kernels.moe_gemm.ref import grouped_matmul_ref
from repro_torch.models import build_model
from repro_torch.serve.engine import ServingEngine
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.step import make_train_step


def layer_a_dram(device=None) -> None:
    print("=== Layer A: SALP DRAM simulator (the paper's mechanisms) ===")
    prof = workload("lbm")
    trace = generate_trace(prof, 4000, seed=7)
    base = None
    for pol in (Policy.BASELINE, Policy.SALP1, Policy.SALP2, Policy.MASA,
                Policy.IDEAL):
        s = summarize(simulate(trace, pol, device=device), prof)
        base = base or s["ipc"]
        print(f"  {pol.pretty:10s} IPC={s['ipc']:.3f} (+{100*(s['ipc']/base-1):5.1f}%) "
              f"row-hit={s['row_hit_rate']:.2f} energy={s['dynamic_nj']:.0f}nJ")

    # Multi-core: the SAME controller with 4 cores, scheduler from SimConfig
    # (the paper's Sec. 4 combination: SALP x request scheduling, refresh on).
    names = ("mcf", "lbm", "soplex", "sphinx3")
    mix = [generate_trace(workload(nm), 1000, seed=7,
                          row_space_offset=ROW_SPACE_STRIDE * i)
           for i, nm in enumerate(names)]
    print(f"  4-core mix {'+'.join(names)} (refresh on):")
    for sched in (Scheduler.FCFS, Scheduler.FRFCFS, Scheduler.TCM):
        cfg = SimConfig(scheduler=sched, refresh=True)
        ws = simulate_multicore(mix, Policy.MASA, cfg,
                                device=device).weighted_speedup
        print(f"    MASA + {sched.pretty:12s} weighted speedup = {ws:.2f}")


def layer_b_kernel(device=None) -> float:
    print("=== Layer B: MASA designation kernel (grouped expert GEMM) ===")
    dev = resolve_device(device)
    E, C, D, F = 4, 128, 64, 128
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((E * C, D), dtype=np.float32)
                         ).to(dev)
    w = torch.from_numpy(rng.standard_normal((E, D, F), dtype=np.float32)
                         * 0.1).to(dev)
    eids = capacity_block_eids(E, C, bt=64, device=dev)
    y = grouped_matmul(x, w, eids, bt=64, bf=128)
    err = float((y - grouped_matmul_ref(x, w, eids, 64)).abs().max())
    print(f"  kernel vs oracle max|err| = {err:.2e} "
          f"({len(eids)} blocks, {E} experts: consecutive same-expert blocks "
          f"are row-buffer hits)")
    return err


def layer_c_train_and_serve(device=None) -> list[float]:
    print("=== Layer C: reduced train step + SALP-aware serving ===")
    cfg = get_config("phi3-mini-3.8b").reduced(64)
    tree = interop.numpy_reference_params(cfg, 0)
    model = build_model(cfg, interop.params_from_reference(cfg, tree),
                        dtype=torch.float32, device=device)
    opt = make_optimizer("adamw", lr=1e-3)
    step = make_train_step(model, opt)
    params = model.param_tree()
    state = opt.init(params)
    batch = make_batch(cfg, 4, 32, dtype=torch.float32, device=device)
    losses = []
    for i in range(3):
        params, state, metrics = step(params, state, batch, i)
        losses.append(float(metrics["loss"]))
        print(f"  train step {i}: loss={losses[-1]:.3f}")

    eng = ServingEngine(model, max_batch=4, n_pages=256, page_size=8)
    rng = np.random.default_rng(0)
    for rid in range(6):
        eng.submit(rid, rng.integers(0, 500, 24).tolist(), 8,
                   shared_prefix_of=rid - 1 if rid % 2 else None)
    stats = eng.run()
    print(f"  served {stats.tokens} tokens; SALP-scheduled page cost vs FIFO: "
          f"-{100*stats.cost_reduction:.1f}%")
    return losses


def main(argv=None) -> list[float]:
    """Run the three layers; returns layer C's train losses."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    layer_a_dram(args.device)
    layer_b_kernel(args.device)
    return layer_c_train_and_serve(args.device)


if __name__ == "__main__":
    main()
