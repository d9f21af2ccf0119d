"""Serving demo: continuous batching with the SALP-aware scheduler vs FIFO.

    PYTHONPATH=src python -m repro_torch.serve_salp [--device cuda]

The port of ``examples/serve_salp.py``: reduced phi3-mini (width 64, fp32)
serves 10 requests (32-token prompts, 12 new tokens, every odd request
sharing its predecessor's prefix) under each paper policy's cost model,
with sequential page ids (the high-conflict regime where scheduling
matters). It prints the page-access cost of the SALP-aware order against
FIFO and checks that the generated tokens are the same under every policy
(scheduling must never change results). The weights are
``repro_torch.interop.numpy_reference_params(cfg, seed)``, where the
example draws them from ``jax.random.key(0)``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core.dram.policies import Policy
from repro_torch.models import Model, build_model
from repro_torch.serve.engine import EngineStats, ServingEngine

POLICIES = (Policy.BASELINE, Policy.SALP1, Policy.SALP2, Policy.MASA)


def run_policy(policy: Policy, model: Model, seed: int = 0
               ) -> tuple[EngineStats, list[tuple[int, ...]]]:
    """The example's workload under ``policy``: stats and every output."""
    eng = ServingEngine(model, max_batch=10, n_pages=512, page_size=8,
                        policy=policy, interleave_pages=False)
    rng = np.random.default_rng(seed)
    for rid in range(10):
        prompt = rng.integers(0, 500, 32).tolist()
        share = rid - 1 if rid % 2 == 1 else None   # half share prefixes
        eng.submit(rid, prompt, 12, shared_prefix_of=share)
    stats = eng.run()
    return stats, [tuple(eng.output(r)) for r in range(10)]


def build(seed: int = 0, device=None) -> Model:
    cfg = get_config("phi3-mini-3.8b").reduced(64)
    params = interop.params_from_reference(
        cfg, interop.numpy_reference_params(cfg, seed))
    return build_model(cfg, params, dtype=torch.float32, device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    model = build(args.seed, args.device)
    out, ref_outs = {}, None
    print(f"{'policy':10s} {'tokens':>7s} {'sched-cost':>11s} "
          f"{'fifo-cost':>10s} {'saved':>7s}")
    for policy in POLICIES:
        stats, outs = run_policy(policy, model)
        if ref_outs is None:
            ref_outs = outs
        if outs != ref_outs:
            raise RuntimeError(f"{policy.name}: scheduling changed the "
                               f"generated tokens")
        print(f"{policy.pretty:10s} {stats.tokens:7d} "
              f"{stats.scheduled_cost:11d} {stats.fifo_cost:10d} "
              f"{100 * stats.cost_reduction:6.1f}%")
        out[policy.name] = (stats, outs)
    print("\n(The MASA cost model turns conflicting page accesses into "
          "designated\n hits, so the scheduler finds cheaper orders — "
          "outputs are identical.)")
    return out


if __name__ == "__main__":
    main()
