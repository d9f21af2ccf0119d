"""Serving launcher: continuous batching with the SALP-aware scheduler.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --reduced --device cpu

The port of ``repro.launch.serve``, with the same flags plus ``--device``
(default: the card; with no card only ``--device cpu`` runs). Runs the
ServingEngine on a reduced model or the full config, reporting throughput
and the SALP cost-model statistics (scheduled vs FIFO page-access cost).
The weights are ``repro_torch.interop.numpy_reference_params(cfg, seed)``
(fp32), which any machine draws alike; the prompts and shared-prefix links
are the reference launcher's draw from ``np.random.default_rng(seed)``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core.dram.policies import Policy
from repro_torch.models import build_model
from repro_torch.serve.engine import ServingEngine


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--shared-prefix", type=float, default=0.5,
                    help="fraction of requests sharing a prompt prefix")
    ap.add_argument("--policy", default="MASA",
                    choices=[p.name for p in Policy])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def build(args: argparse.Namespace) -> ServingEngine:
    """The engine for ``args``: model, weights and seeded requests."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(128)
    params = interop.params_from_reference(
        cfg, interop.numpy_reference_params(cfg, args.seed))
    model = build_model(cfg, params, dtype=torch.float32, device=args.device)

    engine = ServingEngine(model, max_batch=args.max_batch,
                           policy=Policy[args.policy])
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, args.prompt_len).tolist()
        share = rid - 1 if (rid > 0 and rng.random() < args.shared_prefix) else None
        engine.submit(rid, prompt, args.max_new, shared_prefix_of=share)
    return engine


def main(argv=None) -> ServingEngine:
    args = parse_args(argv)
    # the model runs in full fp32 (matmuls and any convolution)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    engine = build(args)
    t0 = time.perf_counter()
    stats = engine.run(max_steps=10_000)
    if engine.model.device.type == "cuda":
        torch.cuda.synchronize(engine.model.device)
    dt = time.perf_counter() - t0
    print(f"[serve] {stats.tokens} tokens in {dt:.1f}s "
          f"({stats.tokens / max(dt, 1e-9):.1f} tok/s) on "
          f"{engine.model.device}, SALP-scheduled page cost vs FIFO: "
          f"-{100 * stats.cost_reduction:.1f}%")
    return engine


if __name__ == "__main__":
    main()
