"""End-to-end training driver: train a reduced LM for a few hundred steps
with checkpointing and an injected node failure (the fault-tolerance path),
and show the loss dropping.

    PYTHONPATH=src python -m repro_torch.train_lm --arch smollm-135m \\
        --steps 200 [--device cpu]

The port of ``examples/train_lm.py``, with the same flags plus
``--device`` (default: the card). The injected failure at step 120
exercises ``SupervisedRun``: the loop restarts from the step-100
checkpoint and replays the exact same data (step-keyed pipeline), finishing
all steps. The weights are ``repro_torch.interop.numpy_reference_params``
of the seed 0, where the example draws them from ``jax.random.key(0)``.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models import build_model
from repro_torch import interop
from repro_torch.train.loop import TrainResult, train
from repro_torch.train.optimizer import make_optimizer


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--fail-at-step", type=int, default=120)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced(args.width)
    tree = interop.numpy_reference_params(cfg, 0)
    model = build_model(cfg, interop.params_from_reference(cfg, tree),
                        dtype=torch.float32, device=args.device)
    opt = make_optimizer(cfg.optimizer_mode, lr=1e-3, warmup=20,
                         total_steps=args.steps)
    pipe = DataPipeline(cfg, args.batch, args.seq, dtype=torch.float32,
                        device=args.device)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        res = train(model, opt, pipe, total_steps=args.steps,
                    ckpt_dir=ckpt_dir, ckpt_every=50,
                    fail_at_step=args.fail_at_step, params=tree)

    first = sum(res.losses[:10]) / 10
    last = sum(res.losses[-10:]) / 10
    print(f"\n[train_lm] {res.final_step} steps done "
          f"(restarts={res.restarts} — injected failure recovered)")
    print(f"[train_lm] loss {first:.3f} -> {last:.3f} "
          f"({'LEARNING' if last < first * 0.9 else 'check hyperparams'})")
    if res.final_step != args.steps:
        raise RuntimeError(f"stopped at step {res.final_step}")
    if res.restarts < 1:
        raise RuntimeError("the injected failure should have triggered a "
                           "restart")
    if not last < first:
        raise RuntimeError(f"loss did not decrease: {first} -> {last}")
    return res


if __name__ == "__main__":
    main()
