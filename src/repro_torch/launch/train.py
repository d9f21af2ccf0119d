"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --steps 200 --ckpt-dir /tmp/ckpt --device cpu

The port of ``repro.launch.train``, with the same flags plus ``--device``
(default: the card; with no card only ``--device cpu`` runs). With
``--distributed`` each process is one rank under ``torchrun``:

  torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch ... \\
      --distributed

``torch.distributed.init_process_group()`` reads torchrun's environment
(NCCL on the card, gloo for ``--device cpu``), the rank runs on
``cuda:$LOCAL_RANK``, and its data pipeline takes host shard ``rank`` of
``world_size``. As in the reference, that is all it shares: each rank
trains its own replica on its own rows and nothing is synchronised (the
sharded step is ``repro_torch.distributed.step``); only rank 0 writes
checkpoints (``checkpoint.store.writes``). A ``--reduced`` run is
float32, a full config takes bfloat16 activations (parameters and
optimizer state stay float32), as in the reference. The
weights are ``repro_torch.interop.numpy_reference_params(cfg, seed)``.
Bounded restarts from the latest checkpoint and the step-keyed data
pipeline make restarts exact.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models import build_model
from repro_torch.train.loop import TrainResult, train
from repro_torch.train.optimizer import make_optimizer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=128,
                    help="reduced-config width")
    ap.add_argument("--distributed", action="store_true",
                    help="one rank of a torchrun job: "
                         "torch.distributed.init_process_group()")
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="inject one crash (fault-tolerance demo)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, *, params: dict | None = None) -> TrainResult:
    """Run the launcher; ``params`` is the tree
    ``numpy_reference_params(cfg, seed)`` gives, for a caller that has
    drawn it already."""
    args = parse_args(argv)
    host_index, n_hosts, device = 0, 1, args.device
    if args.distributed:
        cpu = args.device == "cpu"
        dist.init_process_group("gloo" if cpu else "nccl")
        host_index, n_hosts = dist.get_rank(), dist.get_world_size()
        if not cpu:
            device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
            torch.cuda.set_device(device)
    try:
        return _train(args, params, host_index, n_hosts, device)
    finally:
        if args.distributed:
            dist.destroy_process_group()


def _train(args, params, host_index: int, n_hosts: int, device
           ) -> TrainResult:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(args.width)
    dtype = torch.float32 if args.reduced else torch.bfloat16
    tree = (params if params is not None
            else interop.numpy_reference_params(cfg, args.seed))
    model = build_model(cfg, interop.params_from_reference(cfg, tree),
                        dtype=dtype, device=device)
    opt = make_optimizer(cfg.optimizer_mode, lr=args.lr,
                         warmup=min(50, args.steps // 10 + 1),
                         total_steps=args.steps)
    pipe = DataPipeline(cfg, args.batch, args.seq, seed=args.seed,
                        host_index=host_index, n_hosts=n_hosts,
                        dtype=dtype, device=device)

    res = train(model, opt, pipe, total_steps=args.steps,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                grad_accum=args.grad_accum, seed=args.seed,
                fail_at_step=args.fail_at_step, params=tree)
    first = sum(res.losses[:10]) / max(len(res.losses[:10]), 1)
    last = sum(res.losses[-10:]) / max(len(res.losses[-10:]), 1)
    print(f"[train] done: {res.final_step} steps, loss {first:.3f} -> {last:.3f}, "
          f"restarts={res.restarts}, stragglers={res.straggler_events}")
    return res


if __name__ == "__main__":
    main()
