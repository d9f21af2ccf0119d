"""The training loop: data pipeline + train step + checkpointing + watchdog.

The counterpart of ``repro.train.loop``, with its fault-tolerance
contract: step-keyed deterministic data, async checkpoints every
``ckpt_every`` steps, supervised restarts resuming from the latest
checkpoint (``fail_at_step`` injects one crash).

Deliberate differences: the reference draws the initial parameters from
``jax.random.key(seed)``; the port takes
``repro_torch.interop.numpy_reference_params(cfg, seed)`` (numpy draws,
alike on every machine), or the tree given as ``params`` (the reference's
layout as numpy, so a test hands both packages one tree), and loads it into
the model. ``TrainResult`` also keeps each step's wall time (``step_s``,
read after the step's loss reached the host).
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch import interop
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataPipeline
from repro_torch.fault.watchdog import StepWatchdog, SupervisedRun
from repro_torch.models.builder import Model
from repro_torch.train.optimizer import Optimizer
from repro_torch.train.step import make_train_step


@dataclasses.dataclass
class TrainResult:
    final_step: int
    losses: list[float]
    straggler_events: int
    restarts: int
    step_s: list[float] = dataclasses.field(default_factory=list)


def train(model: Model, optimizer: Optimizer, pipeline: DataPipeline, *,
          total_steps: int, ckpt_dir: str | None = None, ckpt_every: int = 50,
          grad_accum: int = 1, seed: int = 0,
          log_every: int = 10, max_restarts: int = 3,
          fail_at_step: int | None = None,
          params: dict | None = None) -> TrainResult:
    """Train ``model`` from ``params`` (default: the numpy draw of
    ``seed``) for ``total_steps`` steps."""
    step_fn = make_train_step(model, optimizer, grad_accum)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    watchdog = StepWatchdog()
    losses: list[float] = []
    step_s: list[float] = []
    injected = {"done": False}

    tree = params if params is not None else interop.numpy_reference_params(
        model.cfg, seed)
    model.load_state_dict(interop.params_from_reference(
        model.cfg, tree, model.pad_heads))
    params0 = model.param_tree()
    state = {"params": params0, "opt": optimizer.init(params0)}

    def body(start_step: int) -> int:
        nonlocal state
        if mgr is not None and mgr.latest_step() is not None:
            _, restored, _ = mgr.restore(state)
            state = restored
        for step in range(start_step, total_steps):
            t0 = time.perf_counter()
            batch = pipeline.batch_at(step)
            if (fail_at_step is not None and step == fail_at_step
                    and not injected["done"]):
                injected["done"] = True
                raise RuntimeError("injected node failure")
            params, opt, metrics = step_fn(state["params"], state["opt"],
                                           batch, step)
            state = {"params": params, "opt": opt}
            loss = float(metrics["loss"])
            losses.append(loss)
            step_s.append(time.perf_counter() - t0)
            watchdog.observe_step(step, step_s[-1])
            watchdog.observe_heartbeat(pipeline.heartbeat)
            if step % log_every == 0:
                print(f"[train] step={step} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f}")
            if mgr is not None and (step + 1) % ckpt_every == 0:
                mgr.save(step + 1, state)
        if mgr is not None:
            mgr.save(total_steps, state, block=True)
        return total_steps

    sup = SupervisedRun(body, (mgr.latest_step if mgr else (lambda: 0)),
                        max_restarts=max_restarts)
    final = sup.run()
    if mgr is not None:
        mgr.wait()
    return TrainResult(final_step=final, losses=losses,
                       straggler_events=len(watchdog.events),
                       restarts=sup.restarts, step_s=step_s)
