"""Make the port's training fixture with the JAX package.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/make_torch_train_fixture.py

Trains mamba2-780m whole (48 layers, d_model 1536) in float32 for 4 steps
with the reference's own building blocks: ``build_model(cfg,
dtype=float32)``, ``DataPipeline(cfg, 2, 128, seed=0)``,
``make_optimizer(cfg.optimizer_mode, lr=1e-3, warmup=2, total_steps=4)``
and ``make_train_step`` (jitted, parameters and state donated), from the
weights ``repro_torch.interop.numpy_reference_params(cfg, 0)`` (numpy
draws, so a machine without JAX builds the same ones). Writes
``tests/data/torch_train_mamba2_780m.json``: its own arguments, every
weight leaf's sha256 (so that a different numpy stream shows as such), and
each step's loss, ce, aux, grad_norm and lr, and after each step each of
``NAMED`` leaves' norm and its values at ``SAMPLES`` indices drawn once
from ``np.random.default_rng(SAMPLE_SEED)`` (every index for a leaf of at
most ``SAMPLES`` values). ``chip_smoke.py``'s ``train`` phase replays it
on the card. About 80 seconds and 18 GB on a CPU.

The reference's gradient is NaN at step 3 (``grad_norm`` NaN, so every
parameter after that step's update): its ``ssd_chunked`` takes
``jnp.where(mask, jnp.exp(delta), 0)``, and once a chunk's decay overflows
``exp`` above the diagonal, the ``where``'s backward multiplies that inf by
0. The fixture records it as the reference computes it; the port's
``ssd_chunked`` masks ``delta`` before ``exp`` (the same forward, a finite
gradient), and the train phase holds it to every finite number here.
"""
from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.data.pipeline import DataPipeline
from repro.models import build_model
from repro.train.optimizer import make_optimizer
from repro.train.step import make_train_step
from repro_torch import configs as torch_configs
from repro_torch import interop

OUT = Path(__file__).resolve().parent / "data" / "torch_train_mamba2_780m.json"
ARGS = dict(arch="mamba2-780m", batch=2, seq=128, seed=0, data_seed=0,
            lr=1e-3, warmup=2, total_steps=4, steps=4)
#: Leaves held after the last step, by their path in the parameter tree.
NAMED = ("embed/table", "dec/pos0/mixer/in_zx", "dec/pos0/mixer/A_log",
         "dec/pos0/mixer/out_proj", "final_norm/scale")
SAMPLES = 1024
SAMPLE_SEED = 1


def leaf(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def main() -> None:
    t0 = time.perf_counter()
    a = ARGS
    cfg = get_config(a["arch"])
    tree = interop.numpy_reference_params(torch_configs.get_config(a["arch"]),
                                          a["seed"])
    digests = {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
               for k, v in interop.flatten(tree).items()}
    rng = np.random.default_rng(SAMPLE_SEED)
    index = {}
    for path in NAMED:
        n = leaf(tree, path).size
        index[path] = (np.arange(n) if n <= SAMPLES else
                       np.sort(rng.choice(n, SAMPLES, replace=False)))
    params = jax.tree.map(jnp.asarray, tree)
    del tree
    print(f"weights in {time.perf_counter() - t0:.1f}s", flush=True)

    model = build_model(cfg, dtype=jnp.float32)
    opt = make_optimizer(cfg.optimizer_mode, lr=a["lr"], warmup=a["warmup"],
                         total_steps=a["total_steps"])
    pipe = DataPipeline(cfg, a["batch"], a["seq"], seed=a["data_seed"])
    state = opt.init(params)
    step_fn = jax.jit(make_train_step(model, opt), donate_argnums=(0, 1))
    steps = []
    for step in range(a["steps"]):
        params, state, m = step_fn(params, state, pipe.batch_at(step),
                                   jnp.int32(step))
        rec = {k: float(m[k]) for k in ("loss", "ce", "aux", "grad_norm",
                                         "lr")}
        print(f"step {step}: {rec} at {time.perf_counter() - t0:.1f}s",
              flush=True)
        rec["params"] = {}
        for path in NAMED:
            arr = np.asarray(leaf(params, path)).reshape(-1)
            rec["params"][path] = dict(
                norm=float(np.linalg.norm(arr.astype(np.float64))),
                values=[float(v) for v in arr[index[path]]])
        steps.append(rec)
    fixture = {
        "_header": (
            "Made by tests/make_torch_train_fixture.py with the JAX package "
            f"(jax {jax.__version__}, numpy {np.__version__}, on the CPU). "
            "Remake: PYTHONPATH=src:. JAX_PLATFORMS=cpu python "
            "tests/make_torch_train_fixture.py"),
        "args": dict(a, optimizer=cfg.optimizer_mode, remat=cfg.remat,
                     sample_seed=SAMPLE_SEED, samples=SAMPLES),
        "config": {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
                   "padded_vocab": cfg.padded_vocab, "dtype": "float32"},
        "weights": {"source": "repro_torch.interop.numpy_reference_params",
                    "seed": a["seed"], "sha256": digests},
        "index": {path: [int(i) for i in index[path]] for path in NAMED},
        "steps": steps,
    }
    OUT.write_text(json.dumps(fixture, indent=1) + "\n")
    print(f"wrote {OUT} in {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    sys.exit(main())
