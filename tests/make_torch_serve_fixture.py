"""Make ``tests/data/torch_serve_mamba2_780m.json`` with the JAX package.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/make_torch_serve_fixture.py

mamba2-780m at full width in float32, weights from
``repro_torch.interop.numpy_reference_params(cfg, 0)`` (numpy draws, so a
machine without JAX builds the same weights), served by the JAX package's
``ServingEngine``: 4 requests with ``launch/serve.py``'s seeded prompt and
shared-prefix draw (seed 0), prompt length 256 (a multiple of the chunk,
64), 16 new tokens, ``max_batch`` 4, policy MASA. Then each request's
tokens are fed back through ``Model.prefill`` and the jitted
``Model.decode_step`` (as the engine calls them) and every step's logits
are summarised: the top-8 ids and values and the top-1/top-2 gap. The
fixture also holds each weight leaf's sha256, so that a different numpy
stream shows as such and not as a kernel error. About 3 minutes and 10 GB
on a CPU; ``chip_smoke.py`` replays it on the card.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.core.dram.policies import Policy
from repro.models import build_model
from repro.serve.engine import ServingEngine
from repro_torch import configs as torch_configs
from repro_torch import interop

OUT = Path(__file__).resolve().parent / "data" / "torch_serve_mamba2_780m.json"
#: launch/serve.py's flags for the fixture (the port's launcher takes the
#: same ones, plus --device).
ARGS = dict(arch="mamba2-780m", requests=4, prompt_len=256, max_new=16,
            max_batch=4, shared_prefix=0.5, policy="MASA", seed=0)
TOP = 8


def summarise(logits: np.ndarray) -> dict:
    """Top-8 ids and values of one step's logits and the top-1/top-2 gap."""
    idx = np.argsort(-logits, kind="stable")[:TOP]
    val = logits[idx]
    return dict(top_ids=[int(i) for i in idx],
                top_vals=[float(v) for v in val],
                gap=float(val[0] - val[1]))


def leaf_digests(tree) -> dict[str, str]:
    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in interop.flatten(tree).items()}


def main() -> None:
    t0 = time.perf_counter()
    a = ARGS
    cfg = get_config(a["arch"])
    tree = interop.numpy_reference_params(torch_configs.get_config(a["arch"]),
                                          a["seed"])
    digests = leaf_digests(tree)
    params = jax.tree.map(jnp.asarray, tree)
    del tree
    model = build_model(cfg, dtype=jnp.float32)
    print(f"weights in {time.perf_counter() - t0:.1f}s", flush=True)

    engine = ServingEngine(model, params, max_batch=a["max_batch"],
                           policy=Policy[a["policy"]])
    rng = np.random.default_rng(a["seed"])
    prompts, shares = [], []
    for rid in range(a["requests"]):
        prompt = rng.integers(0, cfg.vocab_size, a["prompt_len"]).tolist()
        share = (rid - 1 if (rid > 0 and rng.random() < a["shared_prefix"])
                 else None)
        engine.submit(rid, prompt, a["max_new"], shared_prefix_of=share)
        prompts.append(prompt)
        shares.append(share)
    stats = engine.run(max_steps=10_000)
    print(f"served {stats} in {time.perf_counter() - t0:.1f}s", flush=True)

    decode = jax.jit(model.decode_step)
    requests = []
    for rid, prompt in enumerate(prompts):
        out = engine.output(rid)
        gen = out[len(prompt):]
        toks = jnp.asarray(prompt, jnp.int32)[None, :]
        logits, cache = model.prefill(params, {"tokens": toks, "labels": toks})
        steps = [summarise(np.asarray(logits[0, -1]))]
        for i, tok in enumerate(gen[:-1]):
            logits, cache = decode(params, jnp.asarray([[tok]], jnp.int32),
                                   cache, jnp.int32(len(prompt) + i))
            steps.append(summarise(np.asarray(logits[0, -1])))
        # teacher forcing repeats the engine's calls: same greedy tokens
        assert [s["top_ids"][0] for s in steps] == gen, rid
        requests.append(dict(rid=rid, shared_prefix_of=shares[rid],
                             prompt=prompt, generated=gen, steps=steps))
        print(f"request {rid}: {len(gen)} tokens, min gap "
              f"{min(s['gap'] for s in steps):.4g}", flush=True)

    fixture = {
        "_header": (
            "Made by tests/make_torch_serve_fixture.py with the JAX package "
            f"(jax {jax.__version__}, numpy {np.__version__}, on the CPU). "
            "Remake: PYTHONPATH=src:. JAX_PLATFORMS=cpu python "
            "tests/make_torch_serve_fixture.py"),
        "args": ARGS,
        "config": {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
                   "padded_vocab": cfg.padded_vocab, "dtype": "float32"},
        "weights": {"source": "repro_torch.interop.numpy_reference_params",
                    "seed": a["seed"], "sha256": digests},
        "stats": dataclasses.asdict(stats),
        "requests": requests,
    }
    OUT.write_text(json.dumps(fixture, indent=1) + "\n")
    print(f"wrote {OUT} in {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    sys.exit(main())
