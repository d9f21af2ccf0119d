"""Make the port's serving fixtures with the JAX package.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/make_torch_serve_fixture.py \
        [--arch mamba2-780m | smollm-135m | moonshot-v1-16b-a3b]

One fixture an architecture (``FIXTURES``), at full width in float32:
mamba2-780m (``tests/data/torch_serve_mamba2_780m.json``, prompt length
256, a multiple of its chunk of 64), smollm-135m whole
(``torch_serve_smollm_135m.json``) and moonshot-v1-16b-a3b cut to 2 of its
48 layers (``torch_serve_moonshot_16b_l2.json``; the cut is
``dataclasses.replace(cfg, n_repeats=2)``, recorded as the fixture's
``args["n_repeats"]``), prompt length 128. Weights from
``repro_torch.interop.numpy_reference_params(cfg, 0)`` (numpy draws, so a
machine without JAX builds the same weights), served by the JAX package's
``ServingEngine``: 4 requests with ``launch/serve.py``'s seeded prompt and
shared-prefix draw (seed 0), 16 new tokens, ``max_batch`` 4, policy MASA.
Then each request's tokens are fed back through ``Model.prefill`` and the
jitted ``Model.decode_step`` (as the engine calls them, the prefill cache
padded to the engine's 256 slots) and every step's
logits are summarised: the top-8 ids and values and the top-1/top-2 gap.
The fixture also holds each weight leaf's sha256, so that a different
numpy stream shows as such and not as a kernel error. For an MoE model the
run also prints the smallest gap between a token's k-th and (k+1)-th
router probability (how near the routing came to a tie). mamba2 takes
about 3 minutes and 10 GB on a CPU, smollm one minute, moonshot about 5
minutes and 20 GB; ``chip_smoke.py`` replays each on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
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
from repro.models import moe as moe_mod
from repro.serve.engine import ServingEngine
from repro_torch import configs as torch_configs
from repro_torch import interop

DATA = Path(__file__).resolve().parent / "data"
#: launch/serve.py's flags for each fixture (the port's launcher takes the
#: same ones, plus --device), and the file it goes to. ``n_repeats`` is a
#: depth cut, not a flag: the config's repeats are replaced by it.
FIXTURES = {
    "mamba2-780m": ("torch_serve_mamba2_780m.json", dict(
        arch="mamba2-780m", requests=4, prompt_len=256, max_new=16,
        max_batch=4, shared_prefix=0.5, policy="MASA", seed=0)),
    "smollm-135m": ("torch_serve_smollm_135m.json", dict(
        arch="smollm-135m", requests=4, prompt_len=128, max_new=16,
        max_batch=4, shared_prefix=0.5, policy="MASA", seed=0)),
    "moonshot-v1-16b-a3b": ("torch_serve_moonshot_16b_l2.json", dict(
        arch="moonshot-v1-16b-a3b", requests=4, prompt_len=128, max_new=16,
        max_batch=4, shared_prefix=0.5, policy="MASA", seed=0, n_repeats=2)),
}
TOP = 8
#: ServingEngine.run's default max_len: the slots a decode cache has.
MAX_LEN = 256


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


def grow(prompt_len: int, a):
    """A prefill cache leaf padded to ``MAX_LEN`` slots as
    ``ServingEngine._prefill`` pads it (leaves whose axis 2 has the
    prompt's length: the KV caches), so that teacher forcing decodes as the
    engine does."""
    if a.ndim >= 4 and a.shape[2] == prompt_len:
        return jnp.pad(a, [(0, 0), (0, 0), (0, MAX_LEN - prompt_len)]
                       + [(0, 0)] * (a.ndim - 3))
    return a


def watch_router_gaps(gaps: list) -> None:
    """Wrap the reference's ``route`` (jitted or not) so that each call
    appends the smallest k-th minus (k+1)-th router probability of its
    tokens to ``gaps``. The routing itself is the reference's."""
    route = moe_mod.route

    def watched(p, x2d, cfg):
        out = route(p, x2d, cfg)
        probs = jax.nn.softmax(
            (x2d @ p["router"].astype(x2d.dtype)).astype(jnp.float32), axis=-1)
        top = jax.lax.top_k(probs, cfg.top_k + 1)[0]
        jax.debug.callback(lambda g: gaps.append(float(g)),
                           jnp.min(top[:, -2] - top[:, -1]))
        return out

    moe_mod.route = watched


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m", choices=list(FIXTURES))
    name, a = FIXTURES[ap.parse_args(argv).arch]
    out_path = DATA / name
    t0 = time.perf_counter()
    cfg = get_config(a["arch"])
    port_cfg = torch_configs.get_config(a["arch"])
    if "n_repeats" in a:
        cfg = dataclasses.replace(cfg, n_repeats=a["n_repeats"])
        port_cfg = dataclasses.replace(port_cfg, n_repeats=a["n_repeats"])
    gaps: list[float] = []
    if cfg.moe is not None:
        watch_router_gaps(gaps)
    tree = interop.numpy_reference_params(port_cfg, a["seed"])
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
    stats = engine.run(max_steps=10_000, max_len=MAX_LEN)
    print(f"served {stats} in {time.perf_counter() - t0:.1f}s", flush=True)

    decode = jax.jit(model.decode_step)
    requests = []
    for rid, prompt in enumerate(prompts):
        out = engine.output(rid)
        gen = out[len(prompt):]
        toks = jnp.asarray(prompt, jnp.int32)[None, :]
        logits, cache = model.prefill(params, {"tokens": toks, "labels": toks})
        cache = jax.tree.map(functools.partial(grow, len(prompt)), cache)
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

    if gaps:
        print(f"router: smallest top-k / next gap {min(gaps):.4g} over "
              f"{len(gaps)} route calls", flush=True)
    remake = ("PYTHONPATH=src:. JAX_PLATFORMS=cpu python "
              "tests/make_torch_serve_fixture.py")
    if a["arch"] != "mamba2-780m":
        remake += f" --arch {a['arch']}"
    fixture = {
        "_header": (
            "Made by tests/make_torch_serve_fixture.py with the JAX package "
            f"(jax {jax.__version__}, numpy {np.__version__}, on the CPU). "
            f"Remake: {remake}"),
        "args": a,
        "config": {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
                   "padded_vocab": cfg.padded_vocab, "dtype": "float32"},
        "weights": {"source": "repro_torch.interop.numpy_reference_params",
                    "seed": a["seed"], "sha256": digests},
        "stats": dataclasses.asdict(stats),
        "requests": requests,
    }
    out_path.write_text(json.dumps(fixture, indent=1) + "\n")
    print(f"wrote {out_path} in {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    sys.exit(main())
