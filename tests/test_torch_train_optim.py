"""The port's optimizers, train step and gradient accumulation against the
JAX package, on the CPU, and the ported training examples.

``warmup_cosine``, ``global_norm`` and ``Optimizer.update`` in both modes
(AdamW; Adafactor's factored second moment on leaves of rank 1 to 3) are
held within rtol 1e-6 of the reference on random trees (updated
parameters and states with an absolute floor of 1e-8, for an element that
crosses zero; the parameters are of order 1), the optimizer
state carried across by ``repro_torch.interop`` both ways. Three
``make_train_step`` steps on reduced smollm, mamba2 and moonshot (the
reference's step jitted, the same numpy weights and batches): every step's
loss within rtol 1e-5, every parameter leaf within a relative norm of
1e-5. ``grad_accum=4`` equals ``grad_accum=1`` as ``tests/test_system.py``
holds the reference to it, and equals the reference's own accumulation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as R
import repro_torch.configs as P
from repro.data.synth import make_batch as r_make_batch
from repro.models import build_model as r_build_model
from repro.train import optimizer as r_opt
from repro.train.step import make_train_step as r_make_train_step
from repro_torch import interop
from repro_torch.data.synth import make_batch
from repro_torch.models import build_model
from repro_torch.train import optimizer as p_opt
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves_with_paths

RTOL = 1e-6


def close(got, want, rtol=RTOL, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def to_torch(tree):
    return {k: to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def to_numpy(tree):
    return {k: to_numpy(v) if isinstance(v, dict) else
            (v.detach().numpy().copy() if isinstance(v, torch.Tensor)
             else np.asarray(v)) for k, v in tree.items()}


def random_tree(seed: int, scale: float = 1.0) -> dict:
    """Leaves of rank 1 to 3, a stacked ``[n_repeats, ...]`` leaf included."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"w": n(12, 20), "b": n(20), "dec": {"pos0": {
        "up": n(2, 8, 6), "scale": n(2, 8)}}, "head": n(5, 3)}


# ------------------------------------------------------------ schedule, norm
@pytest.mark.parametrize("base,warmup,total", [(1e-3, 5, 20), (3e-4, 200,
                                                                10_000),
                                               (1e-3, 0, 4)])
def test_warmup_cosine_matches_jax(base, warmup, total):
    steps = sorted({0, 1, 2, warmup - 1, warmup, warmup + 1, total // 2,
                    total - 1, total, total + 7} - {-1})
    p, r = p_opt.warmup_cosine(base, warmup, total), r_opt.warmup_cosine(
        base, warmup, total)
    for s in steps:
        close(p(s), r(jnp.int32(s)), msg=f"step {s}")
        assert p(s).dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1])
def test_global_norm_matches_jax(seed):
    tree = random_tree(seed, scale=3.0)
    close(p_opt.global_norm(to_torch(tree)),
          r_opt.global_norm(jax.tree.map(jnp.asarray, tree)))


# ------------------------------------------------------------ update
@pytest.mark.parametrize("mode", ["adamw", "adafactor"])
@pytest.mark.parametrize("grad_scale", [0.01, 5.0])
def test_update_matches_jax(mode, grad_scale):
    """Four updates from the reference's state after one of its own (so
    the carried state is not zero); ``grad_scale`` 5 clips, 0.01 not."""
    kw = dict(lr=1e-2, warmup=2, total_steps=10)
    p, r = p_opt.make_optimizer(mode, **kw), r_opt.make_optimizer(mode, **kw)
    r_params = jax.tree.map(jnp.asarray, random_tree(10))
    r_state = r.init(r_params)
    r_params, r_state, _ = r.update(jax.tree.map(jnp.asarray,
                                                 random_tree(11, grad_scale)),
                                    r_state, r_params, jnp.int32(0))
    p_params = to_torch(jax.tree.map(np.asarray, r_params))
    p_state = interop.opt_state_from_reference(
        p, p_params, jax.tree.map(np.asarray, r_state))
    for step in range(1, 5):
        g = random_tree(20 + step, grad_scale)
        r_params, r_state, r_m = r.update(jax.tree.map(jnp.asarray, g),
                                          r_state, r_params, jnp.int32(step))
        p_params, p_state, p_m = p.update(to_torch(g), p_state, p_params,
                                          step)
        close(p_m["grad_norm"], r_m["grad_norm"])
        close(p_m["lr"], r_m["lr"])
        for (k, a), b in zip(leaves_with_paths(p_params),
                             jax.tree.leaves(r_params)):
            close(a, b, atol=1e-8, msg=f"{mode} step {step} {k}")
        want_state = jax.tree.map(np.asarray, r_state)
        got_state = interop.opt_state_to_numpy(p_state)
        assert jax.tree.structure(got_state) == jax.tree.structure(want_state)
        for a, b in zip(jax.tree.leaves(got_state),
                        jax.tree.leaves(want_state)):
            close(a, b, atol=1e-8, msg=f"{mode} state at step {step}")


@pytest.mark.parametrize("mode", ["adamw", "adafactor"])
def test_opt_state_interop_checks_the_layout(mode):
    p = p_opt.make_optimizer(mode)
    params = to_torch(random_tree(0))
    state = interop.opt_state_to_numpy(p.init(params))
    back = interop.opt_state_from_reference(p, params, state)
    assert jax.tree.structure(interop.opt_state_to_numpy(back)) == \
        jax.tree.structure(state)
    key = "m" if mode == "adamw" else "v"
    with pytest.raises(ValueError, match="names differ"):
        interop.opt_state_from_reference(p, params, {key: state[key]}
                                         if mode == "adamw" else {})
    bad = jax.tree.map(lambda a: a, state)
    bad["v"]["w"] = (np.zeros((3, 3), np.float32) if mode == "adamw"
                     else {"row": np.zeros(3, np.float32),
                           "col": np.zeros(20, np.float32)})
    with pytest.raises(ValueError, match="want"):
        interop.opt_state_from_reference(p, params, bad)


def test_make_optimizer_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown optimizer mode"):
        p_opt.make_optimizer("sgd")


# ------------------------------------------------------------ train step
def pair(arch: str, width: int = 64, seed: int = 0):
    """(reference config, reference model, its params, port model), both on
    ``numpy_reference_params(cfg, seed)``."""
    r_cfg, p_cfg = R.get_config(arch).reduced(width), P.get_config(
        arch).reduced(width)
    tree = interop.numpy_reference_params(p_cfg, seed)
    p_model = build_model(p_cfg, interop.params_from_reference(p_cfg, tree),
                          dtype=torch.float32, device="cpu")
    return r_cfg, r_build_model(r_cfg, dtype=jnp.float32), jax.tree.map(
        jnp.asarray, tree), p_model


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-780m",
                                  "moonshot-v1-16b-a3b"])
def test_three_train_steps_match_jax(arch):
    r_cfg, r_model, r_params, p_model = pair(arch)
    kw = dict(lr=1e-3, warmup=0, total_steps=10)
    r, p = (r_opt.make_optimizer(r_cfg.optimizer_mode, **kw),
            p_opt.make_optimizer(r_cfg.optimizer_mode, **kw))
    r_step = jax.jit(r_make_train_step(r_model, r))
    p_step = make_train_step(p_model, p)
    r_state, p_params = r.init(r_params), p_model.param_tree()
    p_state = p.init(p_params)
    for step in range(3):
        batch = r_make_batch(r_cfg, 4, 32, seed=step, dtype=jnp.float32)
        r_params, r_state, r_m = r_step(r_params, r_state, batch,
                                        jnp.int32(step))
        p_params, p_state, p_m = p_step(
            p_params, p_state, {k: torch.from_numpy(np.array(v))
                                for k, v in batch.items()}, step)
        for k in ("loss", "ce", "aux"):
            close(p_m[k], r_m[k], rtol=1e-5, atol=1e-7, msg=f"{k} {step}")
        close(p_m["grad_norm"], r_m["grad_norm"], rtol=1e-4)
        for (k, a), b in zip(leaves_with_paths(p_params),
                             jax.tree.leaves(r_params)):
            assert rel_norm(a.detach(), b) < 1e-5, (step, k)


def test_grad_accum_matches_full_batch_and_jax():
    r_cfg, r_model, r_params, p_model = pair("smollm-135m")
    p, r = (p_opt.make_optimizer("adamw", lr=1e-3),
            r_opt.make_optimizer("adamw", lr=1e-3))
    batch = make_batch(p_model.cfg, 8, 32, dtype=torch.float32, device="cpu")
    start = {k: v.detach().clone() for k, v in p_model.state_dict().items()}
    out = {}
    for accum in (1, 4):
        p_model.load_state_dict(start)
        step = make_train_step(p_model, p, grad_accum=accum)
        params, _, m = step(p_model.param_tree(), p.init(p_model.param_tree()),
                            batch, 0)
        out[accum] = (m, to_numpy(params))
    close(out[1][0]["loss"], out[4][0]["loss"], rtol=1e-5)
    for a, b in zip(jax.tree.leaves(out[1][1]), jax.tree.leaves(out[4][1])):
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-4)
    r_batch = r_make_batch(r_cfg, 8, 32, dtype=jnp.float32)
    _, _, r_m = jax.jit(r_make_train_step(r_model, r, grad_accum=4))(
        r_params, r.init(r_params), r_batch, jnp.int32(0))
    for k in ("loss", "ce", "aux", "grad_norm"):
        close(out[4][0][k], r_m[k], rtol=1e-5, atol=1e-7, msg=k)


def test_grad_accum_refuses_a_batch_that_does_not_split():
    _, _, _, p_model = pair("smollm-135m")
    p = p_opt.make_optimizer("adamw")
    step = make_train_step(p_model, p, grad_accum=3)
    batch = make_batch(p_model.cfg, 4, 16, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        step(p_model.param_tree(), p.init(p_model.param_tree()), batch, 0)


def test_adafactor_mode_trains():
    _, _, _, p_model = pair("smollm-135m")
    p = p_opt.make_optimizer("adafactor", lr=1e-3)
    params = p_model.param_tree()
    state = p.init(params)
    assert "m" not in state
    batch = make_batch(p_model.cfg, 4, 32, dtype=torch.float32, device="cpu")
    step = make_train_step(p_model, p)
    losses = []
    for i in range(8):
        params, state, m = step(params, state, batch, i)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
