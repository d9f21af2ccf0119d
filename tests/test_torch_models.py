"""The port's model stack against the JAX package, on the CPU.

Weights are made by the JAX package (``model.init``), converted to numpy
and carried across with ``repro_torch.interop.params_from_reference``;
inputs are numpy. The port's SSD scan runs its plain version here. The bar
is ``tests/test_kernels.py``'s float32 tolerance, rtol = atol = 2e-4, on
reduced mamba2-780m and on a hand-built SSM + dense-FFN stack.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as R
import repro_torch.configs as P
from repro.models import build_model as r_build_model
from repro.models import layers as r_layers
from repro.models import ssm as r_ssm
from repro_torch import interop
from repro_torch.models import build_model
from repro_torch.models import layers as p_layers
from repro_torch.models import ssm as p_ssm
from repro_torch.models.builder import init_params

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "mamba2-780m"


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def configs(variant: str):
    """(reference config, port config): reduced mamba2-780m, or hand-built
    stacks with a dense FFN after every SSM position."""
    r, p = R.get_config(ARCH).reduced(), P.get_config(ARCH).reduced()
    if variant == "ssm_dense":
        kw = dict(pattern=(R.LayerSpec("ssm", "dense"),), d_ff=128)
    elif variant == "ssm_dense_gelu":
        kw = dict(pattern=(R.LayerSpec("ssm", "dense"), R.LayerSpec("ssm")),
                  d_ff=96, act="gelu", mlp_glu=False, tie_embeddings=False)
    else:
        return r, p
    pkw = dict(kw, pattern=tuple(P.LayerSpec(s.mixer, s.ffn)
                                 for s in kw["pattern"]))
    return dataclasses.replace(r, **kw), dataclasses.replace(p, **pkw)


@functools.lru_cache(maxsize=None)
def models(variant: str):
    r_cfg, p_cfg = configs(variant)
    r_model = r_build_model(r_cfg, dtype=jnp.float32)
    params = r_model.init(jax.random.key(0))
    p_model = build_model(p_cfg, interop.params_from_reference(
        p_cfg, to_numpy(params)), dtype=torch.float32, device="cpu")
    return r_cfg, r_model, params, p_model


def tokens(cfg, B: int, S: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", False),
                                     ("relu", True)])
def test_layers_match_jax(act, glu):
    """rmsnorm, rope, mlp (every ACTS entry), embed and unembed."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)[None].repeat(2, 0)
    sin_r, cos_r = r_layers.rope_angles(jnp.asarray(pos), 16, 10000.0)
    sin_p, cos_p = p_layers.rope_angles(torch.from_numpy(pos), 16, 10000.0)
    close(sin_p, sin_r)
    close(cos_p, cos_r)
    close(p_layers.apply_rope(torch.from_numpy(x), sin_p, cos_p),
          r_layers.apply_rope(jnp.asarray(x), sin_r, cos_r))
    h = rng.standard_normal((3, 5, 32)).astype(np.float32)
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "up": rng.standard_normal((32, 48)).astype(np.float32) * 0.2,
         "gate": rng.standard_normal((32, 48)).astype(np.float32) * 0.2,
         "down": rng.standard_normal((48, 32)).astype(np.float32) * 0.2}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    close(p_layers.rmsnorm(pt, torch.from_numpy(h)),
          r_layers.rmsnorm(pj, jnp.asarray(h)))
    close(p_layers.mlp(pt, torch.from_numpy(h), act, glu),
          r_layers.mlp(pj, jnp.asarray(h), act, glu))
    table = {"table": rng.standard_normal((40, 32)).astype(np.float32)}
    toks = rng.integers(0, 40, (3, 5))
    close(p_layers.embed({"table": torch.from_numpy(table["table"])},
                         torch.from_numpy(toks), torch.float32),
          r_layers.embed({"table": jnp.asarray(table["table"])},
                         jnp.asarray(toks), jnp.float32))
    close(p_layers.unembed({"table": torch.from_numpy(table["table"])},
                           torch.from_numpy(h), 37),
          r_layers.unembed({"table": jnp.asarray(table["table"])},
                           jnp.asarray(h), 37))


def test_ssm_forward_and_decode_match_jax():
    cfg = P.get_config(ARCH).reduced()
    d = cfg.d_model
    p_jax = r_ssm.init_ssm(jax.random.key(3), d, R.get_config(ARCH).reduced().ssm)
    p_np = to_numpy(p_jax)
    p_t = {k: torch.from_numpy(np.array(v)) for k, v in p_np.items()}
    x = (np.random.default_rng(5).standard_normal((2, 32, d)) * 0.5
         ).astype(np.float32)
    r_cfg = R.get_config(ARCH).reduced().ssm
    out_r, st_r = r_ssm.ssm_forward(p_jax, jnp.asarray(x), d, r_cfg,
                                    return_state=True)
    out_p, st_p = p_ssm.ssm_forward(p_t, torch.from_numpy(x), d, cfg.ssm,
                                    return_state=True)
    close(out_p, out_r)
    for a, b in zip(st_p, st_r):
        close(a, b)
    x1 = (np.random.default_rng(6).standard_normal((2, 1, d))).astype(np.float32)
    dec_r, new_r = r_ssm.ssm_decode(p_jax, jnp.asarray(x1), st_r, d, r_cfg)
    dec_p, new_p = p_ssm.ssm_decode(p_t, torch.from_numpy(x1), st_p, d,
                                    cfg.ssm)
    close(dec_p, dec_r)
    for a, b in zip(new_p, new_r):
        close(a, b)


@pytest.mark.parametrize("variant", ["mamba2", "ssm_dense", "ssm_dense_gelu"])
def test_forward_prefill_decode_match_jax(variant):
    r_cfg, r_model, params, p_model = models(variant)
    toks = tokens(r_cfg, 2, 32, seed=1)
    logits_r, aux_r = r_model.forward(params, {"tokens": jnp.asarray(toks)})
    logits_p, aux_p = p_model({"tokens": torch.from_numpy(toks).long()})
    assert logits_p.shape == (2, 32, r_cfg.padded_vocab)
    close(logits_p, logits_r)
    assert float(aux_p) == float(aux_r) == 0.0

    pre = {"tokens": jnp.asarray(toks[:, :16])}
    lr, cache_r = r_model.prefill(params, pre)
    lp, cache_p = p_model.prefill({"tokens": torch.from_numpy(toks[:, :16]).long()})
    close(lp, lr)
    assert set(cache_p) == set(cache_r)
    for k in cache_r:
        for a, b in zip(cache_p[k], cache_r[k]):
            assert tuple(a.shape) == b.shape
            close(a, b)
    for t in range(16, 20):
        tok = toks[:, t:t + 1]
        lr, cache_r = r_model.decode_step(params, jnp.asarray(tok), cache_r,
                                          jnp.int32(t))
        lp, cache_p = p_model.decode_step(torch.from_numpy(tok).long(),
                                          cache_p, t)
        close(lp, lr)
    for k in cache_r:
        for a, b in zip(cache_p[k], cache_r[k]):
            close(a, b)


@pytest.mark.parametrize("variant", ["mamba2", "ssm_dense_gelu"])
def test_prefill_then_decode_matches_forward(variant):
    """Teacher-forced decode after a prefill equals the parallel forward,
    as tests/test_arch_smoke.py's consistency test holds the reference."""
    r_cfg, _, _, p_model = models(variant)
    toks = torch.from_numpy(tokens(r_cfg, 2, 32, seed=5)).long()
    logits_all, _ = p_model({"tokens": toks})
    _, cache = p_model.prefill({"tokens": toks[:, :16]})
    for t in range(16, 32):
        logits, cache = p_model.decode_step(toks[:, t:t + 1], cache, t)
        close(logits[:, 0], logits_all[:, t])


def test_init_cache_matches_reference_layout():
    r_cfg, r_model, _, p_model = models("mamba2")
    want = r_model.init_cache(3, 64)
    got = p_model.init_cache(3, 64)
    for k in want:
        for a, b in zip(got[k], want[k]):
            assert tuple(a.shape) == b.shape and not a.any()
            assert str(a.dtype).split(".")[-1] == str(b.dtype)


def tree_spec(tree):
    return {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in interop.flatten(tree).items()}


def test_numpy_reference_params_match_the_reference_tree():
    for width in (64, 128):
        r_cfg = R.get_config(ARCH).reduced(width)
        p_cfg = P.get_config(ARCH).reduced(width)
        want = jax.eval_shape(r_build_model(r_cfg).init, jax.random.key(0))
        tree = interop.numpy_reference_params(p_cfg, seed=0)
        assert jax.tree.structure(tree) == jax.tree.structure(want)
        assert tree_spec(tree) == tree_spec(want)
        again = interop.numpy_reference_params(p_cfg, seed=0)
        assert all(np.array_equal(a, b) for a, b in
                   zip(jax.tree.leaves(tree), jax.tree.leaves(again)))
        # the draws sit at the reference initialisers' scales: a standard
        # normal truncated to [-2, 2] (std 0.880) times sqrt(d / vocab)
        table = tree["embed"]["table"]
        std = np.sqrt(p_cfg.d_model / p_cfg.padded_vocab)
        assert np.abs(table).max() <= 2.0 * std * (1 + 1e-6)
        assert 0.85 < table.std() / std < 0.91
    # full width: shapes only (3.1 GB of weights are not drawn here)
    r_cfg, p_cfg = R.get_config(ARCH), P.get_config(ARCH)
    want = jax.eval_shape(r_build_model(r_cfg).init, jax.random.key(0))
    meta = init_params(p_cfg, torch.Generator(), device="meta")
    assert tree_spec(meta) == tree_spec(want)
    assert sum(np.prod(s) for s, _ in tree_spec(meta).values()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(want))


def test_params_from_reference_refuses_a_wrong_tree():
    r_cfg, _, params, _ = models("mamba2")
    p_cfg = P.get_config(ARCH).reduced()
    tree = to_numpy(params)
    tree["dec"]["pos0"]["mixer"].pop("D")
    with pytest.raises(ValueError, match="missing"):
        interop.params_from_reference(p_cfg, tree)
    tree = to_numpy(params)
    tree["final_norm"]["scale"] = tree["final_norm"]["scale"][:-1]
    with pytest.raises(ValueError, match="final_norm.scale"):
        interop.params_from_reference(p_cfg, tree)


@pytest.mark.parametrize("arch", [a for a in P.list_archs() if a != ARCH])
def test_attention_and_moe_models_are_refused(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        build_model(P.get_config(arch).reduced(), {}, device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None builds there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(P.get_config(ARCH).reduced(), {})
