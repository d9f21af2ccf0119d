"""The port's MoE module against the JAX package, on the CPU.

Weights come from the reference's ``init_moe`` (JAX keys), carried across
as numpy; activations are numpy draws. fp32, rtol = atol = 2e-4. The
port's expert products run through ``kernels.moe_gemm.ops.grouped_matmul``
(its plain version here) where the reference runs an einsum.

* ``expert_capacity`` over token counts and configs;
* ``route``: weights, expert ids (exactly) and the aux loss, also on
  exact ties, which go to the lower expert id as ``jax.lax.top_k`` gives;
* ``moe_ffn``: with and without GLU and shared experts, at a capacity
  factor small enough to drop slots, at decode's T = 1, and the expert
  products' launches through ``grouped_matmul`` (three, one token block
  per expert).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as R
import repro_torch.configs as P
from repro.models import moe as r_moe
from repro_torch.models import moe as p_moe

TOL = dict(rtol=2e-4, atol=2e-4)
D = 32


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def cfgs(**kw):
    base = dict(n_experts=8, top_k=2, d_ff_expert=48, n_shared_experts=0)
    base.update(kw)
    return R.MoEConfig(**base), P.MoEConfig(**base)


@functools.lru_cache(maxsize=None)
def weights(glu: bool, shared: int):
    r_cfg, _ = cfgs(n_shared_experts=shared)
    pj = r_moe.init_moe(jax.random.key(7 + shared), D, r_cfg, glu)
    return pj, {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}


def activations(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_expert_capacity_matches_reference():
    for arch in ("moonshot-v1-16b-a3b", "jamba-v0.1-52b",
                 "llama4-maverick-400b-a17b"):
        r_cfg, p_cfg = R.get_config(arch).moe, P.get_config(arch).moe
        for t in (1, 2, 7, 64, 128, 129, 256, 1000, 4096):
            assert (p_moe.expert_capacity(t, p_cfg)
                    == r_moe.expert_capacity(t, r_cfg)), (arch, t)
    # moonshot's serve shapes: decode (T 1) and a 128-token prefill
    moon = P.get_config("moonshot-v1-16b-a3b").moe
    assert p_moe.expert_capacity(1, moon) == 8
    assert p_moe.expert_capacity(128, moon) == 16


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_route_matches_jax(top_k):
    r_cfg, p_cfg = cfgs(top_k=top_k)
    pj, pt = weights(True, 0)
    x = activations((40, D), seed=top_k)
    w_r, ids_r, aux_r = r_moe.route(pj, jnp.asarray(x), r_cfg)
    w_p, ids_p, aux_p = p_moe.route(pt, torch.from_numpy(x), p_cfg)
    assert ids_p.tolist() == np.asarray(ids_r).tolist()
    close(w_p, w_r)
    close(aux_p, aux_r)


def test_route_breaks_ties_to_the_lower_expert():
    """A zero router gives every expert the same probability: the top k
    are experts 0..k-1 in both packages (torch.topk promises no order)."""
    r_cfg, p_cfg = cfgs(top_k=3)
    pj, pt = weights(True, 0)
    pj = dict(pj, router=jnp.zeros_like(pj["router"]))
    pt = dict(pt, router=torch.zeros_like(pt["router"]))
    # rows with some exact ties among the top: two columns share a value
    x = activations((6, D), seed=3)
    _, ids_r, _ = r_moe.route(pj, jnp.asarray(x), r_cfg)
    _, ids_p, _ = p_moe.route(pt, torch.from_numpy(x), p_cfg)
    assert ids_p.tolist() == np.asarray(ids_r).tolist() == [[0, 1, 2]] * 6
    router = np.zeros((D, 8), np.float32)
    router[:, 5] = router[:, 2] = 1.0        # experts 2 and 5 tie on top
    router[:, 7] = 0.5
    xs = np.abs(activations((4, D), seed=4))
    _, ids_r, _ = r_moe.route(dict(pj, router=jnp.asarray(router)),
                              jnp.asarray(xs), r_cfg)
    _, ids_p, _ = p_moe.route(dict(pt, router=torch.from_numpy(router)),
                              torch.from_numpy(xs), p_cfg)
    assert ids_p.tolist() == np.asarray(ids_r).tolist() == [[2, 5, 7]] * 4


def dropped(p_cfg, pt, x: np.ndarray) -> int:
    """Slots dropped past capacity in the port's dispatch of ``x``."""
    t = x.shape[0] * x.shape[1]
    _, ids, _ = p_moe.route(pt, torch.from_numpy(x).reshape(t, D), p_cfg)
    counts = torch.bincount(ids.reshape(-1), minlength=p_cfg.n_experts)
    cap = p_moe.expert_capacity(t, p_cfg)
    return int((counts - cap).clamp(min=0).sum())


@pytest.mark.parametrize("glu,act", [(True, "silu"), (False, "gelu")])
@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.3])
def test_moe_ffn_matches_jax(glu, act, shared, capacity_factor):
    r_cfg, p_cfg = cfgs(n_shared_experts=shared,
                        capacity_factor=capacity_factor)
    pj, pt = weights(glu, shared)
    x = activations((2, 24, D), seed=5)
    y_r, aux_r = r_moe.moe_ffn(pj, jnp.asarray(x), r_cfg, act, glu)
    y_p, aux_p = p_moe.moe_ffn(pt, torch.from_numpy(x), p_cfg, act, glu)
    close(y_p, y_r)
    close(aux_p, aux_r)
    if capacity_factor < 1:
        assert dropped(p_cfg, pt, x) > 0     # the drop path ran


def test_moe_ffn_at_decode_matches_jax():
    """T = 1: capacity 8, each expert's block mostly empty."""
    r_cfg, p_cfg = cfgs(n_shared_experts=1, top_k=3)
    pj, pt = weights(True, 1)
    x = activations((1, 1, D), seed=6)
    y_r, aux_r = r_moe.moe_ffn(pj, jnp.asarray(x), r_cfg)
    y_p, aux_p = p_moe.moe_ffn(pt, torch.from_numpy(x), p_cfg)
    close(y_p, y_r)
    close(aux_p, aux_r)


def test_expert_products_go_through_grouped_matmul(monkeypatch):
    """Three products (up, gate, down), each one grouped_matmul call on the
    [E*C, D] capacity buffer with bt = C and block_eids = arange(E)."""
    _, p_cfg = cfgs()
    _, pt = weights(True, 0)
    calls = []
    real = p_moe.grouped_matmul

    def spy(x, w, eids, *, bt, bf):
        calls.append((tuple(x.shape), tuple(w.shape), eids.tolist(), bt, bf,
                      eids.dtype))
        return real(x, w, eids, bt=bt, bf=bf)

    monkeypatch.setattr(p_moe, "grouped_matmul", spy)
    x = torch.from_numpy(activations((1, 16, D), seed=8))
    p_moe.moe_ffn(pt, x, p_cfg)
    cap = p_moe.expert_capacity(16, p_cfg)
    e, f = p_cfg.n_experts, p_cfg.d_ff_expert
    assert calls == [((e * cap, D), (e, D, f), list(range(e)), cap, 16,
                      torch.int32),
                     ((e * cap, D), (e, D, f), list(range(e)), cap, 16,
                      torch.int32),
                     ((e * cap, f), (e, f, D), list(range(e)), cap, 32,
                      torch.int32)]


def test_numpy_init_matches_the_reference_tree():
    """init_moe's leaves, shapes and dtypes, with and without GLU and
    shared experts (the numpy draw ``interop`` uses)."""
    for glu, shared in ((True, 0), (False, 2), (True, 1)):
        r_cfg, p_cfg = cfgs(n_shared_experts=shared)
        want = jax.eval_shape(functools.partial(
            r_moe.init_moe, d=D, cfg=r_cfg, glu=glu), jax.random.key(0))
        got = p_moe.init_moe(np.random.default_rng(0), D, p_cfg, glu)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: v.shape for k, v in want.items()}
        assert all(v.dtype == torch.float32 for v in got.values())
