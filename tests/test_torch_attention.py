"""The port's attention module against the JAX package, on the CPU.

Weights come from the reference's ``init_attention`` (JAX keys), carried
across as numpy; inputs are numpy draws. fp32 throughout, at
``tests/test_kernels.py``'s tolerance, rtol = atol = 2e-4.

* ``attention`` naive, and chunked with S above ``q_chunk``, causal and
  not, on MHA and GQA head ratios;
* ``prefill_attention`` at S 2048 (chunked above 1024) on a narrow width;
* ``decode_attention`` grouped and expanded: a scalar and a ``[B]``
  ``cur_len``, and ``cur_len == S_max`` (the reference writes nothing
  there and keeps every slot valid);
* ``cross_attention``;
* ``n_pad_heads`` on a GQA config, where the padded head count regroups
  the query heads onto the kv heads (a reference quirk the port keeps).
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
from repro.models import attention as r_attn
from repro_torch.models import attention as p_attn

TOL = dict(rtol=2e-4, atol=2e-4)
#: (label, n_heads, n_kv_heads, head_dim): MHA, GQA 4:1 and 4:2 as the
#: reduced smollm-135m, phi3-mini and internvl2-2b configs have them.
HEADS = [("mha", 4, 4, 8), ("gqa4", 4, 1, 8), ("gqa2", 4, 2, 16)]


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def cfgs(h: int, kv: int, hd: int, causal: bool = True):
    kw = dict(n_heads=h, n_kv_heads=kv, head_dim=hd, causal=causal)
    return R.AttnConfig(**kw), P.AttnConfig(**kw)


@functools.lru_cache(maxsize=None)
def weights(d: int, h: int, kv: int, hd: int, pad: int = 0):
    """(JAX params, port params) from the reference's initialiser."""
    r_cfg, _ = cfgs(h, kv, hd)
    pj = r_attn.init_attention(jax.random.key(d * 131 + h * 7 + kv + pad), d,
                               r_cfg, n_pad_heads=pad)
    return pj, {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}


def activations(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("label,h,kv,hd", HEADS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl,q_chunk", [("naive", 1024), ("chunked", 16)])
def test_attention_matches_jax(label, h, kv, hd, causal, impl, q_chunk):
    d, s = 32, 64
    r_cfg, p_cfg = cfgs(h, kv, hd, causal)
    pj, pt = weights(d, h, kv, hd)
    x = activations((2, s, d), seed=1)
    want = r_attn.attention(pj, jnp.asarray(x), r_cfg, impl=impl,
                            q_chunk=q_chunk)
    got = p_attn.attention(pt, torch.from_numpy(x), p_cfg, impl=impl,
                           q_chunk=q_chunk)
    close(got, want)
    # explicit positions (an offset prompt) take the same path
    pos = np.arange(5, 5 + s, dtype=np.int32)[None].repeat(2, 0)
    close(p_attn.attention(pt, torch.from_numpy(x), p_cfg,
                           positions=torch.from_numpy(pos)),
          r_attn.attention(pj, jnp.asarray(x), r_cfg,
                           positions=jnp.asarray(pos)))


def test_chunked_equals_naive_in_the_port():
    """The query-chunk schedule is the same function as the full one."""
    _, p_cfg = cfgs(4, 2, 16)
    _, pt = weights(32, 4, 2, 16)
    x = torch.from_numpy(activations((1, 96, 32), seed=2))
    close(p_attn.attention(pt, x, p_cfg, impl="chunked", q_chunk=32),
          p_attn.attention(pt, x, p_cfg, impl="naive"))


@pytest.mark.parametrize("impl", ["chunked", "naive"])
def test_prefill_attention_at_2048_matches_jax(impl):
    """S 2048 > 1024: "chunked" runs two query chunks of 1024."""
    d, s = 16, 2048
    r_cfg, p_cfg = cfgs(2, 1, 8)
    pj, pt = weights(d, 2, 1, 8)
    x = activations((1, s, d), seed=3)
    y_r, kv_r = r_attn.prefill_attention(pj, jnp.asarray(x), r_cfg, impl=impl)
    y_p, kv_p = p_attn.prefill_attention(pt, torch.from_numpy(x), p_cfg,
                                         impl=impl)
    close(y_p, y_r)
    close(kv_p.k, kv_r.k)
    close(kv_p.v, kv_r.v)


def decode_case(h, kv, hd, s_prompt: int, s_max: int, seed: int):
    """A prefilled cache grown to ``s_max`` slots, in both packages."""
    d = 32
    r_cfg, p_cfg = cfgs(h, kv, hd)
    pj, pt = weights(d, h, kv, hd)
    x = activations((3, s_prompt, d), seed)
    _, kv_r = r_attn.prefill_attention(pj, jnp.asarray(x), r_cfg)
    pad = [(0, 0), (0, s_max - s_prompt), (0, 0), (0, 0)]
    kv_r = r_attn.KVCache(jnp.pad(kv_r.k, pad), jnp.pad(kv_r.v, pad))
    kv_p = p_attn.KVCache(torch.from_numpy(np.array(kv_r.k)),
                          torch.from_numpy(np.array(kv_r.v)))
    return r_cfg, p_cfg, pj, pt, kv_r, kv_p


@pytest.mark.parametrize("label,h,kv,hd", HEADS)
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("cur", ["scalar", "per_row", "at_s_max"])
def test_decode_attention_matches_jax(label, h, kv, hd, grouped, cur):
    s_prompt, s_max = 12, 16
    r_cfg, p_cfg, pj, pt, kv_r, kv_p = decode_case(h, kv, hd, s_prompt,
                                                   s_max, seed=4)
    lens = {"scalar": np.int32(s_prompt),
            "per_row": np.array([12, 3, 15], np.int32),
            "at_s_max": np.int32(s_max)}[cur]
    for step in range(3):
        x1 = activations((3, 1, 32), seed=10 + step)
        y_r, kv_r = r_attn.decode_attention(pj, jnp.asarray(x1), r_cfg, kv_r,
                                            jnp.asarray(lens), grouped=grouped)
        y_p, kv_p = p_attn.decode_attention(
            pt, torch.from_numpy(x1), p_cfg, kv_p,
            torch.from_numpy(np.asarray(lens)), grouped=grouped)
        close(y_p, y_r)
        close(kv_p.k, kv_r.k)
        close(kv_p.v, kv_r.v)
        if cur == "at_s_max":
            # nothing written past the cache: it keeps its prefill contents
            assert torch.equal(kv_p.k[:, s_prompt:], torch.zeros_like(
                kv_p.k[:, s_prompt:]))
        else:
            lens = np.minimum(lens + 1, s_max)


def test_decode_takes_a_python_int():
    """The engine passes ``cur_len`` as an int."""
    r_cfg, p_cfg, pj, pt, kv_r, kv_p = decode_case(4, 2, 16, 6, 8, seed=5)
    x1 = activations((3, 1, 32), seed=6)
    y_r, _ = r_attn.decode_attention(pj, jnp.asarray(x1), r_cfg, kv_r,
                                     jnp.int32(6))
    y_p, _ = p_attn.decode_attention(pt, torch.from_numpy(x1), p_cfg, kv_p, 6)
    close(y_p, y_r)


@pytest.mark.parametrize("label,h,kv,hd", HEADS)
def test_cross_attention_matches_jax(label, h, kv, hd):
    d = 32
    r_cfg, p_cfg = cfgs(h, kv, hd, causal=False)
    pj, pt = weights(d, h, kv, hd)
    x = activations((2, 9, d), seed=7)
    enc = activations((2, 20, d), seed=8)
    close(p_attn.cross_attention(pt, torch.from_numpy(x),
                                 torch.from_numpy(enc), p_cfg),
          r_attn.cross_attention(pj, jnp.asarray(x), jnp.asarray(enc), r_cfg))


def test_padded_heads_match_jax_and_regroup():
    """Reduced phi3-mini's 4 heads on 2 kv heads (as if 4:2), padded by 4:
    the padded heads are zero in wq and wo, and the groups become 8 // 2,
    so heads 0-3 all read kv head 0. The port follows the reference."""
    r_cfg = dataclasses.replace(R.get_config("phi3-mini-3.8b").reduced().attn,
                                n_kv_heads=2)
    p_cfg = P.AttnConfig(**dataclasses.asdict(r_cfg))
    d, pad = 64, 4
    pj, pt = weights(d, r_cfg.n_heads, 2, r_cfg.head_dim, pad)
    h = r_cfg.n_heads
    assert pt["wq"].shape[1] == h + pad and not pt["wq"][:, h:].any()
    assert not pt["wo"][h:].any()
    x = activations((2, 10, d), seed=9)
    close(p_attn.attention(pt, torch.from_numpy(x), p_cfg),
          r_attn.attention(pj, jnp.asarray(x), r_cfg))
    y_r, kv_r = r_attn.prefill_attention(pj, jnp.asarray(x), r_cfg)
    y_p, kv_p = p_attn.prefill_attention(pt, torch.from_numpy(x), p_cfg)
    close(y_p, y_r)
    for grouped in (False, True):
        x1 = activations((2, 1, d), seed=11)
        close(p_attn.decode_attention(pt, torch.from_numpy(x1), p_cfg, kv_p,
                                      9, grouped=grouped)[0],
              r_attn.decode_attention(pj, jnp.asarray(x1), r_cfg, kv_r,
                                      jnp.int32(9), grouped=grouped)[0])
    # the regrouping: unpadded, head 2 would read kv head 1
    unpadded = {k: v[:, :h] if k == "wq" else v[:h] if k == "wo" else v
                for k, v in pt.items()}
    assert not torch.allclose(
        p_attn.attention(pt, torch.from_numpy(x), p_cfg),
        p_attn.attention(unpadded, torch.from_numpy(x), p_cfg), **TOL)


def test_numpy_init_pads_with_zeros():
    """The numpy draw (``repro_torch.interop``'s source of weights) zeroes
    the padded heads as the reference's initialiser does."""
    cfg = P.AttnConfig(n_heads=3, n_kv_heads=1, head_dim=8)
    p = p_attn.init_attention(np.random.default_rng(0), 16, cfg,
                              n_pad_heads=2)
    assert p["wq"].shape == (16, 5, 8) and p["wo"].shape == (5, 8, 16)
    assert not p["wq"][:, 3:].any() and not p["wo"][3:].any()
    assert p["wq"][:, :3].abs().min() > 0
