"""The port's fused attention forward against the JAX package, on the CPU.

Identical numpy inputs (``torch_cases.flash_inputs``) go through the JAX
package's ``flash_attention_kernel`` (its Pallas kernel in interpret mode,
as ``tests/test_flash_attention.py`` runs it) and
``ref.flash_attention_ref``, and through the port's counterparts, whose CPU
path is the kernel's plain version. Shapes and tolerances are
``tests/test_flash_attention.py``'s: rtol = atol = 2e-4 in float32, 2e-2 in
bfloat16. The CUDA kernel itself is held against the plain version in
``tests/test_torch_cuda.py`` (card only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cases as tc
from repro.kernels.flash_attention.kernel import (
    flash_attention_kernel as r_kernel)
from repro.kernels.flash_attention.ref import flash_attention_ref as r_ref
from repro_torch.kernels import flash_attention
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,hd,bq,bk", tc.FLASH_SHAPES)
def test_kernel_matches_jax(bh, s, hd, bq, bk, causal, dtype):
    jd, td = DTYPES[dtype]
    arrays = tc.flash_inputs(bh, s, hd)
    j = [jnp.asarray(a).astype(jd) for a in arrays]
    t = [torch.from_numpy(a).to(td) for a in arrays]
    got = K.flash_attention_kernel(*t, causal=causal, bq=bq, bk=bk)
    assert got.dtype == td and got.shape == (bh, s, hd)
    tol = tc.TOLS[dtype]
    close(got, r_kernel(*j, causal=causal, bq=bq, bk=bk, interpret=True), tol)
    close(flash_attention_ref(*t, causal=causal), r_ref(*j, causal=causal),
          tol)


def test_gqa_wrapper_matches_model_attention():
    """flash_attention == the JAX model's naive attention core (GQA,
    causal), on the model's own q, k, v."""
    from repro.configs.base import AttnConfig
    from repro.models import attention as attn_mod

    b, s, h, hkv, hd = 2, 256, 4, 2, 64
    cfg = AttnConfig(n_heads=h, n_kv_heads=hkv, head_dim=hd)
    p = attn_mod.init_attention(jax.random.key(0), 32, cfg)
    x = jax.random.normal(jax.random.key(1), (b, s, 32), jnp.float32)
    positions = jnp.broadcast_to(jnp.arange(s), (b, s))
    q, k, v = attn_mod._qkv(p, x, cfg, positions)

    ke = attn_mod._expand_kv(k, h // hkv)
    ve = attn_mod._expand_kv(v, h // hkv)
    scores = jnp.einsum("bqhk,bshk->bhqs", q, ke) * hd ** -0.5
    mask = jnp.tril(jnp.ones((s, s), bool))
    scores = jnp.where(mask[None, None], scores, -1e9)
    probs = jax.nn.softmax(scores.astype(jnp.float32), -1).astype(x.dtype)
    out_ref = jnp.einsum("bhqs,bshk->bqhk", probs, ve)

    out = flash_attention(*(torch.from_numpy(np.array(a)) for a in (q, k, v)),
                          causal=True)
    assert out.shape == (b, s, h, hd)
    close(out, out_ref, 2e-4)


@pytest.mark.parametrize("h,hkv", [(4, 1), (6, 3), (8, 8)])
def test_gqa_wrapper_matches_jax_wrapper(h, hkv):
    rng = np.random.default_rng(h * 10 + hkv)
    q = rng.standard_normal((2, 128, h, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 128, hkv, 64)).astype(np.float32)
            for _ in range(2))
    from repro.kernels.flash_attention.ops import flash_attention as r_ops
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True)
    close(got, r_ops(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True), 2e-4)


def test_the_jamba_shape_is_the_configs():
    from repro.configs import get_config
    cfg = get_config("jamba-v0.1-52b").attn
    s = tc.FLASH_JAMBA
    assert (s["H"], s["Hkv"], s["hd"]) == (cfg.n_heads, cfg.n_kv_heads,
                                           cfg.head_dim)
    p = tc.PAGED_JAMBA
    assert (p["KVH"], p["G"], p["hd"]) == (
        cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim)
    assert p["P"] == p["B"] * p["seq"] // p["page"]


def test_checks():
    q = torch.zeros((2, 256, 64))
    with pytest.raises(ValueError, match="multiple of"):
        K.flash_attention_kernel(q, q, q, bq=96)
    with pytest.raises(ValueError, match="one shape"):
        K.flash_attention_kernel(q, q[:1], q)
    with pytest.raises(ValueError, match="query heads"):
        flash_attention(torch.zeros((1, 128, 4, 64)),
                        torch.zeros((1, 128, 3, 64)),
                        torch.zeros((1, 128, 3, 64)))
    with pytest.raises(ValueError, match="runs on cuda"):
        K.flash_attention_kernel(*(torch.zeros((1, 128, 64), device="meta"),) * 3)
    assert K.LAUNCHES == {"flash_attention": 0}


@pytest.mark.parametrize("hd", [48, 64, 96, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_body_by_dtype_and_head_dim(dtype, hd):
    """At hd 64, 96 and 128 bf16 takes the wgmma body and fp32 the tf32x3
    body; any hd the kernel does not take, the simt body (whose launch then
    refuses hd 48)."""
    t = torch.empty((2, 128, hd), dtype=DTYPES[dtype][1])
    want = ("simt" if hd not in K.HEAD_DIMS
            else "wgmma" if dtype == "bfloat16" else "tf32x3")
    assert K.body(t, t, t) == want
    kv = torch.empty((1, 128, hd), dtype=DTYPES[dtype][1])
    assert K.body(t, kv, kv) == want                  # GQA's kv rows


def test_body_needs_aligned_bases_and_one_dtype():
    bf = torch.bfloat16
    q = torch.empty((4, 128, 64), dtype=bf)
    assert K.body(q, q, q) == "wgmma"
    shifted = torch.empty(4 * 128 * 64 + 1, dtype=bf)[1:].view(4, 128, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    assert K.body(shifted, q, q) == K.body(q, q, shifted) == "simt"
    assert K.body(q, q.float(), q) == "simt"
    f = q.float()
    assert K.body(f, f, f) == "tf32x3"
    shifted = torch.empty(4 * 128 * 64 + 1)[1:].view(4, 128, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    assert K.body(shifted, f, f) == K.body(f, f, shifted) == "simt"


def test_bodies_and_c_entry():
    """BODIES counts wgmma, simt and tf32x3 launches (none on the CPU);
    the wrapper's ctypes declaration follows the C signature of
    ``flash_attention_launch`` in csrc/flash_attention.cu, whose ``body``
    takes ``kernel._BODY_CODE``'s codes."""
    K.reset_launches()
    q = torch.zeros((2, 128, 64))
    K.flash_attention_kernel(q, q, q)
    assert K.BODIES == {"wgmma": 0, "simt": 0, "tf32x3": 0}
    assert K._BODY_CODE == {"simt": 0, "wgmma": 1, "tf32x3": 2}
    entry = "flash_attention_launch"
    src = K.SOURCES["flash_attention"].read_text()
    ret, args = tc.c_entry_types(src, entry)
    assert tc.declared(K, [entry])[entry] == (ret, args)
    assert "int body" in src


@pytest.mark.parametrize("hd", [64, 96, 128])
@pytest.mark.parametrize("h,hkv", [(32, 8), (9, 3), (48, 1)])
def test_gqa_ops_matches_jax_ops(h, hkv, hd):
    """ops.flash_attention on unexpanded kv heads == the JAX package's ops
    (which repeats them) at the head counts of jamba (32 on 8), smollm (9 on
    3) and granite (48 on 1), S cut to 128 in two blocks of 64."""
    from repro.kernels.flash_attention.ops import flash_attention as r_ops

    rng = np.random.default_rng(h * 1000 + hkv * 10 + hd)
    q = tc.normal(rng, (1, 128, h, hd))
    k, v = (tc.normal(rng, (1, 128, hkv, hd)) for _ in range(2))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True, bq=64, bk=64)
    assert got.shape == (1, 128, h, hd)
    close(got, r_ops(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, bq=64, bk=64), 2e-4)


def test_ops_hands_the_kernel_unexpanded_kv(monkeypatch):
    """ops reaches the wrapper's launch path with k/v of [B * Hkv, S, hd]:
    q's row b * H + h reads kv row b * Hkv + h // g, which the plain
    version expands as the reference does."""
    seen = []
    run = K.run

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape)))
        return run(q, k, v, **kw)

    monkeypatch.setattr(K, "run", spy)
    rng = np.random.default_rng(5)
    q = torch.from_numpy(tc.normal(rng, (2, 128, 6, 64)))
    k, v = (torch.from_numpy(tc.normal(rng, (2, 128, 2, 64)))
            for _ in range(2))
    got = flash_attention(q, k, v, causal=False)
    assert seen == [((12, 128, 64), (4, 128, 64), (4, 128, 64))]
    flat = [t.repeat_interleave(6 // t.shape[2], dim=2).transpose(1, 2)
            .reshape(12, 128, 64) for t in (q, k, v)]
    want = flash_attention_ref(*flat, causal=False)
    close(got, want.reshape(2, 6, 128, 64).transpose(1, 2), 2e-4)


def test_gqa_checks():
    """ops owns the GQA shape rule, the kernel's wrapper its one-shape
    rule; both hold S to the reference's bq and bk."""
    z = torch.zeros
    with pytest.raises(ValueError, match="query heads"):   # 4 on 3
        flash_attention(z((2, 128, 4, 64)), z((2, 128, 3, 64)),
                        z((2, 128, 3, 64)))
    with pytest.raises(ValueError, match="query heads"):   # v != k
        flash_attention(z((2, 128, 4, 64)), z((2, 128, 2, 64)),
                        z((2, 128, 1, 64)))
    with pytest.raises(ValueError, match="query heads"):   # batch 1 != 2
        flash_attention(z((2, 128, 4, 64)), z((1, 128, 2, 64)),
                        z((1, 128, 2, 64)))
    with pytest.raises(ValueError, match="query heads"):   # k not 4-d
        flash_attention(z((2, 128, 4, 64)), z((2, 128, 2, 1, 64)),
                        z((2, 128, 2, 1, 64)))
    with pytest.raises(ValueError, match="multiple of"):
        flash_attention(z((2, 128, 4, 64)), z((2, 128, 2, 64)),
                        z((2, 128, 2, 64)), bq=96)
    q = z((6, 128, 64))
    with pytest.raises(ValueError, match="one shape"):     # 6 rows on 2
        K.flash_attention_kernel(q, q[:2], q[:2])
    with pytest.raises(ValueError, match="multiple of"):
        K.flash_attention_kernel(q, q, q, bk=48)
    got = flash_attention(z((2, 128, 4, 64)), z((2, 128, 2, 64)),
                          z((2, 128, 2, 64)))
    assert got.shape == (2, 128, 4, 64)