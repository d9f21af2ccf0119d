"""The port's grouped expert GEMM against the JAX package, on the CPU.

Identical numpy inputs (``torch_cases.moe_inputs``) go through the JAX
package's ``ops.grouped_matmul`` (its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it) and ``ref.grouped_matmul_ref``, and
through the port's counterparts, whose CPU path is the kernel's plain
version. Shapes and tolerances are ``tests/test_kernels.py``'s: rtol =
atol = 2e-4 in float32, 2e-2 in bfloat16. The CUDA kernel itself is held
against the plain version in ``tests/test_torch_cuda.py`` (card only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cases as tc
from repro.kernels.moe_gemm.ops import capacity_block_eids as r_eids
from repro.kernels.moe_gemm.ops import grouped_matmul as r_grouped_matmul
from repro.kernels.moe_gemm.ref import grouped_matmul_ref as r_ref
from repro_torch.kernels import grouped_matmul
from repro_torch.kernels.moe_gemm import capacity_block_eids
from repro_torch.kernels.moe_gemm import kernel as K
from repro_torch.kernels.moe_gemm.ref import grouped_matmul_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("E,C,D,F,bt,bf", tc.MOE_SHAPES)
def test_matches_jax(E, C, D, F, bt, bf, dtype):
    jd, td = DTYPES[dtype]
    xs, w = tc.moe_inputs(E, C, D, F, seed=1)
    j_eids = r_eids(E, C, bt)
    eids = capacity_block_eids(E, C, bt, device="cpu")
    np.testing.assert_array_equal(eids.numpy(), np.asarray(j_eids))
    jx, jw = jnp.asarray(xs).astype(jd), jnp.asarray(w).astype(jd)
    tx, tw = torch.from_numpy(xs).to(td), torch.from_numpy(w).to(td)
    got = grouped_matmul(tx, tw, eids, bt=bt, bf=bf)
    assert got.dtype == td and got.shape == (E * C, F)
    tol = tc.TOLS[dtype]
    close(got, r_grouped_matmul(jx, jw, j_eids, bt=bt, bf=bf), tol)
    close(grouped_matmul_ref(tx, tw, eids, bt), r_ref(jx, jw, j_eids, bt), tol)


#: The shapes the stream body takes on the card (E, C, D, F, bt): bt 8,
#: 16, 24 and 32 at a ragged D (97) and F's like moonshot's 1408, whole
#: 16-byte units in both dtypes (1408 and 1416 past its last 128 columns).
STREAM_JAX = ((4, 16, 97, 1408, 8), (3, 32, 97, 1416, 16),
              (2, 48, 97, 264, 24), (2, 64, 97, 1416, 32))


@pytest.mark.parametrize("designation", ["capacity", "scattered"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("E,C,D,F,bt", STREAM_JAX)
def test_stream_shapes_match_jax(E, C, D, F, bt, dtype, designation):
    """At the stream body's shapes, on the capacity layout and on a
    scattered designation (random experts, repeats and gaps), the port's
    grouped_matmul equals the JAX package's (interpret mode) within the
    dtype's tolerance; the card would take the stream body there."""
    jd, td = DTYPES[dtype]
    xs, w = tc.moe_inputs(E, C, D, F, seed=6)
    if designation == "capacity":
        ids = np.array(r_eids(E, C, bt))
    else:
        ids = np.random.default_rng(7).integers(
            0, E, E * C // bt).astype(np.int32)
    tx, tw = torch.from_numpy(xs).to(td), torch.from_numpy(w).to(td)
    assert K.body(tx, tw, bt) == "stream"
    got = grouped_matmul(tx, tw, torch.from_numpy(ids), bt=bt, bf=F)
    assert got.dtype == td and got.shape == (E * C, F)
    want = r_grouped_matmul(jnp.asarray(xs).astype(jd),
                            jnp.asarray(w).astype(jd), jnp.asarray(ids),
                            bt=bt, bf=F)
    close(got, want, tc.TOLS[dtype])


def test_c_entry_declarations_match_the_source():
    """The wrapper's ctypes declaration follows the C signature of
    ``moe_gemm_launch`` in csrc/moe_gemm.cu (a pointer c_void_p, an int
    c_int)."""
    entry = "moe_gemm_launch"
    ret, args = tc.c_entry_types(K.SOURCES["moe_gemm"].read_text(), entry)
    assert tc.declared(K, [entry])[entry] == (ret, args)


def test_designation_semantics():
    """Every block must use exactly its designated expert's weights
    (zeroing one expert's weights zeroes only its blocks)."""
    E, C, D, F, bt = 4, 128, 32, 128, 64
    xs = torch.ones((E * C, D))
    w = torch.ones((E, D, F))
    w[2] = 0.0
    eids = capacity_block_eids(E, C, bt, device="cpu")
    yb = grouped_matmul(xs, w, eids, bt=bt, bf=128).reshape(E, C, F)
    assert float(yb[2].abs().max()) == 0.0
    assert float(yb[0].abs().min()) > 0.0
    r = r_grouped_matmul(jnp.ones((E * C, D)), jnp.asarray(w.numpy()),
                         r_eids(E, C, bt), bt=bt, bf=128)
    close(yb.reshape(E * C, F), r, 0.0)


def test_scattered_designation_matches_jax():
    """Ids in any order (not the capacity layout): each block still
    multiplies by its own expert."""
    xs, w = tc.moe_inputs(6, 64, 32, 128, seed=4)
    ids = np.array([3, 0, 5, 5, 1, 3], np.int32)
    got = grouped_matmul(torch.from_numpy(xs), torch.from_numpy(w),
                         torch.from_numpy(ids), bt=64, bf=128)
    want = r_grouped_matmul(jnp.asarray(xs), jnp.asarray(w),
                            jnp.asarray(ids), bt=64, bf=128)
    close(got, want, 2e-4)


def test_matches_moe_layer_grouped_path():
    """The port's kernel slots into the JAX MoE layer's [E, C, D] buffer
    contract, on the layer's own weights."""
    from repro.configs.base import MoEConfig
    from repro.models import moe as moe_mod
    cfg = MoEConfig(n_experts=4, top_k=2, d_ff_expert=64)
    d = 32
    p = moe_mod.init_moe(jax.random.key(0), d, cfg, glu=False)
    cap = moe_mod.expert_capacity(32, cfg)
    bt = 8
    assert cap % bt == 0
    xg = np.random.default_rng(2).standard_normal(
        (cfg.n_experts, cap, d)).astype(np.float32)
    ref = jnp.einsum("ecd,edf->ecf", jnp.asarray(xg), p["up"])
    eids = capacity_block_eids(cfg.n_experts, cap, bt, device="cpu")
    y = grouped_matmul(torch.from_numpy(xg).reshape(-1, d),
                       torch.from_numpy(np.array(p["up"])), eids, bt=bt,
                       bf=64)
    close(y.reshape(ref.shape), ref, 2e-4)


def test_moe_ffn_past_32_rows_matches_moe_layer(monkeypatch):
    """The port's MoE FFN at a capacity past 32 rows (64 tokens, 4 experts
    top-2: capacity 40, the token block of all three expert products)
    against the JAX layer's ``moe_ffn``, on the layer's own weights; on
    the card each product would take the tf32x3 body."""
    from repro.configs.base import MoEConfig
    from repro.models import moe as r_moe
    from repro_torch.configs import MoEConfig as PMoEConfig
    from repro_torch.models import moe as p_moe
    kw = dict(n_experts=4, top_k=2, d_ff_expert=64)
    d, cfg, p_cfg = 32, MoEConfig(**kw), PMoEConfig(**kw)
    pj = r_moe.init_moe(jax.random.key(3), d, cfg, glu=True)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    x = np.random.default_rng(9).standard_normal((2, 32, d)).astype(
        np.float32)
    cap = p_moe.expert_capacity(64, p_cfg)
    assert cap == r_moe.expert_capacity(64, cfg) == 40
    seen, real = [], p_moe.grouped_matmul

    def spy(xs, w, eids, *, bt, bf):
        seen.append((bt, K.body(xs, w, bt)))
        return real(xs, w, eids, bt=bt, bf=bf)

    monkeypatch.setattr(p_moe, "grouped_matmul", spy)
    y_p, aux_p = p_moe.moe_ffn(pt, torch.from_numpy(x), p_cfg)
    y_r, aux_r = r_moe.moe_ffn(pj, jnp.asarray(x), cfg)
    assert seen == [(cap, "tf32x3")] * 3
    close(y_p, y_r, 2e-4)
    close(aux_p, aux_r, 2e-4)


def test_the_jamba_capacity_is_the_layers():
    """torch_cases.MOE_JAMBA's capacity is the JAX layer's expert_capacity
    of 2048 tokens for jamba's MoE, rounded up to the token block."""
    from repro.configs import get_config
    from repro.models import moe as moe_mod
    cfg = get_config("jamba-v0.1-52b")
    s = tc.MOE_JAMBA
    cap = moe_mod.expert_capacity(tc.JAMBA_TOKENS, cfg.moe)
    assert cap == 320
    assert s["C"] == -(-cap // s["bt"]) * s["bt"]
    assert (s["E"], s["D"], s["F"]) == (cfg.moe.n_experts, cfg.d_model,
                                        cfg.moe.d_ff_expert)


def test_checks():
    xs, w = torch.zeros((256, 32)), torch.zeros((2, 32, 128))
    eids = capacity_block_eids(2, 128, 128, device="cpu")
    with pytest.raises(TypeError, match="int32"):
        grouped_matmul(xs, w, eids.long())
    with pytest.raises(ValueError, match=r"outside \[0, 2\)"):
        grouped_matmul(xs, w, eids + 1)
    with pytest.raises(ValueError, match=r"outside \[0, 2\)"):
        grouped_matmul(xs, w, eids - 1)
    with pytest.raises(ValueError, match="block_eids has shape"):
        grouped_matmul(xs, w, eids, bt=64)
    with pytest.raises(ValueError, match="multiples"):
        grouped_matmul(xs, w, eids[:1], bt=256, bf=96)
    with pytest.raises(ValueError, match="not a multiple"):
        capacity_block_eids(2, 100, 64, device="cpu")
    assert K.LAUNCHES == {"moe_gemm": 0}
