"""The port's MASA-tiled matmul against the JAX package, on the CPU.

Identical numpy inputs (``torch_cases.masa_inputs``) go through the JAX
package's ``ops.masa_gemm`` (its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it) and ``ref.masa_gemm_ref``, and through
the port's counterparts, whose CPU path is the kernel's plain version.
Shapes and tolerances are ``tests/test_kernels.py``'s: rtol = atol = 2e-4
in float32, 2e-2 in bfloat16. The CUDA kernel itself is held against the
plain version in ``tests/test_torch_cuda.py`` (card only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cases as tc
from repro.kernels.masa_gemm.ops import masa_gemm as r_masa_gemm
from repro.kernels.masa_gemm.ref import masa_gemm_ref as r_masa_gemm_ref
from repro_torch import cuda_build
from repro_torch.kernels import masa_gemm
from repro_torch.kernels.masa_gemm import kernel as K
from repro_torch.kernels.masa_gemm import ops
from repro_torch.kernels.masa_gemm.ref import masa_gemm_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def both(arrays, dtype: str):
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("order", K.ORDERS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n", tc.MASA_SHAPES)
def test_matches_jax(m, k, n, dtype, order):
    (ja, jb), (ta, tb) = both(tc.masa_inputs(m, k, n), dtype)
    got = masa_gemm(ta, tb, order=order)
    assert got.dtype == ta.dtype and got.shape == (m, n)
    tol = tc.TOLS[dtype]
    close(got, r_masa_gemm(ja, jb, order=order), tol)
    close(masa_gemm_ref(ta, tb), r_masa_gemm_ref(ja, jb), tol)


def test_orders_agree():
    _, (a, b) = both(tc.masa_inputs(256, 256, 256, seed=2), "float32")
    o1 = masa_gemm(a, b, order="output_stationary")
    o2 = masa_gemm(a, b, order="weight_stationary")
    torch.testing.assert_close(o1, o2, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("k,dtype,want", [
    (256, torch.float32, "weight_stationary"),
    (302, torch.float32, "weight_stationary"),
    (384, torch.float32, "output_stationary"),
    (512, torch.bfloat16, "weight_stationary"),
    (640, torch.bfloat16, "output_stationary"),
    (4096, torch.bfloat16, "output_stationary")])
def test_weight_stationary_falls_back_past_shared_memory(k, dtype, want,
                                                         monkeypatch):
    """The reference's fallback with the card's limit: the panel of
    (64 + 128) * K elements must fit a block's 232,448 bytes."""
    seen = []
    monkeypatch.setattr(K, "run", lambda a, b, order: seen.append(order))
    a = torch.zeros((128, k), dtype=dtype)
    b = torch.zeros((k, 128), dtype=dtype)
    ops.masa_gemm(a, b, order="weight_stationary")
    assert seen == [want]
    assert (K.ws_panel_bytes(k, dtype) <= cuda_build.MAX_SMEM_BYTES) == (
        want == "weight_stationary")


@pytest.mark.parametrize("m,k,n,dtype", tc.MASA_WS_ODD_K)
def test_weight_stationary_takes_any_k_as_jax_does(m, k, n, dtype):
    """The reference checks K % bk only for output-stationary, and falls
    back only past its 8 MiB budget: a weight-stationary K that is no
    multiple of bk is taken on both sides of the port's fallback."""
    (ja, jb), (ta, tb) = both(tc.masa_inputs(m, k, n), dtype)
    got = masa_gemm(ta, tb, order="weight_stationary")
    assert got.dtype == ta.dtype and got.shape == (m, n)
    close(got, r_masa_gemm(ja, jb, order="weight_stationary"), tc.TOLS[dtype])


def test_checks_are_the_references():
    a, b = torch.zeros((128, 200)), torch.zeros((200, 128))
    with pytest.raises(ValueError, match="bk=128"):
        masa_gemm(a, b)                      # output-stationary: K % bk
    assert masa_gemm(a, b, order="weight_stationary").shape == (128, 128)
    with pytest.raises(ValueError, match="multiples"):
        masa_gemm(torch.zeros((100, 128)), torch.zeros((128, 128)))
    with pytest.raises(ValueError, match="multiples"):
        masa_gemm(torch.zeros((128, 128)), torch.zeros((128, 96)))
    with pytest.raises(ValueError, match="takes a"):
        masa_gemm(torch.zeros((128, 128)), torch.zeros((64, 128)))
    with pytest.raises(ValueError, match="order"):
        masa_gemm(torch.zeros((128, 128)), torch.zeros((128, 128)),
                  order="row_stationary")
    with pytest.raises(ValueError, match="runs on cuda"):
        masa_gemm(torch.zeros((128, 128), device="meta"),
                  torch.zeros((128, 128), device="meta"))
    assert K.LAUNCHES == {"masa_gemm_os": 0, "masa_gemm_ws": 0}


def test_c_entry_declarations_match_the_source():
    """The wrapper's ctypes declaration follows the C signature of
    ``masa_gemm_launch`` in csrc/masa_gemm.cu (a pointer c_void_p, an int
    c_int; ``body`` the code of ``kernel._BODY_CODE``)."""
    entry = "masa_gemm_launch"
    ret, args = tc.c_entry_types(K.SOURCES["masa_gemm"].read_text(), entry)
    assert tc.declared(K, [entry])[entry] == (ret, args)
    assert "int body" in K.SOURCES["masa_gemm"].read_text()
    assert K._BODY_CODE == {"simt": 0, "wgmma": 1, "tf32x3": 2}
    assert set(K._BODY_CODE) == set(K.BODIES)
