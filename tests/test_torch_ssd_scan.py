"""The port's SSD scan against the JAX package, on the CPU.

Identical numpy inputs (``torch_cases.ssd_inputs``) go through the JAX
package's ``ops.ssd_scan`` (its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it), ``models.ssm.ssd_chunked`` and
``ref.ssd_scan_ref``, and through the port's counterparts, whose CPU path
is the kernel's plain version. Shapes and tolerances are
``tests/test_kernels.py``'s: rtol = atol = 2e-4 in float32, 2e-2 in
bfloat16. The CUDA kernel itself is held against the plain version in
``tests/test_torch_cuda.py`` (card only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cases as tc
from repro.kernels.ssd_scan.ops import ssd_scan as r_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref as r_ssd_scan_ref
from repro.models.ssm import ssd_chunked as r_ssd_chunked
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models.ssm import ssd_chunked

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ARGS = ("x", "dt", "a_log", "b", "c", "d_skip")
#: the arguments that take the test's dtype (dt, a_log, d_skip stay f32)
CAST = ("x", "b", "c")


def both(inp: dict, dtype: str):
    jd, td = DTYPES[dtype]
    j = [jnp.asarray(inp[k]).astype(jd) if k in CAST else jnp.asarray(inp[k])
         for k in ARGS]
    t = [torch.from_numpy(inp[k]).to(td) if k in CAST
         else torch.from_numpy(inp[k]) for k in ARGS]
    return j, t


def close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def kernel_layout(inp: dict):
    """(xr, l, b, c) in the kernel's layout, float32 numpy."""
    x, dt = inp["x"], inp["dt"]
    B, L, H, hd = x.shape
    A = -np.exp(inp["a_log"])
    l = (dt * A).transpose(0, 2, 1).reshape(B * H, L)
    xr = (x * dt[..., None]).transpose(0, 2, 1, 3).reshape(B * H, L, hd)
    return (xr.astype(np.float32), l.astype(np.float32), inp["b"], inp["c"])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,L,H,hd,ds,chunk", tc.SSD_SHAPES)
def test_ops_and_chunked_match_jax(B, L, H, hd, ds, chunk, dtype):
    inp = tc.ssd_inputs(B, L, H, hd, ds)
    j, t = both(inp, dtype)
    tol = tc.TOLS[dtype]
    y_rk, h_rk = r_ssd_scan(*j, chunk=chunk)
    y_rm, h_rm = r_ssd_chunked(*j, chunk)
    y_k, h_k = ssd_scan(*t, chunk=chunk)
    y_m, h_m = ssd_chunked(*t, chunk)
    assert y_k.dtype == t[0].dtype and h_k.dtype == torch.float32
    assert y_k.shape == (B, L, H, hd) and h_k.shape == (B, H, ds, hd)
    for got, want in ((y_k, y_rk), (h_k, h_rk), (y_m, y_rm), (h_m, h_rm),
                      (y_k, y_rm), (h_k, h_rm)):
        close(got, want, tol)


@pytest.mark.parametrize("B,L,H,hd,ds,chunk",
                         tc.SSD_SHAPES + ((2, 48, 2, 16, 8, 16),))
def test_kernel_layout_matches_bruteforce(B, L, H, hd, ds, chunk):
    """The plain version (kernel layout) == the port's and the JAX
    package's brute-force recurrence."""
    xr, l, b, c = kernel_layout(tc.ssd_inputs(B, L, H, hd, ds, seed=7))
    y_r, h_r = r_ssd_scan_ref(*(jnp.asarray(a) for a in (xr, l, b, c)), H)
    t = [torch.from_numpy(a) for a in (xr, l, b, c)]
    y_p, h_p = K.ssd_scan_kernel(*t, chunk=chunk, n_heads=H)
    y_b, h_b = ssd_scan_ref(*t, H)
    for got in (y_p, y_b):
        close(got, y_r, 2e-4)
    for got in (h_p, h_b):
        close(got, h_r, 2e-4)


@pytest.mark.parametrize("B,H,dt_scale", [(1, 1, 0.1), (2, 3, 0.7),
                                          (3, 4, 2.0), (1, 2, 1.3)])
def test_decay_bounds(B, H, dt_scale):
    """tests/test_kernels.py's property: with x = 1, A = -1, B = 1/ds and
    C = 1, |y| is bounded by the geometric decay sum."""
    L, hd, ds, chunk = 32, 16, 8, 16
    y, _ = ssd_scan(torch.ones((B, L, H, hd)),
                    torch.full((B, L, H), dt_scale), torch.zeros(H),
                    torch.ones((B, L, ds)) / ds, torch.ones((B, L, ds)),
                    torch.zeros(H), chunk=chunk)
    bound = dt_scale / (1 - np.exp(-dt_scale)) + 1e-3
    assert float(y.abs().max()) <= bound * 1.05


def test_large_dt_gives_no_nan():
    """exp(cum_i - cum_j) above the diagonal would overflow: it must never
    be formed (inf * 0 is NaN)."""
    inp = tc.ssd_inputs(2, 64, 3, 16, 8, seed=3, dt_scale=400.0)
    j, t = both(inp, "float32")
    y, h = ssd_scan(*t, chunk=32)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    y_r, h_r = r_ssd_scan(*j, chunk=32)
    close(y, y_r, 2e-4)
    close(h, h_r, 2e-4)


@pytest.mark.parametrize("B,L,H,hd,ds,chunk", tc.SSD_SHAPES)
def test_ops_hands_the_kernel_contiguous_tensors(B, L, H, hd, ds, chunk,
                                                 monkeypatch):
    """The CUDA kernel takes contiguous tensors only: the layout change in
    ops.ssd_scan must produce them (B = 1 reshapes give strided views)."""
    from repro_torch.kernels.ssd_scan import ops

    seen = []

    def spy(xr, l, b, c, **kw):
        seen.append([t.is_contiguous() for t in (xr, l, b, c)])
        return K.ssd_scan_kernel(xr, l, b, c, **kw)
    monkeypatch.setattr(ops, "ssd_scan_kernel", spy)
    _, t = both(tc.ssd_inputs(B, L, H, hd, ds), "float32")
    t[3] = t[3].transpose(1, 2).contiguous().transpose(1, 2)   # strided b
    ops.ssd_scan(*t, chunk=chunk)
    assert seen == [[True] * 4]


def test_wrapper_refusals():
    xr, l, b, c = (torch.from_numpy(a) for a in
                   kernel_layout(tc.ssd_inputs(1, 32, 2, 16, 8)))
    with pytest.raises(ValueError, match="multiple of chunk"):
        K.ssd_scan_kernel(xr, l, b, c, chunk=24, n_heads=2)
    with pytest.raises(ValueError, match="n_heads"):
        K.ssd_scan_kernel(xr, l, b, c, chunk=16, n_heads=3)
    with pytest.raises(ValueError, match="runs on cuda"):
        K.ssd_scan_kernel(*(a.to("meta") for a in (xr, l, b, c)), chunk=16,
                          n_heads=2)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,L,H,hd,ds,chunk", tc.SSD_EDGE)
def test_edge_shapes_match_jax(B, L, H, hd, ds, chunk, dtype):
    """The CUDA kernel's edge shapes (torch_cases.SSD_EDGE): the port's
    ops and plain version against the JAX package's interpret-mode kernel
    and ssd_chunked."""
    inp = tc.ssd_inputs(B, L, H, hd, ds, seed=5)
    j, t = both(inp, dtype)
    tol = tc.TOLS[dtype]
    y_k, h_k = ssd_scan(*t, chunk=chunk)
    assert y_k.shape == (B, L, H, hd) and h_k.shape == (B, H, ds, hd)
    y_rk, h_rk = r_ssd_scan(*j, chunk=chunk)
    y_rm, h_rm = r_ssd_chunked(*j, chunk)
    for got, want in ((y_k, y_rk), (h_k, h_rk), (y_k, y_rm), (h_k, h_rm)):
        close(got, want, tol)


@pytest.mark.parametrize("hd,tile,blocks", [(4, 4, 1), (8, 8, 1), (16, 16, 1),
                                            (32, 32, 1), (64, 32, 2),
                                            (128, 32, 4)])
def test_column_tile(hd, tile, blocks):
    """A block takes 32 state columns, or hd where it is smaller: a tile the
    kernel takes (4, 8, 16, 32) that divides hd. mamba2-780m's hd 64 gives
    2 blocks a head, 96 at the serve shape's 48 heads."""
    assert K.column_tile(hd) == tile and hd // tile == blocks
    assert tile in (4, 8, 16, 32) and hd % tile == 0


@pytest.mark.parametrize("entry", ["ssd_scan_launch", "ssd_scan_smem_bytes"])
def test_c_entries_match_their_declarations(entry):
    """The ctypes types ``kernel.declare`` gives each C entry are its
    parameters and result, one for one, read from csrc/ssd_scan.cu."""
    ret, args = tc.c_entry_types(K.SOURCES["ssd_scan"].read_text(), entry)
    got = tc.declared(K, ["ssd_scan_launch", "ssd_scan_smem_bytes"])[entry]
    assert got[0] is ret and got[1] == args
