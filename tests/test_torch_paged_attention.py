"""The port's paged decode attention against the JAX package, on the CPU.

Identical numpy inputs (``torch_cases.paged_inputs``) go through the JAX
package's ``ops.paged_attention`` (its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it) and ``ref.paged_attention_ref``, and
through the port's counterparts, whose CPU path is the kernel's plain
version. Shapes and tolerances are ``tests/test_kernels.py``'s: rtol =
atol = 2e-4 in float32, 2e-2 in bfloat16. The CUDA kernel itself is held
against the plain version in ``tests/test_torch_cuda.py`` (card only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cases as tc
from repro.kernels.paged_attention.ops import paged_attention as r_paged
from repro.kernels.paged_attention.ref import paged_attention_ref as r_ref
from repro_torch.kernels import paged_attention
from repro_torch.kernels.paged_attention import kernel as K
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def both(q, kp, vp, table, lens, dtype: str = "float32"):
    jd, td = DTYPES[dtype]
    j = ([jnp.asarray(a).astype(jd) for a in (q, kp, vp)]
         + [jnp.asarray(table), jnp.asarray(lens)])
    t = ([torch.from_numpy(a).to(td) for a in (q, kp, vp)]
         + [torch.from_numpy(table), torch.from_numpy(lens)])
    return j, t


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,KVH,G,hd,P,page,npg", tc.PAGED_SHAPES)
def test_matches_jax(B, KVH, G, hd, P, page, npg, dtype):
    j, t = both(*tc.paged_inputs(B, KVH, G, hd, P, page, npg, seed=3), dtype)
    got = paged_attention(*t)
    assert got.dtype == t[0].dtype and got.shape == (B, KVH, G, hd)
    tol = tc.TOLS[dtype]
    close(got, r_paged(*j), tol)
    close(paged_attention_ref(*t), r_ref(*j), tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lengths_zero_one_partial_full_match_jax(dtype):
    """seq_lens 0 (every score -1e30: a uniform mean over all slots the
    table names), 1, a partial page and a full table."""
    q, kp, vp, table, _ = tc.paged_inputs(4, 2, 4, 64, 16, 16, 4, seed=5)
    lens = np.array([0, 1, 21, 64], np.int32)
    j, t = both(q, kp, vp, table, lens, dtype)
    got = paged_attention(*t)
    close(got, r_paged(*j), tc.TOLS[dtype])
    mean = torch.from_numpy(vp)[torch.from_numpy(table[0]).long()]
    close(got[0], mean.reshape(-1, 2, 64).mean(0)[:, None, :]
          .expand(2, 4, 64), tc.TOLS[dtype])


def test_out_of_range_table_entries_are_clamped_as_in_jax():
    q, kp, vp, table, lens = tc.paged_inputs(3, 2, 4, 64, 16, 32, 4, seed=6)
    table = table.copy()
    table[0, 3], table[1, 0], table[2, 2] = -7, 16, 1000
    lens[:] = [128, 40, 0]
    j, t = both(q, kp, vp, table, lens)
    close(paged_attention(*t), r_paged(*j), 2e-4)


def test_shared_prefix_pages():
    """Two sequences sharing prefix pages (the scheduler's reuse case)
    produce identical attention for identical queries."""
    q1, kp, vp, _, _ = tc.paged_inputs(1, 2, 2, 64, 8, 16, 4, seed=9)
    q = np.concatenate([q1, q1])
    table = np.array([[0, 1, 2, 3], [0, 1, 2, 3]], np.int32)
    lens = np.array([64, 64], np.int32)
    _, t = both(q, kp, vp, table, lens)
    o = paged_attention(*t)
    torch.testing.assert_close(o[0], o[1], rtol=1e-6, atol=0)


@pytest.mark.parametrize("cut", [1, 15, 16, 17, 33, 60])
def test_length_masking(cut):
    """Positions beyond seq_len must not affect the output."""
    q, kp, vp, _, _ = tc.paged_inputs(1, 1, 2, 64, 8, 16, 4, seed=cut)
    table = np.arange(4, dtype=np.int32)[None, :]
    lens = np.array([cut], np.int32)
    _, t = both(q, kp, vp, table, lens)
    o1 = paged_attention(*t)
    kp2 = t[1].clone()
    kp2[table[0, cut // 16 + 1:]] = 999.0
    o2 = paged_attention(t[0], kp2, *t[2:])
    torch.testing.assert_close(o1, o2, rtol=1e-5, atol=1e-5)


def test_checks():
    q = torch.zeros((2, 2, 4, 64))
    kp = torch.zeros((8, 16, 2, 64))
    table = torch.zeros((2, 4), dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="disagree"):
        paged_attention(q, torch.zeros((8, 16, 3, 64)),
                        torch.zeros((8, 16, 3, 64)), table, lens)
    with pytest.raises(ValueError, match="block_table"):
        paged_attention(q, kp, kp, table[:1], lens)
    with pytest.raises(ValueError, match="runs on cuda"):
        paged_attention(q.to("meta"), kp.to("meta"), kp.to("meta"),
                        table.to("meta"), lens.to("meta"))
    assert K.LAUNCHES == {"paged_attention": 0}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", range(len(tc.PAGED_EDGE)))
def test_edge_cases_match_jax(case, dtype):
    """The CUDA kernel's edges (torch_cases.PAGED_EDGE): G 1, 3, 7 and 8,
    lengths 0, 1 and around half the slots, n_pages 1, a table that repeats a
    page; the port's ops against the JAX package's interpret-mode kernel
    and its ref."""
    j, t = both(*tc.paged_edge_inputs(*tc.PAGED_EDGE[case]), dtype)
    got = paged_attention(*t)
    tol = tc.TOLS[dtype]
    close(got, r_paged(*j), tol)
    close(paged_attention_ref(*t), r_ref(*j), tol)


def _empty(shape, dtype=torch.bfloat16):
    return torch.empty(1, dtype=dtype).expand(shape)


@pytest.mark.parametrize("g,hd,dtype,want", [
    (4, 128, torch.bfloat16, "split"), (4, 128, torch.float32, "split"),
    (1, 64, torch.bfloat16, "split"), (8, 64, torch.float32, "split"),
    (2, 8, torch.bfloat16, "split"), (8, 256, torch.bfloat16, "split"),
    (3, 128, torch.bfloat16, "split"), (7, 64, torch.float32, "split"),
    (9, 64, torch.bfloat16, "serial"), (16, 64, torch.float32, "serial"),
    (4, 96, torch.bfloat16, "serial"), (4, 256, torch.float32, "serial"),
    (4, 4, torch.bfloat16, "serial"), (256, 256, torch.float32, "serial")])
def test_body_by_shape(g, hd, dtype, want):
    """The split body takes G from 1 to 8 and rows of 1 to 32 whole
    16-byte units, a power of two (bf16 hd 8 to 256, fp32 hd 4 to 128);
    every other shape takes the serial body."""
    q = _empty((2, 2, g, hd), dtype)
    pages = _empty((4, 16, 2, hd), dtype)
    assert K.body(q, pages, pages) == want


def test_split_body_needs_aligned_bases():
    q = torch.zeros((2, 2, 4, 64))
    pages = torch.zeros((4, 16, 2, 64))
    shifted = torch.zeros(pages.numel() + 1)[1:].view(pages.shape)
    assert K.body(q, pages, pages) == "split"
    assert shifted.data_ptr() % 16 and K.body(q, shifted, pages) == "serial"


@pytest.mark.parametrize("bsz,kvh,slots,want", [
    (32, 8, 2048, 1),   # jamba: 256 pairs fill the card
    (4, 8, 2048, 4),    # 32 pairs: four blocks a pair
    (1, 1, 2048, 8),    # one pair: the largest cluster
    (4, 2, 128, 2),     # kernel_bench: 8 pairs, 128 slots
    (2, 1, 64, 1),      # at least 64 slots a split
    (300, 1, 4096, 1)])
def test_splits(bsz, kvh, slots, want):
    """A pair takes the fewest splits of 1, 2, 4, 8 that give about one
    block an SM (FILL_BLOCKS), with at least MIN_SPLIT_SLOTS slots each."""
    got = K.splits(bsz, kvh, slots)
    assert got == want and got in K.SPLIT_COUNTS
    assert slots >= got * K.MIN_SPLIT_SLOTS or got == 1


def test_forced_bodies_are_refused_before_a_launch():
    """``_launch``'s forced body and split count (the card tests' and the
    timings') are checked before the library is loaded."""
    q, kp, vp, table, lens = (torch.from_numpy(a) for a in
                              tc.paged_inputs(2, 2, 9, 64, 8, 16, 4))
    with pytest.raises(ValueError, match="body 'split' does not take G=9"):
        K._launch(q, kp, vp, table, lens, which="split")
    with pytest.raises(ValueError, match="not one of"):
        K._launch(q[:, :, :2].contiguous(), kp, vp, table, lens,
                  which="split", n_split=3)
    with pytest.raises(ValueError, match="body 'fast'"):
        K._launch(q, kp, vp, table, lens, which="fast")
    assert K.LAUNCHES == {"paged_attention": 0}


@pytest.mark.parametrize("entry", ["paged_attention_launch",
                                   "paged_attention_smem_bytes"])
def test_c_entries_match_their_declarations(entry):
    """The ctypes types ``kernel.declare`` gives each C entry are its
    parameters and result, one for one, read from
    csrc/paged_attention.cu."""
    ret, args = tc.c_entry_types(K.SOURCES["paged_attention"].read_text(),
                                 entry)
    got = tc.declared(K, ["paged_attention_launch",
                          "paged_attention_smem_bytes"])[entry]
    assert got[0] is ret and got[1] == args
