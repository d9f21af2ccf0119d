"""Which body the masa_gemm and moe_gemm kernels take, and the tile raster
of their wgmma body, on the CPU.

Each wrapper picks ``wgmma`` (csrc/hopper_gemm.cuh: TMA-fed tiles, bf16),
``tf32x3`` (csrc/tf32x3.cuh: three TF32 mma.sync a product, fp32; moe's
for token blocks past 32 rows), moe's ``stream`` (token blocks of 8 to 32
rows: a cp.async ring streaming the expert's W panel) or ``simt`` (fp32
FMAs on the CUDA cores) by shape, before the launch, in one predicate
(``kernel.body``); nothing here launches, since a CPU tensor runs
the plain version. The shapes are ``torch_cases``' sweeps, the card tests'
odd token blocks and the jamba-v0.1-52b timing shapes. ``hopper_gemm.raster``
mirrors the header's launch order and moe's ``tf32x3_tiles`` its tf32x3
body's row tiles; the card holds the kernels themselves
(``tests/test_torch_cuda.py``).
"""
import pytest
import torch

import torch_cases as tc
from repro_torch import cuda_build
from repro_torch.kernels import hopper_gemm
from repro_torch.kernels.masa_gemm import kernel as MK
from repro_torch.kernels.masa_gemm import ops as masa_ops
from repro_torch.kernels.moe_gemm import capacity_block_eids
from repro_torch.kernels.moe_gemm import kernel as EK

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def empty(shape, dtype):
    """An input of ``shape`` on one element of storage: a body is chosen by
    dtype, shape and base address alone (jamba's W is 3.8 GB in fp32)."""
    return torch.empty(1, dtype=dtype).expand(shape)


MASA_CASES = ([(m, k, n, d) for m, k, n in tc.MASA_SHAPES for d in DTYPES]
              + list(tc.MASA_WS_ODD_K)
              + [(s["M"], s["K"], s["N"], d) for d in DTYPES
                 for s in (tc.MASA_JAMBA, tc.MASA_WS_JAMBA)])


@pytest.mark.parametrize("m,k,n,dtype", MASA_CASES)
def test_masa_body_by_shape(m, k, n, dtype):
    """bf16 with K and N multiples of 8 takes wgmma (every sweep shape and
    the jamba shapes); fp32 with K and N multiples of 4 takes tf32x3 (every
    sweep shape, K 300 and 400 and the jamba shapes); K 500 / 700 in bf16
    take simt."""
    a, b = empty((m, k), DTYPES[dtype]), empty((k, n), DTYPES[dtype])
    if dtype == "bfloat16":
        want = "wgmma" if k % 8 == 0 and n % 8 == 0 else "simt"
    else:
        want = "tf32x3" if k % 4 == 0 and n % 4 == 0 else "simt"
    assert MK.body(a, b) == want
    assert (k, dtype) not in ((500, "bfloat16"), (700, "bfloat16")) \
        or want == "simt"
    assert dtype == "bfloat16" or want == "tf32x3"


@pytest.mark.parametrize("case,want", [
    ("aligned", "tf32x3"), ("K 4", "tf32x3"), ("N 4", "tf32x3"),
    ("K 250", "simt"), ("N 126", "simt"), ("a unaligned", "simt"),
    ("b unaligned", "simt"), ("mixed dtypes", "simt"),
    ("bf16 K 252", "simt"), ("bf16", "wgmma")])
def test_masa_tf32x3_takes_fp32_rows_of_whole_16_byte_units(case, want):
    """fp32 takes tf32x3 when K and N are multiples of 4 (rows of whole
    16-byte cp.async units) and both bases are 16-byte aligned; K 250 or N
    126, an unaligned base or two dtypes take simt; bf16 is unchanged."""
    f32, bf = torch.float32, torch.bfloat16
    m, k, n, dtype = 256, 256, 256, f32
    if case.startswith("K "):
        k = int(case[2:])
    elif case.startswith("N "):
        n = int(case[2:])
    elif case.startswith("bf16"):
        dtype, k = bf, 252 if case.endswith("252") else k
    a, b = empty((m, k), dtype), empty((k, n), dtype)
    if case == "a unaligned":
        a = tc.shifted(torch.zeros((m, k)))
    elif case == "b unaligned":
        b = tc.shifted(torch.zeros((k, n)))
    elif case == "mixed dtypes":
        b = b.to(bf)
    assert MK.body(a, b) == want


MOE_CASES = ([(E, C, D, F, bt, d) for E, C, D, F, bt, _ in tc.MOE_SHAPES
              for d in DTYPES]
             + [(4, 24, 40, 128, 24, d) for d in DTYPES]
             + [(3, 12, 16, 128, 3, d) for d in DTYPES]
             + [(tc.MOE_JAMBA["E"], tc.MOE_JAMBA["C"], tc.MOE_JAMBA["D"],
                 tc.MOE_JAMBA["F"], tc.MOE_JAMBA["bt"], d) for d in DTYPES])


@pytest.mark.parametrize("E,C,D,F,bt,dtype", MOE_CASES)
def test_moe_body_by_shape(E, C, D, F, bt, dtype):
    """bf16 with D and F multiples of 8 and bt % 64 == 0 takes wgmma (the
    sweep's bt 128 and 64, jamba's 128); the card test's bt 24 takes stream
    in both dtypes; fp32 at bt 128 and 64 (the sweep's, jamba's) takes
    tf32x3; the card test's bt 3 takes simt."""
    x, w = empty((E * C, D), DTYPES[dtype]), empty((E, D, F), DTYPES[dtype])
    want = ("wgmma" if dtype == "bfloat16" and D % 8 == 0 and F % 8 == 0
            and bt % 64 == 0 else "stream" if bt % 8 == 0 and bt <= 32
            else "tf32x3" if dtype == "float32" and bt % 8 == 0
            and D % 4 == 0 and F % 4 == 0 else "simt")
    assert EK.body(x, w, bt) == want
    assert {24: "stream", 3: "simt"}.get(bt, want) == want
    assert bt not in (64, 128) or want == (
        "tf32x3" if dtype == "float32" else "wgmma")


#: moonshot-v1-16b-a3b's expert products (up and gate D 2048 by F 1408,
#: down 1408 by 2048) and a ragged D, at every token block the stream body
#: takes.
STREAM_BT = (8, 16, 24, 32)
STREAM_DF = ((2048, 1408), (1408, 2048), (97, 1408))


@pytest.mark.parametrize("D,F", STREAM_DF)
@pytest.mark.parametrize("bt", STREAM_BT)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_stream_takes_short_token_blocks(dtype, bt, D, F):
    """fp32 and bf16 at bt 8, 16, 24 and 32 with aligned bases and F's rows
    whole 16-byte units take stream, D ragged or not."""
    x, w = empty((64 * bt, D), DTYPES[dtype]), empty((64, D, F),
                                                       DTYPES[dtype])
    assert EK.body(x, w, bt) == "stream"


@pytest.mark.parametrize("dtype,bt,want", [
    ("float32", 64, "tf32x3"), ("float32", 128, "tf32x3"),
    ("bfloat16", 64, "wgmma"), ("bfloat16", 128, "wgmma"),
    ("float32", 12, "simt"), ("bfloat16", 12, "simt"),
    ("float32", 40, "tf32x3"), ("bfloat16", 4, "simt")])
def test_moe_stream_crossover(dtype, bt, want):
    """Past 32 rows a token block leaves stream: fp32 at bt 40, 64 and 128
    takes tf32x3, bf16 at bt 64 and 128 wgmma; bt 12 and 4 (no multiple of
    8) take simt."""
    x, w = empty((128 * 15, 2048), DTYPES[dtype]), empty((64, 2048, 1408),
                                                         DTYPES[dtype])
    assert EK.body(x, w, bt) == want


@pytest.mark.parametrize("case", ["x unaligned", "w unaligned",
                                  "fp32 F % 4", "bf16 F % 8",
                                  "mixed dtypes"])
def test_moe_stream_needs_aligned_bases_and_whole_rows(case):
    """An unaligned base, F's rows not whole 16-byte units (F % 4 != 0 in
    fp32, F % 8 != 0 in bf16) or two dtypes take simt at bt 16."""
    f32, bf = torch.float32, torch.bfloat16
    x, w = torch.zeros((64, 96)), torch.zeros((2, 96, 1408))
    if case == "x unaligned":
        x = tc.shifted(x)
    elif case == "w unaligned":
        w = tc.shifted(w)
    elif case == "fp32 F % 4":
        w = empty((2, 96, 1406), f32)
    elif case == "bf16 F % 8":
        x, w = empty((64, 96), bf), empty((2, 96, 1412), bf)
    else:
        w = w.to(bf)
    assert EK.body(x, w, 16) == "simt"
    assert EK.body(torch.zeros((64, 96)), torch.zeros((2, 96, 1408)),
                   16) == "stream"


#: (case, bt, want) for moe's tf32x3 predicate at moonshot's up product
#: (D 2048, F 1408) unless the case says otherwise.
MOE_TF32X3_CASES = (
    [(f"fp32 bt {bt}", bt, "tf32x3") for bt in (40, 48, 120, 128, 384)]
    + [("fp32 D 100 F 264", 40, "tf32x3"), ("F % 4", 128, "simt"),
       ("D % 4", 128, "simt"), ("x unaligned", 128, "simt"),
       ("w unaligned", 128, "simt"), ("fp32 bt 12", 12, "simt"),
       ("bf16 bt 40", 40, "simt"), ("bf16 bt 120", 120, "simt")]
    + [(f"fp32 bt {bt}", bt, "stream") for bt in (8, 16, 24, 32)])


@pytest.mark.parametrize("case,bt,want", MOE_TF32X3_CASES)
def test_moe_tf32x3_takes_fp32_token_blocks_past_32_rows(case, bt, want):
    """fp32 with bt a multiple of 8 past 32, D and F multiples of 4 and
    aligned bases takes tf32x3 (D may be ragged past its last stage of 32,
    F past its last 128 columns); F or D not a multiple of 4, an unaligned
    base, bt 12 and bf16 at bt 40 or 120 take simt; bt up to 32 stays on
    stream."""
    dtype = torch.bfloat16 if case.startswith("bf16") else torch.float32
    d, f = (100, 264) if "D 100" in case else (2048, 1408)
    if case == "F % 4":
        f = 1406
    elif case == "D % 4":
        d = 2046
    x, w = empty((4 * bt, d), dtype), empty((64, d, f), dtype)
    if case == "x unaligned":
        x = tc.shifted(torch.zeros((4 * bt, 64)))
        w = torch.zeros((2, 64, 128))
    elif case == "w unaligned":
        x, w = torch.zeros((4 * bt, 64)), tc.shifted(torch.zeros((2, 64, 128)))
    assert EK.body(x, w, bt) == want


TF32X3_BT = (40, 64, 120, 128, 384)


@pytest.mark.parametrize("bt", TF32X3_BT)
def test_moe_tf32x3_tiles_cover_each_token_block_once(bt):
    """The tf32x3 body's row tiles (``tf32x3_tiles``, the kernel's map)
    cover every row of every token block once and none crosses a token
    block's end; with the raster over F's column tiles, every (row tile,
    column tile) launches once. bt 40 and 64 take 64-row tiles, 120, 128
    and 384 128-row ones (8 rows of moonshot's 120 masked)."""
    n_blocks = 7
    tiles = EK.tf32x3_tiles(n_blocks, bt)
    rows = EK.tf32x3_rows(bt)
    assert rows == (64 if bt <= 64 else 128)
    covered = [r for r0, r1 in tiles for r in range(r0, r1)]
    assert covered == list(range(n_blocks * bt))
    for r0, r1 in tiles:
        assert 0 < r1 - r0 <= rows and r0 // bt == (r1 - 1) // bt
    assert len(tiles) == n_blocks * -(-bt // rows)
    mt, nt = len(tiles), 11
    grid = [hopper_gemm.raster(t, mt, nt, EK.GROUP_M)
            for t in range(mt * nt)]
    assert sorted(grid) == [(m, n) for m in range(mt) for n in range(nt)]


def test_bodies_need_rows_of_whole_16_byte_units_and_aligned_bases():
    bf = torch.bfloat16
    a, b = empty((128, 256), bf), empty((256, 128), bf)
    assert MK.body(a, b) == "wgmma"
    assert MK.body(empty((128, 252), bf), empty((252, 128), bf)) == "simt"
    assert MK.body(a, empty((256, 124), bf)) == "simt"
    shifted = torch.empty(128 * 256 + 1, dtype=bf)[1:].view(128, 256)
    assert shifted.data_ptr() % 16 and MK.body(shifted, b) == "simt"
    assert MK.body(a, b.float()) == "simt"
    x, w = empty((256, 64), bf), empty((2, 64, 128), bf)
    assert EK.body(x, w, 128) == EK.body(x, w, 64) == "wgmma"
    assert EK.body(x, w, 32) == "stream"
    assert EK.body(empty((256, 60), bf), empty((2, 60, 128), bf), 128) == \
        "simt"
    assert EK.body(x, empty((2, 64, 132), bf), 128) == "simt"
    assert not hopper_gemm.tma_ready(shifted) and hopper_gemm.tma_ready(a)


def test_cpu_runs_count_no_body():
    """A CPU tensor runs the plain version: no launch, no body counted."""
    a, b = (torch.ones((128, 128), dtype=torch.bfloat16) for _ in range(2))
    MK.reset_launches()
    masa_ops.masa_gemm(a, b)
    assert MK.BODIES == {"wgmma": 0, "simt": 0, "tf32x3": 0}
    MK.reset_launches()
    masa_ops.masa_gemm(a.float(), b.float(), order="weight_stationary")
    assert MK.BODIES == {"wgmma": 0, "simt": 0, "tf32x3": 0}
    x, w = torch.ones((128, 64), dtype=torch.bfloat16), torch.ones(
        (1, 64, 128), dtype=torch.bfloat16)
    EK.reset_launches()
    EK.grouped_matmul_kernel(x, w, torch.zeros(1, dtype=torch.int32))
    assert EK.BODIES == {"wgmma": 0, "simt": 0, "stream": 0, "tf32x3": 0}
    EK.grouped_matmul_kernel(x.float(), w.float(),
                             torch.zeros(1, dtype=torch.int32))
    assert not any(EK.BODIES.values())
    assert tuple(MK.BODIES) == (*hopper_gemm.BODIES, "tf32x3")
    assert tuple(EK.BODIES) == (*hopper_gemm.BODIES, "stream", "tf32x3")


RASTERS = [(1, 1, 12), (5, 3, 12), (13, 7, 4), (48, 56, EK.GROUP_M),
           (16, 56, MK.GROUP_M), (96, 5, EK.GROUP_M), (7, 9, 1)]


@pytest.mark.parametrize("mt,nt,group_m", RASTERS)
def test_raster_covers_every_tile_once(mt, nt, group_m):
    tiles = [hopper_gemm.raster(t, mt, nt, group_m) for t in range(mt * nt)]
    assert sorted(tiles) == [(m, n) for m in range(mt) for n in range(nt)]
    # group by group, M fastest within one column tile
    assert tiles == [(m, n) for g in range(0, mt, group_m) for n in range(nt)
                     for m in range(g, min(g + group_m, mt))]


@pytest.mark.parametrize("E,C,bt", [(16, 384, 128), (16, 384, 64),
                                    (8, 256, 128), (4, 256, 64)])
def test_raster_puts_the_blocks_of_one_w_tile_side_by_side(E, C, bt):
    """In the capacity layout the token blocks that share one [D, 256] W
    tile (one expert, one column tile) launch consecutively, so they read
    it from L2 once; at jamba's shape each W tile is read by one run."""
    bm = 128 if bt % 128 == 0 else 64
    eids = capacity_block_eids(E, C, bt, device="cpu").tolist()
    mt, nt = E * C // bm, 56
    order = [hopper_gemm.raster(t, mt, nt, EK.GROUP_M)
             for t in range(mt * nt)]
    runs = {}
    for t, (m, n) in enumerate(order):
        key = (eids[m * bm // bt], n)
        runs.setdefault(key, []).append(t)
    for key, ts in runs.items():
        assert ts == list(range(ts[0], ts[0] + len(ts))), key
        assert len(ts) == C // bm


@pytest.mark.parametrize("k,dtype", [(256, torch.bfloat16),
                                     (600, torch.bfloat16),
                                     (605, torch.bfloat16),
                                     (606, torch.bfloat16),
                                     (300, torch.float32),
                                     (302, torch.float32),
                                     (303, torch.float32),
                                     (304, torch.float32)])
def test_ws_panel_bytes_alone_decides_the_fallback(k, dtype, monkeypatch):
    """ops consults ws_panel_bytes and nothing else: the same K falls back
    or not as the budget says, whichever body would run (fp32 K 300 and 304
    take tf32x3, 302 and 303 simt; the tf32x3 body's own layout decides
    nothing)."""
    seen = []
    monkeypatch.setattr(MK, "run", lambda a, b, order: seen.append(order))
    a, b = empty((128, k), dtype), empty((k, 128), dtype)
    masa_ops.masa_gemm(a, b, order="weight_stationary")
    fits = MK.ws_panel_bytes(k, dtype) <= cuda_build.MAX_SMEM_BYTES
    assert seen == ["weight_stationary" if fits else "output_stationary"]
    monkeypatch.setattr(MK, "ws_panel_bytes", lambda k, dtype: 0)
    masa_ops.masa_gemm(a, b, order="weight_stationary")
    assert seen[-1] == "weight_stationary"
