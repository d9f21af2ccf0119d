"""Golden-fixture cases for the PyTorch port, in the port's own types.

NOT a test module (no ``test_`` prefix). A copy of the seeded
``random_trace`` recipe, the ten ``CONFIGS`` and the multicore mix recipe
of ``tests/test_packed_state.py``, built from ``repro_torch`` alone so that
``chip_smoke.py`` can replay ``tests/data/golden_packed_state.json`` and
``tests/data/torch_multicore_fixture.json`` on the card without the JAX
package. ``tests/test_torch_engine.py`` and ``tests/test_torch_multicore.py``
hold this copy equal to the reference's; the recipe of
``tests/data/golden_commands.json`` (``tests/make_golden_commands.py``) is
here too, held to it by ``tests/test_torch_commands.py``.

It also holds the accelerator layer's kernel cases (the sweep shapes and
tolerances of ``tests/test_kernels.py`` and ``tests/test_flash_attention.py``,
inputs drawn with numpy, and the jamba-v0.1-52b shapes the card times) and
the serving fixture's reader, which the port's kernel tests,
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` share.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.core.dram import (ROW_SPACE_STRIDE, Scheduler, SimConfig,
                                   generate_trace, stack_traces, workload)
from repro_torch.core.dram.trace import Trace, WorkloadProfile

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN_PATH = os.path.join(DATA, "golden_packed_state.json")
FIG4_PATH = os.path.join(DATA, "torch_fig4_n8000.json")
MULTICORE_PATH = os.path.join(DATA, "torch_multicore_fixture.json")
GOLDEN_COMMANDS_PATH = os.path.join(DATA, "golden_commands.json")
REFRESH_MEMTECH_PATH = os.path.join(DATA, "torch_refresh_memtech_fixture.json")
PAPER_BENCHES_PATH = os.path.join(DATA, "torch_paper_benches_fixture.json")
#: The serving fixtures by architecture (tests/make_torch_serve_fixture.py).
SERVE_PATHS = {
    "mamba2-780m": os.path.join(DATA, "torch_serve_mamba2_780m.json"),
    "smollm-135m": os.path.join(DATA, "torch_serve_smollm_135m.json"),
    "moonshot-v1-16b-a3b": os.path.join(DATA,
                                        "torch_serve_moonshot_16b_l2.json"),
}
#: The training fixture (tests/make_torch_train_fixture.py).
TRAIN_PATH = os.path.join(DATA, "torch_train_mamba2_780m.json")

#: tests/test_kernels.py's SSD sweep: (B, L, H, hd, ds, chunk).
SSD_SHAPES = ((1, 32, 2, 16, 8, 16), (2, 64, 3, 16, 8, 16),
              (2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 32, 64))
#: tests/test_kernels.py's tolerances (rtol = atol) by dtype name.
TOLS = {"float32": 2e-4, "bfloat16": 2e-2}
#: SSD shapes held on the card besides the sweep: mamba2-780m's serve
#: shape (one prefill of a 256-token prompt), jamba's SSM shape, and chunk
#: 256 with ds 128 (SSMConfig's default chunk).
SSD_SERVE = (1, 256, 48, 64, 128, 64)
SSD_CARD_SHAPES = SSD_SHAPES + (SSD_SERVE, (2, 512, 128, 64, 16, 32),
                                (1, 512, 8, 64, 128, 256))
#: The SSD kernel's edges (B, L, H, hd, ds, chunk): hd 4, 8 and 16 below the
#: 32-column tile (one block a head), hd 128 (four tiles a head), one chunk
#: (L = chunk), batch * head 1, chunk 256 with ds 128 in one chunk, ds of
#: 2 and 4 float4s a lane (256, 512) and ds 12 (three float4s).
SSD_EDGE = ((1, 32, 1, 4, 8, 16), (2, 48, 2, 8, 8, 16), (1, 32, 2, 16, 12, 16),
            (2, 64, 2, 128, 16, 64), (1, 64, 3, 32, 16, 64),
            (1, 256, 1, 64, 128, 256), (1, 64, 2, 32, 256, 64),
            (1, 32, 2, 16, 512, 16))

#: tests/test_kernels.py's masa_gemm sweep: (M, K, N).
MASA_SHAPES = ((128, 128, 128), (256, 384, 512), (512, 128, 256),
               (128, 1024, 128))
#: Weight-stationary shapes whose K is no multiple of bk (the reference
#: takes them): (M, K, N, dtype). K 300 in float32 and 500 in bfloat16 fit
#: the resident panel; K 400 in float32 and 700 in bfloat16 fall back to
#: output-stationary.
MASA_WS_ODD_K = ((128, 300, 128, "float32"), (128, 400, 128, "float32"),
                 (128, 500, 128, "bfloat16"), (128, 700, 128, "bfloat16"))
#: tests/test_kernels.py's moe_gemm sweep: (E, C, D, F, bt, bf).
MOE_SHAPES = ((4, 256, 64, 256, 128, 128), (8, 128, 128, 384, 128, 128),
              (2, 512, 96, 128, 128, 128), (16, 128, 64, 128, 64, 128))
#: The moe_gemm stream body's cases (E, C, D, F, bt): moonshot-v1-16b-a3b's
#: expert products as its serve path sends them (64 experts, bt = capacity
#: 16 at a 128-token prefill and 8 at a decode step; up and gate D 2048 by
#: F 1408, down 1408 by 2048), then the edges: bt 24 at a ragged D (97)
#: with F 8 columns past its last 128; bt 32 with two token blocks an
#: expert; D below one stage of the ring (5); F 1416, 1408-like and 8 past
#: its tiles, at a D whose rows are 8-byte units; F 8.
MOE_STREAM_MOONSHOT = ((64, 16, 2048, 1408, 16), (64, 16, 1408, 2048, 16),
                       (64, 8, 2048, 1408, 8), (64, 8, 1408, 2048, 8))
MOE_STREAM_SHAPES = MOE_STREAM_MOONSHOT + (
    (4, 24, 97, 264, 24), (3, 64, 40, 136, 32), (5, 16, 5, 128, 8),
    (2, 16, 130, 1416, 16), (2, 32, 64, 8, 32))
#: The moe_gemm tf32x3 body's cases (E, C, D, F, bt): the fp32 sweep of
#: MOE_SHAPES (bt 128 and 64), then the edges: bt 40 (64-row tiles, 24
#: rows masked) at a D ragged past its last stage of 32 (100) and F 8
#: columns past its last 128 (264); bt 120 (moonshot's capacity at a
#: 1024-token prefill: 128-row tiles, 8 rows masked) at D 36; bt 192 (three
#: 64-row tiles a token block) and 384 (three of 128); moonshot's up
#: product at bt 120 on 4 experts.
MOE_TF32X3_SHAPES = tuple(s[:5] for s in MOE_SHAPES) + (
    (4, 80, 100, 264, 40), (3, 240, 36, 136, 120), (2, 192, 96, 132, 192),
    (2, 384, 64, 128, 384), (4, 120, 2048, 1408, 120))
#: tests/test_kernels.py's paged_attention sweep: (B, KVH, G, hd, P, page,
#: n_pages).
PAGED_SHAPES = ((2, 1, 4, 64, 8, 16, 4), (3, 2, 4, 64, 16, 32, 4),
                (1, 4, 1, 128, 8, 64, 2), (4, 2, 8, 64, 32, 16, 8))
#: The paged kernel's edges: ((B, KVH, G, hd, P, page, n_pages), seq_lens,
#: the one page every table entry names or None). G 1 and 8, and 3 and 7
#: (the split body rounds them up to 4 and 8); lengths 0, 1, one short of
#: half the slots, on it, one past it and full (two splits meet there);
#: n_pages 1; a table that repeats one page.
PAGED_EDGE = (((6, 2, 1, 128, 16, 16, 8), (0, 1, 63, 64, 65, 128), None),
              ((6, 1, 8, 64, 16, 16, 8), (0, 1, 63, 64, 65, 128), None),
              ((3, 2, 4, 64, 4, 16, 1), (0, 1, 16), None),
              ((2, 2, 4, 128, 8, 16, 4), (64, 40), 3),
              ((3, 2, 3, 64, 8, 16, 4), (0, 17, 64), None),
              ((2, 1, 7, 128, 8, 16, 4), (5, 64), None))
#: tests/test_flash_attention.py's sweep: (BH, S, hd, bq, bk).
FLASH_SHAPES = ((2, 256, 64, 128, 128), (4, 512, 64, 128, 128),
                (1, 256, 128, 128, 64), (3, 384, 64, 128, 128))

#: The kernels' timing shapes at the full width of jamba-v0.1-52b
#: (src/repro_torch/configs/jamba_52b.py). Attention: one attention
#: layer's causal prefill of 2048 tokens (32 query heads, 8 kv heads of
#: 128). Paged: one decode step at batch 32 over 2048 cached tokens each,
#: in private pages of 16 (G = 32 / 8 query heads a kv head). MoE: the
#: capacity layout of 2048 tokens (16 experts, top-2, capacity factor 1.25:
#: expert_capacity 320, rounded up to the token block of 128), d_model 4096
#: by d_ff_expert 14336. MASA: a dense FFN up-projection of 2048 tokens,
#: and the weight-stationary order at the deepest K whose panel fits a
#: block's shared memory in float32.
JAMBA_TOKENS = 2048
FLASH_JAMBA = dict(B=1, S=2048, H=32, Hkv=8, hd=128)
PAGED_JAMBA = dict(B=32, KVH=8, G=4, hd=128, page=16, seq=2048, P=4096)
MOE_JAMBA = dict(E=16, C=384, D=4096, F=14336, bt=128)
MASA_JAMBA = dict(M=2048, K=4096, N=14336)
MASA_WS_JAMBA = dict(M=2048, K=256, N=14336)


def normal(rng, shape, scale: float = 1.0) -> np.ndarray:
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def masa_inputs(m: int, k: int, n: int, seed: int = 0):
    """a [M, K], b [K, N]: standard normal float32."""
    rng = np.random.default_rng(seed)
    return normal(rng, (m, k)), normal(rng, (k, n))


def moe_inputs(E: int, C: int, D: int, F: int, seed: int = 0,
               w_scale: float = 0.1):
    """x_sorted [E*C, D] standard normal and w [E, D, F] times
    ``w_scale`` (the scales of tests/test_kernels.py), float32."""
    rng = np.random.default_rng(seed)
    return normal(rng, (E * C, D)), normal(rng, (E, D, F), w_scale)


def moe_stream_case(E: int, C: int, D: int, F: int, bt: int, dtype, device,
                    seed: int = 5):
    """x [E*C, D] standard normal and w [E, D, F] times D ** -0.5, drawn
    on ``device`` (moonshot's fp32 W is 738 MB) and cast to ``dtype``, and
    two designations of the token blocks: the capacity layout's and a
    scattered one (random experts, repeats and gaps)."""
    from repro_torch.kernels.moe_gemm import capacity_block_eids

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((E * C, D), generator=gen, device=device).to(dtype)
    w = (torch.randn((E, D, F), generator=gen, device=device)
         * D ** -0.5).to(dtype)
    scattered = torch.randint(0, E, (E * C // bt,), generator=gen,
                              device=device).to(torch.int32)
    return x, w, {"capacity": capacity_block_eids(E, C, bt, device=device),
                  "scattered": scattered}


def paged_inputs(B: int, KVH: int, G: int, hd: int, P: int, page: int,
                 n_pages: int, seed: int = 0):
    """q, k_pages, v_pages (standard normal, float32), a block table of
    random pages in [0, P) and random lengths in [1, n_pages * page], both
    int32, drawn as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    q = normal(rng, (B, KVH, G, hd))
    kp = normal(rng, (P, page, KVH, hd))
    vp = normal(rng, (P, page, KVH, hd))
    table = rng.integers(0, P, (B, n_pages)).astype(np.int32)
    lens = rng.integers(1, n_pages * page + 1, (B,)).astype(np.int32)
    return q, kp, vp, table, lens


def paged_edge_inputs(shape, lens, page_id=None, seed: int = 4):
    """``paged_inputs`` of ``shape`` with ``seq_lens`` set to ``lens`` and,
    if ``page_id`` is given, every table entry set to it."""
    q, kp, vp, table, _ = paged_inputs(*shape, seed=seed)
    if page_id is not None:
        table = np.full_like(table, page_id)
    return q, kp, vp, table, np.asarray(lens, np.int32)


def c_entry_types(src: str, entry: str):
    """(restype, argtypes) that ctypes needs for the C entry ``entry`` of
    the CUDA source text ``src``: a pointer is c_void_p, an int c_int, a
    long long c_longlong, a float c_float; the result int or long long."""
    import ctypes
    import re

    ret, params = re.search(
        rf'extern "C" (int|long long) {entry}\(([^)]*)\)', src).groups()
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long": ctypes.c_longlong}
    args = [ctypes.c_void_p if "*" in p else kinds[p.split()[0]]
            for p in params.split(",")]
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong}[ret], args


def declared(module, entries):
    """``module.declare`` applied to a stand-in library with ``entries``:
    {entry: (restype, argtypes)} as the wrapper declares them."""
    import types

    lib = module.declare(types.SimpleNamespace(
        **{e: types.SimpleNamespace() for e in entries}))
    return {e: (getattr(lib, e).restype, getattr(lib, e).argtypes)
            for e in entries}


def flash_inputs(bh: int, s: int, hd: int, seed: int = 0):
    """q, k, v [BH, S, hd]: standard normal float32."""
    rng = np.random.default_rng(seed)
    return tuple(normal(rng, (bh, s, hd)) for _ in range(3))


#: Flash cases on bases that are not 16-byte aligned, which bf16 runs on
#: the simt body: (BH, S, hd, bq, bk, g), k and v of BH / g rows.
FLASH_SHIFTED = ((4, 512, 64, 128, 128, 1), (4, 256, 128, 128, 64, 2))


def shifted(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose base lies one element past its
    allocation's: not 16-byte aligned, so TMA cannot map it."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


#: The golden multicore cells' mix and trace length.
GOLDEN_MIX, GOLDEN_MIX_N = ("mcf", "lbm"), 150

#: Refresh-engaged timing for the ladder's fixture cells.
REF_TIMING = dataclasses.replace(
    SimConfig().timing, t_refi=520, t_rfc=80, t_rfc_pb=32, ref_postpone_max=2)

CONFIGS = {
    "default": dict(),
    "refresh": dict(refresh=True),
    "dsarp": dict(refresh=True, dsarp=True),
    "closed": dict(row_policy="closed"),
    "closed_refresh": dict(refresh=True, row_policy="closed"),
    "all_bank": dict(refresh_policy="all_bank"),
    "dsarp_policy": dict(refresh_policy="dsarp"),
    "per_bank": dict(refresh_policy="per_bank", timing=REF_TIMING),
    "darp": dict(refresh_policy="darp", timing=REF_TIMING),
    "sarp": dict(refresh_policy="sarp", timing=REF_TIMING),
}


def random_trace(seed: int, n: int = 120, nb: int = 8, ns: int = 8,
                 mlp: int | None = None) -> Trace:
    """Seeded random trace — the recipe the golden fixture was made with."""
    rng = np.random.default_rng(seed)
    banks = rng.integers(0, nb, n)
    rows = rng.integers(0, 64, n)
    loc = rng.random()
    for i in range(1, n):
        if rng.random() < loc:
            banks[i], rows[i] = banks[i - 1], rows[i - 1]
    sas = (rows * 2654435761 >> 11) % ns
    wr = rng.random(n) < rng.random() * 0.8
    gaps = rng.integers(0, 30, n)
    deps = (rng.random(n) < 0.4) & ~wr
    deps[0] = False
    return Trace(bank=banks.astype(np.int32), subarray=sas.astype(np.int32),
                 row=rows.astype(np.int32), is_write=wr,
                 gap=gaps.astype(np.int32), dep=deps,
                 mlp_window=mlp if mlp is not None else int(rng.integers(1, 16)),
                 profile=WorkloadProfile("g", 10, .3, 4, 2, 4, .2, .3))


def golden_groups() -> dict[tuple[str, str], list[dict]]:
    """The fixture's 300 single-core cells grouped by (config, policy), each
    group's seeds in fixture order (one batched call per group)."""
    with open(GOLDEN_PATH) as f:
        cells = json.load(f)["single"]
    groups: dict[tuple[str, str], list[dict]] = {}
    for c in cells:
        groups.setdefault((c["config"], c["policy"]), []).append(c)
    return groups


def golden_stacked(cells: list[dict]) -> dict:
    return stack_traces([random_trace(c["seed"]) for c in cells])


#: tests/make_golden_commands.py's grid: every CONFIGS x policy cell on
#: random_trace(GOLDEN_COMMANDS_SEED), and the 2-core mix (mcf, lbm x 120
#: requests, seed GOLDEN_COMMANDS_MIX_SEED) under FR-FCFS in these cells.
GOLDEN_COMMANDS_SEED, GOLDEN_COMMANDS_MIX_SEED = 3, 5
GOLDEN_COMMANDS_MIX_CELLS = (("default", "BASELINE"), ("default", "MASA"),
                             ("darp", "BASELINE"), ("darp", "MASA"))


def golden_commands_mix() -> list:
    return golden_mix(GOLDEN_COMMANDS_MIX_SEED, n=120)


def golden_commands_mix_config(config: str) -> SimConfig:
    return SimConfig(scheduler=Scheduler.FRFCFS, **CONFIGS[config])


def refresh_memtech_fixture() -> dict:
    """The committed JAX run of the refresh and memtech benches
    (tests/make_torch_refresh_memtech_fixture.py)."""
    with open(REFRESH_MEMTECH_PATH) as f:
        return json.load(f)


def paper_benches_fixture() -> dict:
    """The committed JAX run of the remaining paper benches
    (tests/make_torch_paper_benches_fixture.py)."""
    with open(PAPER_BENCHES_PATH) as f:
        return json.load(f)


def fig4_fixture() -> dict[tuple[str, str], dict]:
    """``{(workload, policy): counters}`` of the committed n=8000 grid."""
    with open(FIG4_PATH) as f:
        doc = json.load(f)
    return {(c["workload"], c["policy"]): c["counters"] for c in doc["cells"]}


def golden_mix(seed: int, names=GOLDEN_MIX, n: int = GOLDEN_MIX_N) -> list:
    """A multicore golden cell's traces: each core in its own row space."""
    return [generate_trace(workload(m), n, seed=seed,
                           row_space_offset=ROW_SPACE_STRIDE * i)
            for i, m in enumerate(names)]


def golden_multicore_config(config: str, scheduler: str) -> SimConfig:
    return SimConfig(scheduler=Scheduler[scheduler], **CONFIGS[config])


def golden_multicore_groups() -> dict[tuple[str, str, str], list[dict]]:
    """The fixture's 88 multicore cells grouped by (config, scheduler,
    policy), each group's seeds in fixture order (the seeds' mixes are the
    mixes of one batched call)."""
    with open(GOLDEN_PATH) as f:
        cells = json.load(f)["multicore"]
    groups: dict[tuple[str, str, str], list[dict]] = {}
    for c in cells:
        groups.setdefault((c["config"], c["scheduler"], c["policy"]),
                          []).append(c)
    return groups


def multicore_fixture() -> dict[tuple[str, str, str, str], dict]:
    """``{(part, mix, policy, scheduler): cell}`` of the committed
    multicore / scheduler-study products (``part`` is "multicore" or
    "sched"); each cell holds ``counters``, ``core_cycles`` and
    ``alone_cycles``."""
    with open(MULTICORE_PATH) as f:
        doc = json.load(f)
    return {(c["part"], c["mix"], c["policy"], c["scheduler"]): c
            for c in doc["cells"]}


def ssd_inputs(B: int, L: int, H: int, hd: int, ds: int, seed: int = 0,
               dt_scale: float = 1.0) -> dict[str, np.ndarray]:
    """float32 inputs of ``ssd_scan`` at tests/test_kernels.py's scales:
    x [B,L,H,hd], dt [B,L,H] (softplus of a normal, times ``dt_scale``),
    a_log [H], b and c [B,L,ds], d_skip [H]."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    z = rng.standard_normal((B, L, H)).astype(f32)
    return dict(
        x=(rng.standard_normal((B, L, H, hd)) * 0.5).astype(f32),
        dt=(np.logaddexp(z, 0) * dt_scale).astype(f32),
        a_log=np.log(np.linspace(1.0, 4.0, H)).astype(f32),
        b=(rng.standard_normal((B, L, ds)) * 0.3).astype(f32),
        c=(rng.standard_normal((B, L, ds)) * 0.3).astype(f32),
        d_skip=np.ones((H,), f32))


def ssd_kernel_inputs(shape, dtype, device, seed: int = 0):
    """``ssd_inputs`` of ``shape`` (B, L, H, hd, ds, chunk) in the
    kernel's layout on ``device``, as ops.ssd_scan makes them: xr and
    b, c in ``dtype``, l in float32, all contiguous."""
    import torch

    B, L, H, hd, ds, _ = shape
    inp = {k: torch.from_numpy(v).to(device)
           for k, v in ssd_inputs(B, L, H, hd, ds, seed).items()}
    l = (inp["dt"] * -torch.exp(inp["a_log"])).transpose(1, 2)
    xr = (inp["x"] * inp["dt"][..., None]).transpose(1, 2)
    return (xr.reshape(B * H, L, hd).to(dtype).contiguous(),
            l.reshape(B * H, L).contiguous(), inp["b"].to(dtype),
            inp["c"].to(dtype))


def train_fixture() -> dict:
    """mamba2-780m's 4 training steps by the JAX package (see
    tests/make_torch_train_fixture.py)."""
    with open(TRAIN_PATH) as f:
        return json.load(f)


def serve_fixture(arch: str = "mamba2-780m") -> dict:
    """The serving fixture of ``arch`` (``SERVE_PATHS``; see
    tests/make_torch_serve_fixture.py)."""
    with open(SERVE_PATHS[arch]) as f:
        return json.load(f)
