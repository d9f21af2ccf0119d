"""Golden-fixture cases for the PyTorch port, in the port's own types.

NOT a test module (no ``test_`` prefix). A copy of the seeded
``random_trace`` recipe, the ten ``CONFIGS`` and the multicore mix recipe
of ``tests/test_packed_state.py``, built from ``repro_torch`` alone so that
``chip_smoke.py`` can replay ``tests/data/golden_packed_state.json`` and
``tests/data/torch_multicore_fixture.json`` on the card without the JAX
package. ``tests/test_torch_engine.py`` and ``tests/test_torch_multicore.py``
hold this copy equal to the reference's.

It also holds the SSD-scan cases (``tests/test_kernels.py``'s shapes and
tolerances, inputs drawn with numpy) and the serving fixture's reader, which
``tests/test_torch_ssd_scan.py``, ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` share.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from repro_torch.core.dram import (ROW_SPACE_STRIDE, Scheduler, SimConfig,
                                   generate_trace, stack_traces, workload)
from repro_torch.core.dram.trace import Trace, WorkloadProfile

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN_PATH = os.path.join(DATA, "golden_packed_state.json")
FIG4_PATH = os.path.join(DATA, "torch_fig4_n8000.json")
MULTICORE_PATH = os.path.join(DATA, "torch_multicore_fixture.json")
SERVE_PATH = os.path.join(DATA, "torch_serve_mamba2_780m.json")

#: tests/test_kernels.py's SSD sweep: (B, L, H, hd, ds, chunk).
SSD_SHAPES = ((1, 32, 2, 16, 8, 16), (2, 64, 3, 16, 8, 16),
              (2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 32, 64))
#: tests/test_kernels.py's tolerances (rtol = atol) by dtype name.
SSD_TOLS = {"float32": 2e-4, "bfloat16": 2e-2}
#: SSD shapes held on the card besides the sweep: mamba2-780m's serve
#: shape (one prefill of a 256-token prompt), jamba's SSM shape, and chunk
#: 256 with ds 128 (SSMConfig's default chunk).
SSD_SERVE = (1, 256, 48, 64, 128, 64)
SSD_CARD_SHAPES = SSD_SHAPES + (SSD_SERVE, (2, 512, 128, 64, 16, 32),
                                (1, 512, 8, 64, 128, 256))

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


def serve_fixture() -> dict:
    """tests/data/torch_serve_mamba2_780m.json (see
    tests/make_torch_serve_fixture.py)."""
    with open(SERVE_PATH) as f:
        return json.load(f)
