"""The accelerator layer's kernels, end to end: the port of
``benchmarks/kernel_bench.py``.

    python -m repro_torch.kernel_bench [--device cpu]

Drives all five kernels of :mod:`repro_torch.kernels` through their public
wrappers at the reference bench's shapes, each once, as the reference
times them, and holds each result to its dense oracle (or, for the SSD
scan, to the model's chunked form): the tile-residency statistics of the
designation kernels (the DRAM paper's SA_SEL:ACTIVATE ratio becomes the
block-hit rate), wall times per call and the analytic SALP pipeline ladder
(:func:`repro_torch.core.salp.pipeline.speedup_ladder`) on H100 constants.
It prints the reference's ``name,us_per_call,derived`` CSV rows and returns
its keys (``errs``, ``moe_hit``, ``ladder``, ``kernels_ok``) plus
``launches``, the count of each kernel launch in the run.

Inputs are drawn from ``numpy.random.default_rng(0)``. On the card
(the default) every library is built before anything is timed, so no row
includes ``nvcc``; ``--device cpu`` runs the kernels' plain versions, and
its times are the host's.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import compat, kernels
from repro_torch.core.salp.pipeline import speedup_ladder
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.masa_gemm.ops import masa_gemm
from repro_torch.kernels.masa_gemm.ref import masa_gemm_ref
from repro_torch.kernels.moe_gemm.ops import capacity_block_eids, grouped_matmul
from repro_torch.kernels.moe_gemm.ref import grouped_matmul_ref
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.ssm import ssd_chunked

#: fp32 agreement bound of every kernel with its oracle (the reference's;
#: ``benchmarks.validate --suite kernels`` re-checks it from the artifact).
ERR_TOL = 1e-3

#: H100 SXM (NVIDIA data sheet): HBM3 bandwidth and the dense bf16
#: tensor-core rate, the pipeline ladder's fetch and compute terms.
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989.4e12


def block_hit_rate(block_ids) -> float:
    """Fraction of consecutive grid steps reusing the resident tile."""
    b = np.asarray(block_ids)
    return float((b[1:] == b[:-1]).mean()) if len(b) > 1 else 0.0


def emit(name: str, us: float, derived) -> str:
    row = f"{name},{us:.1f},{derived}"
    print(row)
    return row


def timed(fn, device: torch.device):
    """Wall time of one call in microseconds, the device synchronised
    before the clock stops."""
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) * 1e6


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def pipeline_ladder() -> dict[str, float]:
    """The SALP ladder of one 128 x 128 x 128 bf16 masa_gemm tile on the
    H100: fetch and writeback at the HBM rate, compute at the bf16 peak
    (ns)."""
    fetch = 2 * 128 * 128 * 2 / HBM_BYTES_PER_S * 1e9
    compute = 2 * 128 ** 3 / PEAK_BF16_FLOPS * 1e9
    wb = 128 * 128 * 2 / HBM_BYTES_PER_S * 1e9
    return speedup_ladder(fetch, compute, wb, reuse_rate=0.5)


def run(device=None) -> dict:
    dev = compat.resolve_device(device)
    if dev.type == "cuda":
        kernels.build()
    kernels.reset_launches()
    rng = np.random.default_rng(0)

    def normal(shape, scale: float = 1.0) -> torch.Tensor:
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(x).to(dev)

    out: dict = {"errs": {}, "device": str(dev)}

    # ---- moe_gemm: designation hit rate of the capacity layout
    E, C, D, F, bt = 8, 256, 128, 256, 128
    eids = capacity_block_eids(E, C, bt, device=dev)
    hit = block_hit_rate(eids.cpu().numpy())
    xs, w = normal((E * C, D)), normal((E, D, F), 0.1)
    y, us = timed(lambda: grouped_matmul(xs, w, eids, bt=bt), dev)
    err = max_err(y, grouped_matmul_ref(xs, w, eids, bt))
    emit("kernels.moe_gemm.capacity_layout", us,
         f"block_hit={hit:.2f};err={err:.1e}(SA_SEL_per_ACT={1 - hit:.2f})")
    out["moe_hit"] = hit
    out["errs"]["moe_gemm"] = err

    # ---- masa_gemm: residency order ladder
    a, b = normal((1024, 256)), normal((256, 256))
    _, us_os = timed(lambda: masa_gemm(a, b, order="output_stationary"), dev)
    timed(lambda: masa_gemm(a, b, order="weight_stationary"), dev)
    err = max_err(masa_gemm(a, b), masa_gemm_ref(a, b))
    # weight-stationary revisits the same B panel for all 8 M-blocks: 7/8 hits
    emit("kernels.masa_gemm.orders", us_os,
         f"ws_block_hit=0.88;os_block_hit=0.00;err={err:.1e}")
    out["errs"]["masa_gemm"] = err

    # ---- ssd_scan vs the model's chunked form
    B, L, H, hd, ds, chunk = 2, 256, 4, 32, 16, 32
    x = normal((B, L, H, hd), 0.5)
    dt = torch.nn.functional.softplus(normal((B, L, H)))
    a_log = torch.log(torch.linspace(1.0, 4.0, H, device=dev))
    bb, cc = normal((B, L, ds), 0.3), normal((B, L, ds), 0.3)
    dsk = torch.ones(H, device=dev)
    (yk, _), us_k = timed(lambda: ssd_scan(x, dt, a_log, bb, cc, dsk,
                                           chunk=chunk), dev)
    (ym, _), us_m = timed(lambda: ssd_chunked(x, dt, a_log, bb, cc, dsk,
                                              chunk), dev)
    err = max_err(yk, ym)
    emit("kernels.ssd_scan", us_k, f"err={err:.1e};ref_us={us_m:.0f}")
    out["errs"]["ssd_scan"] = err

    # ---- paged_attention: shared-prefix page reuse
    Bq, KVH, G, hd2, P, page, npg = 4, 2, 4, 64, 32, 16, 8
    q = normal((Bq, KVH, G, hd2))
    kp, vp = normal((P, page, KVH, hd2)), normal((P, page, KVH, hd2))
    shared = torch.arange(npg, device=dev)[None, :].repeat(Bq, 1)
    private = torch.from_numpy(rng.integers(0, P, (Bq, npg))).to(dev)
    sl = torch.full((Bq,), npg * page, dtype=torch.int32, device=dev)
    for name, btab in (("shared_prefix", shared), ("private", private)):
        o, us = timed(lambda b=btab: paged_attention(q, kp, vp, b, sl), dev)
        err = max_err(o, paged_attention_ref(q, kp, vp, btab, sl))
        # page-hit rate across the (b, h, p) grid: consecutive b reuse pages
        flat = btab.cpu().numpy().T.reshape(-1)      # page-major order proxy
        emit(f"kernels.paged_attention.{name}", us,
             f"err={err:.1e};page_reuse={block_hit_rate(flat):.2f}")
        out["errs"][f"paged_attention/{name}"] = err

    # ---- flash_attention vs the dense oracle
    qf, kf, vf = (normal((2, 256, 64)) for _ in range(3))
    of, us_f = timed(lambda: flash_attention_kernel(qf, kf, vf, causal=True),
                     dev)
    err = max_err(of, flash_attention_ref(qf, kf, vf, causal=True))
    emit("kernels.flash_attention", us_f, f"err={err:.1e}")
    out["errs"]["flash_attention"] = err

    # ---- analytic SALP pipeline ladder on H100 constants
    ladder = pipeline_ladder()
    base = ladder["baseline"]
    emit("kernels.salp_pipeline_ladder", 0.0,
         ";".join(f"{k}=+{100 * (v / base - 1):.0f}%" for k, v in ladder.items()
                  if k != "baseline"))
    out["ladder"] = {k: v / base for k, v in ladder.items()}
    out["kernels_ok"] = all(e < ERR_TOL for e in out["errs"].values())
    out["launches"] = kernels.launches()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    out = run(args.device)
    print(json.dumps(out))
    return 0 if out["kernels_ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
