"""Roofline analysis over the dry-run records.

The counterpart of ``repro.launch.roofline``, for H100 SXM cards. Three
terms per (arch x shape) cell, single-pod mesh, from
``results/torch/dryrun/``:

  compute    = FLOPs_per_device / PEAK_FLOPS
  memory     = bytes_accessed_per_device / HBM_BW
  collective = nvlink_bytes / NVLINK_BW + ib_bytes / IB_BW

FLOPs and bytes are the dry-run's counts of the port's sharded step
(``launch/dryrun.py``: every layer executed, no loop correction);
collective bytes are its ring-multiplied collectives, split by link. The
dominant term is the step-time lower bound; ``compute_fraction`` =
compute / dominant is the roofline fraction an ideal overlap could reach
(1.0 = compute-bound).

MODEL_FLOPS = 6·N_active·tokens (train) or 2·N_active·tokens (inference);
``useful`` = MODEL_FLOPS / (FLOPs x devices) catches remat and redundant
compute (attention's scores, which 6·N·D leaves out, the recompute of
remat, work a rank repeats). ``peak_gb`` is the dry-run's per-device
``peak_bytes``.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh 16x16] [--md out.md]
"""
from __future__ import annotations

import argparse
import json
import pathlib

#: Dense bf16 tensor-core peak of one H100 SXM, FLOP/s (NVIDIA H100 data
#: sheet, without sparsity; at the 700 W board power).
PEAK_FLOPS = 989.4e12
#: HBM3 bandwidth of one H100 SXM, bytes/s (NVIDIA H100 data sheet).
HBM_BW = 3.35e12
#: NVLink 4 inside an 8-GPU HGX H100 node: 18 links of 25 GB/s each way,
#: 450 GB/s a direction a GPU (NVIDIA H100 data sheet: 900 GB/s
#: bidirectional); a ring sends one way at a time.
NVLINK_BW = 450e9
#: Between nodes: one 400 Gb/s InfiniBand NDR port a GPU (the HGX H100
#: reference design, one ConnectX-7 a GPU), 50 GB/s a direction. A ring
#: over a group that leaves its node runs at its slowest link, this one.
IB_BW = 50e9

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "torch" / "dryrun"


def model_flops(arch: str, shape_name: str) -> float:
    from repro_torch.configs import SHAPES, get_config
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        if cfg.encoder_decoder:
            tokens = shape.global_batch * (shape.seq_len + shape.seq_len // 4)
        return 6.0 * n_act * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        if cfg.encoder_decoder:
            tokens = shape.global_batch * (shape.seq_len + shape.seq_len // 4)
        return 2.0 * n_act * tokens
    # decode: one token per sequence
    return 2.0 * n_act * shape.global_batch


def load_cells(mesh: str = "16x16") -> list[dict]:
    cells = []
    for p in sorted(RESULTS.glob(f"*_{mesh}.json")):
        d = json.loads(p.read_text())
        if d.get("mesh") == mesh:
            cells.append(d)
    return cells


def analyze(rec: dict) -> dict | None:
    if not rec.get("ok"):
        return None
    flops = rec.get("flops_corrected") or rec.get("flops", 0.0)
    byts = rec.get("bytes_corrected") or rec.get("bytes_accessed", 0.0)
    coll = rec.get("collectives", {})
    links = coll.get("by_link", {"nvlink": 0.0, "ib": coll.get("total", 0.0)})
    n = rec.get("n_devices", 256)

    t_c = flops / PEAK_FLOPS
    t_m = byts / HBM_BW
    t_x = links["nvlink"] / NVLINK_BW + links["ib"] / IB_BW
    dom = max(t_c, t_m, t_x)
    name = {t_c: "compute", t_m: "memory", t_x: "collective"}[dom]
    mf = model_flops(rec["arch"], rec["shape"])
    useful = mf / max(flops * n, 1.0)

    fixes = {
        "compute": "already compute-bound: reduce redundant FLOPs (remat "
                   "policy, padding, attention's whole score matrix) "
                   "or quantize",
        "memory": "cut HBM traffic: fuse attention/SSD (the port's CUDA "
                  "kernels), better layouts, fp8/bf16 intermediates",
        "collective": "overlap or shrink collectives: collective-matmul "
                      "(SALP-1 at the link level), int8 gradient "
                      "compression, hierarchical DP reduction",
    }
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
        "dominant": name, "compute_fraction": t_c / dom if dom else 0.0,
        "model_flops": mf, "useful_ratio": useful,
        "peak_gb": (rec["memory"]["peak_bytes"] / 1e9
                    if (rec.get("memory") or {}).get("peak_bytes")
                    else None),
        "fix": fixes[name],
    }


def make_table(mesh: str = "16x16") -> tuple[str, list[dict]]:
    rows = [a for a in (analyze(r) for r in load_cells(mesh)) if a]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    lines = [
        f"### Roofline — mesh {mesh} (H100 SXM: {PEAK_FLOPS / 1e12:.1f} "
        f"TFLOP/s bf16, {HBM_BW / 1e12:.2f} TB/s HBM3, NVLink "
        f"{NVLINK_BW / 1e9:.0f} GB/s, InfiniBand {IB_BW / 1e9:.0f} GB/s a "
        f"direction)",
        "",
        "| arch | shape | compute (s) | memory (s) | collective (s) | dominant "
        "| roofline frac | useful (6ND/FLOPs) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | {r['dominant']} | "
            f"{r['compute_fraction']:.2f} | {r['useful_ratio']:.2f} |")
    lines.append("")
    lines.append("Per-cell dominant-term notes:")
    for r in rows:
        lines.append(f"- **{r['arch']} / {r['shape']}** ({r['dominant']}-bound): "
                     f"{r['fix']}.")
    return "\n".join(lines), rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--md", default=None)
    args = ap.parse_args(argv)
    table, rows = make_table(args.mesh)
    print(table)
    if args.md:
        pathlib.Path(args.md).write_text(table)
    # headline: worst and best cells
    if rows:
        worst = min(rows, key=lambda r: r["compute_fraction"])
        print(f"\nworst roofline fraction: {worst['arch']}/{worst['shape']} "
              f"= {worst['compute_fraction']:.2f} ({worst['dominant']}-bound)")


if __name__ == "__main__":
    main()
