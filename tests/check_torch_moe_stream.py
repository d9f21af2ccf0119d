"""The moe_gemm stream body beside the simt body and ``torch.bmm`` where
``chip_smoke.py`` does not time it: bfloat16 at moonshot-v1-16b-a3b's
serve shapes, and the crossover to the tf32x3 body in float32.

    python3 tests/check_torch_moe_stream.py

Needs an NVIDIA H100 (sm_90a) and nvcc; not a test (pytest does not collect
it). Builds the port's kernels as ``chip_smoke.py`` does and prints
ptxas's registers and spills of every stream kernel. Then, in bfloat16 at
the four shapes of ``torch_cases.MOE_STREAM_MOONSHOT``, and in float32 at
C 32 (bt 32, the stream body's largest token block) and C 64 (bt 64, past
it: the tf32x3 body), it holds the body ``kernel.body`` picks and the simt
body to the plain version within
``torch_cases.TOLS`` and times, with ``chip_smoke.time_ms``, the bodies and
``torch.bmm`` in turns (that order, then reversed; the mean of the two),
each beside the byte bound. It prints the card's name and power limit and
one JSON line of the means.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tests")]
import chip_smoke as cs  # noqa: E402
import torch_cases as tc  # noqa: E402
from repro_torch import cuda_build  # noqa: E402
from repro_torch.kernels.moe_gemm import kernel as EK  # noqa: E402

REPS = 20


def print_registers() -> None:
    """ptxas's registers and spills of each stream kernel the port built."""
    _, log = cuda_build.build(EK.SOURCES)["moe_gemm"]
    for chunk in log.split("Compiling entry function")[1:]:
        kind = re.search(
            r"moe_gemm_stream_kernelI(f|13__nv_bfloat16)Li(\d+)E", chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        if kind and regs:
            print(f"[ptxas] stream {'fp32' if kind[1] == 'f' else 'bf16'} "
                  f"bt {kind[2]}: {regs[1]} registers, "
                  f"{spill[1] if spill else '?'} bytes spill stores")


def in_turns(fns: dict) -> dict[str, float]:
    """Each of ``fns`` timed in turns, forwards then backwards: the mean."""
    order = list(fns) + list(reversed(fns))
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(cs.time_ms(fns[k], REPS, 1))
    return {k: sum(v) / len(v) for k, v in times.items()}


def shape_row(E, C, D, F, bt, dtype) -> dict:
    x, w, designations = tc.moe_stream_case(E, C, D, F, bt, dtype, "cuda")
    eids = designations["capacity"]
    dname = str(dtype).split(".")[-1]
    want = EK.grouped_matmul_plain(x, w, eids, bt=bt)
    bodies = list(dict.fromkeys((EK.body(x, w, bt), "simt")))
    fns = {b: (lambda b=b: EK._launch(x, w, eids, bt, b)) for b in bodies}
    fns["torch.bmm"] = lambda: torch.bmm(x.view(E, C, D), w)
    errs = {b: cs.kernel_err(f"{b} {(E, C, D, F, bt)}", fns[b](), want, dname)
            for b in bodies}
    ms = in_turns(fns)
    nbytes = dtype.itemsize * (E * C * D + E * D * F + E * C * F) \
        + 4 * eids.numel()
    bound_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
    print(f"[moe_stream] {(E, C, D, F, bt)} {dname}: bound {bound_ms:.4f} ms;"
          + ";".join(f" {k} {v:.4f} ms ({bound_ms / v:.3f} of the bound)"
                     for k, v in ms.items()), flush=True)
    return dict(shape=(E, C, D, F, bt), dtype=dname, ms=ms, errs=errs,
                bound_ms=bound_ms)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("check_torch_moe_stream: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print_registers()
    rows = [shape_row(*shape, torch.bfloat16)
            for shape in tc.MOE_STREAM_MOONSHOT]
    E, D, F = 64, 2048, 1408
    rows += [shape_row(E, C, D, F, C, torch.float32) for C in (32, 64)]
    print(smi)
    print(json.dumps({"card": smi, "rows": rows}))


if __name__ == "__main__":
    main()
