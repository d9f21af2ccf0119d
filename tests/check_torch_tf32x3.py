"""The tf32x3 bodies of masa_gemm, moe_gemm and flash_attention beside
their simt bodies and the one PyTorch call for each, at jamba-v0.1-52b's
widths, and moe's tile rows.

    python3 tests/check_torch_tf32x3.py [--sass]

Needs an NVIDIA H100 (sm_90a) and nvcc; not a test (pytest does not collect
it). Builds the three libraries as ``chip_smoke.py`` does, and moe_gemm's
twice more into ``build/tf32x3_rows/`` with ``-DMOE_TF32X3_ROWS=64`` and
``=128`` (every tf32x3 launch on that tile), and prints ptxas's registers
and spills of every tf32x3 kernel; with ``--sass``, the ten most frequent
SASS opcodes of each (``cuobjdump -sass``), which show what the split and
the products compile to. Then, in float32 at ``torch_cases.MASA_JAMBA``
(output-stationary), ``MASA_WS_JAMBA`` (weight-stationary), ``MOE_JAMBA``
(the capacity layout, bt 128; ``torch.bmm`` on [E, C, D]) and
``FLASH_JAMBA`` (causal, on the GQA-expanded heads), it holds each body to
the plain version (max abs error printed; the run fails at its end above
``chip_smoke.TF32X3_MAX_ERR`` for tf32x3, at once outside
``torch_cases.TOLS`` for simt) and times, with ``chip_smoke.time_ms``, the
tf32x3 body, the simt body and the library call in turns (that order, then
reversed; the mean of the two), each with its TFLOP/s beside both fp32
operation bounds. Last, moe's tile study: at moonshot-v1-16b-a3b's up
product (64 experts, D 2048, F 1408) with bt = capacity 40 to 384
(prefills of about 270 to 3280 tokens), its down product at 120 and
jamba's shape, the two forced builds in turns, each held to the plain
version, beside the row tile ``kernel.tf32x3_rows`` picks. It prints the card's name and power limit and one JSON line of the
rows.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tests")]
import chip_smoke as cs  # noqa: E402
import torch_cases as tc  # noqa: E402
from repro_torch import compat, cuda_build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.masa_gemm import kernel as MK  # noqa: E402
from repro_torch.kernels.moe_gemm import capacity_block_eids  # noqa: E402
from repro_torch.kernels.moe_gemm import kernel as EK  # noqa: E402

KERNELS = {"masa_gemm": MK, "moe_gemm": EK, "flash_attention": FK}
#: The rows whose tf32x3 error exceeds the gate: the run goes on to time
#: them all, then fails.
FAILED: list[str] = []
REPS = {"masa output_stationary": 3, "masa weight_stationary": 20,
        "moe": 3, "flash_attention": 10}
#: Where the forced-tile builds of moe_gemm go, and the tile study's
#: shapes (E, C, D, F, bt): moonshot-v1-16b-a3b's up product at bt =
#: capacity of prefills of about 270 to 3280 tokens (40 to 384), its down
#: product at 120, and jamba's.
ROWS_DIR = ROOT / "build" / "tf32x3_rows"
STUDY = tuple((64, bt, 2048, 1408, bt)
              for bt in (40, 64, 120, 128, 192, 240, 256, 384)) + (
    (64, 120, 1408, 2048, 120),
    tuple(tc.MOE_JAMBA[k] for k in ("E", "C", "D", "F", "bt")))


def build_rows() -> dict[int, subprocess.Popen]:
    """Start moe_gemm's builds with every tf32x3 tile forced to 64 and to
    128 rows."""
    ROWS_DIR.mkdir(parents=True, exist_ok=True)
    return {rows: subprocess.Popen(
        [compat.nvcc_path(), *cuda_build.NVCC_FLAGS,
         f"-DMOE_TF32X3_ROWS={rows}", "-o", str(ROWS_DIR / f"moe_{rows}.so"),
         str(EK.SOURCES["moe_gemm"])], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rows in (64, 128)}


def forced_launch(lib, x, w, eids, bt: int):
    """One tf32x3 launch through a forced-tile build's C entry."""
    y = torch.empty((x.shape[0], w.shape[2]), device="cuda")
    err = lib.moe_gemm_launch(
        x.data_ptr(), w.data_ptr(), eids.data_ptr(), y.data_ptr(),
        x.shape[0], x.shape[1], w.shape[2], w.shape[0], bt, 0,
        EK._BODY_CODE["tf32x3"], EK.GROUP_M, torch.cuda.current_stream(
            ).cuda_stream)
    if err:
        sys.exit(f"check_torch_tf32x3: forced-tile launch returned {err}")
    return y


def tile_study(builds: dict[int, subprocess.Popen], gen) -> list[dict]:
    """The forced 64- and 128-row builds in turns at each shape of STUDY,
    beside the tile the default build picks."""
    libs = {}
    for rows, proc in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on MOE_TF32X3_ROWS={rows}:\n{log}")
        libs[rows] = EK.declare(ctypes.CDLL(str(ROWS_DIR / f"moe_{rows}.so")))
    out = []
    for E, C, D, F, bt in STUDY:
        x = torch.randn((E * C, D), generator=gen, device="cuda")
        w = torch.randn((E, D, F), generator=gen, device="cuda") * D ** -0.5
        eids = capacity_block_eids(E, C, bt, device="cuda")
        want = EK.grouped_matmul_plain(x, w, eids, bt=bt)
        fns = {}
        for rows, lib in libs.items():
            fn = (lambda lib=lib: forced_launch(lib, x, w, eids, bt))
            err = float((fn() - want).abs().max())
            if not err <= cs.TF32X3_MAX_ERR:
                FAILED.append(f"moe bt {bt} rows {rows} max abs err "
                              f"{err:.3e}")
            fns[f"rows_{rows}"] = fn
        ms = in_turns(fns, 10)
        flops = 2 * E * C * D * F
        r = dict(shape=(E, C, D, F, bt), picked=EK.tf32x3_rows(bt), ms=ms,
                 tflops={k: flops / (v * 1e-3) / 1e12 for k, v in ms.items()})
        print(f"[tf32x3] moe tile study {r['shape']} (picked {r['picked']} "
              f"rows): "
              + "; ".join(f"{k} {v:.4f} ms ({r['tflops'][k]:.1f} TFLOP/s)"
                          for k, v in ms.items()), flush=True)
        out.append(r)
        del x, w, want
    return out


def print_registers(sass: bool) -> None:
    """ptxas's registers and spills of each tf32x3 kernel; with ``sass``,
    each one's most frequent SASS opcodes."""
    for name, mod in KERNELS.items():
        lib, log = cuda_build.build(mod.SOURCES)[name]
        for chunk in log.split("Compiling entry function")[1:]:
            kernel = re.search(r"'(\w*tf32x3\w*)'", chunk)
            regs = re.search(r"Used (\d+) registers", chunk)
            spill = re.search(r"(\d+) bytes spill stores", chunk)
            if kernel and regs:
                print(f"[ptxas] {kernel[1]}: {regs[1]} registers, "
                      f"{spill[1] if spill else '?'} bytes spill stores",
                      flush=True)
        if sass:
            print_opcodes(lib)


def print_opcodes(lib: Path) -> None:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    for part in text.split("Function : ")[1:]:
        fname = part.split("\n", 1)[0].strip()
        if "tf32x3" not in fname:
            continue
        ops = collections.Counter(
            m.split(".")[0] for m in re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]*)",
                part))
        print(f"[sass] {fname}: {sum(ops.values())} instructions; "
              + ", ".join(f"{k} {v}" for k, v in ops.most_common(10)),
              flush=True)


def in_turns(fns: dict, reps: int) -> dict[str, float]:
    """Each of ``fns`` timed in turns, forwards then backwards: the mean."""
    order = list(fns) + list(reversed(fns))
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(cs.time_ms(fns[k], reps, 1))
    return {k: sum(v) / len(v) for k, v in times.items()}


def row(name: str, bodies: dict, library, plain, flops: float) -> dict:
    want = plain()
    errs = {}
    for b, fn in bodies.items():
        got = fn()
        if b == "tf32x3":
            errs[b] = float((got - want).abs().max())
            if not errs[b] <= cs.TF32X3_MAX_ERR:
                FAILED.append(f"{name} tf32x3 max abs err {errs[b]:.3e} > "
                              f"{cs.TF32X3_MAX_ERR}")
        else:
            errs[b] = cs.kernel_err(f"{name} {b}", got, want, "float32")
    ms = in_turns({**bodies, "library": library}, REPS[name])
    bounds = cs.fp32_op_bounds(flops)
    tflops = {k: flops / (v * 1e-3) / 1e12 for k, v in ms.items()}
    print(f"[tf32x3] {name}: " + "; ".join(
        f"{k} {v:.4f} ms ({tflops[k]:.1f} TFLOP/s)" for k, v in ms.items())
        + f"; bounds {bounds['tf32x3']:.4f} ms (3xTF32), "
        f"{bounds['cuda_cores']:.4f} ms (CUDA cores); max abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)
    return dict(name=name, ms=ms, tflops=tflops, bounds_ms=bounds, errs=errs)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--sass", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("check_torch_tf32x3: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    builds = build_rows()
    print_registers(args.sass)
    gen = torch.Generator(device="cuda").manual_seed(cs.KERNEL_TIME_SEED)
    rows = []
    for name, s, order in (("masa output_stationary", tc.MASA_JAMBA,
                            "output_stationary"),
                           ("masa weight_stationary", tc.MASA_WS_JAMBA,
                            "weight_stationary")):
        M, K, N = s["M"], s["K"], s["N"]
        a = torch.randn((M, K), generator=gen, device="cuda")
        b = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        rows.append(row(name, {
            b_: (lambda b_=b_: MK._launch(a, b, order, b_))
            for b_ in ("tf32x3", "simt")}, lambda: torch.matmul(a, b),
            lambda: MK.masa_gemm_plain(a, b), 2 * M * K * N))
        del a, b
    s = tc.MOE_JAMBA
    E, C, D, F, bt = s["E"], s["C"], s["D"], s["F"], s["bt"]
    x = torch.randn((E * C, D), generator=gen, device="cuda")
    w = torch.randn((E, D, F), generator=gen, device="cuda") * D ** -0.5
    eids = capacity_block_eids(E, C, bt, device="cuda")
    rows.append(row("moe", {
        b_: (lambda b_=b_: EK._launch(x, w, eids, bt, b_))
        for b_ in ("tf32x3", "simt")}, lambda: torch.bmm(x.view(E, C, D), w),
        lambda: EK.grouped_matmul_plain(x, w, eids, bt=bt),
        2 * E * C * D * F))
    del x, w
    torch.cuda.empty_cache()
    s = tc.FLASH_JAMBA
    B, S, H, Hkv, hd = s["B"], s["S"], s["H"], s["Hkv"], s["hd"]
    q = torch.randn((B, H, S, hd), generator=gen, device="cuda")
    k, v = (torch.randn((B, Hkv, S, hd), generator=gen, device="cuda")
            for _ in range(2))
    ke, ve = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    qf, kf, vf = (t.reshape(B * H, S, hd) for t in (q, ke, ve))
    rows.append(row("flash_attention", {
        b_: (lambda b_=b_: FK._launch(qf, kf, vf, True, b_))
        for b_ in ("tf32x3", "simt")},
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, ke, ve, is_causal=True),
        lambda: FK.flash_attention_plain(qf, kf, vf),
        4 * hd * B * H * S * (S + 1) // 2))
    sdpa = sdpa_kernels(q, ke, ve)
    print(f"[tf32x3] SDPA fp32 kernels: {sdpa}")
    del q, k, v, ke, ve, qf, kf, vf
    study = tile_study(builds, gen)
    print(smi)
    print(json.dumps({"card": smi, "rows": rows, "sdpa_kernels": sdpa,
                      "moe_tile_study": study}))
    if FAILED:
        sys.exit("check_torch_tf32x3: " + "; ".join(FAILED))


def sdpa_kernels(q, k, v) -> dict[str, float]:
    """The device kernels of one fp32 causal SDPA call, by name (µs)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True)
        torch.cuda.synchronize()
    return {e.key: (getattr(e, "device_time_total", None)
                    or getattr(e, "cuda_time_total", 0.0))
            for e in prof.key_averages()}


if __name__ == "__main__":
    main()
