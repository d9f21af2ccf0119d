"""Where the wgmma flash-attention body's time goes, on the card.

    python3 tests/check_torch_flash_parts.py

Needs an NVIDIA H100 (sm_90a) and nvcc; not a test (pytest does not collect
it). Builds three variants of ``kernels/flash_attention/csrc/
flash_attention.cu`` with the port's nvcc flags, under
``build/flash_parts/``: the kernel as it is (``full``), the kernel with its
online softmax cut out (``no_softmax``: the raw scores go to P V as they
are), and the kernel with its P V products cut out (``no_pv``). The cut
variants compute nothing useful; they show what each part costs. Each is
timed with ``chip_smoke.time_ms`` (CUDA events, the calls queued behind a
sleep kernel) at jamba-v0.1-52b's attention shape (B 1, S 2048, 32 query
heads on 8 kv heads of 128, causal, bf16, the kv heads indexed in the
kernel), in turns (full, no_softmax, no_pv, then backwards, then again),
and printed with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
from chip_smoke import time_ms  # noqa: E402
from repro_torch import compat, cuda_build  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import declare  # noqa: E402

SRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
HEADER = ROOT / "src/repro_torch/kernels/csrc/hopper_gemm.cuh"
OUT = ROOT / "build" / "flash_parts"
B, S, H, HKV, HD = 1, 2048, 32, 8, 128


def variants() -> dict[str, str]:
    """The three sources, each cut between markers of the wgmma body."""
    text = SRC.read_text().replace('"../../csrc/hopper_gemm.cuh"',
                                   f'"{HEADER}"')

    def cut(start: str, end: str) -> str:
        i, j = text.index(start), text.index(end)
        return text[:i] + text[j:]

    return {
        "full": text,
        "no_softmax": cut("    // ---- the online softmax",
                          "    uint32_t pa[8][4];"),
        "no_pv": cut("#pragma unroll\n    for (int kk = 0; kk < 8; ++kk) {\n"
                     "      const uint64_t dv",
                     "    wgmma_commit();\n    wgmma_wait_all();\n"
                     "    fence_regs(o);"),
    }


def build() -> dict[str, ctypes.CDLL]:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants().items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [compat.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
             str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on the {name} variant:\n{log}")
        libs[name] = declare(ctypes.CDLL(str(OUT / f"{name}.so")))
    return libs


def main() -> None:
    reason = compat.kernel_unavailable_reason()
    if reason:
        sys.exit(reason)
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(14)
    q, k, v = (torch.randn((B * h, S, HD), generator=gen, device="cuda")
               .bfloat16() for h in (H, HKV, HKV))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(name: str) -> None:
        err = libs[name].flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H,
            S, HD, 1, HD ** -0.5, 1, 1, H // HKV, stream)
        if err:
            sys.exit(f"{name}: launch failed with {err}")

    flops = 4 * HD * B * H * S * (S + 1) // 2
    times = {n: [] for n in libs}
    for order in (list(libs), list(libs)[::-1], list(libs)):
        for name in order:
            times[name].append(time_ms(lambda: launch(name), reps=50,
                                       warmup=3))
    for name, ts in times.items():
        print(f"{name}: {', '.join(f'{t:.4f}' for t in ts)} ms; best "
              f"{min(ts):.4f} ms = {flops / min(ts) / 1e9:.0f} TFLOP/s of "
              f"the whole forward's work")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
