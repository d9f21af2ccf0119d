"""The DRAM kernels' global bodies against another checkout's, on the card.

    mkdir -p build/against && git archive <commit> | tar -x -C build/against
    python3 tests/check_torch_dram_global.py build/against [--sass DIR]

Needs an NVIDIA H100 (sm_90a) and nvcc; not a test (pytest does not collect
it). Builds the lane and mix kernels of the checkout at the given root
(``src/repro_torch/core/dram/csrc/``) with the port's nvcc flags under
``build/dram_against/``, and this tree's through ``cuda_step.build()``, and
prints ptxas's registers, spills and stack frames of both. It calls the
other checkout's C entries by their parameter names, read from its source,
with the global body where they take a body (one chain a block where they
take that too), so a checkout from before the bodies existed (one thread a
chain, its state in a scratch buffer) runs as it ran there.

At each shape it holds the other build's outputs equal to this tree's global
body, then times the other build, this tree's global body and its smem body
with ``chip_smoke.time_ms`` in turns (other, global, smem, smem, global,
other), with nvidia-smi's SM clock sampled: the lane kernel at Fig. 4 (B 32
x N 8000, each of the 5 policies), the mix kernel at the multicore bench
shape (M 4 x C 4 x N 1500, each of run_multicore's 7 points) and at M 256 x
C 4 x N 8000 (MASA, FR-FCFS). It prints the card's name and power limit and
one JSON line of the means. With ``--sass DIR`` it also writes
``cuobjdump -sass`` of both builds' libraries there.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tests")]
import chip_smoke as cs  # noqa: E402
from repro_torch import compat, cuda_build  # noqa: E402
from repro_torch.core.dram import cuda_step  # noqa: E402
from repro_torch.core.dram import state_layout as L  # noqa: E402

CSRC = Path("src/repro_torch/core/dram/csrc")
OUT = ROOT / "build" / "dram_against"

#: The C entries' pointer parameters (every other one is an int).
PTRS = {"xs", "reqs", "mlp", "rank", "timing", "scratch", "sc_out",
        "vis_out", "max_out", "stream"}


def c_entry(src: str, name: str) -> list[str]:
    """The parameter names of the C entry ``name`` in ``src``."""
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    return [p.split()[-1].lstrip("*") for p in params.split(",")]


class Other:
    """The lane and mix kernels of another checkout, called by name."""

    def __init__(self, root: Path):
        OUT.mkdir(parents=True, exist_ok=True)
        procs, self.logs, self.libs, self.params = {}, {}, {}, {}
        for name in cuda_step.SOURCES:
            src = root / CSRC / f"{name}.cu"
            self.params[name] = c_entry(src.read_text(), f"{name}_launch")
            procs[name] = subprocess.Popen(
                [compat.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                 str(OUT / f"{name}.so"), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, proc in procs.items():
            self.logs[name], _ = proc.communicate()
            if proc.returncode:
                sys.exit(f"nvcc failed on the other {name}:\n"
                         f"{self.logs[name]}")
            lib = ctypes.CDLL(str(OUT / f"{name}.so"))
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = [ctypes.c_void_p if p in PTRS else ctypes.c_int
                           for p in self.params[name]]
            fn.restype = ctypes.c_int
            self.libs[name] = lib

    def call(self, name: str, scratch_ints: int, rows: int, shape: tuple,
             **values):
        """One launch; ``values`` by parameter name, outputs made here."""
        dev = torch.device("cuda")
        scratch = torch.empty((rows, scratch_ints), dtype=torch.int32,
                              device=dev)
        out = (torch.empty((rows, L.SC_F), dtype=torch.int32,
                           device=dev),
               torch.empty(shape, dtype=torch.int32, device=dev),
               torch.empty(shape, dtype=torch.int32, device=dev))
        values.update(scratch=scratch.data_ptr(), sc_out=out[0].data_ptr(),
                      vis_out=out[1].data_ptr(), max_out=out[2].data_ptr(),
                      body=0, chain_bytes=0, warps=1,
                      stream=torch.cuda.current_stream().cuda_stream)
        err = getattr(self.libs[name], f"{name}_launch")(
            *(values[p] for p in self.params[name]))
        if err:
            sys.exit(f"the other {name} failed to launch: CUDA error {err}")
        return out

    def lane(self, eff, nb, ns, config, xs, mlp):
        lib = self.libs["lane_step"]
        lib.lane_scratch_ints.restype = ctypes.c_int
        ints = lib.lane_scratch_ints(nb, ns, config.refresh_mode)
        timing = cuda_step.timing_array(config.timing, xs.device)
        return self.call("lane_step", ints, xs.shape[0], (xs.shape[0],),
                         xs=xs.data_ptr(), mlp=mlp.data_ptr(),
                         timing=timing.data_ptr(), B=xs.shape[0],
                         N=xs.shape[1], nb=nb, ns=ns, policy=int(eff),
                         refresh_mode=config.refresh_mode,
                         closed_row=int(config.row_policy == "closed"))

    def mix(self, args, config):
        eff, sched, nb, ns, reqs, mlp, rank = args
        M, C, N = reqs.shape[:3]
        lib = self.libs["mix_step"]
        lib.mix_scratch_ints.restype = ctypes.c_int
        ints = lib.mix_scratch_ints(nb, ns, C, config.refresh_mode)
        timing = cuda_step.timing_array(config.timing, reqs.device)
        return self.call("mix_step", ints, M, (M, C), reqs=reqs.data_ptr(),
                         mlp=mlp.data_ptr(), rank=rank.data_ptr(),
                         timing=timing.data_ptr(), M=M, C=C, N=N, nb=nb,
                         ns=ns, policy=int(eff), scheduler=int(sched),
                         refresh_mode=config.refresh_mode,
                         closed_row=int(config.row_policy == "closed"))


def in_turns(launch: dict, reps: int, warmup: int) -> dict:
    """Mean ms of each ``launch[name]()``: other, global, smem, smem,
    global, other."""
    order = ["other", "global", "smem"]
    times = {n: [] for n in order}
    for name in order + order[::-1]:
        times[name].append(cs.time_ms(launch[name], reps, warmup))
    return {n: sum(t) / len(t) for n, t in times.items()}


def same(name: str, got, want) -> None:
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        sys.exit(f"{name}: the other build and this tree's global body "
                 f"differ")


def fig4(other: Other) -> dict:
    from repro_torch import paper_repro as pr
    from repro_torch.core.dram import SimConfig, stack_traces
    from repro_torch.core.dram.engine import lane_inputs

    config = SimConfig()
    stacked = stack_traces(pr.fig4_traces(cs.FIG4_N, cs.FIG4_SEED))
    rows = []
    for pol in pr.POLICIES:
        a = lane_inputs(stacked, pol, config, torch.device("cuda"))
        same(f"fig4 {pol.name}", other.lane(*a[:3], config, *a[3:]),
             cs.lane_launch(*a[:3], config, *a[3:], body="global"))
        rows.append(in_turns({
            "other": lambda a=a: other.lane(*a[:3], config, *a[3:]),
            "global": lambda a=a: cs.lane_launch(*a[:3], config, *a[3:],
                                                 body="global"),
            "smem": lambda a=a: cs.lane_launch(*a[:3], config, *a[3:],
                                               body="smem")}, 10, 2))
        print(f"fig4 {pol.name:8s} B=32 N={cs.FIG4_N}: " + ", ".join(
            f"{n} {t:.4f}" for n, t in rows[-1].items()) + " ms", flush=True)
    return {n: sum(r[n] for r in rows) / len(rows) for n in rows[0]}


def mixes(other: Other) -> tuple[dict, dict]:
    from repro_torch import paper_repro as pr
    from repro_torch.core.dram import Policy, Scheduler

    points = ([(pol, Scheduler.FRFCFS) for pol in pr.POLICIES]
              + [(Policy.BASELINE, Scheduler.TCM),
                 (Policy.MASA, Scheduler.TCM)])
    rows = []
    for pol, sched in points:
        a, cfg = cs.mix_bench_args(pol, sched, pr.MULTICORE_N, [cs.FIG4_SEED])
        same(f"bench {pol.name} {sched.name}", other.mix(a, cfg),
             cs.mix_launch(a, cfg, "global"))
        rows.append(in_turns({
            "other": lambda a=a, c=cfg: other.mix(a, c),
            "global": lambda a=a, c=cfg: cs.mix_launch(a, c, "global"),
            "smem": lambda a=a, c=cfg: cs.mix_launch(a, c, "smem")}, 10, 2))
        print(f"bench {pol.name:8s} {sched.name:6s} M=4 C=4 "
              f"N={pr.MULTICORE_N}: " + ", ".join(
                  f"{n} {t:.4f}" for n, t in rows[-1].items()) + " ms",
              flush=True)
    bench = {n: sum(r[n] for r in rows) / len(rows) for n in rows[0]}
    seeds = range(cs.FIG4_SEED, cs.FIG4_SEED + cs.MIX_THROUGHPUT_SEEDS)
    a, cfg = cs.mix_bench_args(Policy.MASA, Scheduler.FRFCFS,
                               cs.MIX_THROUGHPUT_N, seeds)
    same("M 256", other.mix(a, cfg), cs.mix_launch(a, cfg, "global"))
    wide = in_turns({"other": lambda: other.mix(a, cfg),
                     "global": lambda: cs.mix_launch(a, cfg, "global"),
                     "smem": lambda: cs.mix_launch(a, cfg, "smem")}, 3, 1)
    print(f"M={a[4].shape[0]} C=4 N={cs.MIX_THROUGHPUT_N} MASA FR-FCFS: "
          + ", ".join(f"{n} {t:.4f}" for n, t in wide.items()) + " ms",
          flush=True)
    return bench, wide


def registers(label: str, name: str, log: str) -> None:
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"[ptxas] {label} {name}: {line.strip()}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", type=Path, help="root of the other checkout")
    ap.add_argument("--sass", type=Path, help="write cuobjdump -sass here")
    opts = ap.parse_args()
    reason = compat.kernel_unavailable_reason()
    if reason:
        sys.exit(reason)
    other = Other(opts.root)
    mine = cuda_step.build()
    for name in cuda_step.SOURCES:
        registers("other", name, other.logs[name])
        registers("this tree", name, mine[name][1])
    if opts.sass:
        opts.sass.mkdir(parents=True, exist_ok=True)
        tool = Path(compat.nvcc_path()).with_name("cuobjdump")
        for name in cuda_step.SOURCES:
            for label, lib in (("other", OUT / f"{name}.so"),
                               ("this", mine[name][0])):
                with open(opts.sass / f"{label}_{name}.sass", "w") as f:
                    subprocess.run([str(tool), "-sass", str(lib)], stdout=f,
                                   check=True)
    with cs.SmClock() as clock:
        lane = fig4(other)
        bench, wide = mixes(other)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"fig4_lane_ms": lane, "bench_mix_ms": bench,
                      "m256_mix_ms": wide, "clock_mhz": clock.mhz,
                      "card": smi}))


if __name__ == "__main__":
    main()
