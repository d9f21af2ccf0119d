"""One run of one cell: set-up, the measured window, the device trace when
asked, the check against the frozen reference, and the result line.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic are found by name
(``BENCHMARK.json``, ``configs/``, ``traffic/``), and each per-layer
metric by its reader in ``metrics/<name>.py``.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path

from chipbench.harness import check, generator, peaks, program
from chipbench.harness import trace as trace_mod
from chipbench.reference import jobs as ref_jobs

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
#: top-level modules that may not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_cell(name: str) -> tuple[dict, dict, dict, dict]:
    """``(benchmark, cell, config, traffic)`` by the cell's name."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the cells are "
                         f"{sorted(cells)}")
    cell = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads(
        (BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def readers(bench: dict, cell: str) -> dict:
    """The per-layer metrics this cell reports, name -> (unit, reader)."""
    out = {}
    for m in bench["per_layer"]:
        if cell not in m.get("workloads", (cell,)):
            continue
        spec = importlib.util.spec_from_file_location(
            f"chipbench_metric_{len(out)}", BENCH / "metrics" / f"{m['name']}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[m["name"]] = (m["unit"], mod.read)
    return out


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(config: dict, traffic: dict, *, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             workers: int | None = None) -> dict:
    """Set up, measure and check one cell on ``device``; returns the run's
    record (everything the result line and the readers need)."""
    import torch
    from repro_torch.core.dram import cuda_step

    torch.set_num_threads(1)
    prog = program.Program(config, device)
    jobs = generator.make_pass(config, traffic, seed)
    grids = [prog.grid(j) for j in jobs]
    t = time.perf_counter()
    for j in jobs:
        prog.make_traces(j)
    trace_gen_s = time.perf_counter() - t
    for j, g in zip(jobs, grids):                     # warm every shape
        prog.answers(j, prog.run(j, g))
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    launches0 = dict(cuda_step.LAUNCHES)
    done = []
    profiler = _profiler(torch) if trace else contextlib.nullcontext()
    with profiler as prof:
        t0 = time.perf_counter()
        i = 0
        while True:
            k = i % len(jobs)
            span = (torch.profiler.record_function(
                f"{trace_mod.SPAN}{jobs[k]['label']}")
                    if trace else contextlib.nullcontext())
            with span:
                answers, quarantined = prog.answers(
                    jobs[k], prog.run(jobs[k], grids[k]))
            done.append((k, answers, quarantined))
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
    window_s = t1 - t0
    launches = {k: v - launches0[k] for k, v in cuda_step.LAUNCHES.items()}
    record = dict(window_s=window_s, setup_s=setup_s,
                  trace_gen_s=trace_gen_s, launches=launches,
                  forbidden=forbidden_modules())
    record["device"] = _device(torch, device)
    if trace:
        record["trace"] = trace_mod.reduce(prof)
    del grids, prof
    if device == "cuda":
        torch.cuda.empty_cache()

    record["requests"] = sum(generator.requests(jobs[k]) for k, _, _ in done)
    work: dict = {}
    for k, _, _ in done:
        for kernel, steps, nbytes in generator.launches(jobs[k]):
            w = work.setdefault(kernel, dict(launches=0, steps=0, bytes=0))
            w["launches"] += 1
            w["steps"] += steps
            w["bytes"] += nbytes
    record["work"] = work

    # the check: every completed job against the reference's answers
    ran = sorted({k for k, _, _ in done})
    t = time.perf_counter()
    expected = dict(zip(ran, ref_jobs.expected([jobs[k] for k in ran],
                                               config, workers=workers)))
    record["reference_s"] = time.perf_counter() - t
    wrong = missing = failed = attempted = 0
    for k, answers, quarantined in done:
        w_, m_, cells_failed = check.compare(expected[k], answers)
        wrong, missing = wrong + w_, missing + m_
        attempted += len(generator.cells(jobs[k]))
        failed += max(len(cells_failed), quarantined)
    record.update(checks=dict(answers_wrong=wrong, answers_missing=missing),
                  attempted=attempted, failed=failed, jobs=len(done))
    return record


def _profiler(torch):
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _device(torch, device: str) -> dict:
    if device != "cuda":
        return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=1,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(0)))


def context(record: dict) -> dict:
    """What the per-layer readers read."""
    tr = record.get("trace") or {}
    return dict(window_s=record["window_s"], busy_s=tr.get("busy_s"),
                device_s=tr.get("device_s", {}), launches=record["launches"],
                work=record["work"], trace_gen_s=record["trace_gen_s"],
                hbm_bytes_per_s=peaks.hbm_bytes_per_s(
                    record["device"]["kind"]))


def result_line(bench: dict, cell: dict, record: dict, trace: bool) -> dict:
    correct = (record["jobs"] > 0 and all(
        record["checks"][k] <= lim for k, lim in check.LIMITS.items()))
    metrics = {}
    if trace:
        ctx = context(record)
        for name, (unit, read) in readers(bench, cell["name"]).items():
            value = read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
    else:
        end_to_end = {m["name"]: m for m in bench["end_to_end"]
                      if cell["name"] in m.get("workloads", (cell["name"],))}
        values = {"sim_req_per_s": record["requests"] / record["window_s"],
                  "setup_s": record["setup_s"]}
        metrics = {k: {"value": values[k], "unit": m["unit"]}
                   for k, m in end_to_end.items()}
    device = dict(record["device"])
    line = dict(correct=correct, attempted=record["attempted"],
                failed=record["failed"], metrics=metrics, device=device)
    if trace:
        tr = record["trace"]
        device.update(busy_s=tr["busy_s"], window_s=record["window_s"])
        line["breakdown"] = dict(device_ops=tr["device_ops"],
                                 idle_gaps=tr["idle_gaps"])
    line["checks"] = {k: {"value": record["checks"][k], "limit": lim}
                      for k, lim in check.LIMITS.items()}
    return line


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, cell, config, traffic = load_cell(args.workload)

    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    record = run_cell(config, traffic, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda", t_start=t_start)
    bad = sorted(set(record["forbidden"]) | set(forbidden_modules()))
    if bad:
        print(f"the run loaded {bad}, which the port may not load",
              file=sys.stderr)
        return 3
    line = result_line(bench, cell, record, bool(args.trace))
    print(f"jobs {record['jobs']} window_s {record['window_s']:.4f} "
          f"reference_s {record['reference_s']:.2f} launches "
          f"{record['launches']}", file=sys.stderr)
    for s in check.lines(record["checks"]):
        print(s, file=sys.stderr)
    print(json.dumps(line))
    return 0
