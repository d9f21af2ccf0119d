"""Run one cell several times, each run a process of its own, and report
each run's result and each end-to-end metric's spread.

    python3 chipbench/tools/series.py --workload fig4-1core --seeds 11,12,13 \
        --seconds 20 [--trace 1] [--out chiprun_out/fig4.jsonl]

The spread is the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median. Each
run's record (its seed, exit code, wall time, result line and the end of
its standard error) is appended to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip()
    except FileNotFoundError:
        return "no nvidia-smi"


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    print(f"card: {card()}", flush=True)
    values: dict[str, list[float]] = {}
    for seed in args.seeds.split(","):
        t = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "chipbench/run.py", "--workload", args.workload,
             "--seed", seed, "--seconds", str(args.seconds), "--trace",
             str(args.trace)], cwd=ROOT, capture_output=True, text=True,
            check=False)
        wall = time.perf_counter() - t
        out = p.stdout.strip().splitlines()
        line = json.loads(out[-1]) if p.returncode == 0 and out else None
        rec = dict(workload=args.workload, seed=int(seed), trace=args.trace,
                   rc=p.returncode, wall_s=wall, result=line,
                   stderr=p.stderr[-3000:])
        if args.out:
            with open(ROOT / args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        tail = " | ".join(p.stderr.strip().splitlines()[-4:])
        if line is None:
            print(f"seed {seed} rc {p.returncode} wall {wall:.1f}s: {tail}",
                  flush=True)
            continue
        ms = {k: v["value"] for k, v in line["metrics"].items()}
        for k, v in ms.items():
            values.setdefault(k, []).append(v)
        print(f"seed {seed} rc 0 wall {wall:.1f}s correct {line['correct']} "
              f"{json.dumps(ms)} device {json.dumps(line['device'])} | "
              f"{tail}", flush=True)
        if "breakdown" in line:
            print(f"  breakdown {json.dumps(line['breakdown'])}", flush=True)
    for k, vs in values.items():
        if len(vs) >= 2:
            print(f"{k}: median {statistics.median(vs)!r} spread "
                  f"{spread(vs):.4%} over {len(vs)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
