"""The control of the check: the frozen reference put in the program's
place at a coarser timing resolution, judged by the same comparison.

    python3 chipbench/tools/control.py --workload fig4-1core --seeds 1,2,3 \
        [--quantum 2] [--workers 8]

The simulator states its timing in whole DRAM command cycles and computes
in exact int32. The step below that resolution is to count in pairs of
cycles: every timing constant and every compute gap rounded up to a
multiple of ``--quantum``. For each seed this prints how many of a full
pass's answers the control gets wrong (``answers_wrong``) against the
reference at full resolution; the check's limit is 0, so any reading above
it comes out not correct.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[2])]

from chipbench.harness import check, generator  # noqa: E402
from chipbench.harness.main import load_cell  # noqa: E402
from chipbench.reference import jobs as ref_jobs  # noqa: E402


def control_reading(config: dict, traffic: dict, seed: int, quantum: int,
                    workers: int | None = None) -> dict:
    """``answers_wrong`` and ``answers_missing`` of the control over one
    pass, and the number of answers compared."""
    jobs = generator.make_pass(config, traffic, seed)
    exact = ref_jobs.expected(jobs, config, workers=workers)
    coarse = ref_jobs.expected(jobs, config, quantum=quantum, workers=workers)
    wrong = missing = answers = 0
    for want, have in zip(exact, coarse):
        w, m, _ = check.compare(want, have)
        wrong, missing = wrong + w, missing + m
        answers += sum(len(v) if isinstance(v, tuple) else 1
                       for v in want.values())
    return dict(answers_wrong=wrong, answers_missing=missing,
                answers=answers)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--quantum", type=int, default=2)
    ap.add_argument("--workers", type=int, default=None)
    args = ap.parse_args()
    _, _, config, traffic = load_cell(args.workload)
    for seed in args.seeds.split(","):
        t = time.perf_counter()
        r = control_reading(config, traffic, int(seed), args.quantum,
                            args.workers)
        print(f"{args.workload} seed {seed} quantum {args.quantum}: "
              f"control answers_wrong {r['answers_wrong']} answers_missing "
              f"{r['answers_missing']} of {r['answers']} answers "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
