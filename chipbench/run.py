"""Run one cell of the benchmark once; see ``chipbench/README.md``.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
import time

START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chipbench.harness.main import main
    sys.exit(main(t_start=START))
