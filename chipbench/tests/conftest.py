"""The benchmark's tests import the harness from the checkout's root and the
port from ``src``, as ``chipbench/run.py`` arranges it for a run."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
