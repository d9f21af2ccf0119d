"""Nothing the run imports is JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's), and the
frozen reference imports nothing of the program."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "chipbench"


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in BENCH.rglob("*.py")))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imports(ROOT / path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix() for p in (BENCH / "reference").glob("*.py")))
def test_reference_imports_nothing_of_the_program(path):
    assert _imports(ROOT / path) <= {"__future__", "dataclasses", "json",
                                     "zlib", "pathlib", "multiprocessing",
                                     "os", "numpy", "chipbench"}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole small run of each cell in a fresh process, then a look at
    ``sys.modules`` by top-level name."""
    code = f"""
import sys, time, json
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from chipbench.harness import main
from chipbench.reference import jobs, frontend, dram
before = set(sys.modules)
for cell, small in (("fig4-1core", dict(workloads=["gamess"], instructions=5000)),
                    ("sched-4core", dict(n_requests=8))):
    bench, c, config, traffic = main.load_cell(cell)
    traffic = dict(traffic, **small)
    if cell == "sched-4core":
        traffic["mixes"] = traffic["mixes"][:1]
    rec = main.run_cell(config, traffic, seed=3, seconds=0.0, trace=False,
                        device="cpu", t_start=time.perf_counter(), workers=1)
    assert main.result_line(bench, c, rec, False)["correct"]
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_without_the_program():
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}]\n"
            "import chipbench.reference.jobs\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout
    assert "repro_torch" not in out and "torch" not in out
