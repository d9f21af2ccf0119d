"""The port never imports JAX or the JAX package.

``repro_torch`` and ``chip_smoke.py`` must run on a machine without JAX.
Checked twice: statically (every import statement, including the ones
inside functions) and at run time in a fresh interpreter that imports
every module of the port (``pkgutil.walk_packages`` reaches every
subpackage: the sweep layer, ``fault`` and ``benchmarks`` included). The
repo's top-level ``benchmarks`` package imports the JAX package, so the
port's own ``repro_torch.benchmarks`` must not import it either.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def port_sources():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_cases.py",
        ROOT / "tests" / "check_torch_serve.py"]


#: Top-level packages the port never imports: JAX, and the JAX package and
#: its benches.
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_no_jax_or_reference_imports_in_the_source():
    bad = []
    for path in port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if forbidden(n)]
    assert not bad, bad


def test_importing_every_module_leaves_jax_out():
    code = f"""
import importlib, json, pkgutil, sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT / 'tests')!r}, {str(ROOT)!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
import torch_cases, check_torch_serve, chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in {FORBIDDEN!r})
print(json.dumps(dict(modules=names, leaked=leaked)))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    assert {"repro_torch.core.dram.cuda_step", "repro_torch.core.dram.engine",
            "repro_torch.core.dram.multicore",
            "repro_torch.core.dram.schedulers",
            "repro_torch.paper_repro", "repro_torch.interop",
            "repro_torch.compat", "repro_torch.cuda_build",
            "repro_torch.configs.registry", "repro_torch.core.salp.cost_model",
            "repro_torch.kernels.ssd_scan.kernel",
            "repro_torch.kernels.ssd_scan.ops", "repro_torch.models.builder",
            "repro_torch.models.ssm", "repro_torch.models.attention",
            "repro_torch.models.moe", "repro_torch.serve_salp",
            "repro_torch.serve.engine",
            "repro_torch.serve.steps", "repro_torch.launch.serve",
            "repro_torch.kernel_bench",
            "repro_torch.kernels.masa_gemm.kernel",
            "repro_torch.kernels.masa_gemm.ops",
            "repro_torch.kernels.masa_gemm.ref",
            "repro_torch.kernels.moe_gemm.kernel",
            "repro_torch.kernels.moe_gemm.ops",
            "repro_torch.kernels.moe_gemm.ref",
            "repro_torch.kernels.paged_attention.kernel",
            "repro_torch.kernels.paged_attention.ops",
            "repro_torch.kernels.paged_attention.ref",
            "repro_torch.kernels.flash_attention.kernel",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.flash_attention.ref",
            "repro_torch.kernels.dispatch",
            "repro_torch.fault", "repro_torch.fault.watchdog",
            "repro_torch.experiments", "repro_torch.experiments.grid",
            "repro_torch.experiments.artifact",
            "repro_torch.experiments.cache",
            "repro_torch.experiments.resilience",
            "repro_torch.experiments.sharding",
            "repro_torch.experiments.runner", "repro_torch.serve.what_if",
            "repro_torch.benchmarks", "repro_torch.benchmarks.common",
            "repro_torch.benchmarks.fig4_ipc",
            "repro_torch.benchmarks.sched_bench",
            } <= set(out["modules"])


def test_importing_multicore_alone_leaves_jax_out():
    code = f"""
import json, sys
sys.path[:0] = [{str(ROOT / 'src')!r}]
import repro_torch.core.dram.multicore
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps(leaked))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
