"""The port's one builder for its hand-written CUDA kernels.

Every kernel family keeps its sources in a ``csrc/`` directory beside its
wrapper (``core/dram/csrc/`` for the lane and mix kernels,
``kernels/ssd_scan/csrc/`` for the SSD scan). :func:`build` compiles each
``.cu`` source with ``nvcc`` for ``sm_90a`` into its own shared library
with a plain C interface, one ``nvcc`` per source, all started together,
under ``build/repro_torch_kernels/`` at the repository root (``.gitignore``
lists ``build/``). A library is named by a hash of every file in its own
``csrc/`` directory and the flags, so an edit to a source or a header it
includes rebuilds it, and an up-to-date library is reused. :func:`load`
opens one with ``ctypes``; the family's wrapper declares its argument
types. Nothing is built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Mapping

from repro_torch import compat

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def source_tag(csrc: Path) -> str:
    """Hash of every source and header in ``csrc`` and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(Path(csrc).glob("*.cu*")):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str, src: Path) -> Path:
    """Where ``src`` builds to: its name and its directory's tag."""
    return BUILD_DIR / f"{name}_{source_tag(Path(src).parent)}.so"


def build(sources: Mapping[str, Path]) -> dict[str, tuple[Path, str]]:
    """Compile every ``{name: source}`` that is not built yet, one ``nvcc``
    per source, all started together. Returns ``{name: (library path,
    compiler log)}``; the log is ``-Xptxas -v``'s (registers, spills).
    Raises with the compiler's output if a build fails."""
    nvcc = compat.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from source at first use (" + compat.summary() + ")")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, {}
    for name, src in sources.items():
        lib = library_path(name, src)
        log_path = lib.with_suffix(".log")
        if lib.exists() and log_path.exists():
            out[name] = (lib, log_path.read_text())
            continue
        # build under a temporary name, then rename: a concurrent build
        # never sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, lib, log_path)
    failed = []
    for name, (proc, tmp, lib, log_path) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed to build {Path(sources[name]).name} "
                          f"(rc={proc.returncode}):\n{log}")
            continue
        log_path.write_text(log)
        os.replace(tmp, lib)
        out[name] = (lib, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str, src: Path) -> ctypes.CDLL:
    """The library built from ``src`` (built first if need be), opened
    once per process."""
    return ctypes.CDLL(str(build({name: src})[name][0]))
