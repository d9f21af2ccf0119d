"""Capability probe for the port's kernels (the analogue of ``repro.compat``).

Reports what the machine offers the hand-written kernels: a CUDA device,
its compute capability (the kernels are built for ``sm_90a``, so they need
9.0), the ``nvcc`` that builds them, and whether Triton is installed. Kernel
tests and ``chip_smoke.py`` use it to say why they skip or fail. Probing
imports nothing from CUDA and builds nothing. :func:`resolve_device` turns
an entry point's ``device`` argument into the device the port runs on.
"""
from __future__ import annotations

import importlib.util
import os
import shutil
from pathlib import Path

import torch

#: The compute capability the kernels are built for (``sm_90a``).
REQUIRED_CAPABILITY = (9, 0)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without one, only an explicit CPU runs. An
    explicit ``"meta"`` (shapes without data: the dry-run) is taken too."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch version")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def nvcc_path() -> str | None:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the toolkit's
    default location; None when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    return None


def probe() -> dict:
    """What the kernels can use here, as a plain dict."""
    cuda = torch.cuda.is_available()
    cap = torch.cuda.get_device_capability(0) if cuda else None
    return dict(
        torch=torch.__version__,
        torch_cuda=torch.version.cuda,
        cuda=cuda,
        device_count=torch.cuda.device_count() if cuda else 0,
        device_name=torch.cuda.get_device_name(0) if cuda else None,
        capability=cap,
        sm90=cap == REQUIRED_CAPABILITY,
        nvcc=nvcc_path(),
        triton=importlib.util.find_spec("triton") is not None,
    )


def kernel_unavailable_reason() -> str | None:
    """Why the CUDA kernels cannot run here, or None when they can."""
    p = probe()
    if not p["cuda"]:
        return (f"needs an NVIDIA GPU: torch {p['torch']} sees no CUDA "
                f"device")
    if not p["sm90"]:
        return (f"needs compute capability 9.0 (sm_90a), found "
                f"{p['capability']} on {p['device_name']}")
    if p["nvcc"] is None:
        return "needs nvcc to build the kernels from source; none found"
    return None


def summary() -> str:
    p = probe()
    return ", ".join(f"{k}={v}" for k, v in p.items())
