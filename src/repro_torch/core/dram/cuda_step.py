"""The CUDA lane kernel: batched single-core simulation on the card.

The counterpart of ``repro.core.dram.pallas_step`` (its lane kernel,
``_simulate_lanes_pallas``). ``csrc/lane_step.cu`` runs B independent
single-core traces, one CUDA thread per lane, each looping over its N
requests through the controller step and the bank/subarray timing step;
only the ``[B, SC_F]`` counter pack, ``vis_prev`` and ``max_comp`` leave
the kernel.

* :func:`simulate_lanes` is the wrapper every entry point calls. On a CUDA
  tensor it launches the kernel (or raises); on a CPU tensor it runs the
  plain version. It never falls back from the kernel to the plain version.
* :func:`simulate_lanes_plain` is the plain PyTorch version of the same
  function (:func:`repro_torch.core.dram.controller.run_lanes`), on any
  device: the CPU tests use it, and ``chip_smoke.py`` holds the kernel
  against it on the card.
* ``LAUNCHES`` counts kernel launches, so a run can show that its path went
  through the kernel.

Build: at first use the source is compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface under ``build/repro_torch_kernels/``
at the repository root (``.gitignore`` lists ``build/``), named by a hash of
the source and flags, and loaded with ``ctypes``. Nothing is built or
imported from CUDA when this module is imported.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch import compat
from repro_torch.core.dram import controller as _controller
from repro_torch.core.dram import engine as _engine
from repro_torch.core.dram import state_layout as L
from repro_torch.core.dram.timing import DramTiming

SOURCE = Path(__file__).resolve().parent / "csrc" / "lane_step.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: The timing array's layout: DramTiming's fields in declaration order, as
#: the T_* constants of lane_step.cu index it.
TIMING_FIELDS = ("t_cl", "t_cwl", "t_rcd", "t_rp", "t_ras", "t_wr", "t_rtp",
                 "t_bl", "t_ccd", "t_wtr", "t_rtw", "t_rrd", "t_rrd_sa",
                 "t_faw", "t_sa", "t_refi", "t_rfc", "t_rfc_pb",
                 "ref_postpone_max")

#: Kernel launches by kernel name (set to 0 with :func:`reset_launches`).
LAUNCHES: dict[str, int] = {"lane_step": 0}

#: Human-readable refusal reason for command export.
EMIT_COMMANDS_ERROR = (
    "The CUDA lane kernel refuses emit_commands: the kernel keeps the "
    "per-step state on the card and returns only the final counters, so "
    "there is no per-step command log to decode; command export is not "
    "ported yet — use the JAX package's repro.core.dram.commands.")


def check_no_emit(config) -> None:
    """Raise if ``config`` asks for a command-stream export."""
    if config.emit_commands:
        raise ValueError(EMIT_COMMANDS_ERROR)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def build() -> tuple[Path, str]:
    """Compile ``lane_step.cu`` (once per process and source); return the
    library's path and the compiler's log (``-Xptxas -v``: registers,
    spills). Raises with the compiler's output if the build fails."""
    nvcc = compat.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA lane kernel is built "
                           "from source at first use (" + compat.summary() + ")")
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"lane_step_{tag}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists() and log_path.exists():
        return lib, log_path.read_text()
    # build under a temporary name, then rename: a concurrent build never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {SOURCE.name} "
                           f"(rc={proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return lib, log


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lane_step_launch.argtypes = [vp] * 7 + [ci] * 7 + [vp]
    lib.lane_step_launch.restype = ci
    lib.lane_scratch_ints.argtypes = [ci, ci, ci]
    lib.lane_scratch_ints.restype = ci
    return lib


def timing_array(t: DramTiming, device) -> torch.Tensor:
    """The kernel's ``[19]`` int32 timing array."""
    names = tuple(f.name for f in dataclasses.fields(DramTiming))
    if names != TIMING_FIELDS:
        raise RuntimeError(f"DramTiming fields {names} no longer match the "
                           f"kernel's timing layout {TIMING_FIELDS}")
    return torch.tensor([int(getattr(t, n)) for n in names],
                        dtype=torch.int32, device=device)


def _check_inputs(xs, mlp, nb: int, ns: int, t: DramTiming,
                  refresh_mode: int) -> None:
    if xs.dtype != torch.int32 or mlp.dtype != torch.int32:
        raise TypeError(f"lane kernel takes int32 tensors, got xs {xs.dtype}, "
                        f"mlp {mlp.dtype}")
    if xs.dim() != 3 or xs.shape[2] != L.RQ_F or mlp.shape != (xs.shape[0],):
        raise ValueError(f"lane kernel takes xs [B, N, {L.RQ_F}] and mlp "
                         f"[B]; got {tuple(xs.shape)} and {tuple(mlp.shape)}")
    if not (xs.is_contiguous() and mlp.is_contiguous()):
        raise ValueError("lane kernel takes contiguous tensors")
    if xs.device != mlp.device:
        raise ValueError(f"xs on {xs.device} but mlp on {mlp.device}")
    if nb < 1 or ns < 1:
        raise ValueError(f"geometry must be at least 1 x 1, got {nb} x {ns}")
    if refresh_mode and (t.t_refi <= 0 or (refresh_mode == 4
                                           and t.t_rfc_pb <= 0)):
        raise ValueError(f"refresh mode {refresh_mode} divides by t_refi "
                         f"and t_rfc_pb, which must be positive")


def simulate_lanes(policy: int, n_banks: int, n_subarrays: int,
                   t: DramTiming, refresh_mode: int, xs, mlp,
                   closed_row: bool = False):
    """B single-core traces: the lane kernel on a CUDA tensor, its plain
    version on a CPU tensor.

    ``xs`` is the ``[B, N, RQ_F]`` int32 request tensor (bank, subarray, row,
    is_write, gap, dep) and ``mlp`` the ``[B]`` int32 windows. ``policy`` is
    BASELINE / SALP1 / SALP2 / MASA (IDEAL runs as BASELINE on its rewritten
    geometry). Returns ``(SimResult with [B] fields, max_comp [B])``.
    """
    _check_inputs(xs, mlp, n_banks, n_subarrays, t, refresh_mode)
    if xs.device.type == "cpu":
        sc, vis, maxc = simulate_lanes_plain(policy, n_banks, n_subarrays, t,
                                             refresh_mode, xs, mlp, closed_row)
    elif xs.device.type == "cuda":
        sc, vis, maxc = _launch(policy, n_banks, n_subarrays, t,
                                refresh_mode, xs, mlp, closed_row)
    else:
        raise ValueError(f"lane kernel runs on cuda (or cpu for its plain "
                         f"version), not {xs.device}")
    return _engine.result_from_state(xs.shape[1], sc, vis), maxc


def _launch(policy, n_banks, n_subarrays, t, refresh_mode, xs, mlp,
            closed_row):
    """One launch of the lane kernel on PyTorch's current stream."""
    lib = _library()
    B, N = xs.shape[0], xs.shape[1]
    dev = xs.device
    with torch.cuda.device(dev):
        timing = timing_array(t, dev)
        per_lane = lib.lane_scratch_ints(n_banks, n_subarrays, refresh_mode)
        scratch = torch.empty((B, per_lane), dtype=torch.int32, device=dev)
        sc = torch.empty((B, L.SC_F), dtype=torch.int32, device=dev)
        vis = torch.empty((B,), dtype=torch.int32, device=dev)
        maxc = torch.empty((B,), dtype=torch.int32, device=dev)
        if B == 0:
            return sc, vis, maxc
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lane_step_launch(
            xs.data_ptr(), mlp.data_ptr(), timing.data_ptr(),
            scratch.data_ptr(), sc.data_ptr(), vis.data_ptr(),
            maxc.data_ptr(), B, N, n_banks, n_subarrays, int(policy),
            int(refresh_mode), int(bool(closed_row)), stream)
        if err != 0:
            raise RuntimeError(f"lane_step launch failed: CUDA error {err}")
        LAUNCHES["lane_step"] += 1
    # timing and scratch may be freed now: the caching allocator reuses
    # their memory only for later work on this same stream
    return sc, vis, maxc


#: The plain PyTorch version of the lane kernel, on ``xs``'s device: the
#: controller's lane-batched step looped over the trace. Returns the kernel's
#: raw outputs ``(scalars [B, SC_F], vis_prev [B], max_comp [B])``.
simulate_lanes_plain = _controller.run_lanes
