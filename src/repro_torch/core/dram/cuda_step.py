"""The CUDA lane and mix kernels: single-core and multicore simulation on
the card.

The counterpart of ``repro.core.dram.pallas_step``:

* ``csrc/lane_step.cu`` (its lane kernel, ``_simulate_lanes_pallas``) runs B
  independent single-core traces, one CUDA thread per lane, each looping
  over its N requests;
* ``csrc/mix_step.cu`` (its mix kernel, ``_simulate_cores_pallas``) runs M
  independent mixes of C cores sharing a channel, one CUDA thread per mix,
  each looping over C * N scheduler-chosen requests.

Both step through ``csrc/dram_step.cuh`` (refresh gating, the bank/subarray
timing step, the refresh commit); only the counter pack and the per-core
``vis_prev`` / ``max_comp`` leave the kernels.

* :func:`simulate_lanes` and :func:`simulate_cores` are the wrappers the
  entry points call. On a CUDA tensor they launch their kernel (or raise);
  on a CPU tensor they run the plain version. They never fall back from the
  kernel to the plain version.
* :func:`simulate_lanes_plain` and :func:`simulate_cores_plain` are the
  plain PyTorch versions (:func:`repro_torch.core.dram.controller.run_lanes`
  and ``run_cores``), on any device: the CPU tests use them, and
  ``chip_smoke.py`` holds the kernels against them on the card.
* ``LAUNCHES`` counts kernel launches, so a run can show that its path went
  through the kernels.

Build: at first use :mod:`repro_torch.cuda_build` compiles each ``.cu``
source for ``sm_90a`` into its own plain-C shared library (one ``nvcc`` per
source, all started together), named by a hash of every source and header
in ``csrc/`` and the flags, and it is loaded with ``ctypes``. Nothing is
built or imported from CUDA when this module is imported.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from repro_torch import cuda_build
from repro_torch.core.dram import controller as _controller
from repro_torch.core.dram import engine as _engine
from repro_torch.core.dram import state_layout as L
from repro_torch.core.dram.timing import DramTiming

CSRC = Path(__file__).resolve().parent / "csrc"
#: Kernel name -> source; each builds into its own library.
SOURCES = {"lane_step": CSRC / "lane_step.cu", "mix_step": CSRC / "mix_step.cu"}
BUILD_DIR = cuda_build.BUILD_DIR
NVCC_FLAGS = cuda_build.NVCC_FLAGS

#: The timing array's layout: DramTiming's fields in declaration order, as
#: the T_* constants of dram_step.cuh index it.
TIMING_FIELDS = ("t_cl", "t_cwl", "t_rcd", "t_rp", "t_ras", "t_wr", "t_rtp",
                 "t_bl", "t_ccd", "t_wtr", "t_rtw", "t_rrd", "t_rrd_sa",
                 "t_faw", "t_sa", "t_refi", "t_rfc", "t_rfc_pb",
                 "ref_postpone_max")

#: Kernel launches by kernel name (set to 0 with :func:`reset_launches`).
LAUNCHES: dict[str, int] = {"lane_step": 0, "mix_step": 0}

#: Human-readable refusal reason for command export.
EMIT_COMMANDS_ERROR = (
    "The CUDA lane and mix kernels refuse emit_commands: they keep the "
    "per-step state on the card and return only the final counters, so "
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
def build() -> dict[str, tuple[Path, str]]:
    """Compile both kernels (once per process and sources), one ``nvcc``
    per source, all started together. Returns ``{name: (library path,
    compiler log)}``; the log is ``-Xptxas -v``'s (registers, spills).
    Raises with the compiler's output if a build fails."""
    return cuda_build.build(SOURCES)


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = cuda_build.load(name, SOURCES[name])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name == "lane_step":
        lib.lane_step_launch.argtypes = [vp] * 7 + [ci] * 7 + [vp]
        lib.lane_step_launch.restype = ci
        lib.lane_scratch_ints.argtypes = [ci, ci, ci]
        lib.lane_scratch_ints.restype = ci
    else:
        lib.mix_step_launch.argtypes = [vp] * 8 + [ci] * 9 + [vp]
        lib.mix_step_launch.restype = ci
        lib.mix_scratch_ints.argtypes = [ci, ci, ci, ci]
        lib.mix_scratch_ints.restype = ci
    return lib


def timing_array(t: DramTiming, device) -> torch.Tensor:
    """The kernel's ``[19]`` int32 timing array."""
    names = tuple(f.name for f in dataclasses.fields(DramTiming))
    if names != TIMING_FIELDS:
        raise RuntimeError(f"DramTiming fields {names} no longer match the "
                           f"kernel's timing layout {TIMING_FIELDS}")
    return torch.tensor([int(getattr(t, n)) for n in names],
                        dtype=torch.int32, device=device)


def _check_geometry(nb: int, ns: int, t: DramTiming,
                    refresh_mode: int) -> None:
    if nb < 1 or ns < 1:
        raise ValueError(f"geometry must be at least 1 x 1, got {nb} x {ns}")
    if refresh_mode and (t.t_refi <= 0 or (refresh_mode == 4
                                           and t.t_rfc_pb <= 0)):
        raise ValueError(f"refresh mode {refresh_mode} divides by t_refi "
                         f"and t_rfc_pb, which must be positive")


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
    _check_geometry(nb, ns, t, refresh_mode)


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
    lib = _library("lane_step")
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


def _check_mix_inputs(reqs, mlp, rank, nb: int, ns: int, t: DramTiming,
                      refresh_mode: int) -> None:
    if any(x.dtype != torch.int32 for x in (reqs, mlp, rank)):
        raise TypeError(f"mix kernel takes int32 tensors, got reqs "
                        f"{reqs.dtype}, mlp {mlp.dtype}, rank {rank.dtype}")
    if (reqs.dim() != 4 or reqs.shape[3] != L.RQ_F
            or mlp.shape != reqs.shape[:2] or rank.shape != reqs.shape[:2]):
        raise ValueError(f"mix kernel takes reqs [M, C, N, {L.RQ_F}], mlp and "
                         f"rank [M, C]; got {tuple(reqs.shape)}, "
                         f"{tuple(mlp.shape)} and {tuple(rank.shape)}")
    if reqs.shape[1] < 1 or reqs.shape[2] < 1:
        raise ValueError(f"a mix needs C >= 1 cores and N >= 1 requests a "
                         f"core; got C={reqs.shape[1]}, N={reqs.shape[2]}")
    if not all(x.is_contiguous() for x in (reqs, mlp, rank)):
        raise ValueError("mix kernel takes contiguous tensors")
    if not reqs.device == mlp.device == rank.device:
        raise ValueError(f"reqs on {reqs.device}, mlp on {mlp.device}, rank "
                         f"on {rank.device}")
    _check_geometry(nb, ns, t, refresh_mode)


def simulate_cores(policy: int, scheduler: int, n_banks: int,
                   n_subarrays: int, t: DramTiming, refresh_mode: int, reqs,
                   mlp, rank, closed_row: bool = False):
    """M mixes of C cores sharing a channel: the mix kernel on a CUDA
    tensor, its plain version on a CPU tensor.

    ``reqs`` is the ``[M, C, N, RQ_F]`` int32 request tensor, ``mlp`` and
    ``rank`` the ``[M, C]`` int32 windows and TCM ranks. ``policy`` is
    BASELINE / SALP1 / SALP2 / MASA (IDEAL runs as BASELINE on its
    rewritten geometry), ``scheduler`` a ``Scheduler`` value. Returns
    ``(SimResult with [M] fields, max_comp [M, C])``.
    """
    _check_mix_inputs(reqs, mlp, rank, n_banks, n_subarrays, t, refresh_mode)
    if reqs.device.type == "cpu":
        sc, vis, maxc = simulate_cores_plain(
            policy, scheduler, n_banks, n_subarrays, t, refresh_mode, reqs,
            mlp, rank, closed_row)
    elif reqs.device.type == "cuda":
        sc, vis, maxc = _launch_cores(policy, scheduler, n_banks, n_subarrays,
                                      t, refresh_mode, reqs, mlp, rank,
                                      closed_row)
    else:
        raise ValueError(f"mix kernel runs on cuda (or cpu for its plain "
                         f"version), not {reqs.device}")
    # the reference's result_from_state takes the max of the [C] vis_prev
    # inside; the port's takes [M] vectors, so the core max is taken here
    C, N = reqs.shape[1], reqs.shape[2]
    return _engine.result_from_state(C * N, sc, vis.amax(dim=1)), maxc


def _launch_cores(policy, scheduler, n_banks, n_subarrays, t, refresh_mode,
                  reqs, mlp, rank, closed_row):
    """One launch of the mix kernel on PyTorch's current stream."""
    lib = _library("mix_step")
    M, C, N = reqs.shape[0], reqs.shape[1], reqs.shape[2]
    dev = reqs.device
    with torch.cuda.device(dev):
        timing = timing_array(t, dev)
        per_mix = lib.mix_scratch_ints(n_banks, n_subarrays, C, refresh_mode)
        scratch = torch.empty((M, per_mix), dtype=torch.int32, device=dev)
        sc = torch.empty((M, L.SC_F), dtype=torch.int32, device=dev)
        vis = torch.empty((M, C), dtype=torch.int32, device=dev)
        maxc = torch.empty((M, C), dtype=torch.int32, device=dev)
        if M == 0:
            return sc, vis, maxc
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mix_step_launch(
            reqs.data_ptr(), mlp.data_ptr(), rank.data_ptr(),
            timing.data_ptr(), scratch.data_ptr(), sc.data_ptr(),
            vis.data_ptr(), maxc.data_ptr(), M, C, N, n_banks, n_subarrays,
            int(policy), int(scheduler), int(refresh_mode),
            int(bool(closed_row)), stream)
        if err != 0:
            raise RuntimeError(f"mix_step launch failed: CUDA error {err}")
        LAUNCHES["mix_step"] += 1
    return sc, vis, maxc


#: The plain PyTorch version of the mix kernel, on ``reqs``' device: the
#: controller's mix-batched C-core step looped C * N times. Returns the
#: kernel's raw outputs ``(scalars [M, SC_F], vis_prev [M, C],
#: max_comp [M, C])``.
simulate_cores_plain = _controller.run_cores
