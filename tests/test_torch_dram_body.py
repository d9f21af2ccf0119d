"""The DRAM kernels' body choice (``cuda_step.body``), on the CPU.

The lane and mix kernels have two bodies: ``smem``, one warp a chain with
the chain's state and staged requests in shared memory, and ``global``, one
thread a chain with its state in a scratch buffer. ``body()`` picks one by
shape before a launch and ``chain_bytes()`` is the one count of a chain's
shared memory, which the C entries take as they are. Nothing is launched
here (there is no card): these tests hold the choice and the count at the
repo's geometries, the forced-body keyword's refusals (raised before any
library is loaded), ``BODIES`` on CPU calls, and the staging constants
against ``csrc/dram_step.cuh``.
"""
import re

import numpy as np
import pytest

import repro_torch.core.dram as P
import torch_cases as tc
from repro_torch import cuda_build
from repro_torch.core.dram import cuda_step, engine
from repro_torch.core.dram.engine import lane_inputs, mix_inputs

# (policy, config kwargs, kernel geometry after the IDEAL rewrite,
#  refresh mode, cores, bytes a chain, body)
GEOMETRIES = [
    # the default 8 x 8: plane 360 words, ring 64, request ring 384
    (P.Policy.MASA, dict(), (8, 8), 0, 1, 4 * (360 + 64 + 384), "smem"),
    # a refreshing 8 x 8 adds the [8][5] refresh table
    (P.Policy.SALP2, dict(refresh=True), (8, 8), 1, 1,
     4 * (360 + 448 + 40), "smem"),
    # IDEAL on 8 x 8 runs as BASELINE on 64 x 1
    (P.Policy.IDEAL, dict(), (64, 1), 0, 1, 4 * (640 + 448), "smem"),
    # IDEAL on sens_subarrays' 8 x 64 runs on 512 x 1, about 31 KB refreshing
    (P.Policy.IDEAL, dict(n_subarrays=64, refresh=True), (512, 1), 1, 1,
     4 * (5120 + 448 + 2560), "smem"),
    # a 4-core mix on the default geometry
    (P.Policy.MASA, dict(), (8, 8), 0, 4, 4 * (360 + 4 * 448), "smem"),
    # 16 x 1024: a 328 KB plane, over a block's shared memory
    (P.Policy.MASA, dict(n_banks=16, n_subarrays=1024), (16, 1024), 0, 1,
     4 * (16 * 1025 * 5 + 448), "global"),
]


@pytest.mark.parametrize("pol,kw,geom,mode,cores,nbytes,want", GEOMETRIES)
def test_body_and_bytes_at_the_repos_geometries(pol, kw, geom, mode, cores,
                                                nbytes, want):
    cfg = P.SimConfig(**kw)
    nb, ns = cfg.n_banks, cfg.n_subarrays
    stacked = P.stack_traces([tc.random_trace(0, n=8, nb=nb, ns=ns)])
    _, knb, kns, _, _ = lane_inputs(stacked, pol, cfg, "cpu")
    assert (knb, kns) == geom and cfg.refresh_mode == mode
    assert cuda_step.chain_bytes(knb, kns, mode, cores) == nbytes
    assert cuda_step.body(knb, kns, mode, cores) == want
    assert (nbytes <= cuda_build.MAX_SMEM_BYTES) == (want == "smem")


@pytest.mark.parametrize("cores,want", [(1, "smem"), (32, "smem"),
                                        (40, "smem"), (128, "smem"),
                                        (129, "global")])
def test_mix_cores_the_smem_body_keys(cores, want):
    """Four cores a lane of the warp: C <= 128 on the default geometry."""
    assert cuda_step.body(8, 8, 0, cores) == want


@pytest.mark.parametrize("entry", ["lane_step_launch", "lane_scratch_ints",
                                   "mix_step_launch", "mix_scratch_ints"])
def test_c_entries_match_their_declarations(monkeypatch, entry):
    """The ctypes argument types the wrapper declares are the C entry's
    parameters, one for one, read from the source."""
    import ctypes
    import types

    kernel = entry.split("_")[0] + "_step"
    src = cuda_step.SOURCES[kernel].read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1)
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in params.split(",")]
    assert all("*" in p or p.split()[0] == "int" for p in params.split(","))

    class Library:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(cuda_build, "load", lambda name, src: Library())
    lib = cuda_step._library.__wrapped__(kernel)
    assert getattr(lib, entry).argtypes == want
    assert getattr(lib, entry).restype is ctypes.c_int


def test_staging_constants_match_the_header():
    src = (cuda_step.CSRC / "dram_step.cuh").read_text()
    k, d = re.search(r"STAGE_K = (\d+), STAGE_D = (\d+);", src).groups()
    assert (int(k), int(d)) == (cuda_step.STAGE_CHUNK, cuda_step.STAGE_DEPTH)
    assert int(re.search(r"RING = (\d+);", src).group(1)) == engine._RING
    # the kernels' waits count STAGE_D - 2 groups back, so at least 2 slots
    assert cuda_step.STAGE_DEPTH >= 2


def _lane_args():
    cfg = P.SimConfig()
    stacked = P.stack_traces([tc.random_trace(s, n=40) for s in range(3)])
    eff, nb, ns, xs, mlp = lane_inputs(stacked, P.Policy.MASA, cfg, "cpu")
    return (eff, nb, ns, cfg.timing, cfg.refresh_mode, xs, mlp, False)


def _mix_args():
    cfg = P.SimConfig()
    st = [P.stack_traces([tc.random_trace(10 * m + c, n=24)
                          for c in range(2)]) for m in range(2)]
    stacked = {k: np.stack([s[k] for s in st]) for k in st[0]}
    ranks = np.array([[0, 1], [1, 0]], dtype=np.int32)
    eff, sched, nb, ns, reqs, mlp, rank = mix_inputs(stacked, ranks,
                                                     P.Policy.MASA, cfg, "cpu")
    return (eff, sched, nb, ns, cfg.timing, cfg.refresh_mode, reqs, mlp,
            rank, False)


def test_cpu_calls_leave_the_counts_alone():
    cuda_step.reset_launches()
    before = {k: dict(v) for k, v in cuda_step.BODIES.items()}
    assert before == {"lane_step": {"global": 0, "smem": 0},
                      "mix_step": {"global": 0, "smem": 0}}
    cuda_step.simulate_lanes(*_lane_args())
    cuda_step.simulate_cores(*_mix_args())
    assert cuda_step.BODIES == before
    assert cuda_step.LAUNCHES == {"lane_step": 0, "mix_step": 0}


@pytest.mark.parametrize("kernel", ["lane", "mix"])
@pytest.mark.parametrize("forced,over_budget,match", [
    ("shared", False, "unknown body"),
    ("SMEM", False, "unknown body"),
    ("Global", True, "unknown body"),
    ("smem", True, "does not take 16 x 1024"),
])
def test_forced_body_refusals(kernel, forced, over_budget, match):
    """The private keyword refuses an unknown body, or the smem body where
    a chain does not fit a block, before any library is loaded."""
    if kernel == "lane":
        args = list(_lane_args())
        if over_budget:
            args[1:3] = 16, 1024
        call = lambda: cuda_step._launch(*args, _body=forced)  # noqa: E731
    else:
        args = list(_mix_args())
        if over_budget:
            args[2:4] = 16, 1024
        call = lambda: cuda_step._launch_cores(*args,  # noqa: E731
                                               _body=forced)
    with pytest.raises(ValueError, match=match):
        call()


def test_forcing_smem_over_budget_is_refused():
    with pytest.raises(ValueError, match="does not take 16 x 1024"):
        cuda_step._pick(16, 1024, 0, 1, "smem")
    with pytest.raises(ValueError, match="does not take 8 x 8 with 200"):
        cuda_step._pick(8, 8, 0, 200, "smem")
    # global takes every shape; unforced, the body body() picks
    assert cuda_step._pick(16, 1024, 0, 1, "global")[0] == 0
    which, nbytes = cuda_step._pick(8, 8, 0, 1, None)
    assert (cuda_step.BODY_NAMES[which], nbytes) == ("smem", 3232)


@pytest.mark.parametrize("name", ["dram_step.cuh", "lane_step.cu",
                                  "mix_step.cu"])
def test_every_csrc_file_is_in_the_library_hash(tmp_path, name):
    """Both DRAM libraries are named by every file of csrc/: an edit to any
    one renames both."""
    import shutil

    copy = tmp_path / "csrc"
    shutil.copytree(cuda_step.CSRC, copy)
    assert {p.name for p in cuda_build.sources_of(copy)} == {
        "dram_step.cuh", "lane_step.cu", "mix_step.cu"}
    before = {n: cuda_build.library_path(n, copy / f"{n}.cu")
              for n in cuda_step.SOURCES}
    (copy / name).write_text((copy / name).read_text() + "\n// edited\n")
    for n, path in before.items():
        assert cuda_build.library_path(n, copy / f"{n}.cu") != path
