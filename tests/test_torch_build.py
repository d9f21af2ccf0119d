"""The port's one CUDA builder (``repro_torch.cuda_build``), on the CPU.

Nothing is compiled here (there is no nvcc): these tests hold the naming
that decides when a library is rebuilt. Each library is named by a hash of
every file in its own ``csrc/`` directory, the headers they include by a
quoted path, and the flags, so an edit to ``dram_step.cuh`` rebuilds the
lane and mix kernels and not the SSD scan, and an edit to
``kernels/csrc/hopper_gemm.cuh`` rebuilds masa_gemm, moe_gemm and
flash_attention, and one to ``kernels/csrc/async_cluster.cuh`` the SSD scan,
paged attention and moe_gemm.
The wrappers' shared steps (``kernels.dispatch``: ``runs_plain``,
``check``) are held here too.
"""
import shutil
from pathlib import Path

import pytest

import torch

from repro_torch import compat, cuda_build, kernels
from repro_torch.kernels import dispatch
from repro_torch.core.dram import cuda_step
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel


def test_libraries_are_named_by_their_own_csrc(tmp_path):
    dram = cuda_step.CSRC
    ssd = ssd_kernel.CSRC
    assert cuda_build.source_tag(dram) != cuda_build.source_tag(ssd)
    sources = {**cuda_step.SOURCES, **kernels.SOURCES}
    names = {cuda_build.library_path(n, s).name for n, s in sources.items()}
    assert len(names) == 7
    for n, s in sources.items():
        assert s.parent.name == "csrc" and s.is_file()
        assert cuda_build.library_path(n, s).name == (
            f"{n}_{cuda_build.source_tag(s.parent)}.so")
    # the accelerator layer's five libraries, each from its own csrc/
    assert len({s.parent for s in kernels.SOURCES.values()}) == 5
    assert all(p.parent == cuda_build.BUILD_DIR for p in
               (cuda_build.library_path("lane_step", dram / "lane_step.cu"),))
    assert cuda_step.BUILD_DIR == cuda_build.BUILD_DIR
    assert cuda_build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")


def test_header_edit_renames_the_dram_libraries(tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_step.CSRC, copy)
    before = cuda_build.library_path("lane_step", copy / "lane_step.cu")
    assert before == cuda_build.library_path("lane_step",
                                             cuda_step.SOURCES["lane_step"])
    header = copy / "dram_step.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = cuda_build.library_path("lane_step", copy / "lane_step.cu")
    assert after != before
    assert (cuda_build.library_path("mix_step", copy / "mix_step.cu").name
            .split("_")[-1] == after.name.split("_")[-1])


def test_shared_header_edit_renames_the_gemm_libraries(tmp_path):
    """hopper_gemm.cuh lies outside masa_gemm's, moe_gemm's and
    flash_attention's csrc/ and is hashed into their names through their
    quoted includes."""
    copy = tmp_path / "kernels"
    shutil.copytree(Path(kernels.__file__).parent, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))

    def names():
        return {n: cuda_build.library_path(n, copy / n / "csrc" / f"{n}.cu")
                for n in ("masa_gemm", "moe_gemm", "flash_attention",
                          "ssd_scan")}

    before = names()
    for n, path in before.items():
        assert path == cuda_build.library_path(n, kernels.SOURCES[n])
    header = (copy / "csrc" / "hopper_gemm.cuh").resolve()
    cluster = (copy / "csrc" / "async_cluster.cuh").resolve()
    tf32 = (copy / "csrc" / "tf32x3.cuh").resolve()
    for n, extra in (("masa_gemm", [tf32, cluster]),
                     ("moe_gemm", [tf32, cluster]),
                     ("flash_attention", [tf32, cluster])):
        assert sorted(cuda_build.sources_of(copy / n / "csrc")) == sorted([
            (copy / n / "csrc" / f"{n}.cu").resolve(), header, *extra])
    header.write_text(header.read_text() + "\n// edited\n")
    after = names()
    assert after["masa_gemm"] != before["masa_gemm"]
    assert after["moe_gemm"] != before["moe_gemm"]
    assert after["flash_attention"] != before["flash_attention"]
    assert after["ssd_scan"] == before["ssd_scan"]


def test_async_cluster_header_edit_renames_ssd_and_paged(tmp_path):
    """async_cluster.cuh (cp.async and cluster helpers) is hashed into the
    SSD scan's, paged attention's, moe_gemm's (its stream body's ring) and,
    through tf32x3.cuh, masa_gemm's and flash_attention's (their tf32x3
    bodies' rings) names, and no other kernel's."""
    copy = tmp_path / "kernels"
    shutil.copytree(Path(kernels.__file__).parent, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))

    def names():
        return {n: cuda_build.library_path(n, copy / n / "csrc" / f"{n}.cu")
                for n in kernels.SOURCES}

    before = names()
    header = (copy / "csrc" / "async_cluster.cuh").resolve()
    for n in ("ssd_scan", "paged_attention"):
        assert cuda_build.sources_of(copy / n / "csrc") == [
            (copy / n / "csrc" / f"{n}.cu").resolve(), header]
    assert header in cuda_build.sources_of(copy / "moe_gemm" / "csrc")
    header.write_text(header.read_text() + "\n// edited\n")
    after = names()
    assert {n for n in before if after[n] != before[n]} == {
        "ssd_scan", "paged_attention", "moe_gemm", "masa_gemm",
        "flash_attention"}


def test_tf32x3_header_edit_renames_masa_and_flash(tmp_path):
    """tf32x3.cuh (the 3xTF32 split, mma.sync, fragment loads and the GEMM
    tile's stage and store) lies outside masa_gemm's, moe_gemm's and
    flash_attention's csrc/ and is hashed into their names through their
    quoted includes, and no other kernel's."""
    copy = tmp_path / "kernels"
    shutil.copytree(Path(kernels.__file__).parent, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))

    def names():
        return {n: cuda_build.library_path(n, copy / n / "csrc" / f"{n}.cu")
                for n in kernels.SOURCES}

    before = names()
    header = (copy / "csrc" / "tf32x3.cuh").resolve()
    for n in kernels.SOURCES:
        assert (header in cuda_build.sources_of(copy / n / "csrc")) == (
            n in ("masa_gemm", "moe_gemm", "flash_attention"))
    header.write_text(header.read_text() + "\n// edited\n")
    after = names()
    assert {n for n in before if after[n] != before[n]} == {
        "masa_gemm", "moe_gemm", "flash_attention"}


def test_build_without_nvcc_raises():
    if compat.nvcc_path() is not None:
        pytest.skip("nvcc is present: the build runs instead")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build(ssd_kernel.SOURCES)


def test_runs_plain_picks_the_device():
    cpu = torch.zeros(2)
    assert dispatch.runs_plain("k", cpu, cpu) is True
    with pytest.raises(ValueError, match="runs on cuda"):
        dispatch.runs_plain("k", torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="inputs on"):
        dispatch.runs_plain("k", cpu, torch.zeros(2, device="meta"))


def test_check_raises_on_a_refused_or_failed_launch():
    dispatch.check("k", 0)
    with pytest.raises(ValueError, match="refused"):
        dispatch.check("k", -1)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        dispatch.check("k", 700)
