"""The port's one CUDA builder (``repro_torch.cuda_build``), on the CPU.

Nothing is compiled here (there is no nvcc): these tests hold the naming
that decides when a library is rebuilt. Each library is named by a hash of
every file in its own ``csrc/`` directory and the flags, so an edit to
``dram_step.cuh`` rebuilds the lane and mix kernels and not the SSD scan.
"""
import shutil

import pytest

from repro_torch import compat, cuda_build
from repro_torch.core.dram import cuda_step
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel


def test_libraries_are_named_by_their_own_csrc(tmp_path):
    dram = cuda_step.CSRC
    ssd = ssd_kernel.CSRC
    assert cuda_build.source_tag(dram) != cuda_build.source_tag(ssd)
    names = {cuda_build.library_path(n, s).name
             for n, s in {**cuda_step.SOURCES, **ssd_kernel.SOURCES}.items()}
    assert len(names) == 3
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


def test_build_without_nvcc_raises():
    if compat.nvcc_path() is not None:
        pytest.skip("nvcc is present: the build runs instead")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build(ssd_kernel.SOURCES)
