"""The port of benchmarks/kernel_bench.py, on the CPU.

``repro_torch.kernel_bench.run(device="cpu")`` drives the five kernels'
plain versions through their wrappers at the reference bench's shapes. It
must report what the reference's validator (``validate_kernels``) checks:
every oracle covered and within ``ERR_TOL``, and an ordered SALP ladder.
The designation hit rate and the ladder's model are held to the JAX
package's at the same arguments.
"""
import json

import numpy as np
import pytest

from benchmarks import kernel_bench as r_bench
from repro.core.salp.pipeline import speedup_ladder as r_ladder
from repro.kernels.moe_gemm.ops import capacity_block_eids as r_eids
from repro_torch import kernel_bench
from repro_torch.core.salp.pipeline import speedup_ladder

#: The oracles benchmarks/validate.py's validate_kernels requires.
ERRS = {"moe_gemm", "masa_gemm", "ssd_scan", "flash_attention",
        "paged_attention/shared_prefix", "paged_attention/private"}


@pytest.fixture(scope="module")
def result():
    return kernel_bench.run(device="cpu")


def test_run_reports_what_the_validator_checks(result):
    assert set(result["errs"]) == ERRS
    assert result["kernels_ok"] is True
    assert all(0 <= e < kernel_bench.ERR_TOL for e in result["errs"].values())
    assert kernel_bench.ERR_TOL == r_bench.ERR_TOL
    ladder = result["ladder"]
    assert ladder["baseline"] == 1.0
    assert ladder["masa"] >= ladder["salp1"] > 1.0


def test_moe_hit_is_the_references(result):
    want = r_bench.block_hit_rate(np.asarray(r_eids(8, 256, 128)))
    assert result["moe_hit"] == want == 8 / 15


def test_no_kernel_launches_on_the_cpu(result):
    assert result["device"] == "cpu"
    assert set(result["launches"]) == {
        "masa_gemm_os", "masa_gemm_ws", "ssd_scan", "moe_gemm",
        "paged_attention", "flash_attention"}
    assert not any(result["launches"].values())


@pytest.mark.parametrize("ids", [[0, 0, 1, 1, 2], [3], [], [1, 2, 3, 1],
                                 [5, 5, 5]])
def test_block_hit_rate_is_the_references(ids):
    assert kernel_bench.block_hit_rate(ids) == r_bench.block_hit_rate(ids)


@pytest.mark.parametrize("fetch,compute,wb,reuse", [
    (19.56, 4.24, 9.78, 0.5), (1.0, 2.0, 0.5, 0.0), (5.0, 1.0, 7.0, 0.25),
    (0.0, 0.0, 0.0, 0.0)])
def test_speedup_ladder_is_the_references(fetch, compute, wb, reuse):
    assert (speedup_ladder(fetch, compute, wb, reuse_rate=reuse)
            == r_ladder(fetch, compute, wb, reuse_rate=reuse))


def test_cli_prints_the_rows_and_the_result(capsys):
    assert kernel_bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    names = [ln.split(",")[0] for ln in lines[:-1]]
    assert names == ["kernels.moe_gemm.capacity_layout",
                     "kernels.masa_gemm.orders", "kernels.ssd_scan",
                     "kernels.paged_attention.shared_prefix",
                     "kernels.paged_attention.private",
                     "kernels.flash_attention",
                     "kernels.salp_pipeline_ladder"]
    assert json.loads(lines[-1])["kernels_ok"] is True
