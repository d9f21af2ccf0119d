"""Fig. 4 end to end: the port's grid equals the JAX package's sweep.

The paper's headline grid (32 workloads x 5 policies) through
``repro_torch.paper_repro`` on the CPU equals ``repro.experiments.run_sweep``
cell for cell at n=1000, and the JAX package still reproduces the committed
n=8000 fixture that ``chip_smoke.py`` holds the CUDA kernel to.
"""
import numpy as np
import pytest

import torch_cases as tc
from make_torch_fig4_fixture import fig4_cells
from repro.core.dram import PAPER_WORKLOADS, Policy
from repro.experiments import ResultCache, SweepGrid, run_sweep
from repro_torch import paper_repro as pr

N = 1000
SEED = 7


@pytest.fixture(scope="module")
def jax_sweep():
    grid = SweepGrid(name="paper_repro", workloads=PAPER_WORKLOADS,
                     policies=pr.POLICIES, n_requests=N, seed=SEED)
    return run_sweep(grid, ResultCache())


@pytest.fixture(scope="module")
def port_results():
    return pr.run_fig4(N, SEED, device="cpu")


def test_counters_equal_run_sweep_for_all_160_cells(jax_sweep, port_results):
    got = pr.cell_counters(port_results)
    want = {(c.workload.name, c.policy.name): c.counters
            for c in jax_sweep.cells}
    assert len(want) == 160 and set(got) == set(want)
    bad = [k for k in want if got[k] != want[k]]
    assert not bad, bad[:5]


def test_derived_metrics_equal(jax_sweep, port_results):
    """IPC and energy are float64 functions of equal integers: equal."""
    s = pr.summary(port_results, N)
    for pol in pr.PAPER_GAINS:
        # the reference example's expression, operation for operation
        ref = 100 * (jax_sweep.metric("ipc", policy=Policy(int(pol)))
                     / jax_sweep.metric("ipc", policy=Policy.BASELINE)
                     - 1).mean()
        assert s["gains_pct"][pol.name] == float(ref)
    eb = jax_sweep.metric("dynamic_nj", policy=Policy.BASELINE)
    em = jax_sweep.metric("dynamic_nj", policy=Policy.MASA)
    assert s["dynamic_energy_reduction_pct"] == float(100 * (1 - em / eb).mean())
    hit = [jax_sweep.metric("n_hit", policy=p) / N
           for p in (Policy.BASELINE, Policy.MASA)]
    assert s["row_hit_delta_pp"] == float(100 * (hit[1] - hit[0]).mean())
    assert np.isfinite(list(s["gains_pct"].values())).all()
    assert s["gains_pct"]["MASA"] > s["gains_pct"]["SALP1"] > 0


def test_cli_prints_the_report(capsys):
    pr.main(["--n", "64", "--seed", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "160 cells in 5 batched calls" in out
    assert "MASA" in out and "paper" in out


def test_jax_package_reproduces_the_n8000_fixture():
    """The fixture chip_smoke.py checks the kernel against cannot rot."""
    fixture = tc.fig4_fixture()
    cells = {(c["workload"], c["policy"]): c["counters"] for c in fig4_cells()}
    assert len(fixture) == 160 and cells == fixture
