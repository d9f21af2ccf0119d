"""The port's remaining paper benches equal the JAX package's.

``repro_torch.benchmarks`` ``fig5_energy``, ``sens_subarrays``,
``sens_banks``, ``row_policy_bench``, ``multicore_bench``, ``mapping_bench``
and ``serving_bench`` against the repo's ``benchmarks/`` modules:

* each bench's constants and grids equal the reference's;
* at a cut size (2 workloads, 100 to 200 requests, fewer geometries; the
  tests set both sides' module constants with ``monkeypatch``, nothing under
  ``benchmarks/`` changes) each ``run()`` gives the reference's sweep cells,
  summary and CSV ``derived`` column exactly, or the same error where a cut
  size cannot show the bench's claim (the mapping collapse);
  ``serving_bench`` runs at full size, since it is host-only and cheap;
* ``common.suite_ipc`` over ``suite_traces`` equals the reference's;
* the committed JAX fixture (``tests/make_torch_paper_benches_fixture.py``),
  which ``chip_smoke.py`` holds the card to at full size, has exactly the
  port's grid keys and row-policy rows.

Everything runs on ``device="cpu"`` (the kernels' plain versions). Tolerance
0: integer counters, and float64 summaries from the same numpy arithmetic.
"""
import contextlib
import functools
import io
import json

import pytest

import torch_cases as tc
from benchmarks import common as R_common
from benchmarks import fig5_energy as R_fig5
from benchmarks import mapping_bench as R_mapping
from benchmarks import multicore_bench as R_multicore
from benchmarks import row_policy_bench as R_row
from benchmarks import sens_banks as R_banks
from benchmarks import sens_subarrays as R_subarrays
from benchmarks import serving_bench as R_serving
from benchmarks import smoke as R_smoke
from repro import experiments as R_exp
from repro.core.dram import Policy as RPolicy
from repro_torch import experiments as P_exp
from repro_torch import paper_repro
from repro_torch.benchmarks import common as P_common
from repro_torch.benchmarks import fig5_energy as P_fig5
from repro_torch.benchmarks import mapping_bench as P_mapping
from repro_torch.benchmarks import multicore_bench as P_multicore
from repro_torch.benchmarks import row_policy_bench as P_row
from repro_torch.benchmarks import sens_banks as P_banks
from repro_torch.benchmarks import sens_subarrays as P_subarrays
from repro_torch.benchmarks import serving_bench as P_serving
from repro_torch.benchmarks import smoke as P_smoke
from repro_torch.core.dram import Policy as PPolicy
from repro_torch.experiments.cache import cell_key
from repro_torch.experiments.runner import trace_for

SMALL_N, SMALL_WORKLOADS = 200, 2


def names(profiles) -> list[str]:
    return [p.name for p in profiles]


def test_bench_constants_equal_jax():
    pairs = {
        (R_subarrays, P_subarrays): ("SUBARRAY_COUNTS", "N"),
        (R_banks, P_banks): ("BANK_COUNTS", "N"),
        (R_row, P_row): ("N",),
        (R_multicore, P_multicore): ("N", "MIXES"),
        (R_mapping, P_mapping): ("N", "FOOTPRINT_ROWS", "WORKLOAD_NAMES",
                                 "MAPPINGS"),
        (R_smoke, P_smoke): ("N", "N_MIX"),
    }
    for (ref, port), consts in pairs.items():
        for name in consts:
            assert getattr(port, name) == getattr(ref, name), name
    for ref, port in ((R_subarrays, P_subarrays), (R_banks, P_banks),
                      (R_row, P_row), (R_smoke, P_smoke)):
        assert names(port.SUBSET) == names(ref.SUBSET)
    assert names(P_mapping.POLICIES) == names(R_mapping.POLICIES)
    assert P_multicore.MIXES == paper_repro.MIXES
    for ref, port in ((R_subarrays, P_subarrays), (R_banks, P_banks),
                      (R_mapping, P_mapping), (R_smoke, P_smoke)):
        assert port.make_grid().describe() == ref.make_grid().describe()
    assert P_smoke.make_sched_grid().describe() == \
        R_smoke.make_sched_grid().describe()
    assert P_smoke.COMMANDS_OUT.startswith("artifacts/torch/")
    assert P_common.N_REQUESTS == R_common.N_REQUESTS
    assert P_common.SEED == R_common.SEED


@pytest.fixture
def fresh(monkeypatch):
    """Both sides with an empty process-wide cache and sweep list."""
    monkeypatch.setattr(R_common, "SWEEPS", [])
    monkeypatch.setattr(P_common, "SWEEPS", [])
    prev = [exp.install_global_cache(exp.ResultCache())
            for exp in (R_exp, P_exp)]
    yield
    for exp, cache in zip((R_exp, P_exp), prev):
        exp.install_global_cache(cache)


def run_both(ref_mod, port_mod):
    """Both ``run()``s: ``(summary or error, [(row name, derived)], sweep
    cells)`` for each side, the reference first."""
    out = []
    for mod, common, kw in ((ref_mod, R_common, {}),
                            (port_mod, P_common, {"device": "cpu"})):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                result = json.loads(json.dumps(mod.run(**kw)))
            except AssertionError as e:
                result = f"AssertionError: {e}"
        rows = [tuple(line.split(",", 2)[::2])
                for line in buf.getvalue().splitlines()]
        cells = [c for s in common.SWEEPS for c in s["cells"]]
        out.append((result, rows, cells))
    return out


def small(monkeypatch, pairs, **consts):
    for ref, port in pairs:
        for mod in (ref, port):
            if hasattr(mod, "SUBSET"):
                monkeypatch.setattr(mod, "SUBSET",
                                    mod.SUBSET[:SMALL_WORKLOADS])
            for k, v in consts.items():
                monkeypatch.setattr(mod, k, v)


def assert_equal_runs(ref, port, n_cells: int | None = None):
    (r_sum, r_rows, r_cells), (p_sum, p_rows, p_cells) = ref, port
    assert p_sum == r_sum
    assert p_rows == r_rows and len(p_rows) > 1
    assert p_cells == r_cells
    if n_cells is not None:
        assert len(p_cells) == n_cells


def test_reduced_sens_subarrays_equals_jax(fresh, monkeypatch):
    small(monkeypatch, [(R_subarrays, P_subarrays)], N=SMALL_N,
          SUBARRAY_COUNTS=(2, 8))
    assert_equal_runs(*run_both(R_subarrays, P_subarrays),
                      n_cells=SMALL_WORKLOADS * 3 * 2)


def test_reduced_sens_banks_equals_jax(fresh, monkeypatch):
    small(monkeypatch, [(R_banks, P_banks)], N=SMALL_N, BANK_COUNTS=(8, 16))
    assert_equal_runs(*run_both(R_banks, P_banks),
                      n_cells=SMALL_WORKLOADS * 3)


def test_reduced_row_policy_equals_jax(fresh, monkeypatch):
    small(monkeypatch, [(R_row, P_row)], N=SMALL_N)
    ref, port = run_both(R_row, P_row)
    assert_equal_runs(ref, port, n_cells=0)
    assert set(port[0]) == {"open", "closed"}


def test_reduced_fig5_equals_jax(fresh, monkeypatch):
    """All 32 suite workloads (the rows name each) at 200 requests."""
    for mod, common in ((R_fig5, R_common), (P_fig5, P_common)):
        monkeypatch.setattr(mod, "suite_traces",
                            functools.partial(common.suite_traces, SMALL_N))
    ref, port = run_both(R_fig5, P_fig5)
    assert_equal_runs(ref, port, n_cells=0)
    assert len(port[1]) == 32 + 2


def test_reduced_multicore_equals_jax(fresh, monkeypatch):
    """Two of the four mixes at 100 requests a core; the port's bench runs
    ``paper_repro.run_multicore``, whose ``MIXES`` is cut with it."""
    mixes = R_multicore.MIXES[:2]
    for mod in (R_multicore, P_multicore, paper_repro):
        monkeypatch.setattr(mod, "MIXES", mixes)
    for mod in (R_multicore, P_multicore):
        monkeypatch.setattr(mod, "N", 100)
    assert_equal_runs(*run_both(R_multicore, P_multicore), n_cells=0)


def test_reduced_mapping_grid_equals_jax(fresh, monkeypatch):
    """At a cut size the footprint pressure that makes the contiguous
    mapping collapse is not there: both refuse alike, after sweeping the
    same cells."""
    for mod in (R_mapping, P_mapping):
        monkeypatch.setattr(mod, "WORKLOAD_NAMES",
                            mod.WORKLOAD_NAMES[:SMALL_WORKLOADS])
        monkeypatch.setattr(mod, "POLICIES", (mod.POLICIES[0],
                                              mod.POLICIES[-1]))
        monkeypatch.setattr(mod, "make_grid",
                            functools.partial(mod.make_grid, SMALL_N))
    ref, port = run_both(R_mapping, P_mapping)
    assert_equal_runs(ref, port, n_cells=SMALL_WORKLOADS * 2 * 3)


def test_serving_equals_jax_at_full_size(fresh):
    ref, port = run_both(R_serving, P_serving)
    assert_equal_runs(ref, port, n_cells=0)
    assert port[0] == tc.paper_benches_fixture()["summaries"]["serving"]


def grid_keys(grid) -> list[tuple]:
    return [(cell_key(trace_for(c.workload, grid.n_requests, c.config,
                                grid.seed, footprint_rows=grid.footprint_rows),
                      c.policy, c.config), c.workload.name, c.policy.name)
            for c in grid.expand()]


@pytest.mark.parametrize("bench", ["sens_subarrays", "sens_banks", "mapping",
                                   "smoke"])
def test_fixture_keys_are_the_port_grid_keys(bench):
    port = {"sens_subarrays": P_subarrays, "sens_banks": P_banks,
            "mapping": P_mapping, "smoke": P_smoke}[bench]
    fixture = tc.paper_benches_fixture()
    want = [(c["key"], c["workload"], c["policy"]) for c in fixture["cells"]
            if c["grid"] == bench]
    assert grid_keys(port.make_grid()) == want
    assert fixture["sizes"][bench] == port.make_grid().n_requests


def test_fixture_rows_and_summaries_cover_the_port():
    fixture = tc.paper_benches_fixture()
    rows = [(r["row_policy"], r["policy"], r["workload"])
            for r in fixture["row_policy"]]
    assert rows == [(rp, pol, p.name) for rp in ("open", "closed")
                    for pol in ("BASELINE", "SALP1", "SALP2", "MASA")
                    for p in P_row.SUBSET]
    assert fixture["sizes"]["row_policy"] == P_row.N
    mix = [(c["mix"], c["policy"], c["overrides"]["scheduler"])
           for c in fixture["cells"] if c["grid"] == "smoke_sched"]
    grid = P_smoke.make_sched_grid()
    assert mix == [("+".join(p.name for p in c.profiles), c.policy.name,
                    c.config.scheduler.name) for c in grid.expand()]
    assert set(fixture["summaries"]) == {
        "fig4", "fig5", "sens_subarrays", "sens_banks", "row_policy",
        "multicore", "sched", "mapping", "serving", "smoke"}
    assert fixture["summaries"]["mapping"]["collapse_ok"] is True



def test_suite_ipc_equals_jax():
    """``common.suite_ipc`` over the suite's memoised traces (100 requests)."""
    r_ipc, r_res = R_common.suite_ipc(R_common.suite_traces(100),
                                      RPolicy.MASA)
    p_ipc, p_res = P_common.suite_ipc(P_common.suite_traces(100),
                                      PPolicy.MASA, device="cpu")
    assert p_ipc.tolist() == r_ipc.tolist() and len(p_ipc) == 32
    assert [int(x) for x in p_res.total_cycles] == \
        [int(x) for x in r_res.total_cycles]
