"""The port's sweep layer (``repro_torch.experiments``) equals the JAX
package's.

* grid expansion, ``describe()`` JSON-equal to the reference's, and a
  ``backend`` axis refused (the port's ``SimConfig`` has no such field);
* ``cell_key`` equal to the reference's across config overrides, so the
  result cache and its journal are shared: a journal written by the JAX
  ``run_sweep`` replays in the port as all hits, and the other way round;
* shape bucketing counted through the ``_SIMULATE`` seam, the cache, and
  the results API, as ``tests/test_experiments.py`` pins them for JAX;
* ``run_sweep`` / ``run_mix_sweep`` ``to_json()["cells"]`` equal to the live
  JAX runners' on a small grid with a config axis, on explicit configs and
  on the scheduler study's grid at n 100, bit for bit (tolerance 0: integer
  counters; the float64 ``derived`` and ``weighted_speedup`` come from the
  same numpy code);
* the port's ``benchmarks.fig4_ipc`` / ``sched_bench`` grids and CSV rows
  equal the repo's benches at a small n.

Everything runs on ``device="cpu"`` (the kernels' plain versions).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.core.dram as R
import repro.experiments as RE
import repro_torch.core.dram as P
import repro_torch.experiments as PE
from benchmarks import fig4_ipc as R_fig4
from benchmarks import sched_bench as R_sched
from repro_torch.benchmarks import fig4_ipc as P_fig4
from repro_torch.benchmarks import sched_bench as P_sched
from repro_torch.experiments import cache as P_cache
from repro_torch.experiments import runner as runner_mod

NAMES = ("mcf", "lbm", "gamess")
N = 200
SCHED_N = 100


def wls(mod, names=NAMES):
    return tuple(p for p in mod.PAPER_WORKLOADS if p.name in names)


def small_grid(mod=P, E=PE, **kw):
    defaults = dict(name="t", workloads=wls(mod),
                    policies=(mod.Policy.BASELINE, mod.Policy.SALP1,
                              mod.Policy.MASA),
                    n_requests=N, config_axes={"n_subarrays": (4, 8)})
    defaults.update(kw)
    return E.SweepGrid(**defaults)


def explicit_grid(mod=P, E=PE):
    """Explicit configs (the refresh ladder's shape) with a where filter."""
    return E.SweepGrid(
        name="t_cfg", workloads=wls(mod, ("mcf", "lbm")),
        policies=(mod.Policy.BASELINE, mod.Policy.SALP2, mod.Policy.IDEAL),
        n_requests=N,
        configs=({"refresh_policy": "per_bank"},
                 {"refresh": True, "dsarp": True},
                 {"scheduler": mod.Scheduler.FRFCFS, "row_policy": "closed"}),
        where=lambda pol, ov: not (pol == mod.Policy.BASELINE
                                   and ov.get("dsarp")))


def sweep(grid, cache=None, **kw):
    """``run_sweep`` of either package: the port's on the CPU."""
    E = PE if isinstance(grid, PE.SweepGrid) else RE
    if E is PE:
        kw.setdefault("device", "cpu")
    return E.run_sweep(grid, cache if cache is not None else E.ResultCache(),
                       **kw)


@pytest.fixture(scope="module")
def jax_small():
    return sweep(small_grid(R, RE))


@pytest.fixture(scope="module")
def port_small():
    return sweep(small_grid())


@pytest.fixture(scope="module")
def jax_sched():
    return RE.run_mix_sweep(R_sched.make_grid(SCHED_N))


@pytest.fixture(scope="module")
def port_sched():
    """The sched grid through the port, and the mixes of each run-alone
    baseline call it made."""
    calls = []
    orig = P.multicore.alone_baseline_cycles

    def counting(mixes, config, device=None):
        calls.append(len(mixes))
        return orig(mixes, config, device=device)

    P.multicore.alone_baseline_cycles = counting
    try:
        got = PE.run_mix_sweep(P_sched.make_grid(SCHED_N), device="cpu")
    finally:
        P.multicore.alone_baseline_cycles = orig
    return got, calls


class TestGridExpansion:
    def test_cross_product_count_and_order(self):
        cells = small_grid().expand()
        assert len(cells) == 3 * 3 * 2
        assert (cells[0].config.n_subarrays == 4
                and cells[-1].config.n_subarrays == 8)
        assert [c.policy for c in cells[:3]] == [P.Policy.BASELINE,
                                                 P.Policy.SALP1, P.Policy.MASA]
        assert cells[0].override_dict == {"n_subarrays": 4}

    def test_explicit_configs_and_where(self):
        cells = explicit_grid().expand()
        assert len(cells) == 2 * (3 * 3 - 1)
        assert not any(c.policy == P.Policy.BASELINE
                       and c.config.refresh_policy == "dsarp" for c in cells)

    def test_axes_and_configs_mutually_exclusive(self):
        with pytest.raises(ValueError):
            PE.SweepGrid(name="t", workloads=wls(P),
                         policies=(P.Policy.BASELINE,),
                         config_axes={"n_banks": (8,)}, configs=({},))

    @pytest.mark.parametrize("span", [
        dict(config_axes={"n_banksss": (8,)}),
        dict(configs=({}, {"refres": True})),
        dict(config_axes={"backend": ("scan", "pallas")}),
        dict(configs=({"backend": "scan"},)),
    ], ids=["axis-typo", "configs-typo", "backend-axis", "backend-config"])
    def test_unknown_field_rejected(self, span):
        # the port's SimConfig has no backend: sweeping it is an unknown field
        with pytest.raises(ValueError, match="unknown SimConfig field"):
            PE.SweepGrid(name="t", workloads=wls(P),
                         policies=(P.Policy.BASELINE,), **span)

    @pytest.mark.parametrize("make", [
        small_grid, explicit_grid,
        lambda mod, E: small_grid(
            mod, E, base_config=mod.SimConfig(memtech="lpddr4",
                                              refresh_policy="darp"),
            footprint_rows=512),
        lambda mod, E: (P_sched if mod is P else R_sched).make_grid(SCHED_N),
        lambda mod, E: (P_fig4 if mod is P else R_fig4).make_grid(),
    ], ids=["axes", "configs", "lpddr4-darp", "sched-mix", "fig4"])
    def test_describe_equals_reference(self, make):
        got, want = make(P, PE).describe(), make(R, RE).describe()
        assert json.dumps(got) == json.dumps(want)
        assert want["base_config"]["backend"] == "scan"


#: SimConfig overrides the keys are compared across.
OVERRIDES = [
    {}, {"refresh": True}, {"refresh_policy": "darp"},
    {"memtech": "lpddr4"}, {"memtech": "pcm_palp"},
    {"mapping": "contiguous"}, {"scheduler": "FRFCFS_SALP"},
    {"n_subarrays": 4}, {"n_banks": 16, "row_policy": "closed"},
]


@pytest.mark.parametrize("ov", OVERRIDES, ids=lambda ov: "-".join(
    f"{k}={v}" for k, v in ov.items()) or "default")
def test_cell_key_equals_reference(ov):
    def cfg(mod):
        kw = dict(ov)
        if "scheduler" in kw:
            kw["scheduler"] = mod.Scheduler[kw["scheduler"]]
        return mod.SimConfig(**kw)

    for w, pol in (("mcf", "MASA"), ("gups", "BASELINE")):
        rc, pc = cfg(R), cfg(P)
        rt = RE.trace_for(R.workload(w), 64, rc, seed=3)
        pt = PE.trace_for(P.workload(w), 64, pc, seed=3)
        assert (PE.cell_key(pt, P.Policy[pol], pc)
                == RE.cell_key(rt, R.Policy[pol], rc))
        assert list(P_cache.reference_fields(pc)) == [
            f.name for f in dataclasses.fields(rc)]


class TestBucketingAndCache:
    def test_one_batch_per_static_shape(self, monkeypatch):
        calls = []
        orig = runner_mod._SIMULATE

        def counting(stacked, policy, config, device):
            calls.append((int(policy), config.n_subarrays,
                          stacked["bank"].shape, str(device)))
            return orig(stacked, policy, config, device)

        monkeypatch.setattr(runner_mod, "_SIMULATE", counting)
        s = sweep(small_grid())
        # 3 policies x 2 geometries = 6 buckets, each one [W=3, N] call
        assert len(calls) == 6 == s.stats["sim_batches"]
        assert all(shape == (3, N) and dev == "cpu"
                   for *_, shape, dev in calls)

    def test_cache_hits_skip_simulation(self, port_small):
        cache = PE.ResultCache()
        s1 = sweep(small_grid(), cache)
        s2 = sweep(small_grid(), cache)
        assert s1.stats["simulated_cells"] == s1.stats["n_cells"]
        assert s2.stats["simulated_cells"] == 0 == s2.stats["sim_batches"]
        assert s2.stats["cache_hits"] == s2.stats["n_cells"]
        assert [c.counters for c in s2.cells] == [c.counters
                                                  for c in port_small.cells]

    def test_baseline_simulated_once_across_policy_comparisons(
            self, monkeypatch):
        cache, baseline = PE.ResultCache(), []
        orig = runner_mod._SIMULATE

        def counting(stacked, policy, config, device):
            if policy == P.Policy.BASELINE:
                baseline.append(stacked["bank"].shape[0])
            return orig(stacked, policy, config, device)

        monkeypatch.setattr(runner_mod, "_SIMULATE", counting)
        for mech in (P.Policy.MASA, P.Policy.SALP1):
            sweep(small_grid(policies=(P.Policy.BASELINE, mech)), cache)
        assert sum(baseline) == len(NAMES) * 2, baseline

    def test_cell_key_is_content_addressed(self):
        cfg = P.SimConfig()
        tr = PE.trace_for(wls(P)[0], N, cfg, seed=7)
        assert (PE.cell_key(tr, P.Policy.MASA, cfg)
                != PE.cell_key(tr, P.Policy.SALP1, cfg))
        assert (PE.cell_key(tr, P.Policy.MASA, cfg)
                != PE.cell_key(tr, P.Policy.MASA, P.SimConfig(refresh=True)))
        tr2 = dataclasses.replace(tr, row=np.ascontiguousarray(tr.row[::-1]))
        assert (PE.cell_key(tr, P.Policy.MASA, cfg)
                != PE.cell_key(tr2, P.Policy.MASA, cfg))


class TestParityWithJax:
    def test_small_grid_cells_bit_for_bit(self, jax_small, port_small):
        got, want = port_small.to_json(), jax_small.to_json()
        assert got["cells"] == want["cells"]
        assert got["grid"] == want["grid"]
        for k in ("n_cells", "n_unique", "cache_hits", "simulated_cells",
                  "sim_batches", "quarantined_cells"):
            assert got["stats"][k] == want["stats"][k], k

    def test_explicit_configs_bit_for_bit(self):
        got = sweep(explicit_grid()).to_json()["cells"]
        assert got == sweep(explicit_grid(R, RE)).to_json()["cells"]

    def test_sweep_matches_per_config_simulate(self, port_small):
        for cell in port_small.cells[::3]:
            tr = PE.trace_for(cell.workload, N, cell.config, 7)
            ref = P.simulate(tr, cell.policy, cell.config, device="cpu")
            assert cell.counters == {f: int(v) for f, v in vars(ref).items()}

    def test_sched_mix_grid_bit_for_bit(self, jax_sched, port_sched):
        got, calls = port_sched
        assert got.to_json()["cells"] == jax_sched.to_json()["cells"]
        assert got.to_json()["grid"] == jax_sched.to_json()["grid"]
        assert len(got.cells) == 40 and got.stats["sim_batches"] == 10
        # the run-alone memo: one baseline a mix, shared by all 10 points
        assert calls == [1] * 4
        for pol in (P.Policy.BASELINE, P.Policy.MASA):
            r_pol = R.Policy(int(pol))
            assert np.array_equal(
                got.weighted_speedups(pol, scheduler=P.Scheduler.TCM),
                jax_sched.weighted_speedups(r_pol,
                                            scheduler=R.Scheduler.TCM))

    def test_jax_journal_replays_as_hits(self, tmp_path, monkeypatch):
        journal = tmp_path / "journal.jsonl"
        ref = sweep(small_grid(R, RE), RE.PersistentResultCache(journal))
        monkeypatch.setattr(runner_mod, "_SIMULATE", None)  # must not run
        cache = PE.PersistentResultCache(journal)
        assert cache.loaded == ref.stats["n_cells"] and cache.dropped == 0
        got = sweep(small_grid(), cache)
        assert got.stats["cache_hits"] == got.stats["n_cells"]
        assert got.stats["simulated_cells"] == 0 == got.stats["sim_batches"]
        assert ([dict(c, cache_hit=None) for c in got.to_json()["cells"]]
                == [dict(c, cache_hit=None) for c in ref.to_json()["cells"]])

    def test_port_journal_replays_in_jax(self, tmp_path, port_small):
        journal = tmp_path / "journal.jsonl"
        sweep(small_grid(), PE.PersistentResultCache(journal))
        got = sweep(small_grid(R, RE), RE.PersistentResultCache(journal))
        assert got.stats["cache_hits"] == got.stats["n_cells"] == 18
        assert [c.counters for c in got.cells] == [c.counters
                                                   for c in port_small.cells]


class TestResultsApi:
    def test_metric_ordering_follows_grid(self, port_small):
        cyc = port_small.metric("total_cycles", policy=P.Policy.MASA,
                                n_subarrays=8)
        assert cyc.shape == (len(NAMES),)
        by_hand = [c.counters["total_cycles"] for w in small_grid().workloads
                   for c in port_small.select(policy=P.Policy.MASA,
                                              workload=w.name, n_subarrays=8)]
        assert list(cyc) == by_hand

    def test_ambiguous_selection_raises(self, port_small):
        with pytest.raises(ValueError):
            port_small.metric("total_cycles", policy=P.Policy.MASA)

    def test_pruned_cell_raises_value_error(self):
        g = PE.SweepGrid(name="t", workloads=wls(P, ("mcf",)),
                         policies=(P.Policy.BASELINE, P.Policy.MASA),
                         n_requests=64, config_axes={"n_banks": (8, 16)},
                         where=lambda pol, ov: (pol == P.Policy.BASELINE
                                                or ov.get("n_banks") == 8))
        s = sweep(g)
        with pytest.raises(ValueError, match="where filter"):
            s.metric("total_cycles", policy=P.Policy.MASA, n_banks=16)

    def test_speedup_and_ipc_gain_equal_reference(self, jax_small,
                                                  port_small):
        for pol in (P.Policy.SALP1, P.Policy.MASA):
            r_pol = R.Policy(int(pol))
            assert np.array_equal(
                port_small.speedup_pct(pol, n_subarrays=8),
                jax_small.speedup_pct(r_pol, n_subarrays=8))
            assert np.array_equal(
                port_small.ipc_gain_pct(pol, n_subarrays=4),
                jax_small.ipc_gain_pct(r_pol, n_subarrays=4))

    def test_artifact_schema_roundtrip(self, port_small, tmp_path):
        doc = port_small.to_json()
        assert doc["schema_version"] == "repro.sweep/v1"
        assert doc["grid"]["n_cells"] == len(doc["cells"]) == 18
        path = PE.write_artifact(str(tmp_path / "sweep.json"), doc)
        assert PE.read_artifact(path)["cells"] == json.loads(
            json.dumps(doc["cells"]))


class TestDevices:
    @pytest.mark.parametrize("mix", [False, True], ids=["sweep", "mix"])
    def test_default_device_needs_cuda(self, mix):
        if torch.cuda.is_available():
            pytest.skip("checks the machine without CUDA")
        with pytest.raises(RuntimeError, match="CUDA device"):
            if mix:
                PE.run_mix_sweep(P_sched.make_grid(8))
            else:
                PE.run_sweep(small_grid())

    def test_bucket_counters_come_to_the_host_in_one_copy(self, monkeypatch):
        copies = []
        orig = runner_mod._host_counters

        def counting(counters):
            copies.append(len(counters))
            return orig(counters)

        monkeypatch.setattr(runner_mod, "_host_counters", counting)
        sweep(small_grid(config_axes={"n_subarrays": (8,)}))
        assert copies == [11] * 3


class TestBenches:
    def test_fig4_rows_equal_the_reference_bench(self, monkeypatch, capsys):
        n = 96
        monkeypatch.setattr(P_fig4, "N_REQUESTS", n)
        monkeypatch.setattr(R_fig4, "N_REQUESTS", n)
        monkeypatch.setattr(PE, "GLOBAL_CACHE", PE.ResultCache())
        monkeypatch.setattr(RE, "GLOBAL_CACHE", RE.ResultCache())
        got = P_fig4.run(device="cpu")
        got_rows = capsys.readouterr().out.splitlines()
        want = R_fig4.run()
        want_rows = capsys.readouterr().out.splitlines()
        assert got == want
        # the timing column differs; the names and the derived column do not
        assert len(got_rows) == 32 + 4 + 3 == len(want_rows)
        for a, b in zip(got_rows, want_rows):
            assert a.split(",")[::2] == b.split(",")[::2]

    def test_sched_rows_equal_the_reference_bench(self, jax_sched, port_sched,
                                                  monkeypatch, capsys):
        # the bench's arithmetic over the fixture's sweep of the same grid
        grid = P_sched.make_grid
        monkeypatch.setattr(P_sched, "make_grid", lambda: grid(SCHED_N))
        monkeypatch.setattr(P_sched, "run_mix_grid",
                            lambda g, device: port_sched[0])
        got = P_sched.run(device="cpu")
        rows = capsys.readouterr().out.splitlines()
        assert len(rows) == 3 + 1 + 2
        ws = {(p, s): jax_sched.weighted_speedups(p, scheduler=s).mean()
              for p, s in ((R.Policy.MASA, R.Scheduler.FCFS),
                           (R.Policy.MASA, R.Scheduler.FRFCFS),
                           (R.Policy.MASA, R.Scheduler.TCM))}
        assert got["masa_tcm_vs_frfcfs_pct"] == float(100 * (
            ws[(R.Policy.MASA, R.Scheduler.TCM)]
            / ws[(R.Policy.MASA, R.Scheduler.FRFCFS)] - 1))
        assert got["ws_MASA_FRFCFS"] == float(
            ws[(R.Policy.MASA, R.Scheduler.FRFCFS)])
