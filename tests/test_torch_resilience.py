"""The port's resilience layer (``repro_torch.experiments.resilience``) and
result journal equal the JAX package's.

* the ``FaultPlan`` grammar parses to the reference's faults and refuses the
  same specs;
* ``execute_buckets`` against a fake simulator: retry, bisection,
  quarantine, kill propagation, and stragglers driven only by the ``delay``
  fault on an injected clock (no wall-clock race); a CUDA error propagates
  at once, where the reference would retry it;
* ``run_sweep`` / ``run_mix_sweep`` quarantine records, stats and cells
  equal the live JAX runners' under the same ``FaultPlan``;
* kill-at-every-bucket-boundary resume from the journal, a torn journal
  line, and the cache's defensive copies.

The port runs on ``device="cpu"`` (the kernels' plain versions).
"""
import dataclasses
import json
import types

import pytest
import torch

import repro.core.dram as R
import repro.experiments as RE
import repro_torch.core.dram as P
import repro_torch.experiments as PE
from repro_torch.experiments import resilience as res_mod
from repro_torch.experiments import runner as runner_mod

N = 128

#: Retries without wall-clock cost: zero backoff, no-op sleep.
FAST = PE.ResiliencePolicy(backoff_base_s=0.0, sleep=lambda s: None)
R_FAST = RE.ResiliencePolicy(backoff_base_s=0.0, sleep=lambda s: None)


def tiny_grid(mod=P, E=PE, **kw):
    defaults = dict(name="t", workloads=tuple(
                        p for p in mod.PAPER_WORKLOADS
                        if p.name in ("mcf", "lbm")),
                    policies=(mod.Policy.BASELINE, mod.Policy.SALP1),
                    n_requests=N, config_axes={"n_subarrays": (4, 8)})
    defaults.update(kw)
    return E.SweepGrid(**defaults)


def one_geom(mod=P, E=PE):
    return tiny_grid(mod, E, config_axes={"n_subarrays": (4,)})


def port_sweep(grid, cache=None, **kw):
    return PE.run_sweep(grid, cache if cache is not None else PE.ResultCache(),
                        device="cpu", **kw)


# ---------------------------------------------------------------------------
# FaultPlan spec grammar
# ---------------------------------------------------------------------------

GOOD_SPEC = "oom@b0:x2, raise@c4:p, delay@b1:0.05, corrupt@c2, kill@b3"


class TestFaultPlanParse:
    def test_full_grammar_equals_reference(self):
        got = PE.FaultPlan.parse(GOOD_SPEC).faults
        want = RE.FaultPlan.parse(GOOD_SPEC).faults
        assert [dataclasses.astuple(f) for f in got] == [
            dataclasses.astuple(f) for f in want]
        assert [(f.kind, f.bucket, f.cell, f.times) for f in got] == [
            ("oom", 0, None, 2), ("raise", None, 4, None),
            ("delay", 1, None, 1), ("corrupt", None, 2, 1),
            ("kill", 3, None, 1)]

    @pytest.mark.parametrize("spec", [
        "", "explode@b0", "raise", "raise@z1", "raise@b", "raise@b0:q",
        "raise@c-1",
    ])
    def test_bad_specs_raise_as_the_reference(self, spec):
        with pytest.raises(ValueError) as r:
            RE.FaultPlan.parse(spec)
        with pytest.raises(ValueError) as p:
            PE.FaultPlan.parse(spec)
        assert str(p.value) == str(r.value)

    def test_times_bounds_firing(self):
        plan = PE.FaultPlan.parse("raise@b0:x2")
        for _ in range(2):
            with pytest.raises(RuntimeError, match="injected fault"):
                plan.before(0, [0])
        plan.before(0, [0])
        assert plan.summary() == {"n_faults": 1, "fired": 2}

    def test_fault_needs_target(self):
        with pytest.raises(ValueError, match="bucket and/or cell"):
            PE.Fault(kind="raise")

    def test_corrupt_flips_counters_negative(self):
        out = PE.FaultPlan.parse("corrupt@c1").after(
            0, [0, 1], {0: {"a": 5}, 1: {"a": 5, "b": 0}})
        assert out == {0: {"a": 5}, 1: {"a": -6, "b": -1}}

    def test_corrupt_handles_object_results(self):
        r = types.SimpleNamespace(counters={"a": 3})
        out = PE.FaultPlan.parse("corrupt@b0").after(0, [7], {7: r})
        assert out[7].counters == {"a": -4}


# ---------------------------------------------------------------------------
# execute_buckets against a fake simulator
# ---------------------------------------------------------------------------

def fake_sim(idxs):
    return {i: {"v": i * 10 + 1} for i in idxs}


def run_fake(buckets, plan=None, policy=FAST, sim=fake_sim):
    got = {}
    report = res_mod.execute_buckets(buckets, sim, got.update,
                                     policy=policy, fault_plan=plan)
    return got, report


class FakeClock:
    """``time`` for the resilience module: a bucket takes 1 ms, and a sleep
    (the ``delay`` fault's) advances the clock instead of waiting."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 1e-3
        return self.now

    def sleep(self, s):
        self.now += s


class TestExecuteBuckets:
    def test_clean_run_commits_everything(self):
        got, report = run_fake([[0, 1], [2, 3]])
        assert got == fake_sim([0, 1, 2, 3])
        assert (report.n_batches, report.retries, report.bisections) == (
            2, 0, 0)

    def test_transient_fault_recovered_by_retry(self):
        got, report = run_fake([[0, 1], [2, 3]],
                               plan=PE.FaultPlan.parse("oom@b0:x1"))
        assert got == fake_sim([0, 1, 2, 3])
        assert report.retries == 1 and not report.quarantined

    def test_persistent_cell_fault_bisected_to_single_cell(self):
        got, report = run_fake([[0, 1, 2, 3]],
                               plan=PE.FaultPlan.parse("raise@c2:p"))
        assert sorted(got) == [0, 1, 3]
        (q,) = report.quarantined
        assert (q.index, q.bucket, q.attempts) == (2, 0, FAST.max_retries + 1)
        assert q.error.startswith("RuntimeError: injected fault")
        assert report.bisections == 2

    def test_persistent_bucket_fault_quarantines_whole_bucket(self):
        got, report = run_fake([[0, 1], [2, 3]],
                               plan=PE.FaultPlan.parse("oom@b0:p"))
        assert sorted(got) == [2, 3]
        assert sorted(q.index for q in report.quarantined) == [0, 1]
        assert all("SimulatedOOM" in q.error for q in report.quarantined)

    def test_bisect_disabled_is_all_or_nothing(self):
        got, report = run_fake(
            [[0, 1, 2, 3]], plan=PE.FaultPlan.parse("raise@c2:p"),
            policy=dataclasses.replace(FAST, bisect=False))
        assert got == {} and report.bisections == 0
        assert sorted(q.index for q in report.quarantined) == [0, 1, 2, 3]

    def test_kill_propagates_and_keeps_committed_buckets(self):
        got = {}
        with pytest.raises(PE.SweepKilled):
            res_mod.execute_buckets([[0], [1], [2]], fake_sim, got.update,
                                    policy=FAST,
                                    fault_plan=PE.FaultPlan.parse("kill@b1"))
        assert got == fake_sim([0])

    def test_oom_is_a_memory_error(self):
        assert issubclass(PE.SimulatedOOM, MemoryError)

    def test_delay_fault_flags_straggler(self, monkeypatch):
        clock = FakeClock()
        monkeypatch.setattr(res_mod, "time", clock)
        plan = PE.FaultPlan.parse("delay@b3:0.05")
        got, report = run_fake([[0], [1], [2], [3]], plan=plan)
        assert got == fake_sim([0, 1, 2, 3])
        assert [s["bucket"] for s in report.stragglers] == [3]
        assert report.stragglers[0]["elapsed_s"] == pytest.approx(0.051)
        assert plan.log[-1]["kind"] == "delay"
        assert report.stats()["watchdog"]["stragglers"] == report.stragglers

    @pytest.mark.parametrize("err", [
        RuntimeError("lane_step launch failed: CUDA error 700"),
        RuntimeError("CUDA error: an illegal memory access was encountered"),
        torch.AcceleratorError("illegal memory access"),
    ], ids=["launch", "async", "accelerator"])
    def test_a_cuda_error_propagates_without_retry(self, err):
        calls = []

        def sim(idxs):
            calls.append(list(idxs))
            if 2 in idxs:
                raise err
            return fake_sim(idxs)

        got = {}
        with pytest.raises(type(err)):
            res_mod.execute_buckets([[0, 1], [2, 3], [4]], sim, got.update,
                                    policy=FAST)
        assert calls == [[0, 1], [2, 3]] and got == fake_sim([0, 1])
        assert res_mod.device_fault(err)

    def test_an_allocator_oom_is_still_retried(self):
        calls = []

        def sim(idxs):
            calls.append(list(idxs))
            if len(calls) == 1:
                raise torch.OutOfMemoryError("CUDA out of memory")
            return fake_sim(idxs)

        got, report = run_fake([[0, 1]], sim=sim)
        assert got == fake_sim([0, 1]) and report.retries == 1


# ---------------------------------------------------------------------------
# run_sweep / run_mix_sweep against the JAX runners under the same faults
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_c2():
    return RE.run_sweep(one_geom(R, RE), RE.ResultCache(), resilience=R_FAST,
                        fault_plan=RE.FaultPlan.parse("raise@c2:p"))


class TestSweepQuarantine:
    def test_cell_fault_record_equals_reference(self, jax_c2):
        got = port_sweep(one_geom(), resilience=FAST,
                         fault_plan=PE.FaultPlan.parse("raise@c2:p"))
        (q,) = got.quarantined
        assert (q["workload"], q["policy"], q["index"]) == ("mcf", "BASELINE",
                                                            2)
        doc, want = got.to_json(), jax_c2.to_json()
        assert doc["quarantined"] == want["quarantined"]
        assert doc["cells"] == want["cells"]
        for k in ("n_cells", "simulated_cells", "sim_batches",
                  "quarantined_cells", "retries", "bisections",
                  "quarantined"):
            assert doc["stats"][k] == want["stats"][k], k
        json.dumps(doc)

    def test_metric_error_names_quarantine(self):
        s = port_sweep(one_geom(), resilience=FAST,
                       fault_plan=PE.FaultPlan.parse("raise@c2:p"))
        with pytest.raises(ValueError, match="quarantined"):
            s.metric("total_cycles", policy=P.Policy.BASELINE)

    def test_transient_fault_is_invisible_in_results(self):
        clean = port_sweep(tiny_grid())
        faulted = port_sweep(tiny_grid(), resilience=FAST,
                             fault_plan=PE.FaultPlan.parse("oom@b0:x1"))
        assert faulted.stats["retries"] == 1 and not faulted.quarantined
        assert [c.counters for c in clean.cells] == [
            c.counters for c in faulted.cells]

    def test_corrupt_fault_equals_reference(self):
        got = port_sweep(one_geom(), resilience=FAST,
                         fault_plan=PE.FaultPlan.parse("corrupt@c1"))
        want = RE.run_sweep(one_geom(R, RE), RE.ResultCache(),
                            resilience=R_FAST,
                            fault_plan=RE.FaultPlan.parse("corrupt@c1"))
        assert got.to_json()["cells"] == want.to_json()["cells"]
        bad = [c for c in got.cells if all(v < 0 for v in c.counters.values())]
        assert [(c.workload.name, c.policy) for c in bad] == [
            ("lbm", P.Policy.SALP1)]

    def test_mix_sweep_quarantine_equals_reference(self):
        def grid(mod, E):
            return E.MixGrid(name="t_mix",
                             mixes=[(mod.workload("mcf"),
                                     mod.workload("lbm"))],
                             policies=(mod.Policy.BASELINE, mod.Policy.MASA),
                             n_requests=64)

        got = PE.run_mix_sweep(grid(P, PE), resilience=FAST, device="cpu",
                               fault_plan=PE.FaultPlan.parse("raise@c0:p"))
        want = RE.run_mix_sweep(grid(R, RE), resilience=R_FAST,
                                fault_plan=RE.FaultPlan.parse("raise@c0:p"))
        assert got.quarantined == want.quarantined
        assert got.to_json()["cells"] == want.to_json()["cells"]
        (q,) = got.quarantined
        assert q["mix"] == "mcf+lbm" and q["policy"] == "BASELINE"
        with pytest.raises(ValueError, match="quarantined"):
            got.weighted_speedups(P.Policy.BASELINE)


# ---------------------------------------------------------------------------
# Crash resume from the journal
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clean():
    return port_sweep(tiny_grid())


@pytest.mark.parametrize("k", range(4))
def test_kill_at_bucket_boundary_resumes_bit_identical(k, clean, tmp_path,
                                                       monkeypatch):
    journal = tmp_path / "j.jsonl"
    with pytest.raises(PE.SweepKilled):
        port_sweep(tiny_grid(), PE.PersistentResultCache(journal),
                   resilience=FAST,
                   fault_plan=PE.FaultPlan([PE.Fault(kind="kill", bucket=k)]))
    cache = PE.PersistentResultCache(journal)
    assert cache.loaded == 2 * k
    calls = []
    orig = runner_mod._SIMULATE

    def counting(stacked, policy, config, device):
        calls.append(stacked["bank"].shape)
        return orig(stacked, policy, config, device)

    monkeypatch.setattr(runner_mod, "_SIMULATE", counting)
    resumed = port_sweep(tiny_grid(), cache)
    assert len(calls) == 4 - k
    assert resumed.stats["cache_hits"] == 2 * k
    assert [(c.key, c.counters) for c in resumed.cells] == [
        (c.key, c.counters) for c in clean.cells]


def test_kill_then_resume_through_faulted_run(tmp_path):
    journal = tmp_path / "j.jsonl"
    with pytest.raises(PE.SweepKilled):
        port_sweep(tiny_grid(), PE.PersistentResultCache(journal),
                   resilience=FAST, fault_plan=PE.FaultPlan.parse("kill@b2"))
    resumed = port_sweep(tiny_grid(), PE.PersistentResultCache(journal),
                         resilience=FAST,
                         fault_plan=PE.FaultPlan.parse("raise@c7:p"))
    assert resumed.stats["cache_hits"] == 4
    assert resumed.stats["quarantined_cells"] == 1
    assert len(resumed.cells) == resumed.stats["n_cells"] - 1


# ---------------------------------------------------------------------------
# Persistent result cache (journal) + defensive copies
# ---------------------------------------------------------------------------

class TestPersistentResultCache:
    def test_roundtrip(self, tmp_path):
        p = tmp_path / "cache.jsonl"
        c1 = PE.PersistentResultCache(p)
        c1.put("k1", {"a": 1, "b": 2})
        c1.put("k2", {"a": 3})
        c1.flush()
        c2 = PE.PersistentResultCache(p)
        assert (c2.loaded, c2.dropped) == (2, 0)
        assert c2.get("k1") == {"a": 1, "b": 2} and c2.get("k2") == {"a": 3}
        assert c2.stats()["journal"] == str(p)

    def test_flush_is_atomic_and_lazy(self, tmp_path):
        p = tmp_path / "cache.jsonl"
        c = PE.PersistentResultCache(p)
        c.flush()
        assert not p.exists()
        c.put("k", {"a": 1})
        c.flush()
        assert p.exists() and not list(tmp_path.glob("*.tmp.*"))
        before = p.read_text()
        c.flush()
        assert p.read_text() == before

    def test_torn_and_malformed_lines_dropped_as_the_reference(self,
                                                               tmp_path):
        p = tmp_path / "cache.jsonl"
        c1 = PE.PersistentResultCache(p)
        c1.put("good", {"a": 1})
        c1.flush()
        with open(p, "a") as f:
            f.write('not json at all\n')
            f.write('{"key": "no_counters"}\n')
            f.write('{"key": "torn", "counters": {"a": 1')
        got, want = PE.PersistentResultCache(p), RE.PersistentResultCache(p)
        assert (got.loaded, got.dropped) == (want.loaded, want.dropped) == (
            1, 3)
        assert got.get("good") == {"a": 1}

    def test_install_global_cache_rebinds_both_aliases(self, tmp_path):
        from repro_torch.experiments import cache as cache_mod
        mine = PE.PersistentResultCache(tmp_path / "j.jsonl")
        prev = PE.install_global_cache(mine)
        try:
            assert PE.GLOBAL_CACHE is mine and cache_mod.GLOBAL_CACHE is mine
        finally:
            assert PE.install_global_cache(prev) is mine
        assert PE.GLOBAL_CACHE is prev and cache_mod.GLOBAL_CACHE is prev


@pytest.mark.parametrize("make", [
    PE.ResultCache, lambda: PE.PersistentResultCache("unused.jsonl")],
    ids=["memory", "journal"])
def test_cache_exchanges_defensive_copies(make, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cache = make()
    mine = {"a": 1}
    cache.put("k", mine)
    mine["a"] = 999
    assert cache.get("k") == {"a": 1}
    out = cache.get("k")
    out["a"] = -5
    assert cache.get("k") == {"a": 1}
