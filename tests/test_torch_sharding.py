"""The port's sharded sweeps (``repro_torch.experiments.sharding``) and
``what_if`` equal the JAX package's.

* ``ShardPlan`` over ``torch.device``s: partitioning, submission order,
  round-robin placement over repeated CPU devices, the ``resolve_mesh``
  grammar (``cpu`` and ``gpu``; ``cpu:4`` selects torch's one CPU device)
  and its errors, and ``ShardPlan()`` raising on a machine without CUDA;
* the ``repro.sweep-fragment/v1`` merge contract on synthetic fragments;
* sharded ``run_sweep`` / ``run_mix_sweep`` equal the unsharded run at 1-4
  shards, faults strand only their shard, and a killed sharded run resumes
  from the journal without re-running a committed cell;
* the committed ``tests/data/shard_fragments/`` (made by the JAX package):
  a live port run reproduces the fragments (the shard's ``device`` string
  normalised, as ``tests/test_sharding.py`` does) and ``merged.json`` byte
  for byte;
* ``what_if`` over the same fragments answers as the reference's does.

The port runs on ``device="cpu"`` (the kernels' plain versions).
"""
import json
import os

import pytest
import torch

import repro.experiments as RE
import repro.serve as R_serve
import repro_torch.core.dram as P
import repro_torch.experiments as PE
from repro_torch.experiments import runner as runner_mod
from repro_torch.experiments.sharding import fragment_fingerprint, resolve_mesh
from repro_torch.serve import SweepIndex, what_if

N = 96
CPU = torch.device("cpu")

#: Retries without wall-clock cost: zero backoff, no-op sleep.
FAST = PE.ResiliencePolicy(backoff_base_s=0.0, sleep=lambda s: None)

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "data",
                           "shard_fragments")


@pytest.fixture
def no_cuda():
    """Skips on a machine with CUDA (decided when the test runs, so every
    worker collects the same tests)."""
    if torch.cuda.is_available():
        pytest.skip("checks the machine without CUDA")


def tiny_grid(n_geoms=1, **kw):
    """2 workloads x 2 policies x ``n_geoms`` geometries: with one geometry
    cells 0..3 are lbm/BASE, lbm/SALP1, mcf/BASE, mcf/SALP1, bucketed by
    policy into b0=[0, 2], b1=[1, 3]; at 2 shards the submission order is
    [0], [2], [1], [3]. ``make_golden_shard_fragments.make_grid()`` is this
    grid at one geometry of 4 subarrays."""
    defaults = dict(name="t_shard", workloads=tuple(
                        p for p in P.PAPER_WORKLOADS
                        if p.name in ("mcf", "lbm")),
                    policies=(P.Policy.BASELINE, P.Policy.SALP1),
                    n_requests=N,
                    config_axes={"n_subarrays": (4, 8)[:n_geoms]})
    defaults.update(kw)
    return PE.SweepGrid(**defaults)


def golden_grid():
    return tiny_grid(name="golden_shards")


def mix_grid():
    return PE.MixGrid(name="t_shard_mix",
                      mixes=[(P.workload("mcf"), P.workload("lbm")),
                             (P.workload("gups"), P.workload("stream_copy"))],
                      policies=(P.Policy.BASELINE, P.Policy.MASA),
                      n_requests=64,
                      configs=({"scheduler": P.Scheduler.FRFCFS},))


def run(grid, cache=None, **kw):
    """``run_sweep`` on the CPU; an int ``shards`` shares the CPU."""
    if not isinstance(kw.get("shards"), PE.ShardPlan):
        kw["device"] = "cpu"
    return PE.run_sweep(grid, cache if cache is not None else PE.ResultCache(),
                        **kw)


def cells_json(sweep):
    return [c.to_json() for c in sweep.cells]


def no_device(frags):
    return [dict(f, shard=dict(f["shard"], device=None)) for f in frags]


@pytest.fixture(scope="module")
def ref2():
    return run(tiny_grid(n_geoms=2))


@pytest.fixture(scope="module")
def ref1():
    return run(tiny_grid())


# ---------------------------------------------------------------------------
# ShardPlan and the mesh grammar
# ---------------------------------------------------------------------------

class TestShardPlan:
    def test_partition_is_contiguous_and_ragged(self):
        assert PE.ShardPlan(3, [CPU]).partition(range(7)) == [
            [0, 1, 2], [3, 4], [5, 6]]
        assert PE.ShardPlan(2, [CPU]).partition([4, 7, 9]) == [[4, 7], [9]]
        assert PE.ShardPlan(4, [CPU]).partition([5, 9]) == [[5], [9]]

    def test_shards_for_submission_order_is_bucket_major(self):
        shards = PE.ShardPlan(2, [CPU]).shards_for([[0, 2], [1, 3]])
        assert [(s.bucket, s.shard, s.cells) for s in shards] == [
            (0, 0, (0,)), (0, 1, (2,)), (1, 0, (1,)), (1, 1, (3,))]

    def test_device_assignment_round_robins_over_repeated_devices(self):
        plan = PE.ShardPlan(5, ["cpu", CPU, "cpu"])
        assert plan.devices == (CPU,) * 3
        for s in range(5):
            assert plan.device_for(s) is plan.devices[s % 3]

    @pytest.mark.parametrize("spec,count", [
        ("cpu", 1), ("cpu:1", 1), ("cpu:4", 1), (" CPU ", 1)])
    def test_resolve_cpu_specs(self, spec, count):
        assert resolve_mesh(spec) == [CPU] * count
        plan = PE.ShardPlan.resolve(None, spec)
        assert plan.devices == (CPU,) and plan.n_shards == 1
        assert PE.ShardPlan.resolve(3, spec).n_shards == 3

    @pytest.mark.parametrize("spec,err,match", [
        ("cpu:0", ValueError, "selects no devices"),
        ("cpu:x", ValueError, "is not an integer"),
        ("tpu", ValueError, "unknown mesh platform 'tpu'"),
        ("cpux:2", ValueError, r"did you mean 'cpu'\?"),
    ])
    def test_bad_specs_raise(self, spec, err, match):
        with pytest.raises(err, match=match):
            resolve_mesh(spec)

    @pytest.mark.parametrize("spec", [None, "auto", "2", "gpu", "gpu:1"])
    def test_cuda_specs_raise_without_cuda(self, spec, no_cuda):
        with pytest.raises(RuntimeError, match="CUDA device"):
            resolve_mesh(spec)

    def test_default_plan_and_sweep_need_cuda(self, no_cuda):
        with pytest.raises(RuntimeError, match="CUDA device"):
            PE.ShardPlan(2)
        with pytest.raises(RuntimeError, match="CUDA device"):
            PE.run_sweep(tiny_grid(), shards=2)
        with pytest.raises(RuntimeError, match="CUDA device"):
            PE.run_mix_sweep(mix_grid(), fragment_dir="unused")

    def test_invalid_plans_raise(self):
        with pytest.raises(ValueError, match="n_shards"):
            PE.ShardPlan(0, [CPU])
        with pytest.raises(ValueError, match="names its own devices"):
            PE.run_sweep(tiny_grid(), shards=PE.ShardPlan(2, [CPU]),
                         device="cpu")

    def test_describe_names_mesh_and_devices(self):
        d = PE.ShardPlan(2, [CPU, CPU]).describe()
        assert d == {"n_shards": 2, "n_devices": 2, "devices": ["cpu"] * 2,
                     "mesh_axes": {"shards": 2}}


# ---------------------------------------------------------------------------
# Fragment merge contract (synthetic fragments)
# ---------------------------------------------------------------------------

GRID_DOC = {"name": "g", "n_requests": 8}


def frag(seq, cells, quarantined=(), n_cells=4, grid=None):
    grid = grid if grid is not None else GRID_DOC
    return {"schema_version": PE.FRAGMENT_SCHEMA, "kind": None,
            "fingerprint": fragment_fingerprint(grid, None, n_cells),
            "n_cells": n_cells, "grid": grid,
            "shard": {"role": "shard", "bucket": 0, "shard": seq,
                      "cells": list(cells)},
            "seq": seq,
            "cells": [{"index": i, "payload": i * 10} for i in cells],
            "quarantined": [{"index": i, "bucket": b} for i, b in quarantined]}


MERGES = {
    "ordered": [frag(0, [2, 0]), frag(1, [3, 1])],
    "quarantine": [frag(0, [0], quarantined=[(3, 1)]),
                   frag(1, [1], quarantined=[(2, 0)])],
    "partial": [frag(0, [0, 3])],
}


@pytest.mark.parametrize("name", list(MERGES))
def test_merge_equals_reference(name):
    frags = MERGES[name]
    full = name != "partial"
    got = PE.merge_fragments(frags, require_full=full)
    assert got == RE.merge_fragments(frags, require_full=full)
    assert got == PE.merge_fragments(frags[::-1], require_full=full)


@pytest.mark.parametrize("frags,match", [
    ([frag(0, [0, 1]), frag(1, [1, 2, 3])], "more than one"),
    ([frag(0, [0, 1, 2]), frag(1, [3], quarantined=[(2, 0)])],
     "both committed and quarantined"),
    ([frag(0, [0, 1]), frag(1, [2, 3], grid={"name": "OTHER"})],
     "fingerprint mismatch"),
    ([frag(0, [0, 3])], "2/4"),
    ([frag(0, [0, 1, 2, 4])], "out of range"),
    ([dict(frag(0, [0, 1, 2, 3]), schema_version="repro.sweep/v1")],
     "not a sweep fragment"),
    ([], "no fragments"),
], ids=["duplicate", "conflict", "fingerprint", "coverage", "range",
        "schema", "empty"])
def test_merge_refusals(frags, match):
    with pytest.raises(ValueError, match=match):
        PE.merge_fragments(frags)


# ---------------------------------------------------------------------------
# Parity: sharded execution equals single-device
# ---------------------------------------------------------------------------

class TestShardedParity:
    @pytest.mark.parametrize("s", [1, 2, 3, 4])
    def test_sweep_parity_across_shard_counts(self, s, ref2):
        sharded = run(tiny_grid(n_geoms=2), shards=s)
        assert cells_json(sharded) == cells_json(ref2)
        assert not sharded.quarantined
        assert sharded.stats["sharding"]["n_shards"] == s
        assert sharded.stats["sim_batches"] >= ref2.stats["sim_batches"]

    def test_repeated_devices_parity(self, ref2):
        sharded = run(tiny_grid(n_geoms=2),
                      shards=PE.ShardPlan(3, [CPU, CPU]))
        assert cells_json(sharded) == cells_json(ref2)
        assert sharded.stats["sharding"]["devices"] == ["cpu", "cpu"]

    def test_ragged_last_shard_parity(self):
        wls = tuple(p for p in P.PAPER_WORKLOADS
                    if p.name in ("mcf", "lbm", "gups"))
        ref = run(tiny_grid(workloads=wls))
        sharded = run(tiny_grid(workloads=wls), shards=2)
        assert cells_json(sharded) == cells_json(ref)
        assert sorted(len(f["shard"]["cells"])
                      for f in sharded.fragments) == [1, 1, 2, 2]

    def test_mix_sweep_parity(self):
        ref = PE.run_mix_sweep(mix_grid(), device="cpu")
        sharded = PE.run_mix_sweep(mix_grid(), shards=2, device="cpu")
        assert cells_json(sharded) == cells_json(ref)
        assert [f["kind"] for f in sharded.fragments] == ["mix_sweep"] * 4

    def test_fragment_dir_remerges_to_single_device_artifact(self, tmp_path,
                                                             ref2):
        d = tmp_path / "frags"
        sharded = run(tiny_grid(n_geoms=2), shards=2, fragment_dir=str(d))
        names = sorted(os.listdir(d))
        assert names == [f"fragment-{i:04d}.json" for i in range(len(names))]
        assert PE.load_fragments(d) == sharded.fragments
        merged = PE.merge_fragment_dir(d)
        assert merged["cells"] == cells_json(ref2)
        assert merged["grid"] == tiny_grid(n_geoms=2).describe()
        assert "fragments" not in sharded.to_json()
        json.dumps(sharded.to_json())

    def test_warm_cache_streams_everything_through_prologue(self, tmp_path):
        cache = PE.ResultCache()
        run(tiny_grid(), cache)
        sharded = run(tiny_grid(), cache, shards=2,
                      fragment_dir=str(tmp_path))
        assert sharded.stats["cache_hits"] == 4
        assert sharded.stats["sim_batches"] == 0
        (prologue,) = sharded.fragments
        assert prologue["shard"]["role"] == "prologue"
        assert sorted(prologue["shard"]["cells"]) == [0, 1, 2, 3]

    def test_duplicate_key_cells_ride_with_the_resolving_shard(self):
        grid = tiny_grid(policies=(P.Policy.BASELINE, P.Policy.BASELINE))
        ref = run(grid)
        sharded = run(grid, shards=2)
        assert cells_json(sharded) == cells_json(ref)
        assert sharded.stats["n_unique"] == 2
        assert PE.merge_fragments(
            sharded.fragments)["stats"]["merged_cells"] == 4


# ---------------------------------------------------------------------------
# Fault x shard composition, and kill-resume at shard boundaries
# ---------------------------------------------------------------------------

class TestFaultShardComposition:
    @pytest.mark.parametrize("kind", ["raise", "oom"])
    def test_persistent_cell_fault_strands_only_its_shard(self, kind, ref1,
                                                          tmp_path):
        sweep = run(tiny_grid(), resilience=FAST, shards=2,
                    fault_plan=PE.FaultPlan.parse(f"{kind}@c2:p"),
                    fragment_dir=str(tmp_path))
        (q,) = sweep.quarantined
        assert (q["index"], q["bucket"]) == (2, 0)
        assert cells_json(sweep) == [c for c in cells_json(ref1)
                                     if c["workload"] != "mcf"
                                     or c["policy"] != "BASELINE"]
        merged = PE.merge_fragment_dir(tmp_path)
        assert merged["quarantined"] == sweep.quarantined

    def test_bucket_fault_strands_the_whole_logical_bucket(self):
        sweep = run(tiny_grid(), resilience=FAST, shards=2,
                    fault_plan=PE.FaultPlan.parse("raise@b1:p"))
        assert [(q["index"], q["bucket"]) for q in sweep.quarantined] == [
            (1, 1), (3, 1)]

    def test_transient_fault_recovers_within_its_shard(self, ref1):
        plan = PE.FaultPlan.parse("oom@b0:x1")
        sweep = run(tiny_grid(), resilience=FAST, fault_plan=plan, shards=2)
        assert cells_json(sweep) == cells_json(ref1)
        assert sweep.stats["retries"] >= 1 and plan.log[0]["cells"] == [0]

    def test_delay_fault_never_quarantines(self, ref1):
        plan = PE.FaultPlan.parse("delay@b0:0.0")
        sweep = run(tiny_grid(), resilience=FAST, fault_plan=plan, shards=2)
        assert cells_json(sweep) == cells_json(ref1)
        assert not sweep.quarantined and plan.summary()["fired"] == 1

    def test_mix_fault_composes_with_shards(self, tmp_path):
        mix = PE.run_mix_sweep(mix_grid(), resilience=FAST, shards=2,
                               fault_plan=PE.FaultPlan.parse("raise@c1:p"),
                               fragment_dir=str(tmp_path), device="cpu")
        (q,) = mix.quarantined
        assert q["index"] == 1 and q["mix"] == "mcf+lbm"
        merged = PE.merge_fragment_dir(tmp_path)
        assert merged["kind"] == "mix_sweep"
        assert merged["quarantined"] == mix.quarantined


@pytest.mark.parametrize("kill,committed", [
    ("kill@c0", []), ("kill@c2", [0]), ("kill@c1", [0, 2]),
    ("kill@c3", [0, 2, 1])])
def test_resume_re_executes_zero_committed_cells(kill, committed, ref1,
                                                 tmp_path, monkeypatch):
    journal = tmp_path / "journal.jsonl"
    with pytest.raises(PE.SweepKilled):
        run(tiny_grid(), PE.PersistentResultCache(journal), resilience=FAST,
            fault_plan=PE.FaultPlan.parse(kill), shards=2)
    cache = PE.PersistentResultCache(journal)
    assert cache.loaded == len(committed)
    calls = []
    orig = runner_mod._SIMULATE

    def counting(stacked, policy, config, device):
        calls.append(int(stacked["bank"].shape[0]))
        return orig(stacked, policy, config, device)

    monkeypatch.setattr(runner_mod, "_SIMULATE", counting)
    d = tmp_path / "frags"
    resumed = run(tiny_grid(), cache, shards=2, fragment_dir=str(d))
    assert calls == [1] * (4 - len(committed))
    assert [dict(c, cache_hit=None) for c in cells_json(resumed)] == [
        dict(c, cache_hit=None) for c in cells_json(ref1)]
    if committed:
        prologue = resumed.fragments[0]
        assert prologue["shard"]["role"] == "prologue"
        assert sorted(prologue["shard"]["cells"]) == sorted(committed)
    assert PE.merge_fragment_dir(d)["stats"]["merged_cells"] == 4


# ---------------------------------------------------------------------------
# The committed golden fragments (made by the JAX package)
# ---------------------------------------------------------------------------

class TestGoldenFragments:
    def test_committed_fixtures_merge_byte_identical(self, tmp_path):
        merged = PE.merge_fragments(PE.load_fragments(FIXTURE_DIR))
        pinned = os.path.join(FIXTURE_DIR, "merged.json")
        out = PE.write_artifact(str(tmp_path / "merged.json"), merged)
        with open(out, "rb") as a, open(pinned, "rb") as b:
            assert a.read() == b.read()

    def test_live_port_run_reproduces_the_fixtures(self, tmp_path):
        live = run(golden_grid(), resilience=FAST, shards=2,
                   fault_plan=PE.FaultPlan.parse("raise@c2:p"),
                   fragment_dir=str(tmp_path))
        assert ({f["shard"]["device"] for f in live.fragments} == {"cpu"})
        committed = PE.load_fragments(FIXTURE_DIR)
        assert no_device(live.fragments) == no_device(committed)
        assert no_device(PE.load_fragments(tmp_path)) == no_device(committed)
        out = PE.write_artifact(str(tmp_path / "merged.json"),
                                PE.merge_fragment_dir(tmp_path))
        with open(out, "rb") as a, open(os.path.join(FIXTURE_DIR,
                                                     "merged.json"), "rb") as b:
            assert a.read() == b.read()


# ---------------------------------------------------------------------------
# what-if queries
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frag_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("frags")
    run(tiny_grid(n_geoms=2), shards=2, fragment_dir=str(d))
    return d


QUERIES = [("mcf", None, {}), ("mcf", {"n_subarrays": 8}, {}),
           ("lbm", None, {"metric": "ipc"}),
           ("lbm", {"n_subarrays": 4}, {"metric": "row_hit_rate",
                                         "top": 2})]


class TestWhatIf:
    @pytest.mark.parametrize("workload,axes,query", QUERIES,
                             ids=["cycles", "n_subarrays", "ipc", "top2"])
    def test_answers_equal_the_reference(self, frag_dir, workload, axes,
                                         query):
        got = what_if(workload, axes, fragments=frag_dir, **query)
        assert got == R_serve.what_if(workload, axes, fragments=frag_dir,
                                      **query)

    def test_ranks_candidates_from_fragment_directory(self, frag_dir):
        ans = what_if("mcf", fragments=frag_dir)
        assert ans["n_candidates"] == 4 and ans["minimize"] is True
        vals = [c["total_cycles"] for c in ans["ranking"]]
        assert vals == sorted(vals)

    def test_artifact_source_and_errors(self, ref1):
        idx = SweepIndex.from_artifact(ref1.to_json())
        assert idx.what_if("lbm", metric="ipc")["minimize"] is False
        with pytest.raises(LookupError, match="no cells"):
            idx.what_if("nonexistent_workload")
        with pytest.raises(ValueError, match="exactly one"):
            what_if("mcf")

    def test_counts_quarantined_matches(self):
        sweep = run(tiny_grid(), resilience=FAST, shards=2,
                    fault_plan=PE.FaultPlan.parse("raise@c2:p"))
        ans = SweepIndex([sweep.to_json()]).what_if("mcf")
        assert ans["n_candidates"] == 1
        assert ans["n_quarantined_matches"] == 1
