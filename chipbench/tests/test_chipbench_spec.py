"""The benchmark's files load by name and keep the contract's forms; the
roofline counts come from shapes alone."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from chipbench.harness import generator, main

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + [
        w["name"] for w in BENCH["workloads"]] + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
    assert {"setup_s", "sim_req_per_s"} == {m["name"]
                                           for m in BENCH["end_to_end"]}
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    bench, c, config, traffic = main.load_cell(cell)
    jobs = generator.make_pass(config, traffic, seed=2 ** 31 + 5)
    assert jobs and all(generator.requests(j) > 0 for j in jobs)
    metrics = main.readers(bench, cell)
    assert metrics, "every cell reports a per-layer metric"
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_finds_nothing_in_an_empty_run(metric):
    cell = next(w["name"] for w in BENCH["workloads"]
                if w["name"] in next(m for m in BENCH["per_layer"]
                                     if m["name"] == metric).get(
                    "workloads", [w["name"]]))
    _, read = main.readers(BENCH, cell)[metric]
    ctx = dict(window_s=1.0, busy_s=None, device_s={}, launches={},
               work={}, trace_gen_s=None, hbm_bytes_per_s=None)
    assert read(ctx) is None


def test_fig4_lengths_follow_equal_instructions():
    _, _, config, traffic = main.load_cell("fig4-1core")
    jobs = generator.make_pass(config, traffic, seed=1)
    lengths = {j["label"]: j["n_requests"] for j in jobs}
    assert lengths["gamess"] == 800 and lengths["gups"] == 90000
    assert sum(lengths.values()) == 804200
    assert [j["label"] for j in jobs] == traffic["workloads"]


def test_roofline_counts_from_shapes():
    job = dict(kind="sweep", label="w", workloads=["a", "b"], n_requests=10,
               policies=["BASELINE", "MASA"], points=[{}], seed=0)
    # one launch a policy; 2 lanes of 10 requests of 6 words, the window,
    # the 19 timing words and 18 counter words a lane out
    assert generator.launches(job) == [
        ("lane_step", 10, 4 * (2 * 10 * 6 + 2 + 19 + 2 * 18))] * 2
    assert generator.requests(job) == 2 * 2 * 10
    mix = dict(kind="mix", label="grid", mixes=[["a", "b"]] * 3,
               n_requests=5, policies=["BASELINE", "MASA"],
               points=[{"scheduler": "FCFS"},
                       {"scheduler": "FRFCFS_SALP", "policies": ["MASA"]}],
               seed=0)
    launches = generator.launches(mix)
    mix_bytes = 4 * (3 * 2 * 5 * 6 + 2 * 3 * 2 + 19 + 3 * 16 + 2 * 3 * 2)
    assert launches.count(("mix_step", 2 * 5, mix_bytes)) == 3
    # run-alone: one lane launch a mix (the points differ only in scheduler)
    assert launches.count(
        ("lane_step", 5, 4 * (2 * 5 * 6 + 2 + 19 + 2 * 18))) == 3
    assert generator.requests(mix) == 3 * 3 * 2 * 5


def test_sched_grid_is_the_scheduler_study():
    _, _, config, traffic = main.load_cell("sched-4core")
    (job,) = generator.make_pass(config, traffic, seed=1)
    assert len({(k, p) for k, _, p in generator.cells(job)}) == 10
    assert job["n_requests"] == 16384
    assert generator.requests(job) == 10 * 4 * 4 * 16384
