"""The refresh ladder's cell, ``refresh-1core``: its grid's shape, the
port's CPU path against the frozen reference on it at a small size (with
refresh firing), and one small run on the card (``-m cuda``)."""
from __future__ import annotations

import time

import pytest

from chipbench.harness import generator, main

CELL = "refresh-1core"
MODES = ["all_bank", "per_bank", "darp", "sarp", "dsarp"]
#: density in Gb -> (t_rfc, t_rfc_pb) cycles: HPCA 2014's tRFCab of 350,
#: 530 and 890 ns and tRFCpb = tRFCab / 2.3, rounded up at 1.875 ns a cycle
RFC = {8: (187, 82), 16: (283, 123), 32: (475, 207)}
#: the point of 32 Gb all-bank refresh
ALL_BANK_32 = 1 + 2 * len(MODES)


def _pass(seed: int = 2 ** 31 + 7):
    _, _, config, traffic = main.load_cell(CELL)
    return config, traffic, generator.make_pass(config, traffic, seed)


def test_points_are_the_ladder_with_refresh_off_written_out():
    config, _, _ = _pass()
    points = config["points"]
    assert len(points) == 16
    # a point with no overrides among points with them loses its IPC gains
    # in the harness's adapter, so refresh off is spelled out
    assert points[0] == {"refresh_policy": "none"}
    want = [{"timing": {"t_rfc": r, "t_rfc_pb": p}, "refresh_policy": m}
            for r, p in RFC.values() for m in MODES]
    assert points[1:] == want
    # the reference keys every IPC gain to a BASELINE cell at its point
    assert all(generator.allowed(p, "BASELINE") for p in points)
    assert config["policies"] == ["BASELINE", "MASA"]
    assert config["timing"]["t_refi"] == 2080
    assert config["refresh_policy"] == "none"


def test_pass_sizes():
    _, traffic, jobs = _pass()
    assert [j["label"] for j in jobs] == traffic["workloads"]
    lengths = {j["label"]: j["n_requests"] for j in jobs}
    assert min(lengths.values()) == lengths["bwaves"] == 15000
    assert max(lengths.values()) == lengths["gups"] == 45000
    assert sum(lengths.values()) == 327000
    assert all(len(generator.cells(j)) == 32 for j in jobs)
    assert sum(generator.requests(j) for j in jobs) == 10_464_000
    for j in jobs:
        launches = generator.launches(j)
        assert len(launches) == 32
        assert {k for k, _, _ in launches} == {"lane_step"}
        assert all(steps == j["n_requests"] for _, steps, _ in launches)


def test_port_equals_reference_and_refresh_fires():
    from chipbench.harness import check, program
    from chipbench.reference import jobs as ref_jobs
    config, traffic, _ = _pass()
    # gups at 6667 instructions is 300 requests: long enough for refresh
    # to fire at tREFI 2080 under both policies
    small = dict(traffic, workloads=["gups"], instructions=6667)
    (job,) = generator.make_pass(config, small, seed=2 ** 31 + 13)
    assert job["n_requests"] == 300
    prog = program.Program(config, "cpu")
    got, quarantined = prog.answers(job, prog.run(job, prog.grid(job)))
    (want,) = ref_jobs.expected([job], config, workers=1)
    assert quarantined == 0
    # 32 cells' counters and 16 points' IPC gains of MASA
    assert len(want) == 48
    assert check.compare(want, got) == (0, 0, set())
    for pol in config["policies"]:
        off = got[("cell", "gups", pol, 0)][0]
        hot = got[("cell", "gups", pol, ALL_BANK_32)][0]
        assert hot > off, (pol, hot, off)


@pytest.mark.cuda
def test_small_run_on_the_card_is_correct():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import obs
    bench, c, config, traffic = main.load_cell(CELL)
    small = dict(workloads=["bwaves", "gups"], instructions=20000)
    obs.reset()
    rec = main.run_cell(config, dict(traffic, **small), seed=2 ** 31 + 1,
                        seconds=0.5, trace=True, device="cuda",
                        t_start=time.perf_counter())
    line = main.result_line(bench, c, rec, trace=True)
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
    assert "lane_step_refresh.us_per_step" in line["metrics"]
    # every point but refresh off runs the refresh path: 30 of 32 launches
    lanes = rec["launches"]["lane_step"]
    assert lanes % 32 == 0 and lanes > 0
    assert obs.COUNTS["kernel.refresh_launches"] == lanes // 32 * 30
