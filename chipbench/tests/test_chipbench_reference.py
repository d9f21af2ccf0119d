"""The frozen reference equals the port's CPU path, counter for counter, and
a run whose timed path is broken comes out not correct.

These run the harness itself (``run_cell``) on the CPU at small sizes:
the port's plain PyTorch versions stand where the card's kernels run."""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from chipbench.harness import main
from chipbench.reference import dram, frontend
from chipbench.tools.control import control_reading

SMALL = {
    "fig4-1core": dict(workloads=["gamess", "mcf", "gups"],
                       instructions=8000),
    "sched-4core": None,        # set in _small: two mixes, 40 requests a core
}


def _small(cell: str):
    bench, c, config, traffic = main.load_cell(cell)
    if cell == "sched-4core":
        traffic = dict(traffic, mixes=traffic["mixes"][:2], n_requests=40)
    else:
        traffic = dict(traffic, **SMALL[cell])
    return bench, c, config, traffic


def _run(cell: str, seed: int = 2 ** 31 + 11):
    bench, c, config, traffic = _small(cell)
    rec = main.run_cell(config, traffic, seed=seed, seconds=0.0, trace=False,
                        device="cpu", t_start=time.perf_counter(), workers=1)
    return main.result_line(bench, c, rec, trace=False), rec


@pytest.mark.parametrize("cell", ["fig4-1core", "sched-4core"])
def test_sound_run_is_correct(cell):
    line, rec = _run(cell)
    assert line["correct"], line["checks"]
    assert rec["jobs"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"sim_req_per_s", "setup_s"}


def _zeroed(res):
    return dataclasses.replace(res, **{
        f.name: torch.zeros_like(getattr(res, f.name))
        for f in dataclasses.fields(res) if f.name != "n_requests"})


def _fault_unchanged(orig):
    """The step returns its state unchanged: every counter stays at 0."""
    def f(*a, **k):
        res, maxc = orig(*a, **k)
        return _zeroed(res), torch.zeros_like(maxc)
    return f


def _fault_half(orig, xs_at):
    """Half of the batch left out: the first half of the chains (or, with
    one chain, of its requests) is simulated and stands for the rest."""
    def f(*a, **k):
        a = list(a)
        xs = a[xs_at]
        if xs.shape[0] > 1:
            h = (xs.shape[0] + 1) // 2
            a[xs_at] = xs[:h].contiguous()
            for j in range(xs_at + 1, len(a)):
                if torch.is_tensor(a[j]) and a[j].shape[:1] == xs.shape[:1]:
                    a[j] = a[j][:h].contiguous()
            res, maxc = orig(*a, **k)
            idx = torch.arange(xs.shape[0]) % h
            return (dataclasses.replace(res, **{
                n.name: getattr(res, n.name)[idx]
                for n in dataclasses.fields(res)}), maxc[idx])
        a[xs_at] = xs[..., : max(xs.shape[-2] // 2, 1), :].contiguous()
        res, maxc = orig(*a, **k)
        return dataclasses.replace(res, **{
            n.name: getattr(res, n.name) * 2
            for n in dataclasses.fields(res)}), maxc * 2
    return f


def _fault_altered(orig):
    """One answer altered where it is produced."""
    def f(*a, **k):
        res, maxc = orig(*a, **k)
        tc = res.total_cycles.clone()
        tc[0] += 1
        return dataclasses.replace(res, total_cycles=tc), maxc
    return f


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", ["fig4-1core", "sched-4core"])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.core.dram import cuda_step
    for name, xs_at in (("simulate_lanes", 5), ("simulate_cores", 6)):
        orig = getattr(cuda_step, name)
        wrap = {"unchanged": lambda: _fault_unchanged(orig),
                "half": lambda: _fault_half(orig, xs_at),
                "altered": lambda: _fault_altered(orig)}[fault]()
        monkeypatch.setattr(cuda_step, name, wrap)
    line, _ = _run(cell)
    assert not line["correct"]
    assert line["checks"]["answers_wrong"]["value"] > 0


@pytest.mark.parametrize("cell", ["fig4-1core", "sched-4core"])
def test_control_is_not_correct(cell):
    _, _, config, traffic = _small(cell)
    r = control_reading(config, traffic, seed=7, quantum=2, workers=1)
    assert r["answers_wrong"] > 0


# ---- the reference's controller, step for step, on every refresh mode ----

MODES = ["none", "all_bank", "dsarp", "per_bank", "darp", "sarp"]


def _timing(mode):
    from repro_torch.core.dram.timing import DDR3_1066
    t = DDR3_1066 if mode == "none" else dataclasses.replace(DDR3_1066,
                                                             t_refi=300)
    return t, dram.Timing(**dataclasses.asdict(t))


@pytest.mark.parametrize("row_policy", ["open", "closed"])
@pytest.mark.parametrize("mode", MODES)
def test_lanes_equal_port(mode, row_policy):
    from repro_torch.core.dram.engine import SimConfig, simulate_stacked
    from repro_torch.core.dram.policies import Policy
    from repro_torch.core.dram.trace import (WORKLOADS_BY_NAME,
                                             generate_trace, stack_traces)
    t, ref_t = _timing(mode)
    names, n, seed = ["gups", "lbm", "hmmer"], 200, 2 ** 31 + 3
    suite, core = frontend.load_suite("salp_workloads"), frontend.Core()
    cfg = SimConfig(timing=t, refresh_policy=mode, row_policy=row_policy)
    traces = [generate_trace(WORKLOADS_BY_NAME[w], n, seed=seed)
              for w in names]
    for pol in Policy:
        res = simulate_stacked(stack_traces(traces), pol, cfg, device="cpu")
        for i, w in enumerate(names):
            tr = frontend.generate(suite[w], n, 8, 8, 32768, core, seed)
            want = dram.run_lane(tr, int(pol), 8, 8, ref_t,
                                 dram.REFRESH[mode], row_policy == "closed")
            got = {k: int(getattr(res, k)[i]) for k in dram.COUNTERS}
            assert got == want, (pol.name, w)


@pytest.mark.parametrize("mode", MODES)
def test_mixes_equal_port(mode):
    from repro_torch.core.dram.engine import SimConfig
    from repro_torch.core.dram.multicore import simulate_multicore_batch
    from repro_torch.core.dram.policies import Policy
    from repro_torch.core.dram.schedulers import Scheduler
    from repro_torch.core.dram.trace import WORKLOADS_BY_NAME, generate_trace
    t, ref_t = _timing(mode)
    mix, n, seed = ["mcf", "lbm", "omnetpp", "gups"], 60, 5
    suite, core = frontend.load_suite("salp_workloads"), frontend.Core()
    traces = [generate_trace(WORKLOADS_BY_NAME[w], n, seed=seed,
                             row_space_offset=4096 * i)
              for i, w in enumerate(mix)]
    ref_traces = [frontend.generate(suite[w], n, 8, 8, 32768, core, seed,
                                    4096 * i) for i, w in enumerate(mix)]
    ranks = np.argsort(np.argsort([suite[w].mpki for w in mix])).tolist()
    for sched in Scheduler:
        for pol in (Policy.BASELINE, Policy.SALP1, Policy.MASA, Policy.IDEAL):
            cfg = SimConfig(timing=t, refresh_policy=mode, scheduler=sched)
            (out,) = simulate_multicore_batch([traces], pol, cfg,
                                              alone_cycles=np.zeros(4),
                                              device="cpu")
            want, core_cycles = dram.run_mix(ref_traces, ranks, int(pol),
                                             int(sched), 8, 8, ref_t,
                                             dram.REFRESH[mode])
            got = {k: int(getattr(out.shared, k)) for k in dram.COUNTERS}
            assert got == want, (sched.name, pol.name)
            assert out.core_cycles.tolist() == core_cycles
