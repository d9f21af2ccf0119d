"""The sweep path's spans and counter (``repro_torch.obs``).

* with no profiler recording, no span opens a profiler range and the
  tables stay empty;
* under ``torch.profiler``, every span of the path is counted as often as
  the path opens it, self time is at most the total, the spans nest as the
  code does in the profiler's own events, and each name's total in the
  table equals the profiler's;
* the sweep results are bit for bit the same with tracing on and off;
* a sweep digests each trace its cells share once, and counts that only
  while tracing; a mix sweep digests none.

Everything runs on ``device="cpu"`` at a tiny size (the kernels' plain
versions; the launch spans and the host-to-device counter exist only on a
card, and the test marked ``cuda`` holds them there). The counter of
launches with refresh on is held on the launch wrappers themselves, with a
stand-in for the kernels' library that launches nothing.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core.dram as P
import repro_torch.experiments as PE
from repro_torch import obs
from repro_torch.experiments import runner

N = 64
WORKLOADS = tuple(p for p in P.PAPER_WORKLOADS if p.name in ("mcf", "lbm"))
POLICIES = (P.Policy.BASELINE, P.Policy.MASA)
#: the profiler's own cost of entering and leaving a span, which the table
#: holds and the profiler's interval does not, at most, per span
PROFILER_NS = 100_000


def sweep_grid():
    return PE.SweepGrid(name="obs", workloads=WORKLOADS, policies=POLICIES,
                        n_requests=N)


def mix_grid():
    return PE.MixGrid(name="obs-mix", mixes=[WORKLOADS, WORKLOADS[::-1]],
                      policies=POLICIES, n_requests=N)


def run_both(device="cpu"):
    sweep = PE.run_sweep(sweep_grid(), PE.ResultCache(), device=device)
    mix = PE.run_mix_sweep(mix_grid(), device=device)
    return sweep, mix


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.fixture(autouse=True)
def fresh():
    obs.reset()
    runner.clear_trace_cache()
    yield
    obs.reset()


def test_off_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with tracing off")

    monkeypatch.setattr(obs, "_record", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    run_both()
    obs.count("engine.h2d_copies")
    assert obs.SPANS == {} and obs.COUNTS == {}
    with obs.span("x") as a, obs.span("y") as b:
        assert a is b is None


def test_sweep_spans_and_counts():
    _, prof = traced(lambda: PE.run_sweep(sweep_grid(), PE.ResultCache(),
                                          device="cpu"))
    # one bucket a policy, each of both workloads' lanes
    buckets = len(POLICIES)
    assert {k: v[0] for k, v in obs.SPANS.items()} == {
        "sweep.run": 1, "sweep.cell_key": 1,
        "frontend.generate_trace": len(WORKLOADS),
        "sweep.bucket": buckets, "sweep.stack": buckets,
        "engine.pack": buckets, "engine.range_check": buckets,
        "sweep.wait": buckets, "sweep.readback": buckets}
    # one digest a workload's trace; no copy to a card, no overlap on the CPU
    assert obs.COUNTS == {"sweep.trace_digests": len(WORKLOADS)}


def shared_trace_grid():
    """2 workloads x 3 policies x 2 configs: the 6 cells of a workload
    share its trace."""
    return PE.SweepGrid(name="obs-digests", workloads=WORKLOADS,
                        policies=(P.Policy.BASELINE, P.Policy.SALP1,
                                  P.Policy.MASA),
                        n_requests=N, config_axes={"refresh": (False, True)})


def test_one_trace_digest_a_workload_while_tracing():
    got, _ = traced(lambda: PE.run_sweep(shared_trace_grid(),
                                         PE.ResultCache(), device="cpu"))
    assert len(got.cells) == 12
    assert obs.COUNTS["sweep.trace_digests"] == len(WORKLOADS) == 2


def test_no_trace_digest_counted_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    PE.run_sweep(shared_trace_grid(), PE.ResultCache(), device="cpu")
    assert obs.COUNTS.get("sweep.trace_digests", 0) == 0


def test_a_mix_sweep_digests_no_trace():
    traced(lambda: PE.run_mix_sweep(mix_grid(), device="cpu"))
    assert obs.COUNTS.get("sweep.trace_digests", 0) == 0


def test_mix_sweep_spans_and_counts():
    traced(lambda: PE.run_mix_sweep(mix_grid(), device="cpu"))
    mixes, buckets = 2, len(POLICIES)
    # each bucket stacks its mixes once and reads back once (the cores'
    # cycles and the shared counters); the run-alone baselines are computed
    # once a mix, each one lane launch read back once; each launch is
    # waited for once
    assert {k: v[0] for k, v in obs.SPANS.items()} == {
        "sweep.run": 1, "frontend.generate_trace": 2 * len(WORKLOADS),
        "sweep.bucket": buckets, "sweep.alone": mixes,
        "sweep.stack": buckets,
        "engine.pack": buckets + mixes, "engine.range_check": buckets + mixes,
        "sweep.wait": buckets + mixes,
        "sweep.readback": buckets + mixes}


def test_a_cached_sweep_opens_no_bucket():
    cache = PE.ResultCache()
    PE.run_sweep(sweep_grid(), cache, device="cpu")
    traced(lambda: PE.run_sweep(sweep_grid(), cache, device="cpu"))
    assert {k: v[0] for k, v in obs.SPANS.items()} == {
        "sweep.run": 1, "sweep.cell_key": 1}


def test_self_time_nesting_and_the_profilers_totals():
    _, prof = traced(run_both)
    for name, (n, total, self_ns) in obs.SPANS.items():
        assert n > 0 and 0 <= self_ns <= total, name

    parents = {}
    for ev in prof.events():
        if ev.name in obs.SPANS:
            parent = ev.cpu_parent
            while parent is not None and parent.name not in obs.SPANS:
                parent = parent.cpu_parent
            parents.setdefault(ev.name, set()).add(
                None if parent is None else parent.name)
    assert parents["engine.range_check"] == {"engine.pack"}
    assert parents["engine.pack"] == {"sweep.bucket", "sweep.alone"}
    assert parents["sweep.bucket"] == {"sweep.run"}
    assert parents["sweep.cell_key"] == {"sweep.run"}
    assert parents["sweep.run"] == {None}

    kineto = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in obs.SPANS and "CPU" in str(ev.device_type()):
            n, t = kineto.get(ev.name(), (0, 0))
            kineto[ev.name()] = (n + 1, t + ev.duration_ns())
    assert set(kineto) == set(obs.SPANS)
    for name, (n, total, _) in obs.SPANS.items():
        assert kineto[name][0] == n, name
        slack = 0.05 * total + n * PROFILER_NS
        assert abs(kineto[name][1] - total) <= slack, (name, kineto[name],
                                                        total)


def test_results_equal_with_tracing_on_and_off():
    sweep_off, mix_off = run_both()
    runner.clear_trace_cache()
    (sweep_on, mix_on), _ = traced(run_both)
    assert obs.SPANS
    assert sweep_on.to_json()["cells"] == sweep_off.to_json()["cells"]
    assert mix_on.to_json()["cells"] == mix_off.to_json()["cells"]


def test_count_and_reset():
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
        obs.count("c")
        obs.count("c", 3)
        with obs.span("outer"):
            with obs.span("inner"):
                pass
    assert not torch.autograd.profiler._is_profiler_enabled
    obs.count("c")
    assert obs.COUNTS == {"c": 4}
    outer, inner = obs.SPANS["outer"], obs.SPANS["inner"]
    assert outer[0] == inner[0] == 1
    assert outer[2] == outer[1] - inner[1] and inner[2] == inner[1]
    obs.reset()
    assert obs.SPANS == {} and obs.COUNTS == {}


# ---- kernel.refresh_launches: the launch wrappers on a stand-in library ----

class _FakeLibrary:
    """The C entries of both kernels, returning success and launching
    nothing, so the launch wrappers run their host side on CPU tensors."""

    def lane_step_launch(self, *args):
        return 0

    def mix_step_launch(self, *args):
        return 0


def _launch(kernel, refresh_mode):
    from repro_torch.core.dram import cuda_step
    t = P.DramTiming()
    if kernel == "lane_step":
        xs = torch.zeros((2, 4, 6), dtype=torch.int32)
        mlp = torch.ones((2,), dtype=torch.int32)
        cuda_step._launch(int(P.Policy.MASA), 8, 8, t, refresh_mode, xs,
                          mlp, False)
    else:
        reqs = torch.zeros((1, 2, 4, 6), dtype=torch.int32)
        ones = torch.ones((1, 2), dtype=torch.int32)
        cuda_step._launch_cores(int(P.Policy.MASA), 0, 8, 8, t,
                                refresh_mode, reqs, ones, ones, False)


@pytest.fixture
def stand_in_library(monkeypatch):
    import contextlib
    import types
    from repro_torch.core.dram import cuda_step
    monkeypatch.setattr(cuda_step, "_library", lambda name: _FakeLibrary())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(cuda_step, "LAUNCHES", dict.fromkeys(
        cuda_step.LAUNCHES, 0))
    monkeypatch.setattr(cuda_step, "BODIES", {
        k: dict.fromkeys(cuda_step.BODY_NAMES, 0) for k in cuda_step.BODIES})
    return cuda_step


@pytest.mark.parametrize("kernel", ["lane_step", "mix_step"])
def test_refresh_launches_one_count_a_launch_with_refresh_on(
        stand_in_library, kernel):
    # all_bank, dsarp, per_bank, darp, sarp
    modes = [1, 2, 3, 4, 5]
    with profile(activities=[ProfilerActivity.CPU]):
        for mode in modes:
            _launch(kernel, mode)
    assert stand_in_library.LAUNCHES[kernel] == len(modes)
    assert obs.COUNTS == {"kernel.refresh_launches": len(modes)}


@pytest.mark.parametrize("kernel", ["lane_step", "mix_step"])
def test_refresh_launches_none_with_refresh_off(stand_in_library, kernel):
    with profile(activities=[ProfilerActivity.CPU]):
        _launch(kernel, 0)
        _launch(kernel, 0)
        _launch(kernel, 4)
    assert stand_in_library.LAUNCHES[kernel] == 3
    assert obs.COUNTS == {"kernel.refresh_launches": 1}


@pytest.mark.parametrize("kernel", ["lane_step", "mix_step"])
def test_refresh_launches_nothing_while_no_profiler_records(
        stand_in_library, kernel):
    assert not torch.autograd.profiler._is_profiler_enabled
    _launch(kernel, 1)
    _launch(kernel, 0)
    assert stand_in_library.LAUNCHES[kernel] == 2
    assert obs.COUNTS == {} and obs.SPANS == {}


@pytest.mark.cuda
def test_launch_spans_and_copies_on_the_card():
    from repro_torch import compat
    from repro_torch.core.dram import cuda_step
    reason = compat.kernel_unavailable_reason()
    if reason:
        pytest.skip(reason)
    cuda_step.build()
    run_both("cuda")                                        # warm
    obs.reset()
    cuda_step.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sweep, mix = run_both("cuda")
        torch.cuda.synchronize()
    lanes, mixes = cuda_step.LAUNCHES["lane_step"], cuda_step.LAUNCHES[
        "mix_step"]
    assert lanes == len(POLICIES) + 2 and mixes == len(POLICIES)
    assert obs.SPANS["kernel.lane_step"][0] == lanes
    assert obs.SPANS["kernel.mix_step"][0] == mixes
    # six request fields, the window and the timing array a lane launch;
    # the ranks besides a mix launch. Every launch of a call but its first
    # is issued before the one before it is collected: 2 of the sweep's
    # buckets, and of the mix sweep's 2 run-alone and 2 mix launches
    assert obs.COUNTS == {"engine.h2d_copies": 8 * lanes + 9 * mixes,
                          "sweep.overlapped_launches": 1 + 3,
                          "sweep.trace_digests": len(WORKLOADS)}
    # a span is no device work: on the device's timeline it is at most an
    # annotation
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in obs.SPANS and "CPU" not in str(ev.device_type()):
            assert ev.is_user_annotation(), (ev.name(), ev.device_type())
    off_sweep, off_mix = run_both("cuda")
    assert sweep.to_json()["cells"] == off_sweep.to_json()["cells"]
    assert mix.to_json()["cells"] == off_mix.to_json()["cells"]
