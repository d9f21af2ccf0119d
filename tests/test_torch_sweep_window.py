"""Buckets issued ahead and collected in order (``execute_buckets``'s
``window``, ``repro_torch.experiments.streams``), on the CPU.

* ``execute_buckets`` against a fake issue / collect pair, at a window of 1
  and of 8: commits in bucket order, never more than the window in flight,
  a kill at every bucket boundary leaves exactly the earlier buckets
  committed, retry / bisect / quarantine give the window-1 report, a
  ``corrupt`` fault at collect and a failure at collect are handled, and a
  CUDA error propagates with the earlier buckets committed;
* the runners at a window of 8 (their CUDA window, forced on the CPU) equal
  the window-1 path, faults included;
* the issuer's overlap counter and its launches' bookkeeping.

The port runs on ``device="cpu"`` (the kernels' plain versions). The card
tests (``tests/test_torch_cuda.py``) hold the streams themselves.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core.dram as P
import repro_torch.experiments as PE
from repro_torch import obs
from repro_torch.experiments import resilience as res_mod
from repro_torch.experiments import streams

WINDOWS = (1, 8)
#: Retries without wall-clock cost: zero backoff, no-op sleep.
FAST = PE.ResiliencePolicy(backoff_base_s=0.0, sleep=lambda s: None)
BUCKETS = [[0, 1], [2, 3, 4, 5], [6], [7, 8], [9, 10, 11], [12], [13, 14],
           [15], [16, 17], [18], [19, 20]]


def counters(idxs):
    return {i: {"v": i * 10 + 1} for i in idxs}


class FakeDevice:
    """A simulator split into issue and collect: logs both, tracks how many
    buckets are in flight, and fails where it is told to."""

    def __init__(self, fail_collect=None):
        self.log, self.open, self.most_open = [], 0, 0
        self.fail_collect = fail_collect or (lambda idxs: None)

    def issue(self, idxs):
        self.log.append(("issue", list(idxs)))
        self.open += 1
        self.most_open = max(self.most_open, self.open)

        def collect():
            self.log.append(("collect", list(idxs)))
            self.open -= 1
            err = self.fail_collect(idxs)
            if err is not None:
                raise err
            return counters(idxs)
        return collect


def run_fake(window, plan=None, buckets=BUCKETS, device=None, policy=FAST):
    device = device or FakeDevice()
    commits = []
    report = res_mod.execute_buckets(
        buckets, device.issue, lambda out: commits.append(out),
        policy=policy, fault_plan=plan, window=window)
    return commits, report, device


def report_key(report):
    return (report.n_batches, report.retries, report.bisections,
            [dataclasses.astuple(q) for q in report.quarantined])


@pytest.mark.parametrize("window", WINDOWS)
class TestWindow:
    def test_commits_in_bucket_order(self, window):
        commits, report, dev = run_fake(window)
        assert [sorted(c) for c in commits] == BUCKETS
        assert [list(c) for c in commits] == BUCKETS
        assert report.n_batches == len(BUCKETS)
        assert [idxs for kind, idxs in dev.log if kind == "collect"] == BUCKETS

    def test_issues_ahead_up_to_the_window(self, window):
        _, _, dev = run_fake(window)
        assert dev.most_open == min(window, len(BUCKETS))
        kinds = [kind for kind, _ in dev.log]
        assert kinds[:2] == (["issue", "collect"] if window == 1
                             else ["issue", "issue"])
        # the oldest is collected before one more is issued
        assert kinds[:window + 2] == ["issue"] * window + ["collect", "issue"]

    @pytest.mark.parametrize("k", range(len(BUCKETS)))
    def test_kill_at_every_bucket_leaves_the_earlier_committed(self, window,
                                                               k):
        dev, commits = FakeDevice(), []
        with pytest.raises(PE.SweepKilled):
            res_mod.execute_buckets(
                BUCKETS, dev.issue, commits.append, policy=FAST,
                fault_plan=PE.FaultPlan.parse(f"kill@b{k}"), window=window)
        assert [list(c) for c in commits] == BUCKETS[:k]
        assert ("issue", BUCKETS[k]) not in dev.log

    @pytest.mark.parametrize("spec", [
        "oom@b0:x1", "oom@b3:x2", "raise@c4:p", "oom@b1:p",
        "raise@c9:x2,raise@c16:p", "delay@b2:0.001,raise@c20:p",
        "raise@c0:p,raise@c19:p",
    ])
    def test_retry_bisect_quarantine_report_equals_window_one(self, window,
                                                              spec):
        got = run_fake(window, PE.FaultPlan.parse(spec))
        want = run_fake(1, PE.FaultPlan.parse(spec))
        assert got[0] == want[0]
        assert report_key(got[1]) == report_key(want[1])

    def test_bisect_disabled_quarantines_the_bucket(self, window):
        commits, report, _ = run_fake(
            window, PE.FaultPlan.parse("raise@c3:p"),
            policy=dataclasses.replace(FAST, bisect=False))
        assert sorted(q.index for q in report.quarantined) == BUCKETS[1]
        assert [list(c) for c in commits] == BUCKETS[:1] + BUCKETS[2:]

    def test_corrupt_at_collect(self, window):
        commits, _, _ = run_fake(window, PE.FaultPlan.parse("corrupt@c3"))
        merged = {i: v for c in commits for i, v in c.items()}
        assert merged[3] == {"v": -32}
        assert merged[2] == {"v": 21}
        assert [list(c) for c in commits] == BUCKETS

    def test_a_failed_collect_is_retried_in_order(self, window):
        fired = []

        def fail(idxs):
            if 5 in idxs and not fired:
                fired.append(idxs)
                return RuntimeError("transient")
            return None

        commits, report, _ = run_fake(window, device=FakeDevice(fail))
        assert [list(c) for c in commits] == BUCKETS
        assert report.retries == 1 and not report.quarantined

    def test_a_persistent_collect_failure_is_quarantined(self, window):
        def fail(idxs):
            return RuntimeError("poisoned") if 12 in idxs else None

        commits, report, _ = run_fake(window, device=FakeDevice(fail))
        assert [list(c) for c in commits] == BUCKETS[:5] + BUCKETS[6:]
        (q,) = report.quarantined
        assert (q.index, q.bucket, q.attempts) == (12, 5,
                                                   FAST.max_retries + 1)
        assert q.error == "RuntimeError: poisoned"

    @pytest.mark.parametrize("at", ["issue", "collect"])
    def test_a_cuda_error_propagates_with_the_earlier_committed(self, window,
                                                                at):
        err = RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")
        dev = FakeDevice(lambda idxs: err if 6 in idxs and at == "collect"
                         else None)
        issue = dev.issue
        if at == "issue":
            def issue(idxs):
                if 6 in idxs:
                    raise err
                return dev.issue(idxs)
        commits = []
        with pytest.raises(RuntimeError, match="CUDA error"):
            res_mod.execute_buckets(BUCKETS, issue, commits.append,
                                    policy=FAST, window=window)
        assert [list(c) for c in commits] == BUCKETS[:2]

    def test_plain_results_are_taken_as_collected(self, window):
        commits = []
        res_mod.execute_buckets(BUCKETS, counters, commits.append,
                                policy=FAST, window=window)
        assert [list(c) for c in commits] == BUCKETS


# ---------------------------------------------------------------------------
# The runners at their CUDA window, on the CPU
# ---------------------------------------------------------------------------

N = 96


def sweep_grid():
    return PE.SweepGrid(
        name="w", workloads=tuple(p for p in P.PAPER_WORKLOADS
                                  if p.name in ("mcf", "lbm", "gcc")),
        policies=(P.Policy.BASELINE, P.Policy.SALP1, P.Policy.MASA,
                  P.Policy.IDEAL),
        n_requests=N, config_axes={"n_subarrays": (4, 8)})


def mix_grid():
    wl = {p.name: p for p in P.PAPER_WORKLOADS}
    return PE.MixGrid(
        name="w-mix", mixes=[(wl["mcf"], wl["lbm"]), (wl["gcc"], wl["mcf"])],
        policies=(P.Policy.BASELINE, P.Policy.MASA), n_requests=N,
        configs=[{"scheduler": s, "refresh": True}
                 for s in (P.Scheduler.FCFS, P.Scheduler.FRFCFS)])


def comparable(result):
    doc = result.to_json()
    stats = {k: v for k, v in doc["stats"].items()
             if k not in ("elapsed_s", "watchdog")}
    return doc["cells"], doc["quarantined"], stats


def run_at(window, monkeypatch, mix, cache=None, **kw):
    monkeypatch.setattr(streams, "window", lambda device: window)
    if mix:
        return PE.run_mix_sweep(mix_grid(), device="cpu", **kw)
    return PE.run_sweep(sweep_grid(),
                        PE.ResultCache() if cache is None else cache,
                        device="cpu", **kw)


@pytest.mark.parametrize("mix", [False, True], ids=["sweep", "mix"])
@pytest.mark.parametrize("spec", [None, "oom@b0:x1", "raise@c2:p",
                                  "corrupt@c1", "oom@b2:p"])
def test_runner_window_eight_equals_window_one(monkeypatch, mix, spec):
    def run(window):
        plan = PE.FaultPlan.parse(spec) if spec else None
        return comparable(run_at(window, monkeypatch, mix, resilience=FAST,
                                 fault_plan=plan))

    assert run(8) == run(1)


@pytest.mark.parametrize("k", [0, 2, 5, 7])
def test_runner_kill_at_window_eight_journals_what_window_one_does(
        monkeypatch, tmp_path, k):
    def run(window):
        journal = tmp_path / f"w{window}.jsonl"
        with pytest.raises(PE.SweepKilled):
            run_at(window, monkeypatch, False,
                   cache=PE.PersistentResultCache(journal), resilience=FAST,
                   fault_plan=PE.FaultPlan.parse(f"kill@b{k}"))
        return journal.read_text() if journal.exists() else ""

    got = run(8)
    assert got == run(1)
    # one journal line a cell of the k buckets before the kill, 3 cells each
    assert len(got.splitlines()) == 3 * k


# ---------------------------------------------------------------------------
# streams: the window by device, the issuer's bookkeeping
# ---------------------------------------------------------------------------

def test_window_by_device():
    assert streams.window(torch.device("cpu")) == 1
    assert streams.window(torch.device("cuda", 0)) == streams.WINDOW == 8


def test_overlapped_launches_are_counted_while_tracing():
    cpu = torch.device("cpu")
    obs.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            issuer = streams.Issuer()
            with issuer.launch(cpu) as a:
                pass
            with issuer.launch(cpu) as b:         # a not yet collected
                pass
            a.wait()
            b.wait()
            b.wait()                              # once only
            with issuer.launch(cpu) as c:         # nothing in flight
                pass
            with pytest.raises(ValueError):
                with issuer.launch(cpu):          # a failed issue
                    raise ValueError("refused")
            with issuer.launch(cpu) as d:         # c still in flight
                pass
            c.wait()
            d.wait()
            with issuer.launch(cpu):              # nothing in flight
                pass
        assert obs.COUNTS == {"sweep.overlapped_launches": 3}
    finally:
        obs.reset()


def test_to_host_reads_the_tensor():
    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    host = streams.to_host(t)
    assert host.dtype == np.int32 and host.tolist() == t.tolist()
