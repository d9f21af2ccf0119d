"""The port's multicore simulator is bit-exact to the JAX package.

On the CPU the port's multicore entry points run the plain PyTorch version
of the CUDA mix kernel (and of the lane kernel, for the run-alone
baselines). The bar is exact equality of every integer counter and every
per-core cycle; weighted speedups are float64 functions of equal integers,
so they are equal too:

* the 88 multicore cells of ``tests/data/golden_packed_state.json``, each
  (config, scheduler, policy) group's seeds as the mixes of one call;
* the pinned values of ``tests/test_controller.py`` (mcf + lbm, 400
  requests, MASA, every scheduler);
* a 1-core mix against ``simulate``;
* live JAX ``simulate_multicore_batch`` on the benches' four 4-core mixes;
* ``paper_repro.run_multicore`` against the reference's product, and the
  JAX package against the committed full-size fixture;
* the reference's refusals.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.dram as R
import repro_torch.core.dram as P
import torch_cases as tc
from benchmarks import multicore_bench, sched_bench
from make_torch_multicore_fixture import multicore_cells
from repro.core.dram import multicore as R_multicore
from repro_torch import interop
from repro_torch import paper_repro as pr
from repro_torch.core.dram import cuda_step, multicore
from repro_torch.core.dram.engine import SimResult, mix_inputs
from test_controller import TestPinnedMulticoreRegression
from test_packed_state import CONFIGS as R_CONFIGS

COUNTERS = tuple(f.name for f in dataclasses.fields(SimResult))
GROUPS = tc.golden_multicore_groups()
LIVE_N = 200


def port_config(jax_config: R.SimConfig) -> P.SimConfig:
    return interop.config_from_reference(dataclasses.asdict(jax_config))


def counters(shared) -> dict:
    return {f: int(np.asarray(getattr(shared, f))) for f in COUNTERS}


def assert_results_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert counters(g.shared) == counters(r.shared)
        assert g.core_cycles.dtype == np.float64
        assert np.array_equal(g.core_cycles, np.asarray(r.core_cycles))
        assert np.array_equal(g.alone_cycles, np.asarray(r.alone_cycles))
        assert g.weighted_speedup == r.weighted_speedup


def bench_mixes(pkg, n):
    return [[pkg.generate_trace(pkg.workload(w), n, seed=7,
                                row_space_offset=pkg.ROW_SPACE_STRIDE * i)
             for i, w in enumerate(m)] for m in pr.MIXES]


def test_copies_equal_the_benches():
    """paper_repro's mixes and points are the benches'; torch_cases' golden
    mix recipe is tests/test_packed_state.py's."""
    assert pr.MIXES == multicore_bench.MIXES == sched_bench.MIXES
    assert (pr.MULTICORE_N, pr.SCHED_N) == (multicore_bench.N, sched_bench.N)
    grid = sched_bench.make_grid(16)
    want = {(c.policy.name, c.config.scheduler.name) for c in grid.expand()}
    assert {(p.name, s.name) for p, s in pr.sched_points()} == want
    assert all(c.config.refresh_mode == P.SimConfig(**pr.SCHED_REFRESH)
               .refresh_mode for c in grid.expand())
    for seed in (1, 2):
        for a, b in zip(r_mix(seed), tc.golden_mix(seed)):
            for f in ("bank", "subarray", "row", "is_write", "gap", "dep"):
                assert getattr(a, f).tobytes() == getattr(b, f).tobytes()
            assert a.mlp_window == b.mlp_window
    for (config, sched, _), _cells in GROUPS.items():
        assert tc.golden_multicore_config(config, sched) == port_config(
            R.SimConfig(scheduler=R.Scheduler[sched], **R_CONFIGS[config]))


@pytest.mark.parametrize("group", sorted(GROUPS), ids="-".join)
def test_golden_multicore_cells(group):
    """Each group's seeds are the mixes of one call; counters and per-core
    cycles are bit-exact."""
    config, sched, policy = group
    cells = GROUPS[group]
    res = P.simulate_multicore_batch(
        [tc.golden_mix(c["seed"]) for c in cells], P.Policy[policy],
        tc.golden_multicore_config(config, sched), device="cpu")
    for r, c in zip(res, cells):
        for f in COUNTERS:
            v = getattr(r.shared, f)
            assert v.dtype == torch.int32 and v.shape == (), f
        assert counters(r.shared) == c["counters"]
        assert [int(x) for x in r.core_cycles] == c["core_cycles"]


@pytest.mark.parametrize("sched", list(P.Scheduler), ids=lambda s: s.name)
def test_pinned_multicore_values(sched):
    mix = tc.golden_mix(7, n=400)
    r = P.simulate_multicore(mix, P.Policy.MASA, P.SimConfig(scheduler=sched),
                             device="cpu")
    got = (int(r.shared.total_cycles), int(r.shared.n_act),
           int(r.shared.n_hit), [int(x) for x in r.core_cycles])
    assert got == TestPinnedMulticoreRegression.EXPECTED[R.Scheduler(int(sched))]
    batch = P.simulate_multicore_batch([mix], P.Policy.MASA,
                                       P.SimConfig(scheduler=sched),
                                       device="cpu")[0]
    assert counters(batch.shared) == counters(r.shared)
    assert np.array_equal(batch.core_cycles, r.core_cycles)


@pytest.mark.parametrize("cfg", [
    P.SimConfig(),
    P.SimConfig(refresh=True),
    P.SimConfig(refresh=True, dsarp=True),
    P.SimConfig(row_policy="closed"),
], ids=["default", "refresh", "dsarp", "closed"])
@pytest.mark.parametrize("policy", [P.Policy.BASELINE, P.Policy.MASA],
                         ids=lambda p: p.name)
def test_one_core_mix_bit_identical_to_simulate(policy, cfg):
    tr = P.generate_trace(P.workload("lbm"), 600, seed=7)
    single = counters(P.simulate(tr, policy, cfg, device="cpu"))
    multi = P.simulate_multicore([tr], policy, cfg, device="cpu")
    assert counters(multi.shared) == single
    assert multi.core_cycles.tolist() == [single["total_cycles"]]


@pytest.fixture(scope="module")
def live_mixes():
    ref, port = bench_mixes(R, LIVE_N), bench_mixes(P, LIVE_N)
    # per-core windows differ across each mix's workloads
    assert all(len({t.mlp_window for t in m}) > 1 for m in ref)
    return ref, port


@pytest.mark.parametrize("policy", list(R.Policy), ids=lambda p: p.name)
def test_live_parity_with_jax_frfcfs(live_mixes, policy):
    ref_mixes, port_mixes = live_mixes
    jcfg = R.SimConfig(scheduler=R.Scheduler.FRFCFS)
    ref = R_multicore.simulate_multicore_batch(ref_mixes, policy, jcfg)
    got = P.simulate_multicore_batch(port_mixes, P.Policy(int(policy)),
                                     port_config(jcfg), device="cpu")
    assert_results_equal(got, ref)


def test_mix_inputs_from_numpy_match_the_entry_point(live_mixes):
    """Identical [M, C, N] inputs through interop.mixes_from_numpy and
    simulate_cores equal the entry point; IDEAL's geometry is rewritten."""
    ref_mixes, port_mixes = live_mixes
    stacked_list = [R.stack_traces(m) for m in ref_mixes]
    ranks = [np.argsort(np.argsort([t.profile.mpki for t in m]))
             for m in ref_mixes]
    stacked, rank = interop.mixes_from_numpy(stacked_list, ranks, "cpu")
    assert stacked["bank"].shape == (4, 4, LIVE_N)
    assert stacked["mlp_window"].shape == rank.shape == (4, 4)
    cfg = P.SimConfig(scheduler=P.Scheduler.TCM)
    eff, sched, nb, ns, reqs, mlp, rk = mix_inputs(stacked, rank,
                                                   P.Policy.IDEAL, cfg, "cpu")
    assert (eff, sched, nb, ns) == (int(P.Policy.BASELINE),
                                    int(P.Scheduler.TCM), 64, 1)
    assert reqs.shape == (4, 4, LIVE_N, 6) and reqs.dtype == torch.int32
    assert torch.equal(reqs[..., 0], stacked["bank"] * 8 + stacked["subarray"])
    assert int(reqs[..., 1].abs().sum()) == 0
    res, maxc = cuda_step.simulate_cores(eff, sched, nb, ns, cfg.timing, 0,
                                         reqs[:2].contiguous(),
                                         mlp[:2].contiguous(),
                                         rk[:2].contiguous())
    want = P.simulate_multicore_batch(port_mixes[:2], P.Policy.IDEAL, cfg,
                                      alone_cycles=np.ones(8), device="cpu")
    for b, w in enumerate(want):
        assert {f: int(getattr(res, f)[b]) for f in COUNTERS} == \
            counters(w.shared)
        assert maxc[b].tolist() == [int(x) for x in w.core_cycles]


def test_run_multicore_equals_the_reference_product():
    """paper_repro.run_multicore at a small size equals the reference's
    multicore_bench product (same calls, same alone baselines), and its
    summary is the bench's arithmetic."""
    n = 48
    port = pr.run_multicore(n, 7, device="cpu")
    ref_mixes = bench_mixes(R, n)
    alone = R_multicore.alone_baseline_cycles(ref_mixes)
    ref = {}
    for (pol, sched) in port:
        ref[(pol, sched)] = R_multicore.simulate_multicore_batch(
            ref_mixes, R.Policy[pol],
            R.SimConfig(scheduler=R.Scheduler[sched]), alone_cycles=alone)
        assert_results_equal(port[(pol, sched)], ref[(pol, sched)])
    assert len(port) == 7 and len(pr.mix_cells(port)) == 28
    ws = {k: np.array([r.weighted_speedup for r in v]) for k, v in ref.items()}
    ws0 = ws[("BASELINE", "FRFCFS")]
    s = pr.multicore_summary(port)
    for pol in ("SALP1", "SALP2", "MASA", "IDEAL"):
        assert s["gains_pct"][pol] == float(
            (100 * (ws[(pol, "FRFCFS")] / ws0 - 1)).mean())
    assert s["masa_tcm_pct"] == float(
        (100 * (ws[("MASA", "TCM")] / ws0 - 1)).mean())


def test_jax_package_reproduces_the_multicore_fixture():
    """The fixture chip_smoke.py holds the kernels to cannot rot."""
    fixture = tc.multicore_fixture()
    cells = {(c["part"], c["mix"], c["policy"], c["scheduler"]): c
             for c in multicore_cells()}
    assert len(cells) == 28
    assert all(cells[k] == fixture[k] for k in cells)


def r_mix(seed: int, names=tc.GOLDEN_MIX, n: int = tc.GOLDEN_MIX_N):
    """tc.golden_mix's recipe, through the reference's frontend."""
    return [R.generate_trace(R.workload(m), n, seed=seed,
                             row_space_offset=R.ROW_SPACE_STRIDE * i)
            for i, m in enumerate(names)]


def test_refusals_match_the_reference(monkeypatch):
    mix = tc.golden_mix(1)
    with pytest.raises(ValueError) as r:
        R_multicore.simulate_multicore_batch(
            [[dataclasses.replace(r_mix(1)[0], mlp_window=64), r_mix(1)[1]]],
            R.Policy.MASA)
    with pytest.raises(ValueError) as p:
        P.simulate_multicore_batch(
            [[dataclasses.replace(mix[0], mlp_window=64), mix[1]]],
            P.Policy.MASA, device="cpu")
    assert "mlp_window" in str(p.value) and str(p.value) == str(r.value)
    with pytest.raises(ValueError, match="refuse emit_commands"):
        P.simulate_multicore(mix, P.Policy.MASA,
                             P.SimConfig(emit_commands=True), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.simulate_multicore(mix, P.Policy.MASA)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.simulate_multicore_batch([mix], P.Policy.MASA)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.alone_baseline_cycles([mix])


def test_use_ranking_is_tcm_and_ranks_follow_numpy():
    mix = tc.golden_mix(2)
    a = P.simulate_multicore(mix, P.Policy.MASA, use_ranking=True,
                             device="cpu")
    b = P.simulate_multicore(mix, P.Policy.MASA,
                             P.SimConfig(scheduler=P.Scheduler.TCM),
                             device="cpu")
    assert counters(a.shared) == counters(b.shared)
    # equal MPKIs: the ranks are numpy's stable tie order, as the reference's
    _, rank = multicore._prep_mix([mix[0], mix[0], mix[1]])
    _, ref_rank = R_multicore._prep_mix(r_mix(2, ("mcf", "mcf", "lbm")),
                                        R.Policy.MASA, R.SimConfig())
    assert rank.tolist() == ref_rank.tolist()


def test_mix_wrapper_checks_its_inputs():
    mixes = [tc.golden_mix(1), tc.golden_mix(2)]
    stacked = {k: np.stack([P.stack_traces(m)[k] for m in mixes])
               for k in interop.STACKED_FIELDS}
    ranks = np.zeros((2, 2), np.int32)
    eff, sched, nb, ns, reqs, mlp, rank = mix_inputs(
        stacked, ranks, P.Policy.MASA, P.SimConfig(), "cpu")
    t = P.SimConfig().timing
    before = dict(cuda_step.LAUNCHES)
    res, maxc = cuda_step.simulate_cores(eff, sched, nb, ns, t, 0, reqs, mlp,
                                         rank)
    assert cuda_step.LAUNCHES == before
    assert res.n_requests.tolist() == [300, 300] and maxc.shape == (2, 2)
    with pytest.raises(TypeError):
        cuda_step.simulate_cores(eff, sched, nb, ns, t, 0, reqs.long(), mlp,
                                 rank)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_step.simulate_cores(eff, sched, nb, ns, t, 0,
                                 reqs.transpose(0, 1).contiguous()
                                 .transpose(0, 1), mlp, rank)
    with pytest.raises(ValueError, match=r"\[M, C, N, 6\]"):
        cuda_step.simulate_cores(eff, sched, nb, ns, t, 0, reqs, mlp[:, :1],
                                 rank)
    with pytest.raises(ValueError, match="C >= 1"):
        cuda_step.simulate_cores(eff, sched, nb, ns, t, 0,
                                 reqs[:, :0].contiguous(),
                                 mlp[:, :0].contiguous(),
                                 rank[:, :0].contiguous())
    bad = dict(stacked, subarray=stacked["subarray"] + 8)
    with pytest.raises(ValueError, match="outside"):
        mix_inputs(bad, ranks, P.Policy.MASA, P.SimConfig(), "cpu")
