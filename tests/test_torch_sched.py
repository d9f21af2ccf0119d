"""The port's request schedulers and the scheduler study equal the JAX
package's.

* ``request_key`` over ``[M, C]`` heads equals the reference's ``[C]`` key
  function on random planes, for every scheduler, with and without DARP's
  refresh debt, and refuses PALP-RP without the is-write bits with the
  reference's message;
* ties go to the lowest core, in the key's argmin and in the step;
* live JAX ``simulate_multicore_batch`` under TCM and PALP-RP (on the PCM
  technology), on the benches' four 4-core mixes;
* ``paper_repro.run_sched`` against the reference's mix-grid runner, and
  the JAX package against the committed full-size fixture.

The bar is exact equality of every integer key, counter and per-core cycle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.dram as R
import repro_torch.core.dram as P
import torch_cases as tc
from benchmarks import sched_bench
from make_torch_multicore_fixture import sched_cells
from repro.core.dram import multicore as R_multicore
from repro.core.dram import schedulers as R_sched
from repro.experiments import run_mix_sweep
from repro_torch import paper_repro as pr
from repro_torch.core.dram import controller, engine
from repro_torch.core.dram import state_layout as L
from test_torch_multicore import (assert_results_equal, bench_mixes,
                                  port_config)

NB, NS, C, M = 4, 6, 5, 6


def random_heads(seed: int):
    """M random pre-step planes and [M, C] heads on them."""
    rng = np.random.default_rng(seed)
    sa = rng.integers(0, 400, (M, NB, NS + 1, L.SA_F)).astype(np.int32)
    sa[..., L.SA_OPEN_ROW] = rng.integers(-1, 4, (M, NB, NS + 1))
    scalars = rng.integers(0, 400, (M, L.SC_F)).astype(np.int32)
    heads = dict(
        hb=rng.integers(0, NB, (M, C)), hs=rng.integers(0, NS, (M, C)),
        hw=rng.integers(0, 4, (M, C)), vis=rng.integers(0, 500, (M, C)),
        rank=np.stack([rng.permutation(C) for _ in range(M)]),
        live=rng.random((M, C)) < 0.8, hwr=rng.random((M, C)) < 0.4,
        ref_debt=rng.integers(0, 4, (M, C)))
    heads = {k: v if v.dtype == bool else v.astype(np.int32)
             for k, v in heads.items()}
    return sa, scalars, heads


@pytest.mark.parametrize("darp", [False, True], ids=["plain", "darp"])
@pytest.mark.parametrize("sched", list(R.Scheduler), ids=lambda s: s.name)
def test_request_key_equals_reference(sched, darp):
    for seed in range(3):
        sa, scalars, h = random_heads(100 * int(sched) + seed)
        ref_urgent = 2
        got = P.request_key(
            int(sched), dict(sa=torch.as_tensor(sa),
                             scalars=torch.as_tensor(scalars)),
            *(torch.as_tensor(h[k]) for k in ("hb", "hs", "hw", "vis",
                                              "rank")),
            C, torch.as_tensor(h["live"]),
            ref_debt=torch.as_tensor(h["ref_debt"]) if darp else None,
            ref_urgent=ref_urgent, hwr=torch.as_tensor(h["hwr"]))
        assert got.dtype == torch.int32 and got.shape == (M, C)
        for m in range(M):
            want = R_sched.request_key(
                sched, dict(sa=jnp.asarray(sa[m]),
                            scalars=jnp.asarray(scalars[m])),
                *(jnp.asarray(h[k][m]) for k in ("hb", "hs", "hw", "vis",
                                                 "rank")),
                C, jnp.asarray(h["live"][m]),
                ref_debt=jnp.asarray(h["ref_debt"][m]) if darp else None,
                ref_urgent=ref_urgent, hwr=jnp.asarray(h["hwr"][m]))
            assert got[m].tolist() == np.asarray(want).tolist(), (seed, m)


def test_palp_rp_needs_the_write_bits():
    sa, scalars, h = random_heads(0)
    args = [torch.as_tensor(h[k]) for k in ("hb", "hs", "hw", "vis", "rank")]
    with pytest.raises(ValueError) as r:
        R_sched.request_key(R.Scheduler.PALP_RP,
                            dict(sa=jnp.asarray(sa[0]),
                                 scalars=jnp.asarray(scalars[0])),
                            *(jnp.asarray(a[0].numpy()) for a in args), C,
                            jnp.asarray(h["live"][0]))
    with pytest.raises(ValueError) as p:
        P.request_key(P.Scheduler.PALP_RP,
                      dict(sa=torch.as_tensor(sa),
                           scalars=torch.as_tensor(scalars)),
                      *args, C, torch.as_tensor(h["live"]))
    assert str(p.value) == str(r.value)


def test_a_tie_is_served_by_the_lowest_core():
    key = torch.tensor([[7, 3, 3, 9], [5, 5, 5, 5], [2_000_000_000] * 4],
                       dtype=torch.int32)
    # torch.argmin returns the first minimum, like jnp.argmin
    assert torch.argmin(key, dim=1).tolist() == [1, 0, 0]
    assert np.asarray(jnp.argmin(jnp.asarray(key.numpy()), axis=1)).tolist() \
        == [1, 0, 0]
    # two identical cores: FCFS keys tie, core 0 is served first and core 1
    # next (its head is then the oldest visible)
    tr = tc.golden_mix(3)[0]
    stacked = {k: np.stack([v[0], v[0]])[None]
               for k, v in P.stack_traces([tr]).items() if k != "addr"}
    eff, sched, nb, ns, reqs, mlp, rank = engine.mix_inputs(
        stacked, np.zeros((1, 2), np.int32), P.Policy.MASA, P.SimConfig(),
        "cpu")
    t = P.SimConfig().timing
    step = controller._build_stepC(eff, sched, t, 0, False, reqs, mlp, rank,
                                   controller._refresh_fns(eff, t, ns, 0))
    state = controller._stateC_init(1, nb, ns, t, 0, 2)
    step(state)
    assert state["core"][0, :, L.CORE_PTR].tolist() == [1, 0]
    step(state)
    assert state["core"][0, :, L.CORE_PTR].tolist() == [1, 1]


@pytest.fixture(scope="module")
def live_mixes():
    return bench_mixes(R, 200), bench_mixes(P, 200)


@pytest.mark.parametrize("policy,sched,kw", [
    (R.Policy.BASELINE, R.Scheduler.TCM, {}),
    (R.Policy.MASA, R.Scheduler.TCM, {}),
    (R.Policy.MASA, R.Scheduler.PALP_RP, dict(memtech="pcm_palp")),
], ids=["BASELINE-TCM", "MASA-TCM", "MASA-PALP_RP-pcm"])
def test_live_parity_with_jax(live_mixes, policy, sched, kw):
    ref_mixes, port_mixes = live_mixes
    jcfg = R.SimConfig(scheduler=sched, **kw)
    ref = R_multicore.simulate_multicore_batch(ref_mixes, policy, jcfg)
    got = P.simulate_multicore_batch(port_mixes, P.Policy(int(policy)),
                                     port_config(jcfg), device="cpu")
    assert_results_equal(got, ref)


def test_run_sched_equals_the_reference_mix_sweep():
    """paper_repro.run_sched at a small size equals sched_bench's grid
    through the reference's runner, cell for cell, and its summary is the
    bench's arithmetic."""
    n = 40
    port = pr.run_sched(n, 7, device="cpu")
    sweep = run_mix_sweep(sched_bench.make_grid(n))
    want = {("+".join(p.name for p in c.cell.profiles), c.cell.policy.name,
             c.cell.config.scheduler.name): c for c in sweep.cells}
    got = pr.mix_cells(port)
    assert len(got) == len(want) == 40
    for k, c in want.items():
        assert got[k] == dict(counters=c.counters, core_cycles=c.core_cycles,
                              alone_cycles=c.alone_cycles), k
    s = pr.sched_summary(port)
    ws = {(p, sc): sweep.weighted_speedups(p, scheduler=sc).mean()
          for p, sc in ((R.Policy.MASA, R.Scheduler.FCFS),
                        (R.Policy.MASA, R.Scheduler.FRFCFS),
                        (R.Policy.MASA, R.Scheduler.TCM))}
    assert s["ws"]["MASA/TCM"] == float(ws[(R.Policy.MASA, R.Scheduler.TCM)])
    assert s["masa_frfcfs_vs_fcfs_pct"] == float(
        100 * (ws[(R.Policy.MASA, R.Scheduler.FRFCFS)]
               / ws[(R.Policy.MASA, R.Scheduler.FCFS)] - 1))


def test_cli_prints_the_multicore_report(capsys):
    pr.main(["--multicore", "--n", "30", "--seed", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "28 + 40 mix cells in 7 + 10 batched calls" in out
    assert "MASA+TCM" in out and "paper" in out


def test_jax_package_reproduces_the_sched_fixture():
    """The fixture chip_smoke.py holds the kernels to cannot rot."""
    fixture = tc.multicore_fixture()
    cells = {(c["part"], c["mix"], c["policy"], c["scheduler"]): c
             for c in sched_cells()}
    assert len(cells) == 40 and len(fixture) == 68
    assert all(cells[k] == fixture[k] for k in cells)
