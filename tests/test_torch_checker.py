"""The port's JEDEC checker equals the JAX package's.

``repro_torch.core.dram.checker`` is a copy of ``repro.core.dram.checker``
with its imports pointed at the port. Held three ways: the source is the
reference's word for word (imports and the port note aside); ``rules_for``
returns the reference's table for every policy x refresh policy x row
policy; and on the same streams, clean and with injected violations (an ACT
shifted into tRCD, a command moved into a refresh burst, a command rewound
below its ``min_legal_cycles`` bound, a stream cut short), ``check_trace``
gives the same ``ok``, ``n_rules``, violation list and summary.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

import repro.core.dram as R
import repro_torch.core.dram as P
import torch_cases as tc
from repro.core.dram import checker as R_checker
from repro_torch.core.dram import checker as P_checker
from repro_torch.core.dram import state_layout as L

FIELDS = ("op", "cycle", "bank", "subarray", "row", "aux", "step", "core",
          "req")
#: The streams' trace: random_trace(11, mlp=16) spreads over the banks
#: (tests/test_commands.py's tFAW sweep uses it for its ACT pressure).
STREAM_SEED = 11
#: Streams checked live: (config, policy) cells of the golden grid's configs.
CELLS = (("default", "MASA"), ("default", "BASELINE"), ("closed", "SALP2"),
         ("closed_refresh", "SALP1"), ("dsarp", "MASA"),
         ("per_bank", "SALP2"), ("darp", "BASELINE"), ("darp", "MASA"),
         ("sarp", "MASA"), ("all_bank", "IDEAL"))


def as_reference(ct) -> "R.CommandTrace":
    """The same stream as the reference's CommandTrace."""
    return R.CommandTrace(
        **{f: getattr(ct, f).copy() for f in FIELDS}, meta=dict(ct.meta),
        timing=R.DramTiming(**dataclasses.asdict(ct.timing)),
        step_comp=None if ct.step_comp is None else ct.step_comp.copy())


def verdict(res) -> tuple:
    return (res.ok, res.n_commands, res.n_rules, res.summary(limit=50),
            [dataclasses.astuple(v) for v in res.violations])


def assert_same_verdict(ct, **kw) -> tuple:
    p = verdict(P.check_trace(ct, **kw))
    assert p == verdict(R.check_trace(as_reference(ct), **kw))
    return p


@pytest.fixture(scope="module")
def streams() -> dict:
    return {(cfg, pol): P.simulate_commands(
        tc.random_trace(STREAM_SEED, mlp=16), P.Policy[pol],
        P.SimConfig(**tc.CONFIGS[cfg]), device="cpu")[1]
        for cfg, pol in CELLS}


def test_source_is_the_reference_copy():
    port = Path(P_checker.__file__).read_text()
    ref = Path(R_checker.__file__).read_text()
    port = re.sub(r"\n\nPort note:.*?\n\"\"\"", '\n"""', port, flags=re.S)
    assert port.replace("repro_torch.", "repro.") == ref


@pytest.mark.parametrize("policy", [p.name for p in P.Policy])
def test_rules_for_equals_the_reference(policy):
    t = P.SimConfig().timing
    rt = R.DramTiming(**dataclasses.asdict(t))
    for rp in P.RefreshPolicy:
        for closed in (False, True):
            got = P.rules_for(P.Policy[policy], t, closed, rp)
            want = R.rules_for(R.Policy[policy], rt, closed,
                               R.RefreshPolicy(int(rp)))
            assert [dataclasses.astuple(r) for r in got] == \
                [dataclasses.astuple(r) for r in want], (policy, rp, closed)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(c))
def test_clean_streams_same_verdict(streams, cell):
    ct = streams[cell]
    ok, n, *_ = assert_same_verdict(ct)
    assert ok and n == len(ct)
    assert np.array_equal(P.min_legal_cycles(ct),
                          R.min_legal_cycles(as_reference(ct)))
    assert_same_verdict(ct, structural=False)


def mutated(ct, i: int, cycle: int):
    mut = dataclasses.replace(ct, cycle=ct.cycle.copy())
    mut.cycle[i] = cycle
    return mut


@pytest.mark.parametrize("cell", CELLS[:6], ids=lambda c: "-".join(c))
def test_act_shifted_into_trcd(streams, cell):
    ct = streams[cell]
    acts = np.flatnonzero(ct.op == L.OP_ACT)
    col = np.isin(ct.op, (L.OP_RD, L.OP_WR))
    i = acts[len(acts) // 2]
    c = np.flatnonzero(col & (ct.step == ct.step[i]))[0]
    ok, _, _, summary, _ = assert_same_verdict(
        mutated(ct, i, ct.cycle[c] - ct.timing.t_rcd + 1))
    assert not ok and "tRCD" in summary


#: The cells whose refresh fires inside 120 requests (tc.REF_TIMING).
REF_CELLS = [c for c in CELLS if c[0] in ("per_bank", "darp", "sarp")]


@pytest.mark.parametrize("cell", REF_CELLS, ids=lambda c: "-".join(c))
def test_command_inside_a_refresh_burst(streams, cell):
    ct = streams[cell]
    refs = np.flatnonzero(ct.op == L.OP_REF)
    assert len(refs)
    for r in refs:
        later = np.flatnonzero((ct.step > ct.step[r]) & (ct.bank == ct.bank[r])
                               & (ct.op != L.OP_REF)
                               & (ct.subarray == (ct.subarray[r]
                                                  if ct.subarray[r] >= 0
                                                  else ct.subarray)))
        if len(later):
            break
    ok, _, _, summary, _ = assert_same_verdict(
        mutated(ct, later[0], ct.cycle[r] + 1))
    assert not ok and "tRFC-blocking" in summary


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(c))
def test_rewound_commands(streams, cell):
    """Every fourth rewindable command, one at a time, just below its bound
    (flagged at that command) and at it."""
    ct = streams[cell]
    bound = P.min_legal_cycles(ct)
    cand = np.flatnonzero((ct.cycle > bound) & (bound > 0)
                          & (ct.op != L.OP_REF))
    assert len(cand)
    for i in cand[:: max(1, len(cand) // 4)]:
        _, _, _, _, vs = assert_same_verdict(mutated(ct, i, bound[i] - 1),
                                             structural=False)
        assert any(v[1] == i for v in vs), (cell, i)
        assert_same_verdict(mutated(ct, i, bound[i]), structural=False)


def test_structural_violations(streams):
    ct = streams[("default", "MASA")]
    # a stream cut short: the last step's column command dropped
    keep = np.ones(len(ct), bool)
    keep[np.flatnonzero(np.isin(ct.op, (L.OP_RD, L.OP_WR)))[-1]] = False
    cut = dataclasses.replace(ct, **{f: getattr(ct, f)[keep] for f in FIELDS})
    assert not assert_same_verdict(cut)[0]
    # an SA_SEL turned into an ACT, and an SA_SEL under a non-MASA policy
    ct = next(s for (_, pol), s in streams.items()
              if pol == "MASA" and (s.op == L.OP_SASEL).any())
    sasel = np.flatnonzero(ct.op == L.OP_SASEL)[0]
    act = dataclasses.replace(ct, op=ct.op.copy())
    act.op[sasel] = L.OP_ACT
    assert not assert_same_verdict(act)[0]
    base = streams[("default", "BASELINE")]
    odd = dataclasses.replace(base, op=base.op.copy())
    odd.op[np.flatnonzero(base.op == L.OP_PRE)[0]] = L.OP_SASEL
    assert not assert_same_verdict(odd)[0]
