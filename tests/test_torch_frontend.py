"""The port's copied frontend modules equal the JAX package's.

``repro_torch`` keeps its own copies of the framework-free modules of
``repro.core.dram`` (it never imports the reference). These tests hold each
copy to its reference on identical inputs: trace generation byte for byte,
the text trace format, the timing packs, the state-layout constants, the
enums and the registry's near-miss errors word for word.
"""
import dataclasses
import io

import numpy as np
import pytest

import repro.core.dram as R
import repro_torch.core.dram as P
from repro.core.dram import address_map as R_map
from repro.core.dram import errors as R_errors
from repro.core.dram import schedulers as R_sched
from repro.core.dram import state_layout as R_layout
from repro.core.dram import trace as R_trace
from repro_torch.core.dram import address_map as P_map
from repro_torch.core.dram import errors as P_errors
from repro_torch.core.dram import schedulers as P_sched
from repro_torch.core.dram import state_layout as P_layout
from repro_torch.core.dram import trace as P_trace

MAPPINGS = ("golden", "contiguous", "xor", "bits:row-sa-bank")
SEEDS = (0, 7, 12345)
TRACE_ARRAYS = ("bank", "subarray", "row", "is_write", "gap", "dep", "addr")


def assert_same_trace(a, b):
    for f in TRACE_ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    assert a.mlp_window == b.mlp_window
    assert a.mapping == b.mapping


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mapping", MAPPINGS)
def test_generate_trace_byte_for_byte(mapping, seed):
    """All 32 paper workloads under every mapping kind and seed."""
    assert len(P.PAPER_WORKLOADS) == 32
    for rw, pw in zip(R.PAPER_WORKLOADS, P.PAPER_WORKLOADS):
        assert dataclasses.astuple(rw) == dataclasses.astuple(pw)
        a = R.generate_trace(rw, 300, seed=seed, mapping=mapping)
        b = P.generate_trace(pw, 300, seed=seed, mapping=mapping)
        assert_same_trace(a, b)


@pytest.mark.parametrize("kwargs", [
    dict(), dict(n_banks=4, n_subarrays=16),
    dict(row_space_offset=P.ROW_SPACE_STRIDE), dict(footprint_rows=4096)])
def test_generate_trace_knobs(kwargs):
    for name in ("mcf", "lbm", "gups", "stream_copy"):
        assert_same_trace(R.generate_trace(R.workload(name), 500, seed=3,
                                           **kwargs),
                          P.generate_trace(P.workload(name), 500, seed=3,
                                           **kwargs))


@pytest.mark.parametrize("mapping", MAPPINGS)
def test_dump_text_equal_and_round_trips(mapping):
    ra = R.generate_trace(R.workload("mcf"), 200, seed=5, mapping=mapping)
    pa = P.generate_trace(P.workload("mcf"), 200, seed=5, mapping=mapping)
    rbuf, pbuf = io.StringIO(), io.StringIO()
    # the text format has no dependence column: dump dependence-free traces
    dataclasses.replace(ra, dep=np.zeros_like(ra.dep)).dump(rbuf)
    dataclasses.replace(pa, dep=np.zeros_like(pa.dep)).dump(pbuf)
    text = pbuf.getvalue()
    assert text == rbuf.getvalue()
    back = P.Trace.from_file(io.StringIO(text), mapping=mapping,
                             mlp_window=pa.mlp_window)
    ref = R.Trace.from_file(io.StringIO(text), mapping=mapping,
                            mlp_window=ra.mlp_window)
    assert_same_trace(back, ref)
    for f in ("bank", "subarray", "row", "is_write", "addr"):
        assert np.array_equal(getattr(back, f), getattr(pa, f)), f


def test_stack_and_ideal_equal():
    rt = [R.generate_trace(w, 100, seed=1) for w in R.PAPER_WORKLOADS[:4]]
    pt = [P.generate_trace(w, 100, seed=1) for w in P.PAPER_WORKLOADS[:4]]
    rs, ps = R.stack_traces(rt), P.stack_traces(pt)
    assert rs.keys() == ps.keys()
    for k in rs:
        assert rs[k].tobytes() == ps[k].tobytes(), k
    assert_same_trace(R_trace.to_ideal(rt[0], 8, 8), P_trace.to_ideal(pt[0], 8, 8))


@pytest.mark.parametrize("tech", sorted(R.MEMTECHS))
def test_timing_presets_equal(tech):
    assert (dataclasses.astuple(R.DramTiming.preset(tech))
            == dataclasses.astuple(P.DramTiming.preset(tech)))
    for gb in (8, 16, 32):
        if tech == "pcm_palp":
            with pytest.raises(ValueError) as r:
                R.DramTiming.preset(tech, density_gb=gb)
            with pytest.raises(ValueError) as p:
                P.DramTiming.preset(tech, density_gb=gb)
            assert str(r.value) == str(p.value)
            continue
        for refi in (None, 2080):
            assert (dataclasses.astuple(R.DramTiming.preset(
                tech, density_gb=gb, t_refi=refi))
                == dataclasses.astuple(P.DramTiming.preset(
                    tech, density_gb=gb, t_refi=refi)))


def test_models_and_enums_equal():
    assert dataclasses.astuple(R.DEFAULT_CORE) == dataclasses.astuple(P.DEFAULT_CORE)
    assert (dataclasses.astuple(R.DEFAULT_ENERGY)
            == dataclasses.astuple(P.DEFAULT_ENERGY))
    assert [(p.name, int(p), p.pretty) for p in R.Policy] == \
        [(p.name, int(p), p.pretty) for p in P.Policy]
    assert [(p.name, int(p), p.spec, p.subarray_granular, p.per_bank_burst)
            for p in R.RefreshPolicy] == \
        [(p.name, int(p), p.spec, p.subarray_granular, p.per_bank_burst)
         for p in P.RefreshPolicy]
    assert [(s.name, int(s), s.pretty) for s in R.Scheduler] == \
        [(s.name, int(s), s.pretty) for s in P.Scheduler]
    assert [int(s) for s in R.ALL_SCHEDULERS] == [int(s) for s in P.ALL_SCHEDULERS]
    for k in ("_BIG", "_DEAD", "_REF_URGENT"):
        assert int(getattr(R_sched, k)) == int(getattr(P_sched, k)), k
    assert R_map.GOLDEN_MULT == P_map.GOLDEN_MULT
    assert sorted(R.NAMED_MAPPINGS) == sorted(P.NAMED_MAPPINGS)


def test_state_layout_constants_equal():
    names = sorted(n for n in vars(R_layout) if n.isupper())
    assert names == sorted(n for n in vars(P_layout) if n.isupper())
    for n in names:
        assert int(getattr(R_layout, n)) == int(getattr(P_layout, n)), n


#: (kind, reference trigger, port trigger, typo) for the four axes the port
#: has (the backend and mesh axes belong to executors the port replaces).
AXES = [
    ("address mapping", lambda s: R.mapping_for(s, 8, 8, 64),
     lambda s: P.mapping_for(s, 8, 8, 64), "contiguos"),
    ("workload", R.workload, P.workload, "stream_cpy"),
    ("refresh policy", R.RefreshPolicy.from_spec, P.RefreshPolicy.from_spec,
     "dsrp"),
    ("memtech", R.resolve_memtech, P.resolve_memtech, "lpdr4"),
    ("memtech", lambda s: R.SimConfig(memtech=s),
     lambda s: P.SimConfig(memtech=s), "pcm"),
    ("refresh policy", lambda s: R.SimConfig(refresh_policy=s),
     lambda s: P.SimConfig(refresh_policy=s), "per-bank"),
]


@pytest.mark.parametrize("kind,rtrig,ptrig,typo", AXES,
                         ids=[f"{a[0].replace(' ', '_')}-{a[3]}" for a in AXES])
def test_registry_errors_word_for_word(kind, rtrig, ptrig, typo):
    for spec in (typo, "qqqqzzzz"):
        with pytest.raises(ValueError) as r:
            rtrig(spec)
        with pytest.raises(ValueError) as p:
            ptrig(spec)
        assert str(p.value) == str(r.value)
        assert str(p.value).startswith(f"unknown {kind} ")
    assert R_errors.did_you_mean(typo, ["x", typo[:-1]]) == \
        P_errors.did_you_mean(typo, ["x", typo[:-1]])
