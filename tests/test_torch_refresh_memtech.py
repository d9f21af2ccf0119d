"""The port's refresh and memtech benches and validators equal the JAX
package's.

At a reduced size (2 workloads, 200 requests; the tests set both modules'
``N`` / ``SUBSET`` with ``monkeypatch``, nothing under ``benchmarks/``
changes) the port's ``make_grid()`` runs cell for cell equal to the
reference's (the refresh grid at its 32 Gb rung), its ``command_slice`` records and dumps equal the reference's,
and the port's validators give the reference's verdicts, message for
message, on good and broken artifacts and command dumps. At full size the
committed JAX fixture (``tests/make_torch_refresh_memtech_fixture.py``),
which ``chip_smoke.py`` holds the card to, has exactly the port's grid keys.
"""
import copy
import dataclasses
import json

import numpy as np
import pytest

import torch_cases as tc
from benchmarks import common as R_common
from benchmarks import memtech_bench as R_memtech
from benchmarks import refresh_bench as R_refresh
from benchmarks import validate as R_validate
from repro.core.dram import min_legal_cycles as r_min_legal_cycles
from repro.core.dram import state_layout as RL
from repro.core.dram.commands import CommandTrace as RCommandTrace
from repro.experiments import ResultCache as RResultCache
from repro.experiments import run_sweep as r_run_sweep
from repro_torch.benchmarks import common as P_common
from repro_torch.benchmarks import memtech_bench as P_memtech
from repro_torch.benchmarks import refresh_bench as P_refresh
from repro_torch.benchmarks import validate as P_validate
from repro_torch.core.dram import commands as P_commands
from repro_torch.experiments import ResultCache, run_sweep
from repro_torch.experiments.cache import cell_key
from repro_torch.experiments.runner import trace_for
from test_artifacts import make_doc

BENCHES = {"refresh": (R_refresh, P_refresh), "memtech": (R_memtech,
                                                         P_memtech)}
SMALL_N, SMALL_WORKLOADS = 200, 2


@pytest.fixture
def small(monkeypatch):
    """Both sides' benches at 2 workloads x 200 requests."""
    for ref, port in BENCHES.values():
        for mod in (ref, port):
            monkeypatch.setattr(mod, "N", SMALL_N)
            monkeypatch.setattr(mod, "SUBSET", mod.SUBSET[:SMALL_WORKLOADS])


def cells_of(sweep) -> list[tuple]:
    return [(c.key, c.workload.name, c.policy.name, c.counters)
            for c in sweep.cells]


def test_reduced_memtech_grid_equals_jax(small):
    want = r_run_sweep(R_memtech.make_grid(), RResultCache())
    got = run_sweep(P_memtech.make_grid(), ResultCache(), device="cpu")
    assert len(got.cells) == len(want.cells) == 12 * SMALL_WORKLOADS
    assert cells_of(got) == cells_of(want)
    assert got.to_json()["cells"] == want.to_json()["cells"]


def test_reduced_refresh_run_equals_jax(small, monkeypatch):
    """The refresh grid through both ``run()``s, cut to the 32 Gb rung (11
    buckets, each a JAX compile; the other densities differ only in their
    ``_timing``, held equal in :func:`test_bench_constants_equal_jax`, and
    their keys in :func:`test_fixture_keys_are_the_port_grid_keys`): at 200
    requests refresh barely fires, so both refuse the ladder, with the same
    table, after sweeping the same cells."""
    monkeypatch.setattr(R_common, "SWEEPS", [])
    monkeypatch.setattr(P_common, "SWEEPS", [])
    for mod in (R_refresh, P_refresh):
        monkeypatch.setattr(mod, "DENSITIES", ("32Gb",))
    with pytest.raises(AssertionError) as r:
        R_refresh.run()
    with pytest.raises(AssertionError) as p:
        P_refresh.run(device="cpu")
    assert str(p.value) == str(r.value)
    assert "ladder ordering violated" in str(p.value)
    got, want = P_common.SWEEPS[0]["cells"], R_common.SWEEPS[0]["cells"]
    assert len(got) == 11 * SMALL_WORKLOADS and got == want


#: The benches' command slices, as their run()s call them.
SLICES = {
    "refresh": ("refresh", dict(refresh_policy="darp"), "32Gb"),
    "memtech_pcm": ("memtech", "pcm_palp", None),
    "memtech_lpddr4": ("memtech", "lpddr4", dict(refresh_policy="per_bank")),
}


def slice_args(name: str, side: int):
    """``(trace, policy, config)`` of one slice on the reference (0) or the
    port (1)."""
    from repro.core.dram import Policy as RP, SimConfig as RS
    from repro.core.dram import generate_trace as r_gen
    from repro_torch.core.dram import Policy as PP, SimConfig as PS
    from repro_torch.core.dram import generate_trace as p_gen

    bench, a, b = SLICES[name]
    mod = BENCHES[bench][side]
    Pol, Cfg, gen = ((RP, RS, r_gen), (PP, PS, p_gen))[side]
    if bench == "refresh":
        cfg = Cfg(timing=mod._timing(b), **a)
    else:
        cfg = Cfg.for_tech(a, **(b or {}))
    return gen(mod.SUBSET[0], mod.N, seed=R_common.SEED), Pol.MASA, cfg


@pytest.fixture
def slice_dumps(small, tmp_path):
    out = {}
    for name in SLICES:
        paths = (tmp_path / f"ref_{name}.trace", tmp_path / f"port_{name}.trace")
        rrec = R_common.command_slice(*slice_args(name, 0), str(paths[0]))
        prec = P_common.command_slice(*slice_args(name, 1), str(paths[1]),
                                      device="cpu")
        out[name] = (rrec, prec, paths)
    return out


def test_reduced_command_slices_equal_jax(slice_dumps):
    for name, (rrec, prec, paths) in slice_dumps.items():
        assert {k: v for k, v in prec.items() if k != "path"} == \
            {k: v for k, v in rrec.items() if k != "path"}, name
        assert paths[1].read_bytes() == paths[0].read_bytes(), name
    assert "REF" not in slice_dumps["memtech_pcm"][1]["ops"]


def verdict(validate, fn, *args) -> str:
    """The validator's message, or its error's, tagged."""
    try:
        return "ok: " + getattr(validate, fn)(*args)
    except validate.ValidationError as e:
        return f"invalid: {e}"
    except (KeyError, IndexError, TypeError) as e:
        return f"malformed: {type(e).__name__}: {e}"


def mutate(doc: dict, path: str, value) -> dict:
    doc = copy.deepcopy(doc)
    *head, last = path.split(".")
    node = doc
    for k in head:
        node = node[int(k) if k.isdigit() else k]
    if value is KeyError:
        del node[last]
    else:
        node[last] = value
    return doc


#: Broken artifacts, each one field off a good one (path, bad value);
#: KeyError deletes the field.
BROKEN = {
    "refresh": [
        ("schema_version", "repro.bench/v0"), ("git_sha", "unknown"),
        ("seed", None), ("results.refresh.ladder_ok", False),
        ("results.refresh.table.32Gb.MASA.darp", 99.0),
        ("results.refresh.table.8Gb.BASELINE.dsarp", 1.0),
        ("results.refresh.table.16Gb", KeyError), ("sweeps", []),
        ("results.refresh.commands.checker_ok", False),
        ("results.refresh.commands.n_commands", 0),
        ("sweeps.0.stats", {"quarantined_cells": 1, "n_cells": 5}),
    ],
    "memtech": [
        ("seed", None), ("results.memtech.salp_ladder_ok", False),
        ("results.memtech.table.pcm_palp.MASA", 1.0),
        ("results.memtech.ddr3_pin.got", [1, 2]),
        ("results.memtech.palp.pcm_palp.palp_rp_read_lat", 200.0),
        ("results.memtech.commands.ops.REF", 3),
        ("results.memtech.commands_lpddr4.ops.REF", KeyError),
        ("results.memtech.table.lpddr4", KeyError), ("sweeps", []),
        ("results.memtech.commands.sha256", ""),
    ],
}


def good_doc(suite: str, slice_dumps) -> dict:
    doc = make_doc(suite)
    if suite == "refresh":
        doc["results"]["refresh"]["commands"] = slice_dumps["refresh"][1]
    else:
        # the LPDDR4 slice stays synthetic: 200 requests fire no refresh
        doc["results"]["memtech"]["commands"] = slice_dumps["memtech_pcm"][1]
    return doc


@pytest.mark.parametrize("suite", sorted(BROKEN))
def test_validators_same_verdicts(slice_dumps, suite):
    fn = f"validate_{suite}"
    doc = good_doc(suite, slice_dumps)
    ok = verdict(P_validate, fn, doc)
    assert ok.startswith(f"ok: {suite} ok") and ok == verdict(R_validate, fn,
                                                              doc)
    assert P_validate.detect_suite(doc) == R_validate.detect_suite(doc) == \
        suite
    for path, value in BROKEN[suite]:
        bad = mutate(doc, path, value)
        got = verdict(P_validate, fn, bad)
        assert not got.startswith("ok"), path
        assert got == verdict(R_validate, fn, bad), path


def test_check_commands_file_same_verdicts(slice_dumps, tmp_path):
    _, rec, paths = slice_dumps["refresh"]
    dump = str(paths[1])
    doc = good_doc("refresh", slice_dumps)
    args = [(dump, doc, "refresh"), (dump,), (str(tmp_path / "missing"),),
            (dump, mutate(doc, "results.refresh.commands.sha256", "0" * 64),
             "refresh")]
    # a command rewound below its bound: the checker, not the pin, refuses
    ct = RCommandTrace.load(dump)
    bound = r_min_legal_cycles(ct)
    i = int(np.flatnonzero((ct.cycle > bound) & (bound > 0)
                           & (ct.op != RL.OP_REF))[0])
    ct.cycle[i] = bound[i] - 1
    bad = tmp_path / "bad.trace"
    ct.dump(str(bad))
    args.append((str(bad),))
    # the same dump read back by the port and broken the same way
    pct = P_commands.CommandTrace.load(dump)
    assert pct.dumps() == RCommandTrace.load(dump).dumps()
    verdicts = [verdict(P_validate, "check_commands_file", *a) for a in args]
    assert verdicts == [verdict(R_validate, "check_commands_file", *a)
                        for a in args]
    assert [v.split(":")[0] for v in verdicts] == \
        ["ok", "ok", "invalid", "invalid", "invalid"]
    assert "sha pinned" in verdicts[0] and "violation" in verdicts[-1]


def test_cli_exit_codes(slice_dumps, tmp_path, capsys):
    _, rec, paths = slice_dumps["refresh"]
    art = tmp_path / "refresh.json"
    doc = good_doc("refresh", slice_dumps)
    art.write_text(json.dumps(doc))
    assert P_validate.main([str(art), "--check-commands",
                            str(paths[1])]) == 0
    assert "VALID" in capsys.readouterr().out
    art.write_text(json.dumps(mutate(doc, "results.refresh.commands.sha256",
                                     "0" * 64)))
    assert P_validate.main([str(art), "--check-commands",
                            str(paths[1])]) == 1
    art.write_text(json.dumps(mutate(doc, "results", {})))
    assert P_validate.main([str(art)]) == 2
    art.write_text("{")
    assert P_validate.main([str(art)]) == 1
    capsys.readouterr()


def test_ddr3_pin_on_the_port():
    ok, got, want = P_memtech._ddr3_pin("cpu")
    assert ok and got == P_memtech.DDR3_PIN_WANT == R_memtech.DDR3_PIN_WANT


def test_palp_read_latency_equals_jax(monkeypatch):
    """A cut PALP mix (60 requests a core) on PCM, both schedulers."""
    from repro.core.dram import Scheduler as RS
    from repro_torch.core.dram import Scheduler as PS

    for mod in (R_memtech, P_memtech):
        monkeypatch.setattr(mod, "PALP_N", 60)
    for s in ("FRFCFS", "PALP_RP"):
        assert P_memtech._palp_read_latency("pcm_palp", PS[s], "cpu") == \
            R_memtech._palp_read_latency("pcm_palp", RS[s])


def test_bench_constants_equal_jax():
    for name in ("N", "DENSITIES", "T_REFI_HOT", "LADDER"):
        assert getattr(P_refresh, name) == getattr(R_refresh, name)
    for gb in P_refresh.DENSITIES:
        assert dataclasses.asdict(P_refresh._timing(gb)) == \
            dataclasses.asdict(R_refresh._timing(gb)), gb
    for name in ("N", "PALP_MIX", "PALP_N", "TECHS"):
        assert getattr(P_memtech, name) == getattr(R_memtech, name)
    for ref, port in BENCHES.values():
        assert [p.name for p in port.SUBSET] == [p.name for p in ref.SUBSET]
        assert [p.name for p in port.POLICIES] == \
            [p.name for p in ref.POLICIES]
    assert P_refresh.COMMANDS_OUT.startswith("artifacts/torch/")
    assert P_memtech.COMMANDS_OUT.startswith("artifacts/torch/")


def test_fixture_keys_are_the_port_grid_keys():
    fixture = tc.refresh_memtech_fixture()
    for bench, (_, port) in BENCHES.items():
        grid = port.make_grid()
        keys = [cell_key(trace_for(c.workload, grid.n_requests, c.config,
                                   grid.seed), c.policy, c.config)
                for c in grid.expand()]
        want = [(c["key"], c["workload"], c["policy"])
                for c in fixture["cells"] if c["grid"] == bench]
        assert keys == [k for k, _, _ in want], bench
        assert [(c.workload.name, c.policy.name) for c in grid.expand()] \
            == [w[1:] for w in want]
        assert fixture["sizes"][bench] == {"n": port.N,
                                           "workloads": len(port.SUBSET)}
    assert fixture["ddr3_pin"] == list(P_memtech.DDR3_PIN_WANT)
    assert set(fixture["commands"]) == set(SLICES)
