"""The port's command-stream export equals the JAX package's.

On the CPU the port's export runs the plain emitting step
(``controller.run_lanes`` / ``run_cores`` with ``emit_commands=True``). The
bar is exact:

* every cell of ``tests/data/golden_commands.json`` (50 single-core x
  (config, policy), 4 multicore): the dump's sha256, command count and
  opcode counts, and the three embedded texts byte for byte;
* live against ``repro.core.dram.simulate_commands`` /
  ``simulate_mix_commands`` on random traces, field by field;
* the stream-derived counters and completions equal the engine's, and an
  emitting run's result equals the non-emitting run's;
* the dump round-trips exactly.
"""
import dataclasses
import hashlib
import io
import json

import numpy as np
import pytest
import torch

import repro.core.dram as R
import repro_torch.core.dram as P
import torch_cases as tc
from repro_torch import interop
from repro_torch.core.dram import cuda_step
from repro_torch.core.dram import state_layout as L
from repro_torch.core.dram.commands import CommandTrace
from test_packed_state import CONFIGS as R_CONFIGS
from test_packed_state import random_trace as r_random_trace

COUNTERS = tuple(f.name for f in dataclasses.fields(P.SimResult))
FIELDS = ("op", "cycle", "bank", "subarray", "row", "aux", "step", "core",
          "req")
GOLDEN = json.load(open(tc.GOLDEN_COMMANDS_PATH))


def sha(ct) -> str:
    return hashlib.sha256(ct.dumps().encode()).hexdigest()


def ints(res) -> dict:
    return {f: int(np.asarray(getattr(res, f))) for f in COUNTERS}


@pytest.fixture(scope="module")
def cells() -> dict:
    """(config, policy) -> (SimResult, CommandTrace): the port's exports of
    the golden grid on the CPU."""
    return {(cfg, pol.name): P.simulate_commands(
        tc.random_trace(tc.GOLDEN_COMMANDS_SEED), pol,
        P.SimConfig(**tc.CONFIGS[cfg]), device="cpu")
        for cfg in tc.CONFIGS for pol in P.Policy}


@pytest.fixture(scope="module")
def mix_cells() -> dict:
    mix = tc.golden_commands_mix()
    return {(cfg, pol): P.simulate_mix_commands(
        mix, P.Policy[pol], tc.golden_commands_mix_config(cfg), device="cpu")
        for cfg, pol in tc.GOLDEN_COMMANDS_MIX_CELLS}


@pytest.mark.parametrize("config", list(tc.CONFIGS))
def test_golden_single_cells(cells, config):
    want = [c for c in GOLDEN["single"] if c["config"] == config]
    assert len(want) == len(P.Policy)
    for c in want:
        _, ct = cells[(config, c["policy"])]
        got = {"sha256": sha(ct), "n_commands": len(ct), "ops": ct.counts()}
        assert got == {k: c[k] for k in got}, (config, c["policy"])


@pytest.mark.parametrize("key", sorted(GOLDEN["texts"]))
def test_golden_texts_byte_equal(cells, key):
    _, ct = cells[tuple(key.split("/"))]
    assert ct.dumps() == GOLDEN["texts"][key]


@pytest.mark.parametrize("cell", GOLDEN["multicore"],
                         ids=lambda c: f"{c['config']}-{c['policy']}")
def test_golden_multicore_cells(mix_cells, cell):
    assert (cell["seed"], cell["scheduler"]) == (
        tc.GOLDEN_COMMANDS_MIX_SEED, "FRFCFS")
    _, ct = mix_cells[(cell["config"], cell["policy"])]
    assert sha(ct) == cell["sha256"]
    assert (len(ct), ct.counts()) == (cell["n_commands"], cell["ops"])


def test_golden_cases_equal_the_reference_recipe():
    """torch_cases' copy of the golden grid is the one the pins were made
    with (tests/make_golden_commands.py)."""
    assert set(tc.CONFIGS) == set(R_CONFIGS)
    assert {(c["config"], c["policy"]) for c in GOLDEN["single"]} == {
        (c, p.name) for c in tc.CONFIGS for p in P.Policy}
    assert {c["seed"] for c in GOLDEN["single"]} == {tc.GOLDEN_COMMANDS_SEED}
    assert [(c["config"], c["policy"]) for c in GOLDEN["multicore"]] == list(
        tc.GOLDEN_COMMANDS_MIX_CELLS)


def test_every_stream_is_legal(cells, mix_cells):
    for key, (_, ct) in {**cells, **mix_cells}.items():
        r = P.check_trace(ct)
        assert r.ok, f"{key}: {r.summary()}"


@pytest.mark.parametrize("config", list(tc.CONFIGS))
def test_stream_reproduces_the_engine(cells, config):
    """Counters and completions re-derived from the stream alone equal the
    emitting run's, and the emitting run equals the non-emitting one."""
    for pol in P.Policy:
        res, ct = cells[(config, pol.name)]
        want = ints(res)
        plain = P.simulate(tc.random_trace(tc.GOLDEN_COMMANDS_SEED), pol,
                           P.SimConfig(**tc.CONFIGS[config]), device="cpu")
        assert ints(plain) == want, (config, pol)
        want.pop("sa_open_cycles")
        assert P.counters_from_commands(ct) == want, (config, pol)
        assert np.array_equal(P.completions_from_commands(ct), ct.step_comp)


def test_mix_stream_reproduces_the_engine(mix_cells):
    mix = tc.golden_commands_mix()
    for (cfg, pol), (res, ct) in mix_cells.items():
        plain = P.simulate_multicore(mix, P.Policy[pol],
                                     tc.golden_commands_mix_config(cfg),
                                     device="cpu")
        assert ints(res.shared) == ints(plain.shared), (cfg, pol)
        assert np.array_equal(res.core_cycles, plain.core_cycles)
        assert np.array_equal(res.alone_cycles, plain.alone_cycles)
        want = ints(res.shared)
        want.pop("sa_open_cycles")
        assert P.counters_from_commands(ct) == want, (cfg, pol)
        comp = P.completions_from_commands(ct)
        assert np.array_equal(comp, ct.step_comp)
        # each core's cycles are the last completion of its own requests
        col = np.isin(ct.op, (L.OP_RD, L.OP_WR))
        per_core = [comp[ct.step[col & (ct.core == c)]].max()
                    for c in range(len(mix))]
        assert np.array_equal(per_core, res.core_cycles)


def assert_same_stream(p, r):
    for f in FIELDS:
        assert np.array_equal(getattr(p, f), np.asarray(getattr(r, f))), f
    assert p.meta == r.meta
    assert dataclasses.asdict(p.timing) == dataclasses.asdict(r.timing)
    assert np.array_equal(p.step_comp, np.asarray(r.step_comp))
    assert p.dumps() == r.dumps()
    assert p.sorted_by_cycle().dumps() == r.sorted_by_cycle().dumps()


#: Live cells: (config, policy, trace seed, window) — one single-core cell
#: under each of the four configs the issue names, IDEAL's rewrite beside.
LIVE = (("default", "MASA", 31, None), ("default", "IDEAL", 32, 4),
        ("closed_refresh", "SALP2", 33, None), ("darp", "BASELINE", 34, 16),
        ("sarp", "SALP1", 35, None))


@pytest.mark.parametrize("config,policy,seed,mlp", LIVE,
                         ids=[f"{c}-{p}" for c, p, _, _ in LIVE])
def test_live_single_equals_jax(config, policy, seed, mlp):
    rcfg = R.SimConfig(**R_CONFIGS[config])
    rres, rct = R.simulate_commands(r_random_trace(seed, n=96, mlp=mlp),
                                    R.Policy[policy], rcfg)
    pres, pct = P.simulate_commands(
        tc.random_trace(seed, n=96, mlp=mlp), P.Policy[policy],
        interop.config_from_reference(dataclasses.asdict(rcfg)), device="cpu")
    assert ints(pres) == ints(rres)
    assert_same_stream(pct, rct)
    assert P.counters_from_commands(pct) == R.counters_from_commands(rct)
    assert np.array_equal(P.completions_from_commands(pct),
                          R.completions_from_commands(rct))


def test_live_mix_equals_jax():
    names, seed, n = ("milc", "lbm"), 9, 80
    rmix = [R.generate_trace(R.workload(m), n, seed=seed,
                             row_space_offset=R.ROW_SPACE_STRIDE * i)
            for i, m in enumerate(names)]
    rcfg = R.SimConfig(scheduler=R.Scheduler.FRFCFS, **R_CONFIGS["darp"])
    rres, rct = R.simulate_mix_commands(rmix, R.Policy.SALP2, rcfg)
    pres, pct = P.simulate_mix_commands(
        tc.golden_mix(seed, names, n), P.Policy.SALP2,
        interop.config_from_reference(dataclasses.asdict(rcfg)), device="cpu")
    assert ints(pres.shared) == ints(rres.shared)
    assert np.array_equal(pres.core_cycles, rres.core_cycles)
    assert np.array_equal(pres.alone_cycles, rres.alone_cycles)
    assert_same_stream(pct, rct)
    assert set(pct.core.tolist()) == {0, 1}


@pytest.mark.parametrize("key", [("default", "MASA"), ("sarp", "MASA"),
                                 ("closed_refresh", "SALP2"),
                                 ("darp", "BASELINE")],
                         ids=lambda k: "-".join(k))
def test_dump_round_trips_exactly(cells, key):
    _, ct = cells[key]
    buf = io.StringIO()
    ct.dump(buf)
    back = CommandTrace.load(io.StringIO(buf.getvalue()))
    for f in FIELDS:
        assert np.array_equal(getattr(back, f), getattr(ct, f)), f
    assert back.meta == ct.meta and back.timing == ct.timing
    assert back.step_comp is None and back.dumps() == ct.dumps()
    # the reference reads the port's dump to the same stream
    assert R.CommandTrace.loads(buf.getvalue()).dumps() == ct.dumps()
    assert P.check_trace(back).ok


def test_loads_rejects_what_the_reference_rejects():
    for text in ("", "# repro-cmds v1 policy=MASA\n",
                 "# repro-cmds v1 policy=MASA\n1 ACT 0 0 0\n",
                 "# repro-cmds v1 policy=MASA\n1 FOO 0 0 0 0 0 0 0\n"):
        with pytest.raises(ValueError) as r:
            R.CommandTrace.loads(text)
        with pytest.raises(ValueError) as p:
            CommandTrace.loads(text)
        assert str(p.value) == str(r.value)


def test_kernels_refuse_emit_commands_and_point_at_the_export():
    cfg = P.SimConfig(emit_commands=True)
    assert "repro_torch.core.dram.commands.simulate_commands" in \
        cuda_step.EMIT_COMMANDS_ERROR
    with pytest.raises(ValueError, match="refuse emit_commands"):
        P.simulate_stacked(P.stack_traces([tc.random_trace(0)]),
                           P.Policy.MASA, cfg, device="cpu")
    # the export takes such a config as it is
    res, ct = P.simulate_commands(tc.random_trace(0, n=24), P.Policy.MASA,
                                  cfg, device="cpu")
    assert int(res.n_requests) == 24 and len(ct) >= 24


def test_export_without_a_card_raises(monkeypatch):
    """device=None means the card: no silent CPU export."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.simulate_commands(tc.random_trace(0, n=8), P.Policy.MASA)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.simulate_mix_commands(tc.golden_commands_mix(), P.Policy.MASA)
