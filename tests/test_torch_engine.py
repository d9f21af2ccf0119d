"""The port's single-core simulator is bit-exact to the JAX package.

On the CPU the port's entry points run the plain PyTorch version of the
CUDA lane kernel. The bar is exact equality of every integer counter:

* the 300 single-core cells of ``tests/data/golden_packed_state.json``
  (each (config, policy) group's seeds run as lanes of one call);
* live JAX ``simulate_stacked`` on random traces, for every config x policy,
  with per-lane ``mlp_window`` and a second geometry;
* the reference's validation and refusals, message for message.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.dram as R
import repro_torch.core.dram as P
import torch_cases as tc
from repro.core.dram import controller as R_controller
from repro.core.dram.engine import simulate_stacked as r_simulate_stacked
from repro_torch import interop
from repro_torch.core.dram import controller as P_controller
from repro_torch.core.dram import cuda_step
from repro_torch.core.dram.engine import SimResult, lane_inputs
from test_packed_state import CONFIGS as R_CONFIGS
from test_packed_state import random_trace as r_random_trace

COUNTERS = tuple(f.name for f in dataclasses.fields(SimResult))
GROUPS = tc.golden_groups()


def port_config(jax_config: R.SimConfig) -> P.SimConfig:
    return interop.config_from_reference(dataclasses.asdict(jax_config))


def as_ints(res, b: int) -> dict:
    return {f: int(np.asarray(getattr(res, f))[b]) for f in COUNTERS}


def test_cases_copy_equals_reference():
    """tests/torch_cases.py (used by chip_smoke.py) is the reference recipe."""
    assert list(tc.CONFIGS) == list(R_CONFIGS)
    for name, kw in R_CONFIGS.items():
        assert P.SimConfig(**tc.CONFIGS[name]) == port_config(R.SimConfig(**kw))
    for seed in range(8):
        for kw in (dict(), dict(n=64, nb=4, ns=16, mlp=5)):
            a, b = r_random_trace(seed, **kw), tc.random_trace(seed, **kw)
            for f in ("bank", "subarray", "row", "is_write", "gap", "dep"):
                assert getattr(a, f).tobytes() == getattr(b, f).tobytes()
            assert a.mlp_window == b.mlp_window


@pytest.mark.parametrize("config,policy", sorted(GROUPS),
                         ids=[f"{c}-{p}" for c, p in sorted(GROUPS)])
def test_golden_single_cells(config, policy):
    """Each group's seeds are lanes of one call; counters are bit-exact."""
    cells = GROUPS[(config, policy)]
    res = P.simulate_stacked(tc.golden_stacked(cells), P.Policy[policy],
                             P.SimConfig(**tc.CONFIGS[config]), device="cpu")
    for f in COUNTERS:
        v = getattr(res, f)
        assert v.dtype == torch.int32 and v.shape == (len(cells),), f
    got = [as_ints(res, b) for b in range(len(cells))]
    assert got == [c["counters"] for c in cells]


LIVE_GEOMETRY = {name: ((8, 8), (4, 16), (2, 32))[k % 3]
                 for k, name in enumerate(R_CONFIGS)}


@pytest.mark.parametrize("policy", list(R.Policy), ids=lambda p: p.name)
@pytest.mark.parametrize("config", list(R_CONFIGS))
def test_live_parity_with_jax(config, policy):
    """Random traces with per-lane windows through both packages."""
    nb, ns = LIVE_GEOMETRY[config]
    jcfg = R.SimConfig(n_banks=nb, n_subarrays=ns, **R_CONFIGS[config])
    base = 500 + 6 * list(R_CONFIGS).index(config)
    stacked = R.stack_traces([r_random_trace(s, n=160, nb=nb, ns=ns)
                              for s in range(base, base + 6)])
    assert len(set(stacked["mlp_window"].tolist())) > 1
    ref = r_simulate_stacked(stacked, policy, jcfg)
    got = P.simulate_stacked(interop.stacked_from_numpy(stacked, "cpu"),
                             P.Policy(int(policy)), port_config(jcfg),
                             device="cpu")
    for f in COUNTERS:
        assert np.array_equal(np.asarray(getattr(ref, f)),
                              getattr(got, f).numpy()), f


def test_single_trace_simulate_matches_jax():
    tr = R.generate_trace(R.workload("mcf"), 400, seed=3)
    pt = P.generate_trace(P.workload("mcf"), 400, seed=3)
    for pol in R.Policy:
        ref = R.simulate(tr, pol)
        got = P.simulate(pt, P.Policy(int(pol)), device="cpu")
        for f in COUNTERS:
            assert getattr(got, f).shape == () and \
                int(getattr(got, f)) == int(np.asarray(getattr(ref, f))), f


def test_config_fields_and_defaults_match_reference():
    ref = {f.name: f.default for f in dataclasses.fields(R.SimConfig)}
    port = {f.name: f.default for f in dataclasses.fields(P.SimConfig)}
    assert set(ref) - set(port) == {"backend"}
    assert set(port) <= set(ref)
    for k in port:
        d = port[k]
        assert (dataclasses.astuple(d) if dataclasses.is_dataclass(d) else d) \
            == (dataclasses.astuple(ref[k]) if dataclasses.is_dataclass(ref[k])
                else ref[k]), k


@pytest.mark.parametrize("kwargs", [
    dict(), dict(memtech="lpddr4"), dict(memtech="pcm_palp"),
    dict(refresh=True), dict(refresh=True, dsarp=True),
    dict(refresh_policy="darp", row_policy="closed"),
    dict(n_banks=4, n_subarrays=16, scheduler=R.Scheduler.TCM),
])
def test_config_canonicalization_matches_reference(kwargs):
    ref = R.SimConfig(**kwargs)
    port = P.SimConfig(**{k: (P.Scheduler(int(v)) if k == "scheduler" else v)
                          for k, v in kwargs.items()})
    assert port == port_config(ref)
    assert port.refresh_mode == ref.refresh_mode
    assert dataclasses.astuple(port.timing) == dataclasses.astuple(ref.timing)
    for pol in R.Policy:
        assert port.geometry_for(P.Policy(int(pol))) == ref.geometry_for(pol)
    assert (dataclasses.astuple(P.SimConfig.for_tech("lpddr4", density_gb=16))
            == dataclasses.astuple(port_config(R.SimConfig.for_tech(
                "lpddr4", density_gb=16))))


@pytest.mark.parametrize("kwargs", [
    dict(memtech="pcm_palp", refresh_policy="all_bank"),
    dict(memtech="pcm_palp", refresh=True),
    dict(refresh_policy="darp", refresh=False),
    dict(dsarp=True),
])
def test_config_errors_match_reference(kwargs):
    with pytest.raises(ValueError) as r:
        R.SimConfig(**kwargs)
    with pytest.raises(ValueError) as p:
        P.SimConfig(**kwargs)
    assert str(p.value) == str(r.value)
    with pytest.raises(ValueError) as r:
        R.SimConfig.for_tech("ddr3", timing=R.DDR3_1066)
    with pytest.raises(ValueError) as p:
        P.SimConfig.for_tech("ddr3", timing=P.DDR3_1066)
    assert str(p.value) == str(r.value)


@pytest.mark.parametrize("window", [0, 64, [3, 70], np.array([5, 0])])
def test_mlp_window_error_matches_reference(window):
    with pytest.raises(ValueError) as r:
        R_controller.validate_mlp_window(window)
    with pytest.raises(ValueError) as p:
        P_controller.validate_mlp_window(window)
    assert str(p.value) == str(r.value)
    stacked = P.stack_traces([tc.random_trace(s) for s in range(2)])
    stacked["mlp_window"] = np.broadcast_to(np.asarray(window, np.int32),
                                            (2,)).copy()
    with pytest.raises(ValueError) as p2:
        P.simulate_stacked(stacked, P.Policy.MASA, device="cpu")
    assert str(p2.value) == str(r.value)


def test_emit_commands_refused():
    cfg = P.SimConfig(emit_commands=True)
    tr = tc.random_trace(0)
    with pytest.raises(ValueError) as r:
        R.simulate(r_random_trace(0), R.Policy.MASA,
                   R.SimConfig(emit_commands=True))
    with pytest.raises(ValueError) as p:
        P.simulate(tr, P.Policy.MASA, cfg, device="cpu")
    assert str(p.value) == str(r.value)
    for fn, arg in ((P.simulate_batch, [tr]),
                    (P.simulate_stacked, P.stack_traces([tr]))):
        with pytest.raises(ValueError, match="refuse emit_commands"):
            fn(arg, P.Policy.MASA, cfg, device="cpu")
    assert cuda_step.EMIT_COMMANDS_ERROR.startswith(
        "The CUDA lane and mix kernels refuse emit_commands")


def test_default_device_without_a_card_raises(monkeypatch):
    """No silent CPU fallback: device=None means the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr = tc.random_trace(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.simulate(tr, P.Policy.BASELINE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.simulate_batch([tr], P.Policy.MASA)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.simulate_stacked(P.stack_traces([tr]), P.Policy.SALP1,
                           device="cuda")


def test_wrapper_checks_its_inputs():
    """The kernel wrapper refuses what the kernel cannot take, on any
    device, and counts no launch for the plain version."""
    stacked = P.stack_traces([tc.random_trace(s) for s in range(3)])
    eff, nb, ns, xs, mlp = lane_inputs(stacked, P.Policy.MASA, P.SimConfig(),
                                       torch.device("cpu"))
    t = P.SimConfig().timing
    before = dict(cuda_step.LAUNCHES)
    res, _ = cuda_step.simulate_lanes(eff, nb, ns, t, 0, xs, mlp)
    assert cuda_step.LAUNCHES == before
    assert res.n_requests.tolist() == [120] * 3
    with pytest.raises(TypeError):
        cuda_step.simulate_lanes(eff, nb, ns, t, 0, xs.long(), mlp)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_step.simulate_lanes(eff, nb, ns, t, 0,
                                 xs.transpose(0, 1).contiguous().transpose(0, 1),
                                 mlp)
    with pytest.raises(ValueError, match="xs \\[B, N, 6\\]"):
        cuda_step.simulate_lanes(eff, nb, ns, t, 0, xs[..., :5].contiguous(),
                                 mlp)
    with pytest.raises(ValueError, match="positive"):
        cuda_step.simulate_lanes(eff, nb, ns, P.PCM_PALP, 1, xs, mlp)
    bad = dict(stacked, bank=stacked["bank"] + 8)
    with pytest.raises(ValueError, match="outside"):
        lane_inputs(bad, P.Policy.MASA, P.SimConfig(), torch.device("cpu"))
    assert cuda_step.timing_array(t, "cpu").tolist() == \
        list(dataclasses.astuple(t))
