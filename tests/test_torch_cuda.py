"""The CUDA lane kernel against its plain version, on the card.

Marked ``cuda``: these run where an NVIDIA GPU with compute capability 9.0
and ``nvcc`` are present (``pytest -m cuda``) and skip elsewhere, with the
capability probe's reason. Whether there is a card is decided inside the
fixture, never at import.
"""
import dataclasses

import pytest
import torch

import repro_torch.core.dram as P
import torch_cases as tc
from repro_torch import compat
from repro_torch.core.dram import cuda_step
from repro_torch.core.dram.engine import lane_inputs, result_from_state

pytestmark = pytest.mark.cuda

COUNTERS = tuple(f.name for f in dataclasses.fields(P.SimResult))


@pytest.fixture(scope="module")
def card():
    reason = compat.kernel_unavailable_reason()
    if reason:
        pytest.skip(reason)
    cuda_step.build()
    return torch.device("cuda")


@pytest.mark.parametrize("config", list(tc.CONFIGS))
def test_kernel_equals_plain(card, config):
    cfg = P.SimConfig(n_banks=4, n_subarrays=16, **tc.CONFIGS[config])
    for pol in P.Policy:
        stacked = P.stack_traces([tc.random_trace(s, n=200, nb=4, ns=16)
                                  for s in range(40, 48)])
        eff, nb, ns, xs, mlp = lane_inputs(stacked, pol, cfg, card)
        closed = cfg.row_policy == "closed"
        got, got_max = cuda_step.simulate_lanes(
            eff, nb, ns, cfg.timing, cfg.refresh_mode, xs, mlp, closed)
        sc, vis, ref_max = cuda_step.simulate_lanes_plain(
            eff, nb, ns, cfg.timing, cfg.refresh_mode, xs, mlp, closed)
        ref = result_from_state(xs.shape[1], sc, vis)
        torch.cuda.synchronize()
        for f in COUNTERS:
            assert torch.equal(getattr(got, f), getattr(ref, f)), (pol, f)
        assert torch.equal(got_max, ref_max)


def test_golden_cells_through_the_kernel(card):
    for (config, policy), cells in tc.golden_groups().items():
        res = P.simulate_stacked(tc.golden_stacked(cells), P.Policy[policy],
                                 P.SimConfig(**tc.CONFIGS[config]),
                                 device="cuda")
        got = [{f: int(getattr(res, f)[b]) for f in COUNTERS}
               for b in range(len(cells))]
        assert got == [c["counters"] for c in cells], (config, policy)


def test_one_launch_per_call_and_refusals(card):
    stacked = P.stack_traces([tc.random_trace(s) for s in range(4)])
    cuda_step.reset_launches()
    res = P.simulate_stacked(stacked, P.Policy.MASA, device=None)
    assert cuda_step.LAUNCHES["lane_step"] == 1
    assert res.n_act.is_cuda and res.n_act.dtype == torch.int32
    eff, nb, ns, xs, mlp = lane_inputs(stacked, P.Policy.MASA, P.SimConfig(),
                                       card)
    t = P.SimConfig().timing
    with pytest.raises(TypeError):
        cuda_step.simulate_lanes(eff, nb, ns, t, 0, xs.long(), mlp)
    with pytest.raises(ValueError):
        cuda_step.simulate_lanes(eff, nb, ns, t, 0, xs, mlp.cpu())
    assert cuda_step.LAUNCHES["lane_step"] == 1
