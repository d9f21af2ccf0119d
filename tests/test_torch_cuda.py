"""The CUDA lane, mix and SSD-scan kernels against their plain versions,
on the card.

Marked ``cuda``: these run where an NVIDIA GPU with compute capability 9.0
and ``nvcc`` are present (``pytest -m cuda``) and skip elsewhere, with the
capability probe's reason. Whether there is a card is decided inside the
fixture, never at import.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core.dram as P
import torch_cases as tc
from repro_torch import compat
from repro_torch.core.dram import cuda_step
from repro_torch.core.dram.engine import (lane_inputs, mix_inputs,
                                          result_from_state)

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


def random_mix_inputs(config, policy, M, C, N, seed, device):
    """M random mixes of C cores ([M, C, N] requests, per-core windows,
    shuffled ranks) through mix_inputs."""
    st = [P.stack_traces([tc.random_trace(seed + 17 * m + c, n=N,
                                          nb=config.n_banks,
                                          ns=config.n_subarrays)
                          for c in range(C)]) for m in range(M)]
    stacked = {k: np.stack([s[k] for s in st]) for k in st[0]}
    rng = np.random.default_rng(seed)
    ranks = np.stack([rng.permutation(C) for _ in range(M)]).astype(np.int32)
    return mix_inputs(stacked, ranks, policy, config, device)


@pytest.mark.parametrize("config", list(tc.CONFIGS))
def test_mix_kernel_equals_plain(card, config):
    for k, sched in enumerate(P.Scheduler):
        for pol in (P.Policy.BASELINE, P.Policy.MASA, P.Policy.IDEAL):
            cfg = P.SimConfig(n_banks=4, n_subarrays=16, scheduler=sched,
                              **tc.CONFIGS[config])
            C = (1, 2, 3, 4, 4)[k]
            eff, sc_, nb, ns, reqs, mlp, rank = random_mix_inputs(
                cfg, pol, 6, C, 48, 60 + k, card)
            closed = cfg.row_policy == "closed"
            got, got_max = cuda_step.simulate_cores(
                eff, sc_, nb, ns, cfg.timing, cfg.refresh_mode, reqs, mlp,
                rank, closed)
            sc, vis, ref_max = cuda_step.simulate_cores_plain(
                eff, sc_, nb, ns, cfg.timing, cfg.refresh_mode, reqs, mlp,
                rank, closed)
            ref = result_from_state(C * 48, sc, vis.amax(dim=1))
            torch.cuda.synchronize()
            for f in COUNTERS:
                assert torch.equal(getattr(got, f), getattr(ref, f)), \
                    (sched, pol, f)
            assert torch.equal(got_max, ref_max)


def test_golden_multicore_cells_through_the_kernel(card):
    for (config, sched, policy), cells in tc.golden_multicore_groups().items():
        res = P.simulate_multicore_batch(
            [tc.golden_mix(c["seed"]) for c in cells], P.Policy[policy],
            tc.golden_multicore_config(config, sched), device="cuda")
        got = [({f: int(getattr(r.shared, f)) for f in COUNTERS},
                [int(x) for x in r.core_cycles]) for r in res]
        assert got == [(c["counters"], c["core_cycles"]) for c in cells], \
            (config, sched, policy)


def test_one_mix_launch_per_call_and_refusals(card):
    mixes = [tc.golden_mix(s) for s in range(3)]
    cuda_step.reset_launches()
    res = P.simulate_multicore_batch(mixes, P.Policy.MASA, device=None)
    assert cuda_step.LAUNCHES == {"lane_step": 1, "mix_step": 1}
    assert res[0].shared.n_act.is_cuda
    eff, sc_, nb, ns, reqs, mlp, rank = random_mix_inputs(
        P.SimConfig(), P.Policy.MASA, 2, 2, 16, 0, card)
    t = P.SimConfig().timing
    with pytest.raises(TypeError):
        cuda_step.simulate_cores(eff, sc_, nb, ns, t, 0, reqs.long(), mlp,
                                 rank)
    with pytest.raises(ValueError):
        cuda_step.simulate_cores(eff, sc_, nb, ns, t, 0, reqs, mlp,
                                 rank.cpu())
    assert cuda_step.LAUNCHES["mix_step"] == 1


# ---------------------------------------------------------------- SSD scan
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", tc.SSD_CARD_SHAPES)
def test_ssd_kernel_equals_plain(card, shape, dtype):
    from repro_torch.kernels.ssd_scan import kernel as K

    H, chunk = shape[2], shape[5]
    args = tc.ssd_kernel_inputs(shape, getattr(torch, dtype), card)
    y_k, h_k = K.ssd_scan_kernel(*args, chunk=chunk, n_heads=H)
    y_p, h_p = K.ssd_scan_plain(*args, chunk=chunk, n_heads=H)
    torch.cuda.synchronize()
    tol = tc.SSD_TOLS[dtype]
    assert y_k.dtype == args[0].dtype and h_k.dtype == torch.float32
    torch.testing.assert_close(y_k.float(), y_p.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h_k, h_p, rtol=tol, atol=tol)


def test_ssd_launches_and_refusals(card):
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import kernel as K
    from repro_torch.models import build_model

    cfg = get_config("mamba2-780m").reduced(128)
    model = build_model(cfg, interop.params_from_reference(
        cfg, interop.numpy_reference_params(cfg, 0)), dtype=torch.float32,
        device=None)
    K.reset_launches()
    model.prefill({"tokens": torch.zeros((1, 32), dtype=torch.long,
                                         device=card)})
    assert K.LAUNCHES["ssd_scan"] == cfg.n_layers
    xr, l, b, c = tc.ssd_kernel_inputs((1, 32, 2, 16, 8, 16), torch.float32,
                                       card)
    with pytest.raises(TypeError):
        K.ssd_scan_kernel(xr.double(), l, b, c, chunk=16, n_heads=2)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        K.ssd_scan_kernel(xr.bfloat16(), l, b, c, chunk=16, n_heads=2)
    with pytest.raises(ValueError, match="does not take chunk=8"):
        K.ssd_scan_kernel(xr, l, b, c, chunk=8, n_heads=2)
    with pytest.raises(ValueError, match="inputs on"):
        K.ssd_scan_kernel(xr, l.cpu(), b, c, chunk=16, n_heads=2)
    assert K.LAUNCHES["ssd_scan"] == cfg.n_layers


@pytest.mark.parametrize("chunk,hd,ds,fits", [
    (64, 64, 128, True), (256, 64, 128, True), (32, 64, 16, True),
    (16, 16, 8, True), (256, 128, 256, True), (8, 16, 8, False),
    (64, 48, 16, False), (64, 256, 16, False), (64, 64, 6, False),
    (256, 128, 512, False)])
def test_kernel_shape_limits(card, chunk, hd, ds, fits):
    """Every (chunk, ds, hd) the configs and tests use fits the kernel's
    shared memory and agrees with the plain version; shapes it cannot take
    are refused before a launch."""
    from repro_torch.kernels.ssd_scan import kernel as K

    args = tc.ssd_kernel_inputs((1, chunk, 2, hd, ds, chunk), torch.float32,
                                card)
    K.reset_launches()
    if not fits:
        with pytest.raises(ValueError, match="does not take"):
            K.ssd_scan_kernel(*args, chunk=chunk, n_heads=2)
        assert K.LAUNCHES["ssd_scan"] == 0
        return
    y_k, h_k = K.ssd_scan_kernel(*args, chunk=chunk, n_heads=2)
    y_p, h_p = K.ssd_scan_plain(*args, chunk=chunk, n_heads=2)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ssd_scan"] == 1
    tol = tc.SSD_TOLS["float32"]
    torch.testing.assert_close(y_k, y_p, rtol=tol, atol=tol)
    torch.testing.assert_close(h_k, h_p, rtol=tol, atol=tol)
