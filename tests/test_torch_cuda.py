"""The CUDA lane, mix and SSD-scan kernels and the accelerator layer's
masa_gemm, moe_gemm, paged_attention and flash_attention kernels against
their plain versions, on the card.

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


def smem_ran(kernel, launches):
    """Every launch of ``kernel`` since the last reset ran the smem body."""
    assert cuda_step.LAUNCHES[kernel] == launches
    assert cuda_step.BODIES[kernel] == {"global": 0, "smem": launches}


@pytest.mark.parametrize("config", list(tc.CONFIGS))
def test_kernel_equals_plain(card, config):
    cfg = P.SimConfig(n_banks=4, n_subarrays=16, **tc.CONFIGS[config])
    cuda_step.reset_launches()
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
    smem_ran("lane_step", len(P.Policy))


def test_golden_cells_through_the_kernel(card):
    cuda_step.reset_launches()
    for (config, policy), cells in tc.golden_groups().items():
        res = P.simulate_stacked(tc.golden_stacked(cells), P.Policy[policy],
                                 P.SimConfig(**tc.CONFIGS[config]),
                                 device="cuda")
        got = [{f: int(getattr(res, f)[b]) for f in COUNTERS}
               for b in range(len(cells))]
        assert got == [c["counters"] for c in cells], (config, policy)
    smem_ran("lane_step", len(tc.golden_groups()))


def test_one_launch_per_call_and_refusals(card):
    stacked = P.stack_traces([tc.random_trace(s) for s in range(4)])
    cuda_step.reset_launches()
    res = P.simulate_stacked(stacked, P.Policy.MASA, device=None)
    smem_ran("lane_step", 1)
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
    cuda_step.reset_launches()
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
    smem_ran("mix_step", 3 * len(P.Scheduler))


def test_golden_multicore_cells_through_the_kernel(card):
    cuda_step.reset_launches()
    for (config, sched, policy), cells in tc.golden_multicore_groups().items():
        res = P.simulate_multicore_batch(
            [tc.golden_mix(c["seed"]) for c in cells], P.Policy[policy],
            tc.golden_multicore_config(config, sched), device="cuda")
        got = [({f: int(getattr(r.shared, f)) for f in COUNTERS},
                [int(x) for x in r.core_cycles]) for r in res]
        assert got == [(c["counters"], c["core_cycles"]) for c in cells], \
            (config, sched, policy)
    smem_ran("mix_step", cuda_step.LAUNCHES["mix_step"])
    smem_ran("lane_step", cuda_step.LAUNCHES["lane_step"])
    assert cuda_step.LAUNCHES["mix_step"] == len(tc.golden_multicore_groups())


def test_one_mix_launch_per_call_and_refusals(card):
    mixes = [tc.golden_mix(s) for s in range(3)]
    cuda_step.reset_launches()
    res = P.simulate_multicore_batch(mixes, P.Policy.MASA, device=None)
    assert cuda_step.LAUNCHES == {"lane_step": 1, "mix_step": 1}
    smem_ran("mix_step", 1)
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


# ------------------------------------------- the DRAM kernels' two bodies
def lane_equals_plain(card, cfg, pol, seeds, n, body=None):
    """The lane kernel (``body`` forced, or as body() picks) == plain."""
    nb, ns = cfg.n_banks, cfg.n_subarrays
    stacked = P.stack_traces([tc.random_trace(s, n=n, nb=nb, ns=ns)
                              for s in seeds])
    eff, knb, kns, xs, mlp = lane_inputs(stacked, pol, cfg, card)
    args = (eff, knb, kns, cfg.timing, cfg.refresh_mode, xs, mlp,
            cfg.row_policy == "closed")
    got = cuda_step._launch(*args, _body=body)
    ref = cuda_step.simulate_lanes_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r), (pol, body)
    return cuda_step.body(knb, kns, cfg.refresh_mode)


def mix_equals_plain(card, cfg, pol, M, C, N, seed, body=None,
                     identical=False):
    """The mix kernel (``body`` forced, or as body() picks) == plain; with
    ``identical`` every core of a mix runs the same trace."""
    if identical:
        st = [P.stack_traces([tc.random_trace(seed + m, n=N,
                                              nb=cfg.n_banks,
                                              ns=cfg.n_subarrays)] * C)
              for m in range(M)]
        stacked = {k: np.stack([s[k] for s in st]) for k in st[0]}
        ranks = np.tile(np.arange(C, dtype=np.int32), (M, 1))
        args = mix_inputs(stacked, ranks, pol, cfg, card)
    else:
        args = random_mix_inputs(cfg, pol, M, C, N, seed, card)
    eff, sched, nb, ns, reqs, mlp, rank = args
    full = (eff, sched, nb, ns, cfg.timing, cfg.refresh_mode, reqs, mlp,
            rank, cfg.row_policy == "closed")
    got = cuda_step._launch_cores(*full, _body=body)
    ref = cuda_step.simulate_cores_plain(*full)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r), (pol, body, C)
    return cuda_step.body(nb, ns, cfg.refresh_mode, C)


@pytest.mark.parametrize("body", ["smem", "global"])
@pytest.mark.parametrize("config", list(tc.CONFIGS))
def test_both_lane_bodies_equal_plain(card, config, body):
    cfg = P.SimConfig(n_banks=4, n_subarrays=16, **tc.CONFIGS[config])
    cuda_step.reset_launches()
    for pol in P.Policy:
        lane_equals_plain(card, cfg, pol, range(70, 75), 150, body=body)
    assert cuda_step.BODIES["lane_step"][body] == len(P.Policy)


@pytest.mark.parametrize("body", ["smem", "global"])
@pytest.mark.parametrize("config", list(tc.CONFIGS))
def test_both_mix_bodies_equal_plain(card, config, body):
    cuda_step.reset_launches()
    n = 0
    for sched in P.Scheduler:
        for pol in P.Policy:
            cfg = P.SimConfig(n_banks=4, n_subarrays=16, scheduler=sched,
                              **tc.CONFIGS[config])
            mix_equals_plain(card, cfg, pol, 3, 3, 16, 80 + int(sched),
                             body=body)
            n += 1
    assert cuda_step.BODIES["mix_step"][body] == n


def test_over_budget_geometry_takes_the_global_body(card):
    """16 x 1024 (a 328 KB plane) is over a block's shared memory: body()
    sends it to the global body, and forcing smem is refused."""
    cuda_step.reset_launches()
    for config in ("default", "closed_refresh", "darp"):
        cfg = P.SimConfig(n_banks=16, n_subarrays=1024, **tc.CONFIGS[config])
        assert lane_equals_plain(card, cfg, P.Policy.SALP1, range(3), 60) \
            == "global"
        assert mix_equals_plain(card, cfg, P.Policy.BASELINE, 2, 2, 30, 5) \
            == "global"
    assert cuda_step.BODIES == {"lane_step": {"global": 3, "smem": 0},
                                "mix_step": {"global": 3, "smem": 0}}
    with pytest.raises(ValueError, match="does not take"):
        lane_equals_plain(card, P.SimConfig(n_banks=16, n_subarrays=1024),
                          P.Policy.MASA, range(2), 8, body="smem")


@pytest.mark.parametrize("identical", [False, True])
@pytest.mark.parametrize("sched", list(P.Scheduler))
@pytest.mark.parametrize("C", [40, 4])
def test_mix_cores_past_a_warp_and_ties(card, C, sched, identical):
    """C = 40 keys two cores on lanes 0-7; identical traces make every key
    tie, so the lowest core must win, as jnp.argmin's does."""
    cfg = P.SimConfig(scheduler=sched)
    cuda_step.reset_launches()
    for pol in (P.Policy.BASELINE, P.Policy.MASA):
        assert mix_equals_plain(card, cfg, pol, 3, C, 8 if C > 32 else 40,
                                90, identical=identical) == "smem"
    smem_ran("mix_step", 2)


@pytest.mark.parametrize("config", ["closed", "closed_refresh", "sarp",
                                    "darp", "refresh", "per_bank"])
def test_ns64_warp_split_loops(card, config):
    """At ns 64 the refresh close and the closed-row BASELINE / SALP-1 bump
    run split over the warp's 32 lanes, two rows a lane."""
    cfg = P.SimConfig(n_banks=2, n_subarrays=64, **tc.CONFIGS[config])
    cuda_step.reset_launches()
    for pol in (P.Policy.BASELINE, P.Policy.SALP1, P.Policy.SALP2,
                P.Policy.MASA):
        lane_equals_plain(card, cfg, pol, range(20, 26), 300)
        mix_equals_plain(card, P.SimConfig(n_banks=2, n_subarrays=64,
                                           scheduler=P.Scheduler.FRFCFS,
                                           **tc.CONFIGS[config]),
                         pol, 3, 4, 60, 31)
    smem_ran("lane_step", 4)
    smem_ran("mix_step", 4)


@pytest.mark.parametrize("n", [1, 2, 15, 16, 17, 63, 64, 65, 101])
def test_streams_not_a_multiple_of_the_chunk(card, n):
    """N around and between multiples of the 16-request staging chunk."""
    cfg = P.SimConfig(refresh=True)
    cuda_step.reset_launches()
    lane_equals_plain(card, cfg, P.Policy.MASA, range(4), n)
    mix_equals_plain(card, P.SimConfig(refresh=True,
                                       scheduler=P.Scheduler.FRFCFS),
                     P.Policy.SALP2, 2, 3, n, 12)
    smem_ran("lane_step", 1)
    smem_ran("mix_step", 1)


# ------------------------------------------- the sweep layer's stream pool
#: The benchmark's two cells at a reduced size: a Fig. 4 job a workload
#: (five one-lane buckets), and the scheduler grid as one mix sweep (ten
#: mix buckets and four run-alone launches)
SWEEP_CELLS = {
    "fig4-1core": dict(workloads=["gamess", "gups"], instructions=2_000_000),
    "sched-4core": dict(n_requests=4096),
}
#: kernel launches a call of each cell: one a bucket, one a run-alone mix
CALL_LAUNCHES = {"fig4-1core": {"lane_step": 5, "mix_step": 0},
                 "sched-4core": {"lane_step": 4, "mix_step": 10}}


@pytest.fixture(scope="module")
def cell_grids(card):
    """Each cell's calls, as ``(grid, kind)``, built by the benchmark's
    adapter from its configuration and traffic files."""
    from chipbench.harness import generator, main, program
    out = {}
    for cell, small in SWEEP_CELLS.items():
        _, _, config, traffic = main.load_cell(cell)
        prog = program.Program(config, "cuda")
        jobs = generator.make_pass(config, dict(traffic, **small),
                                   seed=2 ** 31 + 33)
        out[cell] = [(prog.grid(j), j["kind"]) for j in jobs]
    return out


def sweep_call(grid, kind):
    from repro_torch import experiments as PE
    if kind == "sweep":
        return PE.run_sweep(grid, PE.ResultCache(), device="cuda")
    return PE.run_mix_sweep(grid, device="cuda")


def sweep_answers(result, kind):
    doc = result.to_json()
    if kind == "sweep":
        gains = [result.ipc_gain_pct(pol).tolist()
                 for pol in sorted({c.policy for c in result.cells})]
        return doc["cells"], doc["quarantined"], gains
    return doc["cells"], doc["quarantined"]


@pytest.mark.parametrize("cell", list(SWEEP_CELLS))
def test_sweep_window_equals_one_bucket_at_a_time(card, cell_grids, cell,
                                                  monkeypatch):
    from repro_torch.experiments import streams

    def calls(window):
        monkeypatch.setattr(streams, "window", lambda device: window)
        out = []
        for grid, kind in cell_grids[cell]:
            cuda_step.reset_launches()
            answers = sweep_answers(sweep_call(grid, kind), kind)
            out.append((answers, dict(cuda_step.LAUNCHES)))
        return out

    assert streams.window(card) == 8
    calls(8)                                                # warm
    got, want = calls(8), calls(1)
    assert got == want
    assert all(launches == CALL_LAUNCHES[cell] for _, launches in got)
    assert all(not answers[1] for answers, _ in got)        # none quarantined


@pytest.mark.parametrize("cell", list(SWEEP_CELLS))
def test_buckets_of_one_call_run_side_by_side(card, cell_grids, cell):
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    kernel = "mix_step" if cell == "sched-4core" else "lane_step"
    grid, kind = cell_grids[cell][-1]
    sweep_call(grid, kind)                                   # warm
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sweep_call(grid, kind)
    spans = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                   for ev in prof.profiler.kineto_results.events()
                   if "CUDA" in str(ev.device_type())
                   and f"{kernel}_" in ev.name())
    assert len(spans) == CALL_LAUNCHES[cell][kernel]
    assert any(b[0] < a[1] for a, b in zip(spans, spans[1:])), spans
    launches = sum(CALL_LAUNCHES[cell].values())
    assert obs.COUNTS["sweep.overlapped_launches"] == launches - 1
    obs.reset()


# ---------------------------------------------------------------- SSD scan
def ssd_equals_plain(args, shape, dtype):
    """One launch on ``args`` equals the plain version within the dtype's
    tolerance."""
    from repro_torch.kernels.ssd_scan import kernel as K

    H, chunk = shape[2], shape[5]
    K.reset_launches()
    y_k, h_k = K.ssd_scan_kernel(*args, chunk=chunk, n_heads=H)
    y_p, h_p = K.ssd_scan_plain(*args, chunk=chunk, n_heads=H)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ssd_scan"] == 1
    tol = tc.TOLS[dtype]
    assert y_k.dtype == args[0].dtype and h_k.dtype == torch.float32
    torch.testing.assert_close(y_k.float(), y_p.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h_k, h_p, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", tc.SSD_CARD_SHAPES + tc.SSD_EDGE)
def test_ssd_kernel_equals_plain(card, shape, dtype):
    """Every column tile (hd 4, 8, 16 and 32 up take tiles of 4, 8, 16
    and 32) and ds of 1 to 4 float4s a lane."""
    ssd_equals_plain(tc.ssd_kernel_inputs(shape, getattr(torch, dtype), card),
                     shape, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 64, 2, 32, 16, 32), tc.SSD_SERVE])
def test_ssd_unaligned_bases(card, shape, dtype):
    """Bases one element past an allocation's: the kernel stages them in
    the largest unit they allow (4-byte cp.async in float32, 2-byte plain
    copies in bfloat16) and still equals the plain version."""
    args = [tc.shifted(t) for t in
            tc.ssd_kernel_inputs(shape, getattr(torch, dtype), card)]
    assert all(t.data_ptr() % 16 for t in args)
    ssd_equals_plain(args, shape, dtype)


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
    (256, 128, 512, True), (64, 64, 1024, False)])
def test_kernel_shape_limits(card, chunk, hd, ds, fits):
    """Every (chunk, ds, hd) the configs and tests use fits the kernel's
    shared memory and agrees with the plain version; shapes it cannot take
    (chunk not a multiple of 16, hd not a power of two up to 128, ds not a
    multiple of 4 up to 512) are refused before a launch."""
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
    tol = tc.TOLS["float32"]
    torch.testing.assert_close(y_k, y_p, rtol=tol, atol=tol)
    torch.testing.assert_close(h_k, h_p, rtol=tol, atol=tol)


# ------------------------------------------- masa, moe, paged, flash kernels
def card_tensors(arrays, dtype, device):
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrays]


def assert_kernel_close(got, want, dtype: str):
    tol = tc.TOLS[dtype]
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("order", ["output_stationary", "weight_stationary"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", tc.MASA_SHAPES)
def test_masa_kernel_equals_plain(card, m, k, n, dtype, order):
    from repro_torch.kernels import masa_gemm
    from repro_torch.kernels.masa_gemm import kernel as K

    a, b = card_tensors(tc.masa_inputs(m, k, n), getattr(torch, dtype), card)
    K.reset_launches()
    got = masa_gemm(a, b, order=order)
    torch.cuda.synchronize()
    ws = (order == "weight_stationary"
          and K.ws_panel_bytes(k, a.dtype) <= K.cuda_build.MAX_SMEM_BYTES)
    assert K.LAUNCHES == {"masa_gemm_os": int(not ws), "masa_gemm_ws": int(ws)}
    body = "wgmma" if dtype == "bfloat16" else "tf32x3"
    assert K.body(a, b) == body and K.BODIES[body] == 1
    assert_kernel_close(got, K.masa_gemm_plain(a, b), dtype)


@pytest.mark.parametrize("m,k,n,dtype", tc.MASA_WS_ODD_K)
def test_masa_weight_stationary_takes_any_k(card, m, k, n, dtype):
    from repro_torch.kernels import masa_gemm
    from repro_torch.kernels.masa_gemm import kernel as K

    a, b = card_tensors(tc.masa_inputs(m, k, n), getattr(torch, dtype), card)
    K.reset_launches()
    got = masa_gemm(a, b, order="weight_stationary")
    torch.cuda.synchronize()
    ws = K.ws_panel_bytes(k, a.dtype) <= K.cuda_build.MAX_SMEM_BYTES
    assert K.LAUNCHES == {"masa_gemm_os": int(not ws), "masa_gemm_ws": int(ws)}
    # fp32 K 300 and 400 (multiples of 4) take tf32x3; bf16 K 500 and 700
    # (K % 8 != 0) simt
    body = "tf32x3" if dtype == "float32" else "simt"
    assert K.BODIES == {b: int(b == body) for b in K.BODIES}
    assert_kernel_close(got, K.masa_gemm_plain(a, b), dtype)


#: wgmma-body shapes (M, K, N) with ragged edges: one 64 x 256 x 64 tile;
#: M and N no multiples of the tiles (128 x 256, 128-column panels) and K
#: a multiple of 8 but not of 64; a K step of 8 past the last full stage;
#: and K 600, the deepest multiple of 8 whose weight-stationary budget
#: (ws_panel_bytes) fits in bf16.
MASA_WGMMA_RAGGED = ((64, 64, 256), (192, 200, 384), (300, 136, 520),
                     (128, 72, 8), (136, 600, 136))


@pytest.mark.parametrize("order", ["output_stationary", "weight_stationary"])
@pytest.mark.parametrize("m,k,n", MASA_WGMMA_RAGGED)
def test_masa_wgmma_ragged_edges(card, m, k, n, order):
    from repro_torch.kernels.masa_gemm import kernel as K

    a, b = card_tensors(tc.masa_inputs(m, k, n, seed=3), torch.bfloat16,
                        card)
    K.reset_launches()
    got = K.masa_gemm_kernel(a, b, bm=4, bn=8, bk=8, order=order)
    torch.cuda.synchronize()
    assert K.BODIES == {"wgmma": 1, "simt": 0, "tf32x3": 0}
    assert_kernel_close(got, K.masa_gemm_plain(a, b), "bfloat16")


def test_masa_fp32_takes_the_simt_body(card):
    """fp32 rows that are not whole 16-byte units (K 202) take the simt
    body by shape; forced on an aligned shape (K 200), it is still right."""
    from repro_torch.kernels.masa_gemm import kernel as K

    a, b = card_tensors(tc.masa_inputs(192, 202, 384, seed=3), torch.float32,
                        card)
    K.reset_launches()
    got = K.masa_gemm_kernel(a, b, bm=64, bn=128, bk=2)
    torch.cuda.synchronize()
    assert K.BODIES == {"wgmma": 0, "simt": 1, "tf32x3": 0}
    assert_kernel_close(got, K.masa_gemm_plain(a, b), "float32")
    a, b = card_tensors(tc.masa_inputs(192, 200, 384, seed=3), torch.float32,
                        card)
    for order in K.ORDERS:
        assert_kernel_close(K._launch(a, b, order, "simt"),
                            K.masa_gemm_plain(a, b), "float32")


#: tf32x3-body shapes (M, K, N): ragged M (one row, a row past a tile, one
#: short of one); K 4, 36 (a stage and one 16-byte unit) and 300 (the
#: deepest fp32 K whose weight-stationary budget fits: a panel of 320 rows
#: and the ring); N 4 and 132 (past one 128-column panel); the kernel
#: bench's 1024 x 256 x 256.
MASA_TF32X3 = ((1, 4, 4), (129, 36, 132), (255, 300, 132), (192, 200, 384),
               (300, 64, 4), (64, 300, 256), (1024, 256, 256))


@pytest.mark.parametrize("order", ["output_stationary", "weight_stationary"])
@pytest.mark.parametrize("m,k,n", MASA_TF32X3)
def test_masa_tf32x3_equals_plain(card, m, k, n, order):
    """fp32 with K and N multiples of 4: one tf32x3 launch in either order,
    equal to the plain version at the fp32 tolerance; two launches
    bit-equal."""
    from repro_torch.kernels.masa_gemm import kernel as K

    a, b = card_tensors(tc.masa_inputs(m, k, n, seed=5), torch.float32, card)
    assert K.body(a, b) == "tf32x3"
    assert K.ws_panel_bytes(k, a.dtype) <= K.cuda_build.MAX_SMEM_BYTES
    K.reset_launches()
    got = K.masa_gemm_kernel(a, b, bm=1, bn=4, bk=4, order=order)
    torch.cuda.synchronize()
    ws = order == "weight_stationary"
    assert K.LAUNCHES == {"masa_gemm_os": int(not ws), "masa_gemm_ws": int(ws)}
    assert K.BODIES == {"wgmma": 0, "simt": 0, "tf32x3": 1}
    assert_kernel_close(got, K.masa_gemm_plain(a, b), "float32")
    assert torch.equal(got, K.masa_gemm_kernel(a, b, bm=1, bn=4, bk=4,
                                               order=order))


def test_tf32x3_refuses_what_it_does_not_take(card):
    """Forced on a shape or dtype it does not take (masa K 250 or N 126,
    bf16; flash bf16, an unaligned base) the tf32x3 body raises, and no
    body counts a launch."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.masa_gemm import kernel as MK

    MK.reset_launches()
    FK.reset_launches()
    for (m, k, n), dtype in (((128, 250, 128), torch.float32),
                             ((128, 256, 126), torch.float32),
                             ((128, 256, 128), torch.bfloat16)):
        a = torch.randn((m, k), device=card).to(dtype)
        b = torch.randn((k, n), device=card).to(dtype)
        for order in MK.ORDERS:
            with pytest.raises(ValueError, match="refused"):
                MK._launch(a, b, order, "tf32x3")
    q = torch.randn((2, 128, 64), device=card)
    with pytest.raises(ValueError, match="refused"):
        FK._launch(q.bfloat16(), q.bfloat16(), q.bfloat16(), True, "tf32x3")
    with pytest.raises(ValueError, match="refused"):
        FK._launch(tc.shifted(q), q, q, True, "tf32x3")
    assert not any(MK.BODIES.values()) and not any(FK.BODIES.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F,bt,bf", tc.MOE_SHAPES
                         + ((4, 24, 40, 128, 24, 128), (3, 12, 16, 128, 3, 128)))
def test_moe_kernel_equals_plain(card, E, C, D, F, bt, bf, dtype):
    from repro_torch.kernels import grouped_matmul
    from repro_torch.kernels.moe_gemm import capacity_block_eids
    from repro_torch.kernels.moe_gemm import kernel as K

    x, w = card_tensors(tc.moe_inputs(E, C, D, F, seed=1),
                        getattr(torch, dtype), card)
    eids = capacity_block_eids(E, C, bt, device=card)
    eids = eids.flip(0).contiguous()       # any order: designation, not layout
    K.reset_launches()
    got = grouped_matmul(x, w, eids, bt=bt, bf=bf)
    torch.cuda.synchronize()
    assert K.LAUNCHES["moe_gemm"] == 1
    body = ("wgmma" if dtype == "bfloat16" and bt % 64 == 0
            else "stream" if bt == 24
            else "tf32x3" if dtype == "float32" and bt % 64 == 0 else "simt")
    assert K.body(x, w, bt) == body and K.BODIES[body] == 1
    assert_kernel_close(got, K.grouped_matmul_plain(x, w, eids, bt=bt), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F,bt", tc.MOE_STREAM_SHAPES)
def test_moe_stream_body_equals_plain(card, E, C, D, F, bt, dtype):
    """The stream body at moonshot's four serve shapes and at the edges,
    on the capacity and a scattered designation: one launch each, on the
    stream body, within the dtype's tolerance of the plain version, and a
    second launch on the same inputs bit-equal."""
    from repro_torch.kernels.moe_gemm import kernel as K

    x, w, designations = tc.moe_stream_case(E, C, D, F, bt,
                                            getattr(torch, dtype), card)
    assert K.body(x, w, bt) == "stream"
    for ids in designations.values():
        K.reset_launches()
        got = K.grouped_matmul_kernel(x, w, ids, bt=bt, bf=8)
        torch.cuda.synchronize()
        assert K.LAUNCHES["moe_gemm"] == 1
        assert K.BODIES == {"wgmma": 0, "simt": 0, "stream": 1, "tf32x3": 0}
        assert_kernel_close(got, K.grouped_matmul_plain(x, w, ids, bt=bt),
                            dtype)
        assert torch.equal(got, K.grouped_matmul_kernel(x, w, ids, bt=bt,
                                                        bf=8))


def test_moe_stream_body_refuses_what_it_does_not_take(card):
    """Forced on a shape it does not take (bt 12, bt 64, F's rows not whole
    16-byte units) the stream body raises; simt takes each of them."""
    from repro_torch.kernels.moe_gemm import kernel as K

    x, w, ids = (torch.randn((128, 64), device=card),
                 torch.randn((2, 64, 130), device=card),
                 torch.zeros(2, dtype=torch.int32, device=card))
    for bt, ww in ((64, w), (64, w[..., :128].contiguous())):
        with pytest.raises(ValueError, match="refused"):
            K._launch(x, ww, ids, bt, "stream")
        assert_kernel_close(K._launch(x, ww, ids, bt, "simt"),
                            K.grouped_matmul_plain(x, ww, ids, bt=bt),
                            "float32")
    ids12 = torch.zeros(128 // 12 + 1, dtype=torch.int32, device=card)
    x12 = torch.randn((12 * len(ids12), 64), device=card)
    with pytest.raises(ValueError, match="refused"):
        K._launch(x12, w[..., :128].contiguous(), ids12, 12, "stream")


@pytest.mark.parametrize("E,C,D,F,bt", tc.MOE_TF32X3_SHAPES)
def test_moe_tf32x3_equals_plain(card, E, C, D, F, bt):
    """The tf32x3 body in fp32 at the sweep's token blocks and its edges
    (rows masked at bt 40 and 120, D ragged past its last stage, F past its
    last 128 columns, several row tiles a token block), on the capacity
    designation, the same flipped and a scattered one: one launch each on
    tf32x3, within 2e-4 of the plain version, a second launch bit-equal."""
    from repro_torch.kernels.moe_gemm import kernel as K

    x, w, designations = tc.moe_stream_case(E, C, D, F, bt, torch.float32,
                                            card)
    designations["flipped"] = designations["capacity"].flip(0).contiguous()
    assert K.body(x, w, bt) == "tf32x3"
    for ids in designations.values():
        K.reset_launches()
        got = K.grouped_matmul_kernel(x, w, ids, bt=bt, bf=4)
        torch.cuda.synchronize()
        assert K.LAUNCHES["moe_gemm"] == 1
        assert K.BODIES == {"wgmma": 0, "simt": 0, "stream": 0, "tf32x3": 1}
        assert_kernel_close(got, K.grouped_matmul_plain(x, w, ids, bt=bt),
                            "float32")
        assert torch.equal(got, K.grouped_matmul_kernel(x, w, ids, bt=bt,
                                                        bf=4))


def test_moe_tf32x3_refuses_what_it_does_not_take(card):
    """Forced on what it does not take (bf16, F % 4 != 0, an unaligned
    base, bt 16) the tf32x3 body raises and counts no launch; simt takes
    each of them."""
    from repro_torch.kernels.moe_gemm import kernel as K

    ids = torch.zeros(2, dtype=torch.int32, device=card)
    x, w = torch.randn((128, 64), device=card), torch.randn((2, 64, 128),
                                                            device=card)
    cases = {"bf16": (x.bfloat16(), w.bfloat16(), ids, 64),
             "F % 4": (x, torch.randn((2, 64, 130), device=card), ids, 64),
             "x unaligned": (tc.shifted(x), w, ids, 64),
             "w unaligned": (x, tc.shifted(w), ids, 64),
             "bt 16": (x, w, torch.zeros(8, dtype=torch.int32, device=card),
                       16)}
    for case, (xx, ww, ii, bt) in cases.items():
        K.reset_launches()
        with pytest.raises(ValueError, match="refused"):
            K._launch(xx, ww, ii, bt, "tf32x3")
        assert not any(K.BODIES.values()), case
        dtype = "bfloat16" if case == "bf16" else "float32"
        assert_kernel_close(K._launch(xx, ww, ii, bt, "simt"),
                            K.grouped_matmul_plain(xx, ww, ii, bt=bt), dtype)
        assert K.BODIES["simt"] == 1, case


#: wgmma-body MoE shapes (E, C, D, F, bt) with ragged edges: bt 64 (one
#: consumer warpgroup, 64-row tiles) with D and F no multiples of the
#: stage (64) or the column tile (256); bt 128 likewise.
MOE_WGMMA_RAGGED = ((4, 128, 200, 264, 64), (3, 256, 136, 384, 128),
                    (5, 128, 64, 256, 128))


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("E,C,D,F,bt", MOE_WGMMA_RAGGED)
def test_moe_wgmma_ragged_edges(card, E, C, D, F, bt, flip):
    from repro_torch.kernels.moe_gemm import capacity_block_eids
    from repro_torch.kernels.moe_gemm import kernel as K

    x, w = card_tensors(tc.moe_inputs(E, C, D, F, seed=2), torch.bfloat16,
                        card)
    eids = capacity_block_eids(E, C, bt, device=card)
    if flip:
        eids = eids.flip(0).contiguous()
    K.reset_launches()
    got = K.grouped_matmul_kernel(x, w, eids, bt=bt, bf=8)
    torch.cuda.synchronize()
    assert K.BODIES == {"wgmma": 1, "simt": 0, "stream": 0, "tf32x3": 0}
    assert_kernel_close(got, K.grouped_matmul_plain(x, w, eids, bt=bt),
                        "bfloat16")


def paged_case(shape, dtype, device, seed=3, lens=None, table=None):
    q, kp, vp, t, l = tc.paged_inputs(*shape, seed=seed)
    t = t if table is None else table
    l = l if lens is None else np.asarray(lens, np.int32)
    return (card_tensors((q, kp, vp), getattr(torch, dtype), device)
            + [torch.from_numpy(t).to(device), torch.from_numpy(l).to(device)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", tc.PAGED_SHAPES)
def test_paged_kernel_equals_plain(card, shape, dtype):
    from repro_torch.kernels import paged_attention
    from repro_torch.kernels.paged_attention import kernel as K

    args = paged_case(shape, dtype, card)
    K.reset_launches()
    got = paged_attention(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["paged_attention"] == 1
    assert K.BODIES == {"split": 1, "serial": 0}
    assert_kernel_close(got, K.paged_attention_plain(*args), dtype)


def paged_body_equals_plain(args, dtype, which, n_split):
    """One launch on body ``which`` with ``n_split`` blocks a cluster equals
    the plain version."""
    from repro_torch.kernels.paged_attention import kernel as K

    K.reset_launches()
    got = K._launch(*args, which, n_split)
    torch.cuda.synchronize()
    assert K.LAUNCHES["paged_attention"] == 1
    assert K.BODIES == {b: int(b == which) for b in K.BODIES}
    assert_kernel_close(got, K.paged_attention_plain(*args), dtype)


BODY_SPLITS = [("serial", None), ("split", 1), ("split", 2), ("split", 4),
               ("split", 8)]


@pytest.mark.parametrize("which,n_split", BODY_SPLITS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", tc.PAGED_SHAPES)
def test_paged_bodies_equal_plain(card, shape, dtype, which, n_split):
    """Both bodies, the split one at every cluster size, at the sweep."""
    paged_body_equals_plain(paged_case(shape, dtype, card), dtype, which,
                            n_split)


@pytest.mark.parametrize("which,n_split", BODY_SPLITS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(tc.PAGED_EDGE)))
def test_paged_edges_equal_plain(card, case, dtype, which, n_split):
    """G 1 and 8, lengths 0, 1, around a split's boundary and full,
    n_pages 1 and a repeated page (torch_cases.PAGED_EDGE), on both
    bodies and every cluster size: a split with no slot adds nothing."""
    q, kp, vp, table, lens = tc.paged_edge_inputs(*tc.PAGED_EDGE[case])
    args = card_tensors((q, kp, vp), getattr(torch, dtype), card) + [
        torch.from_numpy(table).to(card), torch.from_numpy(lens).to(card)]
    paged_body_equals_plain(args, dtype, which, n_split)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_lengths_and_clamped_tables(card, dtype):
    """seq_lens 0 (uniform over every named slot), 1, a partial page and
    full; out-of-range table entries clamped by ops as in the reference."""
    from repro_torch.kernels import paged_attention
    from repro_torch.kernels.paged_attention import kernel as K

    shape = (4, 2, 4, 64, 16, 16, 4)
    table = tc.paged_inputs(*shape, seed=5)[3].copy()
    table[0, 3], table[1, 0], table[2, 2] = -7, 16, 1000
    args = paged_case(shape, dtype, card, seed=5, lens=[0, 1, 21, 64],
                      table=table)
    got = paged_attention(*args)
    clamped = args[3].clamp(0, 15).to(torch.int32)
    assert_kernel_close(got, K.paged_attention_plain(*args[:3], clamped,
                                                     args[4]), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,hd,bq,bk", tc.FLASH_SHAPES
                         + ((2, 128, 96, 128, 128), (1, 100, 64, 100, 50)))
def test_flash_kernel_equals_plain(card, bh, s, hd, bq, bk, causal, dtype):
    from repro_torch.kernels.flash_attention import kernel as K

    q, k, v = card_tensors(tc.flash_inputs(bh, s, hd), getattr(torch, dtype),
                           card)
    K.reset_launches()
    got = K.flash_attention_kernel(q, k, v, causal=causal, bq=bq, bk=bk)
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_attention"] == 1
    body = "wgmma" if dtype == "bfloat16" else "tf32x3"
    assert K.body(q, k, v) == body and K.BODIES[body] == 1
    assert_kernel_close(got, K.flash_attention_plain(q, k, v, causal=causal,
                                                     bk=bk), dtype)


#: wgmma-body shapes (BH, S, hd) with ragged edges: S past one tile of 128
#: but no multiple of it (keys past S zero-filled by TMA and masked), hd 96
#: over three query tiles, and one key past a tile.
FLASH_WGMMA_RAGGED = ((2, 200, 128), (3, 300, 96), (1, 129, 64))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,hd", FLASH_WGMMA_RAGGED)
def test_flash_wgmma_ragged_edges(card, bh, s, hd, causal):
    from repro_torch.kernels.flash_attention import kernel as K

    q, k, v = card_tensors(tc.flash_inputs(bh, s, hd, seed=4),
                           torch.bfloat16, card)
    K.reset_launches()
    got = K.flash_attention_kernel(q, k, v, causal=causal, bq=s, bk=s)
    torch.cuda.synchronize()
    assert K.BODIES == {"wgmma": 1, "simt": 0, "tf32x3": 0}
    assert_kernel_close(got, K.flash_attention_plain(q, k, v, causal=causal,
                                                     bk=s), "bfloat16")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,hd,bq,bk,g", tc.FLASH_SHIFTED)
def test_flash_bf16_unaligned_takes_the_simt_body(card, bh, s, hd, bq, bk, g,
                                                  causal):
    """bf16 on bases that are not 16-byte aligned: one simt launch, k/v
    row bh // g read in the kernel, equal to the plain version."""
    from repro_torch.kernels.flash_attention import kernel as K

    q, k, v = (tc.shifted(t) for t in card_tensors(
        tc.flash_inputs(bh, s, hd, seed=6), torch.bfloat16, card))
    k, v = tc.shifted(k[:bh // g]), tc.shifted(v[:bh // g])
    assert K.body(q, k, v) == "simt"
    K.check_blocks(s, bq, bk)
    K.reset_launches()
    got = K.run(q, k, v, causal=causal, bk=bk)
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_attention"] == 1
    assert K.BODIES == {"wgmma": 0, "simt": 1, "tf32x3": 0}
    assert_kernel_close(got, K.flash_attention_plain(q, k, v, causal=causal,
                                                     bk=bk), "bfloat16")


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("s", [1, 65, 130])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 96, 128])
def test_flash_tf32x3_equals_plain(card, hd, causal, s, g):
    """fp32 at every head dim, causal or not, S of one key, one past a
    key tile and past a query tile and two key tiles, GQA groups of 1 and
    4 (k/v of BH / g rows, indexed in the kernel): one tf32x3 launch,
    equal to the plain version at the fp32 tolerance; two launches
    bit-equal."""
    from repro_torch.kernels.flash_attention import kernel as K

    q, k, v = card_tensors(tc.flash_inputs(8, s, hd, seed=7), torch.float32,
                           card)
    k, v = k[:8 // g].contiguous(), v[:8 // g].contiguous()
    assert K.body(q, k, v) == "tf32x3"
    K.reset_launches()
    got = K.run(q, k, v, causal=causal, bk=128)
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_attention"] == 1
    assert K.BODIES == {"wgmma": 0, "simt": 0, "tf32x3": 1}
    assert_kernel_close(got, K.flash_attention_plain(q, k, v, causal=causal,
                                                     bk=128), "float32")
    assert torch.equal(got, K.run(q, k, v, causal=causal, bk=128))


def spy_launches(monkeypatch, K):
    """Record the shapes of q, k and v at every kernel launch."""
    seen, launch = [], K._launch

    def spy(q, k, v, causal):
        seen.append(tuple(tuple(t.shape) for t in (q, k, v)))
        return launch(q, k, v, causal)

    monkeypatch.setattr(K, "_launch", spy)
    return seen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_gqa_through_ops_equals_plain(card, dtype, monkeypatch):
    """8 query heads on 2 kv heads through ops: one launch, on the
    unexpanded kv heads ([B * Hkv, S, hd])."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import kernel as K

    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 256, 8, 128)).astype(np.float32)
    k, v = (rng.standard_normal((2, 256, 2, 128)).astype(np.float32)
            for _ in range(2))
    q, k, v = card_tensors((q, k, v), getattr(torch, dtype), card)
    seen = spy_launches(monkeypatch, K)
    K.reset_launches()
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_attention"] == 1
    assert seen == [((16, 256, 128), (4, 256, 128), (4, 256, 128))]
    ke, ve = (t.repeat_interleave(4, dim=2) for t in (k, v))
    flat = [t.transpose(1, 2).reshape(16, 256, 128) for t in (q, ke, ve)]
    want = K.flash_attention_plain(*flat, causal=True)
    assert_kernel_close(got, want.reshape(2, 8, 256, 128).transpose(1, 2),
                        dtype)


@pytest.mark.parametrize("hd", [64, 96, 128])
@pytest.mark.parametrize("h,hkv", [(32, 8), (9, 3), (48, 1)])
def test_flash_gqa_wgmma_indexes_the_kv_head(card, h, hkv, hd, monkeypatch):
    """jamba's, smollm's and granite's head ratios in bf16 through ops: one
    wgmma launch on [B * Hkv, S, hd], equal to the plain version on the
    expanded heads."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import kernel as K

    rng = np.random.default_rng(h + hkv + hd)
    q = tc.normal(rng, (2, 256, h, hd))
    k, v = (tc.normal(rng, (2, 256, hkv, hd)) for _ in range(2))
    q, k, v = card_tensors((q, k, v), torch.bfloat16, card)
    seen = spy_launches(monkeypatch, K)
    K.reset_launches()
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert K.BODIES == {"wgmma": 1, "simt": 0, "tf32x3": 0}
    assert seen == [((2 * h, 256, hd), (2 * hkv, 256, hd),
                     (2 * hkv, 256, hd))]
    ke, ve = (t.repeat_interleave(h // hkv, dim=2) for t in (k, v))
    flat = [t.transpose(1, 2).reshape(2 * h, 256, hd) for t in (q, ke, ve)]
    want = K.flash_attention_plain(*flat, causal=True)
    assert_kernel_close(got, want.reshape(2, h, 256, hd).transpose(1, 2),
                        "bfloat16")


@pytest.mark.parametrize("hd", [64, 96, 128])
@pytest.mark.parametrize("h,hkv", [(32, 8), (9, 3), (48, 1)])
def test_flash_gqa_tf32x3_indexes_the_kv_head(card, h, hkv, hd, monkeypatch):
    """jamba's, smollm's and granite's head ratios in fp32 through ops: one
    tf32x3 launch on the unexpanded [B * Hkv, S, hd], equal to the plain
    version on the expanded heads."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import kernel as K

    rng = np.random.default_rng(h + hkv + hd + 1)
    q = tc.normal(rng, (2, 256, h, hd))
    k, v = (tc.normal(rng, (2, 256, hkv, hd)) for _ in range(2))
    q, k, v = card_tensors((q, k, v), torch.float32, card)
    seen = spy_launches(monkeypatch, K)
    K.reset_launches()
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert K.BODIES == {"wgmma": 0, "simt": 0, "tf32x3": 1}
    assert seen == [((2 * h, 256, hd), (2 * hkv, 256, hd),
                     (2 * hkv, 256, hd))]
    ke, ve = (t.repeat_interleave(h // hkv, dim=2) for t in (k, v))
    flat = [t.transpose(1, 2).reshape(2 * h, 256, hd) for t in (q, ke, ve)]
    want = K.flash_attention_plain(*flat, causal=True)
    assert_kernel_close(got, want.reshape(2, h, 256, hd).transpose(1, 2),
                        "float32")


def test_accelerator_kernels_refuse_without_falling_back(card):
    """Each wrapper raises on a non-contiguous input, a wrong dtype or a
    shape its kernel refuses, and launches nothing."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.masa_gemm import kernel as MK
    from repro_torch.kernels.moe_gemm import kernel as EK
    from repro_torch.kernels.paged_attention import kernel as PK

    kernels.reset_launches()
    a = torch.randn((128, 256), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        MK.masa_gemm_kernel(a, a.t())
    with pytest.raises(TypeError):
        MK.masa_gemm_kernel(a.double(), a.t().contiguous().double())
    with pytest.raises(TypeError):
        MK.masa_gemm_kernel(a, a.t().contiguous().bfloat16())
    with pytest.raises(ValueError, match="falls back"):
        MK.masa_gemm_kernel(torch.randn((128, 512), device=card),
                            torch.randn((512, 128), device=card),
                            order="weight_stationary")
    x, w = torch.randn((256, 64), device=card), torch.randn((2, 64, 128),
                                                             device=card)
    eids = torch.tensor([0, 1], dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="int32"):
        EK.grouped_matmul_kernel(x, w, eids.long())
    with pytest.raises(TypeError):
        EK.grouped_matmul_kernel(x.bfloat16(), w, eids)
    with pytest.raises(ValueError, match="contiguous"):
        EK.grouped_matmul_kernel(x, w.transpose(1, 2).contiguous()
                                 .transpose(1, 2), eids)
    q, kp, vp, table, lens = paged_case((2, 2, 4, 64, 8, 16, 4), "float32",
                                        card)
    with pytest.raises(TypeError, match="int32"):
        PK.paged_attention_kernel(q, kp, vp, table.long(), lens)
    with pytest.raises(TypeError):
        PK.paged_attention_kernel(q.bfloat16(), kp, vp, table, lens)
    with pytest.raises(ValueError, match="contiguous"):
        PK.paged_attention_kernel(q.transpose(2, 3).contiguous()
                                  .transpose(2, 3), kp, vp, table, lens)
    with pytest.raises(ValueError, match="does not take G"):
        big = torch.randn((1, 1, 256, 256), device=card)
        pages = torch.randn((2, 16, 1, 256), device=card)
        PK.paged_attention_kernel(big, pages, pages,
                                  torch.zeros((1, 1), dtype=torch.int32,
                                              device=card),
                                  torch.ones(1, dtype=torch.int32,
                                             device=card))
    f = torch.randn((2, 128, 48), device=card)
    with pytest.raises(ValueError, match="head dims 64, 96 and 128, not 48"):
        FK.flash_attention_kernel(f, f, f)
    f = torch.randn((2, 128, 64), device=card)
    with pytest.raises(TypeError):
        FK.flash_attention_kernel(f.half(), f.half(), f.half())
    with pytest.raises(ValueError, match="contiguous"):
        FK.flash_attention_kernel(f.transpose(1, 2).contiguous()
                                  .transpose(1, 2), f, f)
    with pytest.raises(ValueError, match="inputs on"):
        FK.flash_attention_kernel(f, f.cpu(), f)
    assert not any(kernels.launches().values())


def test_kernel_wrappers_refuse_autograd(card):
    """A kernel has no backward: on the card each wrapper given an input
    that requires grad under grad mode raises before it launches (its
    output would leave the autograd graph), and launches under
    ``torch.no_grad()`` or on inputs that do not require grad."""
    from repro_torch import kernels
    from repro_torch.kernels import (flash_attention, grouped_matmul,
                                     masa_gemm, paged_attention, ssd_scan)
    from repro_torch.kernels.moe_gemm.ops import capacity_block_eids

    g = torch.Generator(device=card).manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g, device=card)

    dt, a_log, b, c, d = r(1, 32, 2).abs(), r(2), r(1, 32, 8), r(1, 32, 8), r(2)
    w, eids = r(4, 64, 128), capacity_block_eids(4, 64, 64, device=card)
    q, kp, vp, table, lens = paged_case(tc.PAGED_SHAPES[0], "float32", card)
    kf, vf, bw = r(1, 128, 2, 64), r(1, 128, 2, 64), r(128, 128)
    cases = {
        "ssd_scan": (lambda x: ssd_scan(x, dt, a_log, b, c, d, chunk=16),
                     r(1, 32, 2, 16)),
        "masa_gemm": (lambda x: masa_gemm(x, bw), r(128, 128)),
        "moe_gemm": (lambda x: grouped_matmul(x, w, eids, bt=64, bf=128),
                     r(256, 64)),
        "paged_attention": (lambda x: paged_attention(x, kp, vp, table,
                                                      lens), q),
        "flash_attention": (lambda x: flash_attention(x, kf, vf),
                            r(1, 128, 2, 64)),
    }
    for name, (fn, x) in cases.items():
        kernels.reset_launches()
        with pytest.raises(RuntimeError, match="no backward"):
            fn(x.detach().requires_grad_(True))
        assert not any(kernels.launches().values()), name
        with torch.no_grad():
            fn(x.detach().requires_grad_(True))
        fn(x.detach())
        torch.cuda.synchronize()
        assert sum(kernels.launches().values()) == 2, (name,
                                                       kernels.launches())


@pytest.mark.parametrize("arch", ["mamba2-780m", "moonshot-v1-16b-a3b"])
def test_train_route_launches_no_kernel_on_the_card(card, arch):
    """``Model.loss`` with a backward on the card: every parameter gets a
    gradient and no kernel launches; the serving forward of the same
    model, whose parameters now require grad, still launches its
    kernels."""
    from repro_torch import interop, kernels
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced()
    model = build_model(cfg, interop.params_from_reference(
        cfg, interop.numpy_reference_params(cfg, 0)), dtype=torch.float32,
        device=card)
    model.requires_grad_(True)
    batch = make_batch(cfg, 2, 32, dtype=torch.float32, device=card)
    kernels.reset_launches()
    loss, _ = model.loss(batch)
    loss.backward()
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert all(p.grad is not None for p in model.parameters())
    assert not any(kernels.launches().values())
    model.forward(batch)
    assert sum(kernels.launches().values()) > 0
