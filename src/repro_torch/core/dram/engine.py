"""Bank/subarray DRAM timing state machine in PyTorch (layer 1 of 3).

The port of ``repro.core.dram.engine``. Given one already-scheduled request
per lane and the cycle at which the controller exposes it (``vis``),
:func:`_step_math` computes the issue time of every DRAM command the request
needs (PRE / ACT / SA_SEL / RD / WR) under the active policy's timing rules,
updates the per-bank / per-subarray timing state, and returns the request's
completion time. Everything about *which* request is served next lives one
layer up in :mod:`repro_torch.core.dram.controller`.

The reference writes the step for one trace and ``vmap``s it; here the lane
(trace) dimension ``B`` is written out as the leading dimension of every
tensor. All state is int32: every tensor is built with ``dtype=torch.int32``
and Python ints never promote it (torch treats them as weak scalars).

State layout (:mod:`repro_torch.core.dram.state_layout`): the per-subarray
timing plane and the per-bank vector state ride in ONE packed
``[B, nb, ns + 1, SA_F]`` tensor; a step gathers each lane's target bank
block ``[B, ns + 1, SA_F]``, computes on ``[B]`` / ``[B, ns + 1]`` tensors and
scatters the block back.

Policy timing semantics (``t_*`` are issue cycles; see timing.py):

  same-subarray conflict (all policies):   PRE(s) -> tRP -> ACT(s) -> tRCD -> COL
  cross-subarray conflict, open s', target s:
    BASELINE:  ACT(s) >= PRE(s') + tRP                (bank-level serialization)
    SALP-1:    ACT(s) >= PRE(s') + 1                  (tRP overlapped)
    SALP-2:    ACT(s) independent of PRE(s');
               COL(s) >= PRE(s') + 1                  (write recovery overlapped)
    MASA:      s' stays open; no PRE at all; COL needs SA_SEL if the bank's
               designated subarray != s. A row still open in ANY subarray is a
               row-buffer hit (SA_SEL + COL, no ACT).

Execution: the entry points run on the card unless the caller asks for the
CPU (``device=None`` means ``"cuda"``). On a CUDA device they launch the
hand-written lane kernel (:mod:`repro_torch.core.dram.cuda_step`); on
``device="cpu"`` they run its plain PyTorch version; with no card and no
explicit CPU they raise.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core.dram import registry
from repro_torch.core.dram import state_layout as L
from repro_torch.core.dram.policies import Policy
from repro_torch.core.dram.refresh import RefreshPolicy
from repro_torch.core.dram.schedulers import Scheduler
from repro_torch.core.dram.timing import DramTiming, DDR3_1066, MEMTECHS
from repro_torch.core.dram.trace import Trace, stack_traces

_NEG = int(L.NEG)
_RING = 64  # completion ring size; controller.validate_mlp_window enforces
            # mlp_window < _RING at every simulate* entry
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """The simulator configuration: every field, default and check of
    ``repro.core.dram.engine.SimConfig`` except ``backend``.

    The reference's ``backend`` named its executors (the XLA scan, the
    Pallas kernel on a TPU, and the Pallas kernel in interpret mode). The
    port has one executor per device instead: the ``device`` argument of
    :func:`simulate` / :func:`simulate_stacked` / :func:`simulate_batch`
    takes the field's place (CUDA runs the lane kernel, the CPU its plain
    PyTorch version). See the reference for each field's meaning.
    """
    n_banks: int = 8
    n_subarrays: int = 8
    timing: DramTiming = DDR3_1066
    # Deprecated refresh pair, canonicalized into refresh_policy and nulled
    # by __post_init__ exactly as in the reference.
    refresh: bool | None = None
    dsarp: bool | None = None
    row_policy: str = "open"
    scheduler: Scheduler = Scheduler.FCFS
    mapping: str = "golden"
    refresh_policy: str = "none"
    # Command-stream export is not ported: the entry points refuse it.
    emit_commands: bool = False
    memtech: str = "ddr3"

    def __post_init__(self) -> None:
        tech = registry.resolve("memtech", str(self.memtech).lower(),
                                valid=tuple(MEMTECHS))
        object.__setattr__(self, "memtech", tech)
        if tech != "ddr3" and self.timing == DDR3_1066:
            object.__setattr__(self, "timing", MEMTECHS[tech])
        rp = RefreshPolicy.from_spec(self.refresh_policy)
        if rp == RefreshPolicy.NONE:
            if self.refresh:
                rp = RefreshPolicy.DSARP if self.dsarp else RefreshPolicy.ALL_BANK
            elif self.dsarp:
                raise ValueError("dsarp=True requires refresh=True (or use "
                                 "refresh_policy='dsarp')")
        else:
            expect = (True, rp == RefreshPolicy.DSARP)
            if ((self.refresh is not None and self.refresh != expect[0])
                    or (self.dsarp is not None and self.dsarp != expect[1])):
                raise ValueError(
                    f"refresh_policy={rp.spec!r} conflicts with the "
                    f"deprecated pair refresh={self.refresh}, "
                    f"dsarp={self.dsarp}; the booleans are derived from "
                    f"refresh_policy — drop them, and use "
                    f"refresh_policy='none'/'dsarp' instead of toggling "
                    f"refresh/dsarp on an existing config")
        object.__setattr__(self, "refresh_policy", rp.spec)
        object.__setattr__(self, "refresh", None)
        object.__setattr__(self, "dsarp", None)
        if self.memtech == "pcm_palp" and rp != RefreshPolicy.NONE:
            raise ValueError(
                f"memtech='pcm_palp' forces refresh_policy='none' (PCM "
                f"cells need no refresh), but got "
                f"refresh_policy={rp.spec!r}; drop the refresh_policy (or "
                f"sweep it only over the DRAM memtechs)")

    @classmethod
    def for_tech(cls, memtech: str, *, density_gb: int | None = None,
                 t_refi: int | None = None, **overrides) -> "SimConfig":
        """Canonical per-technology constructor (see the reference)."""
        if "timing" in overrides:
            raise ValueError(
                "SimConfig.for_tech builds the timing pack itself; pass "
                "SimConfig(memtech=..., timing=...) to pin explicit timing")
        timing = DramTiming.preset(memtech, density_gb=density_gb,
                                   t_refi=t_refi)
        return cls(memtech=str(memtech).lower(), timing=timing, **overrides)

    def geometry_for(self, policy: Policy) -> tuple[int, int]:
        """IDEAL turns every subarray into a real bank."""
        if policy == Policy.IDEAL:
            return self.n_banks * self.n_subarrays, 1
        return self.n_banks, self.n_subarrays

    @property
    def refresh_mode(self) -> int:
        """Static engine/controller mode: the ``RefreshPolicy`` enum value
        (0 off, 1 REFab, 2 DSARP, 3 REFpb, 4 DARP, 5 SARP)."""
        return int(RefreshPolicy.from_spec(self.refresh_policy))


@dataclasses.dataclass
class SimResult:
    """Aggregate counters, each an int32 tensor ([B] from the batched entry
    points, 0-d from :func:`simulate`)."""
    total_cycles: torch.Tensor
    n_requests: torch.Tensor
    n_act: torch.Tensor
    n_pre: torch.Tensor
    n_rd: torch.Tensor
    n_wr: torch.Tensor
    n_sasel: torch.Tensor
    n_hit: torch.Tensor
    sum_latency: torch.Tensor
    n_reads: torch.Tensor
    sa_open_cycles: torch.Tensor


def _bank_state0(B: int, nb: int, ns: int, device) -> dict:
    """Initial packed state of ``B`` lanes: the ``[B, nb, ns + 1, SA_F]``
    plane (open_row = NEG, timing fields 0; row ``ns`` is the bank-vector
    row with designated = open_sa = NEG), the ``[B, 4]`` ACT history and
    the ``[B, SC_F]`` scalar pack (last column issue at -10**6)."""
    sa = torch.zeros((B, nb, ns + 1, L.SA_F), dtype=I32, device=device)
    sa[..., L.SA_OPEN_ROW] = _NEG                 # also BK_DESIGNATED = NEG
    sa[:, :, ns, L.BK_OPEN_SA] = _NEG
    scalars = torch.zeros((B, L.SC_F), dtype=I32, device=device)
    scalars[:, L.SC_COL_LAST] = -(10 ** 6)
    return dict(sa=sa, act_hist=torch.zeros((B, 4), dtype=I32, device=device),
                scalars=scalars)


def _step_math(policy: int, t: DramTiming, refresh_mode: int,
               bk, act_hist, sc, req: dict, closed_row: bool = False):
    """One request per lane against its gathered bank block.

    ``bk`` is ``[B, ns + 1, SA_F]`` (bank-vector row at index ``ns``),
    ``act_hist`` ``[B, 4]``, ``sc`` ``[B, SC_F]``; every ``req`` field is a
    ``[B]`` tensor (``is_write`` and ``ref_pending`` bool). Returns
    ``(new_bk, new_act_hist, new_sc, comp)``: the reference's int32 op
    sequence with the lane dimension written out.
    """
    s, w = req["subarray"], req["row"]
    is_wr, vis = req["is_write"], req["vis"]
    B, ns_p1 = bk.shape[0], bk.shape[1]
    ns = ns_p1 - 1
    is_masa = policy == Policy.MASA
    lanes = torch.arange(B, dtype=torch.long, device=bk.device)

    bv = bk[:, ns]                                        # bank-vector row
    designated = bv[:, L.BK_DESIGNATED]
    os_ = bv[:, L.BK_OPEN_SA]
    last_act_bank = bv[:, L.BK_LAST_ACT]

    # ``so`` is made gather-safe independently of ``pre_other_needed``: every
    # consumer of the other row is gated on it, but the index must be valid.
    so = torch.where(os_ != _NEG, os_, 0)
    own = bk[lanes, s.long()]                             # [B, SA_F]
    oth = bk[lanes, so.long()]
    orow = own[:, L.SA_OPEN_ROW]

    hit = orow == w
    act_needed = ~hit
    pre_own_needed = (orow != _NEG) & act_needed
    if is_masa:
        pre_other_needed = torch.zeros_like(hit)
    else:
        pre_other_needed = (os_ != _NEG) & (os_ != s) & act_needed

    # ---- PRECHARGE timings (ready = after tRAS and write recovery)
    t_pre_other = torch.maximum(vis, torch.maximum(oth[:, L.SA_RAS_DONE],
                                                   oth[:, L.SA_WRR_DONE]))
    t_pre_own = torch.maximum(vis, torch.maximum(own[:, L.SA_RAS_DONE],
                                                 own[:, L.SA_WRR_DONE]))

    # ---- ACTIVATE timing
    t_act = torch.maximum(vis, own[:, L.SA_PRE_DONE])
    t_act = torch.maximum(t_act, last_act_bank + t.t_rrd_sa)
    t_act = torch.maximum(t_act, act_hist[:, 3] + t.t_rrd)
    t_act = torch.maximum(t_act, act_hist[:, 0] + t.t_faw)
    t_act = torch.where(pre_own_needed,
                        torch.maximum(t_act, t_pre_own + t.t_rp), t_act)
    if policy == Policy.BASELINE or policy == Policy.IDEAL:
        t_act = torch.where(pre_other_needed,
                            torch.maximum(t_act, t_pre_other + t.t_rp), t_act)
    elif policy == Policy.SALP1:
        t_act = torch.where(pre_other_needed,
                            torch.maximum(t_act, t_pre_other + 1), t_act)

    # ---- column command
    t_col = torch.where(hit, torch.maximum(vis, own[:, L.SA_ACT_DONE]),
                        t_act + t.t_rcd)
    if policy == Policy.SALP2:
        t_col = torch.where(pre_other_needed,
                            torch.maximum(t_col, t_pre_other + 1), t_col)
    if is_masa:
        sasel_needed = hit & (designated != s)
    else:
        sasel_needed = torch.zeros_like(hit)
    t_col = torch.where(sasel_needed, t_col + t.t_sa, t_col)
    col_last = sc[:, L.SC_COL_LAST]
    col_last_wr = sc[:, L.SC_COL_LAST_WR] != 0
    t_col = torch.maximum(t_col, col_last + t.t_ccd)
    t_col = torch.where(~is_wr & col_last_wr,
                        torch.maximum(t_col, sc[:, L.SC_WR_DATA_END] + t.t_wtr),
                        t_col)
    t_col = torch.where(is_wr & ~col_last_wr,
                        torch.maximum(t_col, col_last + t.t_rtw), t_col)
    lat = torch.where(is_wr, t.t_cwl, t.t_cl).to(I32)
    t_col = torch.maximum(t_col, sc[:, L.SC_DATA_BUS_FREE] - lat)
    data_start = t_col + lat
    data_end = data_start + t.t_bl
    comp = torch.where(is_wr, t_col, data_end)

    # ---- state updates: [B, ns + 1] columns + masks -------------------------
    # Unmasked broadcasts (bank-granular refresh, closed-row pre_done ladder)
    # may touch the bank-vector row; that row is rebuilt wholesale below.
    sidx = torch.arange(ns_p1, dtype=I32, device=bk.device)[None, :]
    own_m = sidx == s[:, None]
    oth_m = (sidx == so[:, None]) & pre_other_needed[:, None]
    own_pre_m = own_m & pre_own_needed[:, None]
    act_m = own_m & act_needed[:, None]

    now = t_col
    extra = torch.clamp_min(sc[:, L.SC_OPEN_COUNT] - 1, 0)
    sa_open_cyc = sc[:, L.SC_SA_OPEN_CYC] + extra * torch.clamp_min(
        now - sc[:, L.SC_LAST_OPEN_TIME], 0)
    last_open_time = torch.maximum(now, sc[:, L.SC_LAST_OPEN_TIME])

    open_row = bk[:, :, L.SA_OPEN_ROW]
    act_done = bk[:, :, L.SA_ACT_DONE]
    ras_done = bk[:, :, L.SA_RAS_DONE]
    wrr_done = bk[:, :, L.SA_WRR_DONE]
    pre_done = bk[:, :, L.SA_PRE_DONE]

    # PRE other subarray (non-MASA path) + PRE own subarray
    open_row = torch.where(oth_m | own_pre_m, _NEG, open_row)
    pre_done = torch.where(oth_m, (t_pre_other + t.t_rp)[:, None], pre_done)
    pre_done = torch.where(own_pre_m, (t_pre_own + t.t_rp)[:, None], pre_done)

    i32 = lambda x: x.to(I32)  # noqa: E731
    delta_open = i32(act_needed) - i32(pre_other_needed) - i32(pre_own_needed)
    open_count = sc[:, L.SC_OPEN_COUNT] + delta_open

    # ACT
    open_row = torch.where(act_m, w[:, None], open_row)
    act_done = torch.where(act_m, (t_act + t.t_rcd)[:, None], act_done)
    ras_done = torch.where(act_m, (t_act + t.t_ras)[:, None], ras_done)
    wrr_done = torch.where(act_m, 0, wrr_done)
    last_act_new = torch.where(act_needed, t_act, last_act_bank)
    act_hist = torch.where(act_needed[:, None],
                           torch.cat([act_hist[:, 1:], t_act[:, None]], 1),
                           act_hist)

    # write recovery bookkeeping (after the column command)
    wrr_done = torch.where(own_m & is_wr[:, None],
                           torch.maximum(wrr_done, (data_end + t.t_wr)[:, None]),
                           wrr_done)
    # read-to-precharge: fold tRTP into ras_done (both gate PRE)
    ras_done = torch.where(own_m & ~is_wr[:, None],
                           torch.maximum(ras_done, (t_col + t.t_rtp)[:, None]),
                           ras_done)

    open_sa_new = os_ if is_masa else s
    designated_new = s

    if refresh_mode:
        # refresh closes every row of the bank (REFab / REFpb / DARP) or only
        # the refreshed subarray (DSARP / SARP), as the controller directs
        ref_pending = req["ref_pending"][:, None]
        if RefreshPolicy(refresh_mode).subarray_granular:
            open_row = torch.where(
                ref_pending & (sidx == req["ref_target"][:, None]), _NEG,
                open_row)
        else:
            open_row = torch.where(ref_pending, _NEG, open_row)

    if closed_row:
        # auto-precharge after every access, under the same gates as an
        # explicit PRE (tRAS, tRTP, tWR); the policy ladder applies to the
        # bank's global structures exactly as for an explicit PRE
        zero = torch.zeros_like(t_col)
        ras_ready = torch.where(act_needed, t_act + t.t_ras,
                                own[:, L.SA_RAS_DONE])
        rtp_ready = torch.where(is_wr, zero, t_col + t.t_rtp)
        wr_ready = torch.where(is_wr, data_end + t.t_wr,
                               torch.where(act_needed, zero,
                                           own[:, L.SA_WRR_DONE]))
        auto_pre = torch.maximum(torch.maximum(data_end, ras_ready),
                                 torch.maximum(rtp_ready, wr_ready))
        open_row = torch.where(own_m, _NEG, open_row)
        pre_done = torch.where(
            own_m, torch.maximum(pre_done, (auto_pre + t.t_rp)[:, None]),
            pre_done)
        if policy in (Policy.BASELINE, Policy.IDEAL):
            pre_done = torch.maximum(pre_done, (auto_pre + t.t_rp)[:, None])
        elif policy == Policy.SALP1:
            pre_done = torch.maximum(pre_done, (auto_pre + 1)[:, None])
            pre_done = torch.where(
                own_m, torch.maximum(pre_done, (auto_pre + t.t_rp)[:, None]),
                pre_done)
        open_sa_new = torch.full_like(s, _NEG)
        open_count = open_count - i32(act_needed)

    # ---- rebuild the block + scalar pack ------------------------------------
    new_bk = torch.stack([open_row, act_done, ras_done, wrr_done, pre_done],
                         dim=2)                           # [B, ns + 1, SA_F]
    zero_b = torch.zeros_like(s)
    new_bk[:, ns] = torch.stack([designated_new, open_sa_new, last_act_new,
                                 zero_b, zero_b], dim=1)
    not_wr = ~is_wr
    new_sc = torch.stack([
        t_col,                                                  # SC_COL_LAST
        i32(is_wr),                                             # SC_COL_LAST_WR
        torch.where(is_wr, data_end, sc[:, L.SC_WR_DATA_END]),  # SC_WR_DATA_END
        data_end,                                               # SC_DATA_BUS_FREE
        last_open_time,                                         # SC_LAST_OPEN_TIME
        open_count,                                             # SC_OPEN_COUNT
        sc[:, L.SC_C_ACT] + i32(act_needed),
        sc[:, L.SC_C_PRE] + i32(pre_other_needed) + i32(pre_own_needed),
        sc[:, L.SC_C_RD] + i32(not_wr),
        sc[:, L.SC_C_WR] + i32(is_wr),
        sc[:, L.SC_C_SASEL] + i32(sasel_needed),
        sc[:, L.SC_C_HIT] + i32(hit),
        sc[:, L.SC_SUM_LAT] + torch.where(is_wr, 0, comp - vis),
        sc[:, L.SC_C_READS] + i32(not_wr),
        sa_open_cyc,                                            # SC_SA_OPEN_CYC
        torch.maximum(sc[:, L.SC_MAX_COMP], comp),              # SC_MAX_COMP
    ], dim=1)
    return new_bk, act_hist, new_sc, comp


def _timing_step(policy: int, t: DramTiming, refresh_mode: int,
                 state: dict, req: dict, closed_row: bool = False):
    """Serve one request per lane: gather each lane's target bank block,
    run :func:`_step_math`, scatter the block back.

    Updates ``state`` in place (the plain loop owns its state, so no copy is
    kept) and returns the ``[B]`` completion cycles.
    """
    sa = state["sa"]
    lanes = torch.arange(sa.shape[0], dtype=torch.long, device=sa.device)
    b = req["bank"].long()
    bk = sa[lanes, b]                                     # [B, ns + 1, SA_F]
    new_bk, act_hist, new_sc, comp = _step_math(
        policy, t, refresh_mode, bk, state["act_hist"], state["scalars"], req,
        closed_row=closed_row)
    sa[lanes, b] = new_bk
    state["act_hist"], state["scalars"] = act_hist, new_sc
    return comp


def _controller_args(policy: Policy, config: SimConfig):
    """Resolve (effective policy, scheduler, geometry) for the controller."""
    nb, ns = config.geometry_for(policy)
    eff = Policy.BASELINE if policy == Policy.IDEAL else policy
    return int(eff), int(Scheduler(config.scheduler)), nb, ns


def result_from_state(n_requests: int, scalars, vis_prev) -> SimResult:
    """Unpack ``[B, SC_F]`` scalar packs and ``[B]`` last visibility cycles
    into the public SimResult counters."""
    return SimResult(
        total_cycles=torch.maximum(scalars[:, L.SC_MAX_COMP], vis_prev),
        n_requests=torch.full_like(vis_prev, n_requests),
        n_act=scalars[:, L.SC_C_ACT], n_pre=scalars[:, L.SC_C_PRE],
        n_rd=scalars[:, L.SC_C_RD], n_wr=scalars[:, L.SC_C_WR],
        n_sasel=scalars[:, L.SC_C_SASEL], n_hit=scalars[:, L.SC_C_HIT],
        sum_latency=scalars[:, L.SC_SUM_LAT], n_reads=scalars[:, L.SC_C_READS],
        sa_open_cycles=scalars[:, L.SC_SA_OPEN_CYC],
    )


_EMIT_ERROR = (
    "SimConfig.emit_commands is consumed by the command-export entry "
    "points — use repro.core.dram.commands.simulate_commands "
    "(simulate() would silently drop the log)")


def lane_inputs(stacked: dict, policy: Policy, config: SimConfig, device):
    """Everything the lane executor takes, on ``device``.

    Returns ``(eff_policy, nb, ns, xs, mlp)``: ``xs`` is the packed
    ``[B, N, RQ_F]`` int32 request tensor (bank, subarray, row, is_write,
    gap, dep), with IDEAL's every-subarray-is-a-bank rewrite applied, and
    ``mlp`` the ``[B]`` int32 window. Validates the window (host side) and
    the bank / subarray ranges, which the kernel indexes with unchecked.
    """
    from repro_torch.core.dram import controller

    controller.validate_mlp_window(stacked["mlp_window"])
    eff, _, nb, ns = _controller_args(policy, config)
    xs = _pack(stacked, policy, config, nb, ns, device)
    return eff, nb, ns, xs, _dev_i32(stacked["mlp_window"], device).reshape(-1)


def _dev_i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                           device=device).to(I32)


def mix_inputs(stacked_mixes: dict, ranks, policy: Policy, config: SimConfig,
               device):
    """Everything the mix executor takes, on ``device``: the multicore
    counterpart of :func:`lane_inputs`.

    ``stacked_mixes`` holds ``bank/subarray/row/is_write/gap/dep`` of shape
    ``[M, C, N]`` and ``mlp_window`` of shape ``[M, C]`` (numpy arrays or
    tensors), ``ranks`` the ``[M, C]`` TCM ranks. Returns ``(eff_policy,
    scheduler, nb, ns, reqs, mlp, rank)``: ``reqs`` is the packed
    ``[M, C, N, RQ_F]`` int32 request tensor with IDEAL's
    every-subarray-is-a-bank rewrite applied, ``mlp`` and ``rank`` the
    ``[M, C]`` int32 windows and ranks. Validates the windows (host side)
    and the bank / subarray ranges, which the kernel indexes unchecked.
    """
    from repro_torch.core.dram import controller

    controller.validate_mlp_window(stacked_mixes["mlp_window"])
    eff, sched, nb, ns = _controller_args(policy, config)
    reqs = _pack(stacked_mixes, policy, config, nb, ns, device)
    mlp = _dev_i32(stacked_mixes["mlp_window"], device)
    rank = _dev_i32(ranks, device)
    if reqs.dim() != 4 or mlp.shape != reqs.shape[:2] or rank.shape != mlp.shape:
        raise ValueError(f"mix inputs are [M, C, N] requests with [M, C] "
                         f"windows and ranks; got {tuple(reqs.shape[:-1])}, "
                         f"{tuple(mlp.shape)}, {tuple(rank.shape)}")
    return eff, sched, nb, ns, reqs, mlp.contiguous(), rank.contiguous()


def _pack(stacked: dict, policy: Policy, config: SimConfig, nb: int, ns: int,
          device) -> torch.Tensor:
    """The ``[..., N, RQ_F]`` int32 request tensor of ``[..., N]`` fields,
    with IDEAL's rewrite applied and the bank / subarray ranges checked."""
    bank = _dev_i32(stacked["bank"], device)
    subarray = _dev_i32(stacked["subarray"], device)
    if policy == Policy.IDEAL:
        bank = bank * config.n_subarrays + subarray
        subarray = torch.zeros_like(subarray)
    reqs = torch.stack([bank, subarray, _dev_i32(stacked["row"], device),
                        _dev_i32(stacked["is_write"], device),
                        _dev_i32(stacked["gap"], device),
                        _dev_i32(stacked["dep"], device)], dim=-1).contiguous()
    bad = ((bank < 0) | (bank >= nb) | (subarray < 0) | (subarray >= ns)).any()
    if bool(bad):
        raise ValueError(f"bank/subarray indices outside the {nb} x {ns} "
                         f"geometry of policy {Policy(policy).name}")
    return reqs


def simulate_stacked(stacked: dict, policy: Policy,
                     config: SimConfig = SimConfig(),
                     device=None) -> SimResult:
    """Batched entry point over pre-stacked ``[B, N]`` traces.

    ``stacked`` is the dict :func:`~repro_torch.core.dram.trace.stack_traces`
    produces (numpy arrays or tensors): ``bank/subarray/row/is_write/gap/dep``
    of shape ``[B, N]`` and ``mlp_window`` of shape ``[B]``. Each row is one
    single-core controller instance; all rows go through one launch of the
    lane kernel (CUDA) or one lane-batched plain loop (CPU).
    """
    from repro_torch.core.dram import cuda_step

    cuda_step.check_no_emit(config)
    dev = resolve_device(device)
    eff, nb, ns, xs, mlp = lane_inputs(stacked, policy, config, dev)
    res, _ = cuda_step.simulate_lanes(
        eff, nb, ns, config.timing, config.refresh_mode, xs, mlp,
        closed_row=config.row_policy == "closed")
    return res


def simulate(trace: Trace, policy: Policy, config: SimConfig = SimConfig(),
             device=None) -> SimResult:
    """Simulate one trace under one policy (a 1-core controller instance);
    the counters come back as 0-d int32 tensors."""
    if config.emit_commands:
        raise ValueError(_EMIT_ERROR)
    res = simulate_stacked(stack_traces([trace]), policy, config, device)
    return SimResult(**{f.name: getattr(res, f.name)[0]
                        for f in dataclasses.fields(SimResult)})


def simulate_batch(traces: list[Trace], policy: Policy,
                   config: SimConfig = SimConfig(), device=None) -> SimResult:
    """Simulate a list of equal-length traces as lanes of one batch."""
    return simulate_stacked(stack_traces(traces), policy, config, device)
