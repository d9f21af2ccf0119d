"""Memory-controller layer (layer 2 of 3), in PyTorch.

The port of ``repro.core.dram.controller``. One step serves one request of
every lane at once; a lane is one trace (single-core path) or one mix of C
cores sharing a channel (multicore path):

* **visibility** — when a core's next request becomes visible to the
  controller: compute-gap pacing, dependent-load serialization, and the
  ROB/MSHR-bounded request window (request ``i`` waits for request
  ``i - mlp_window``'s completion, read back from a ``_RING``-deep
  completion ring per core; ``validate_mlp_window`` guards
  ``mlp_window < _RING``);
* **request scheduling** (multicore) — every step the scheduler
  (:func:`repro_torch.core.dram.schedulers.request_key`) keys each core's
  live head request and the controller serves the ``argmin``;
* **refresh bookkeeping** — per-bank staggered tREFI deadlines under the
  refresh-policy ladder (:mod:`repro_torch.core.dram.refresh`): a due bank
  delays the requests its burst blocks, DARP schedules the bursts
  themselves, and every mode directs the timing layer to close the
  refreshed row(s).

:func:`_build_step1` looped over the trace in Python (:func:`run_lanes`) is
the plain version of the CUDA lane kernel, and :func:`_build_stepC` looped
C * N times (:func:`run_cores`) the plain version of the CUDA mix kernel
(:mod:`repro_torch.core.dram.cuda_step`). The reference's lane-vectorized
scan (``_simulate_stacked_lanes``) is an XLA-specific reformulation of the
single-core step with bit-identical results; the lane-batched step here
covers it. The reference runs a 1-core mix through its single-core step;
here every mix takes the C-core step, which is bit-identical with C == 1.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dram import engine as _engine
from repro_torch.core.dram import state_layout as L
from repro_torch.core.dram.policies import Policy
from repro_torch.core.dram.schedulers import request_key
from repro_torch.core.dram.timing import DramTiming

_RING = _engine._RING
_NEG = _engine._NEG
I32 = _engine.I32


def validate_mlp_window(mlp_window) -> None:
    """Enforce the completion-ring invariant ``1 <= mlp_window < _RING``.

    The ROB-limit rule reads the ring ``mlp_window`` entries back; a window
    as large as the ring would read the slot the current request is about to
    overwrite. Checked host side at every ``simulate*`` entry.
    """
    if torch.is_tensor(mlp_window):
        mlp_window = mlp_window.cpu().numpy()
    mw = np.asarray(mlp_window)
    if (mw >= _RING).any() or (mw < 1).any():
        raise ValueError(
            f"mlp_window must be in [1, {_RING - 1}] (completion ring holds "
            f"{_RING} entries and request i waits on request i - mlp_window); "
            f"got {np.unique(mw).tolist()}. Reduce CoreModel.mshr or enlarge "
            f"engine._RING.")


def _refresh_due0(nb: int, t_refi: int, device=None) -> torch.Tensor:
    # stagger per-bank refresh deadlines (real controllers do) to avoid bursts
    return (torch.arange(nb, dtype=I32, device=device)
            * max(t_refi // max(nb, 1), 1) + t_refi)


def _refresh_table0(B: int, n_banks: int, t: DramTiming, refresh_mode: int,
                    device=None):
    """Initial ``[B, nb, REF_F]`` refresh tables (None when refresh is off):
    the staggered tREFI deadline, the in-flight burst (end cycle, refreshed
    subarray), DARP's debt and the bank's last demand end."""
    if not refresh_mode:
        return None
    ref = torch.zeros((B, n_banks, L.REF_F), dtype=I32, device=device)
    ref[:, :, L.REF_NEXT_DUE] = _refresh_due0(n_banks, t.t_refi, device)
    return ref


def _lanes(table, hb) -> torch.Tensor:
    """Lane indices that pair with ``hb`` ([B] or [B, C]) to index
    ``table[lane, bank]``."""
    lanes = torch.arange(table.shape[0], dtype=torch.long, device=table.device)
    return lanes if hb.dim() == 1 else lanes[:, None]


def _bank_rows(table, hb) -> torch.Tensor:
    """``table[lane, hb]``: each head's bank row of a ``[B, nb, F]`` table."""
    return table[_lanes(table, hb), hb.long()]


def _refresh_fns(policy: int, t: DramTiming, n_subarrays: int,
                 refresh_mode: int, emit_commands: bool = False):
    """Build ``(head_visibility, update_ref, ref_cmds)`` for one static
    refresh mode.

    ``ref`` is the ``[B, nb, REF_F]`` table of ``B`` lanes.
    ``head_visibility`` takes ``[B]`` heads (one per lane) or ``[B, C]``
    heads (one per core of each mix) and is a pure read of the table;
    ``update_ref`` commits one served head per lane (``[B]``). ``hb/hs/vis/
    comp`` are int32 and ``hwr`` bool. ``ref_cmds`` gives the served heads'
    ``[B, R, CMD_F]`` refresh records (``emit_commands`` only: DARP's
    directive then also carries its chains' geometry). The
    reference's floor divisions only ever see non-negative operands on the
    branch that is kept (deadlines are non-negative and ``avail`` is clamped
    at 0), which the CUDA kernel relies on.
    """
    is_masa = policy == Policy.MASA

    def head_visibility(ref, vis, hb, hs, hwr):
        """Refresh gating of the heads' visibility; returns the gated
        ``vis`` and the refresh directive (``None`` when refresh is off)."""
        if not refresh_mode:
            return vis, None
        refb = _bank_rows(ref, hb)                        # [B, (C,) REF_F]
        busy_end = refb[..., L.REF_BUSY_UNTIL]
        if refresh_mode in (1, 2):
            # a burst already started by an earlier step still blocks the bank
            busy_blocks = vis < busy_end
            if refresh_mode == 2 and is_masa:
                busy_blocks = busy_blocks & (hs == refb[..., L.REF_BUSY_TARGET])
            vis = torch.where(busy_blocks, busy_end, vis)
            due = refb[..., L.REF_NEXT_DUE]
            ref_pending = vis >= due
            ref_end = due + t.t_rfc
            ref_target = (due // t.t_refi) % n_subarrays
            blocks = ref_pending
            if refresh_mode == 2 and is_masa:
                blocks = blocks & (hs == ref_target)
            vis = torch.where(blocks, torch.maximum(vis, ref_end), vis)
            return vis, dict(pending=ref_pending, end=ref_end,
                             target=ref_target, due=due)

        if refresh_mode in (3, 5):
            # REFpb / SARP: deadline-fired tRFCpb bursts; SARP gates only
            # same-subarray requests
            sarp = refresh_mode == 5
            busy_blocks = vis < busy_end
            if sarp:
                busy_blocks = busy_blocks & (hs == refb[..., L.REF_BUSY_TARGET])
            vis = torch.where(busy_blocks, busy_end, vis)
            due = refb[..., L.REF_NEXT_DUE]
            ref_pending = vis >= due
            ref_end = due + t.t_rfc_pb
            ref_target = (due // t.t_refi) % n_subarrays
            blocks = ref_pending & (hs == ref_target) if sarp else ref_pending
            vis = torch.where(blocks, torch.maximum(vis, ref_end), vis)
            return vis, dict(pending=ref_pending, end=ref_end,
                             target=ref_target, due=due)

        # mode 4: DARP — matured deadlines become debt, drained in idle gaps
        # and write shadows; only debt overflowing the window forces bursts
        pmax = t.ref_postpone_max
        vis = torch.where(vis < busy_end, busy_end, vis)  # in-flight burst
        due, debt = refb[..., L.REF_NEXT_DUE], refb[..., L.REF_DEBT]
        crossings = torch.where(vis >= due, (vis - due) // t.t_refi + 1, 0)
        owed = debt + crossings
        new_due = due + crossings * t.t_refi
        gap_start = torch.maximum(refb[..., L.REF_LAST_END], busy_end)
        launch = gap_start + t.t_rfc_pb                   # patience window
        avail = torch.clamp_min(vis - launch, 0)          # idle observed past it
        n_idle = torch.minimum(owed, (avail + t.t_rfc_pb - 1) // t.t_rfc_pb)
        drain_end = launch + n_idle * t.t_rfc_pb
        vis = torch.where(n_idle > 0, torch.maximum(vis, drain_end), vis)
        owed = owed - n_idle
        n_forced = torch.clamp_min(owed - pmax, 0)
        forced_at = vis                                   # forced chain start
        vis = vis + n_forced * t.t_rfc_pb
        owed = owed - n_forced
        chain_end = torch.where(n_forced > 0, vis, drain_end)
        shadow = hwr & (owed >= 2)
        act = (n_idle > 0) | (n_forced > 0)
        d = dict(pending=act | shadow, due=new_due, debt=owed - shadow.to(I32),
                 act=act, end=chain_end, shadow=shadow)
        if emit_commands:
            # the chains' geometry for the command log (update_ref ignores
            # it); the shadow burst starts at the write's completion, known
            # only after the timing step (ref_cmds)
            d.update(n_idle=n_idle, launch=launch, n_forced=n_forced,
                     forced_at=forced_at)
        return vis, d

    def update_ref(ref, directive, hb, vis, comp):
        """Commit each lane's served bank row of the refresh table, in
        place."""
        old = _bank_rows(ref, hb)                         # [B, REF_F]
        if refresh_mode == 4:
            # DARP rows advance unconditionally
            shadow_end = torch.where(directive["shadow"], comp + t.t_rfc_pb, 0)
            busy = torch.maximum(
                old[:, L.REF_BUSY_UNTIL],
                torch.maximum(torch.where(directive["act"], directive["end"], 0),
                              shadow_end))
            row_new = torch.stack([
                directive["due"], busy, torch.zeros_like(busy),
                directive["debt"],
                torch.maximum(old[:, L.REF_LAST_END], comp)], dim=1)
        else:
            served = torch.stack([
                torch.maximum(directive["due"] + t.t_refi, vis),
                directive["end"], directive["target"],
                old[:, L.REF_DEBT], old[:, L.REF_LAST_END]], dim=1)
            row_new = torch.where(directive["pending"][:, None], served, old)
        ref[_lanes(ref, hb), hb.long()] = row_new

    def ref_cmds(directive, hb, comp):
        """``[B, R, CMD_F]`` OP_REF records of the served heads.

        Modes 1/2/3/5 fire at most one burst a step, at the deadline;
        subarray-granular modes carry the target subarray, bank-granular
        ones NEG. DARP fires up to three chains (idle drain, forced
        overflow, write shadow) whose lengths ride the aux lane; decode
        expands a chain of k into k bursts spaced tRFCpb.
        """
        neg = torch.full_like(hb, _NEG)
        one = torch.ones_like(hb)

        def rec(cond, cycle, sa_i, aux):
            return torch.stack([torch.where(cond, L.OP_REF, L.OP_NOP).to(I32),
                                cycle, hb, sa_i, neg, aux], dim=1)

        if refresh_mode != 4:
            target = directive["target"] if refresh_mode in (2, 5) else neg
            return rec(directive["pending"], directive["due"], target,
                       one)[:, None]
        return torch.stack([
            rec(directive["n_idle"] > 0, directive["launch"], neg,
                directive["n_idle"]),
            rec(directive["n_forced"] > 0, directive["forced_at"], neg,
                directive["n_forced"]),
            rec(directive["shadow"], comp, neg, one),
        ], dim=1)

    return head_visibility, update_ref, ref_cmds


def _state1_init(B: int, n_banks: int, n_subarrays: int, t: DramTiming,
                 refresh_mode: int, device=None) -> dict:
    """Initial state of ``B`` single-core lanes."""
    state0 = dict(_engine._bank_state0(B, n_banks, n_subarrays, device))
    state0["ring"] = torch.zeros((B, _RING), dtype=I32, device=device)
    state0["vis_prev"] = torch.zeros((B,), dtype=I32, device=device)
    state0["max_comp"] = torch.zeros((B,), dtype=I32, device=device)
    if refresh_mode:
        state0["ref"] = _refresh_table0(B, n_banks, t, refresh_mode, device)
    return state0


def _build_step1(policy: int, t: DramTiming, refresh_mode: int,
                 closed_row: bool, mlp, refresh_fns,
                 emit_commands: bool = False):
    """Build the lane-batched single-core step ``step(state, i, x)``.

    ``i`` is the request index (a Python int, the same for every lane),
    ``x`` the ``[B, RQ_F]`` request rows, ``mlp`` the ``[B]`` windows. With
    one core the serve order is program order, so the step is the
    reference's ``_build_step1`` with the lane dimension written out.
    Updates ``state`` in place; with ``emit_commands`` it returns the step's
    record ``dict(cmds=[B, slots, CMD_F], comp=[B], core=[B], req=[B])``.
    """
    head_visibility, update_ref, ref_cmds = refresh_fns
    mlp_l = mlp.long()

    def step1(state, i: int, x):
        hb, hs, hw = x[:, L.RQ_BANK], x[:, L.RQ_SA], x[:, L.RQ_ROW]
        hwr, hgap, hdep = x[:, L.RQ_WR] != 0, x[:, L.RQ_GAP], x[:, L.RQ_DEP] != 0
        ring = state["ring"]
        # ring slots by floor modulo: (i - 1) and (i - mlp) are negative early
        comp_prev = ring[:, (i - 1) % _RING]
        rob_raw = ring.gather(1, ((i - mlp_l) % _RING)[:, None])[:, 0]
        rob_lim = torch.where(i >= mlp, rob_raw, 0)
        vis = torch.maximum(state["vis_prev"] + hgap,
                            torch.maximum(torch.where(hdep, comp_prev, 0),
                                          rob_lim))
        vis, directive = head_visibility(state.get("ref"), vis, hb, hs, hwr)
        req = dict(bank=hb, subarray=hs, row=hw, is_write=hwr, vis=vis)
        if refresh_mode:
            req["ref_pending"] = directive["pending"]
            req["ref_target"] = directive.get("target", torch.zeros_like(hb))
        stepped = _engine._timing_step(policy, t, refresh_mode, state, req,
                                       closed_row=closed_row,
                                       emit=emit_commands)
        comp = stepped[0] if emit_commands else stepped
        if refresh_mode:
            update_ref(state["ref"], directive, hb, vis, comp)
        ring[:, i % _RING] = comp
        state["vis_prev"] = vis
        state["max_comp"] = torch.maximum(state["max_comp"], comp)
        if not emit_commands:
            return None
        cmds = stepped[1]
        if refresh_mode:
            cmds = torch.cat([cmds, ref_cmds(directive, hb, comp)], dim=1)
        return dict(cmds=cmds, comp=comp, core=torch.zeros_like(comp),
                    req=torch.full_like(comp, i))

    return step1


def run_lanes(policy: int, n_banks: int, n_subarrays: int, t: DramTiming,
              refresh_mode: int, xs, mlp, closed_row: bool = False,
              emit_commands: bool = False):
    """The plain lane loop: ``N`` lane-batched steps over ``xs``.

    ``xs`` is the ``[B, N, RQ_F]`` int32 request tensor and ``mlp`` the
    ``[B]`` int32 windows, on any device. Returns ``(scalars [B, SC_F],
    vis_prev [B], max_comp [B])``, the lane kernel's outputs;
    ``emit_commands`` appends the stacked command log (:func:`_stack_log`).
    """
    if xs.dtype != I32 or mlp.dtype != I32:
        raise TypeError(f"xs and mlp must be int32, got {xs.dtype}, "
                        f"{mlp.dtype}")
    B, N = xs.shape[0], xs.shape[1]
    fns = _refresh_fns(policy, t, n_subarrays, refresh_mode, emit_commands)
    step1 = _build_step1(policy, t, refresh_mode, closed_row, mlp, fns,
                         emit_commands)
    state = _state1_init(B, n_banks, n_subarrays, t, refresh_mode, xs.device)
    rows = xs.transpose(0, 1).contiguous()               # [N, B, RQ_F]
    log = [step1(state, i, rows[i]) for i in range(N)]
    out = state["scalars"], state["vis_prev"], state["max_comp"]
    return (*out, _stack_log(log)) if emit_commands else out


def _stack_log(log: list[dict]) -> dict:
    """The steps' records stacked lane-major: ``cmds [B, steps, slots,
    CMD_F]``, ``comp`` / ``core`` / ``req`` ``[B, steps]``, where ``core``
    and ``req`` name the served request of each step."""
    return {k: torch.stack([r[k] for r in log], dim=1) for k in log[0]}


def _stateC_init(M: int, n_banks: int, n_subarrays: int, t: DramTiming,
                 refresh_mode: int, C: int, device=None) -> dict:
    """Initial state of ``M`` mixes of ``C`` cores: the bank state, the
    ``[M, C, CORE_F]`` core rows (next request, last visibility, max
    completion), the ``[M, C, _RING]`` completion rings and, when
    refreshing, the ``[M, nb, REF_F]`` refresh tables."""
    state0 = dict(_engine._bank_state0(M, n_banks, n_subarrays, device))
    state0["core"] = torch.zeros((M, C, L.CORE_F), dtype=I32, device=device)
    state0["comp_ring"] = torch.zeros((M, C, _RING), dtype=I32, device=device)
    if refresh_mode:
        state0["ref"] = _refresh_table0(M, n_banks, t, refresh_mode, device)
    return state0


def _build_stepC(policy: int, scheduler: int, t: DramTiming,
                 refresh_mode: int, closed_row: bool, reqs, mlp, rank,
                 refresh_fns, emit_commands: bool = False):
    """Build the mix-batched C-core step ``step(state)``.

    ``reqs`` is the ``[M, C, N, RQ_F]`` request tensor, ``mlp`` and ``rank``
    the ``[M, C]`` windows and TCM ranks. Each step keys every core's head
    against the PRE-step state, serves the argmin core of every mix through
    the timing step, and commits that core's refresh row, core row and ring
    slot: the reference's ``_build_stepC`` with the mix dimension written
    out. Updates ``state`` in place; with ``emit_commands`` it returns the
    served heads' record ``dict(cmds, comp, core, req)`` (``[M, ...]``).
    """
    head_visibility, update_ref, ref_cmds = refresh_fns
    M, C, N = reqs.shape[0], reqs.shape[1], reqs.shape[2]
    mix = torch.arange(M, dtype=torch.long, device=reqs.device)
    mix_c = mix[:, None]
    cores = torch.arange(C, dtype=torch.long, device=reqs.device)[None, :]
    mlp_l = mlp.long()

    def step(state):
        core, ring = state["core"], state["comp_ring"]
        ptr = core[..., L.CORE_PTR]
        live = ptr < N
        p = torch.clamp_max(ptr, N - 1)       # a dead core's head stays in bounds
        p_l = p.long()
        h = reqs[mix_c, cores, p_l]                       # [M, C, RQ_F]
        hb, hs, hw = h[..., L.RQ_BANK], h[..., L.RQ_SA], h[..., L.RQ_ROW]
        hwr = h[..., L.RQ_WR] != 0

        # ---- per-core visibility of the head request; ring slots by floor
        # modulo ((p - 1) and (p - mlp) are negative early)
        comp_prev = ring.gather(2, ((p_l - 1) % _RING)[..., None])[..., 0]
        rob_raw = ring.gather(2, ((p_l - mlp_l) % _RING)[..., None])[..., 0]
        rob_lim = torch.where(p >= mlp, rob_raw, 0)
        vis = torch.maximum(core[..., L.CORE_VIS_PREV] + h[..., L.RQ_GAP],
                            torch.maximum(
                                torch.where(h[..., L.RQ_DEP] != 0, comp_prev, 0),
                                rob_lim))
        vis, directive = head_visibility(state.get("ref"), vis, hb, hs, hwr)

        # ---- scheduler: key the live heads, serve the argmin (torch.argmin
        # returns the first minimum, like jnp.argmin). Under DARP a bank one
        # postpone from a forced refresh drains its queued requests first.
        ref_debt = (_bank_rows(state["ref"], hb)[..., L.REF_DEBT]
                    if refresh_mode == 4 else None)
        key = request_key(scheduler, state, hb, hs, hw, vis, rank, C, live,
                          ref_debt=ref_debt,
                          ref_urgent=t.ref_postpone_max - 1, hwr=hwr)
        c = torch.argmin(key, dim=1)                      # [M]

        hc = h[mix, c]                                    # [M, RQ_F]
        vis_c, pc = vis[mix, c], p[mix, c]
        req = dict(bank=hc[:, L.RQ_BANK], subarray=hc[:, L.RQ_SA],
                   row=hc[:, L.RQ_ROW], is_write=hc[:, L.RQ_WR] != 0,
                   vis=vis_c)
        if refresh_mode:
            directive_c = {k: v[mix, c] for k, v in directive.items()}
            req["ref_pending"] = directive_c["pending"]
            req["ref_target"] = directive_c.get("target",
                                                torch.zeros_like(vis_c))
        stepped = _engine._timing_step(policy, t, refresh_mode, state, req,
                                       closed_row=closed_row,
                                       emit=emit_commands)
        comp = stepped[0] if emit_commands else stepped
        if refresh_mode:
            update_ref(state["ref"], directive_c, req["bank"], vis_c, comp)
        # the loop runs exactly C * N steps, so the chosen core is live and
        # its pointer was never clamped
        core[mix, c] = torch.stack(
            [pc + 1, vis_c,
             torch.maximum(core[mix, c, L.CORE_MAX_COMP], comp)], dim=1)
        ring[mix, c, (pc % _RING).long()] = comp
        if not emit_commands:
            return None
        # emission follows the served head only (the step serves one
        # request a mix; update_ref commits the same head's refresh row)
        cmds = stepped[1]
        if refresh_mode:
            cmds = torch.cat([cmds, ref_cmds(directive_c, req["bank"], comp)],
                             dim=1)
        return dict(cmds=cmds, comp=comp, core=c.to(I32), req=pc)

    return step


def run_cores(policy: int, scheduler: int, n_banks: int, n_subarrays: int,
              t: DramTiming, refresh_mode: int, reqs, mlp, rank,
              closed_row: bool = False, emit_commands: bool = False):
    """The plain mix loop: ``C * N`` mix-batched steps over ``reqs``.

    ``reqs`` is the ``[M, C, N, RQ_F]`` int32 request tensor, ``mlp`` and
    ``rank`` the ``[M, C]`` int32 windows and TCM ranks, on any device.
    Returns ``(scalars [M, SC_F], vis_prev [M, C], max_comp [M, C])``, the
    mix kernel's outputs; ``emit_commands`` appends the stacked command log
    (:func:`_stack_log`, mix-major).
    """
    if reqs.dtype != I32 or mlp.dtype != I32 or rank.dtype != I32:
        raise TypeError(f"reqs, mlp and rank must be int32, got {reqs.dtype}, "
                        f"{mlp.dtype}, {rank.dtype}")
    M, C, N = reqs.shape[0], reqs.shape[1], reqs.shape[2]
    fns = _refresh_fns(policy, t, n_subarrays, refresh_mode, emit_commands)
    step = _build_stepC(policy, scheduler, t, refresh_mode, closed_row, reqs,
                        mlp, rank, fns, emit_commands)
    state = _stateC_init(M, n_banks, n_subarrays, t, refresh_mode, C,
                         reqs.device)
    log = [step(state) for _ in range(C * N)]
    core = state["core"]
    out = (state["scalars"], core[..., L.CORE_VIS_PREV].contiguous(),
           core[..., L.CORE_MAX_COMP].contiguous())
    return (*out, _stack_log(log)) if emit_commands else out
