"""Memory-controller layer (layer 2 of 3), single-core path, in PyTorch.

The port of the C == 1 path of ``repro.core.dram.controller``. One step
serves one request of every lane (trace) at once:

* **visibility** — when the lane's next request becomes visible to the
  controller: compute-gap pacing, dependent-load serialization, and the
  ROB/MSHR-bounded request window (request ``i`` waits for request
  ``i - mlp_window``'s completion, read back from a ``_RING``-deep
  completion ring; ``validate_mlp_window`` guards ``mlp_window < _RING``);
* **refresh bookkeeping** — per-bank staggered tREFI deadlines under the
  refresh-policy ladder (:mod:`repro_torch.core.dram.refresh`): a due bank
  delays the requests its burst blocks, DARP schedules the bursts
  themselves, and every mode directs the timing layer to close the
  refreshed row(s).

With one core every scheduler serves program order, so there is no
``request_key`` here; it comes with the multicore path.

:func:`_build_step1` looped over the trace in Python (:func:`run_lanes`) is
the plain version of the CUDA lane kernel
(:mod:`repro_torch.core.dram.cuda_step`). The reference's lane-vectorized
scan (``_simulate_stacked_lanes``) is an XLA-specific reformulation of the
same step with bit-identical results; the lane-batched step here covers it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dram import engine as _engine
from repro_torch.core.dram import state_layout as L
from repro_torch.core.dram.policies import Policy
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


def _refresh_fns(policy: int, t: DramTiming, n_subarrays: int,
                 refresh_mode: int):
    """Build ``(head_visibility, update_ref)`` for one static refresh mode.

    Both act on ``[B]`` lanes: ``ref`` is the ``[B, nb, REF_F]`` table,
    ``hb/hs/vis/comp`` are ``[B]`` int32 and ``hwr`` ``[B]`` bool. The
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
        lanes = torch.arange(ref.shape[0], dtype=torch.long, device=ref.device)
        refb = ref[lanes, hb.long()]                      # [B, REF_F]
        busy_end = refb[:, L.REF_BUSY_UNTIL]
        if refresh_mode in (1, 2):
            # a burst already started by an earlier step still blocks the bank
            busy_blocks = vis < busy_end
            if refresh_mode == 2 and is_masa:
                busy_blocks = busy_blocks & (hs == refb[:, L.REF_BUSY_TARGET])
            vis = torch.where(busy_blocks, busy_end, vis)
            due = refb[:, L.REF_NEXT_DUE]
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
                busy_blocks = busy_blocks & (hs == refb[:, L.REF_BUSY_TARGET])
            vis = torch.where(busy_blocks, busy_end, vis)
            due = refb[:, L.REF_NEXT_DUE]
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
        due, debt = refb[:, L.REF_NEXT_DUE], refb[:, L.REF_DEBT]
        crossings = torch.where(vis >= due, (vis - due) // t.t_refi + 1, 0)
        owed = debt + crossings
        new_due = due + crossings * t.t_refi
        gap_start = torch.maximum(refb[:, L.REF_LAST_END], busy_end)
        launch = gap_start + t.t_rfc_pb                   # patience window
        avail = torch.clamp_min(vis - launch, 0)          # idle observed past it
        n_idle = torch.minimum(owed, (avail + t.t_rfc_pb - 1) // t.t_rfc_pb)
        drain_end = launch + n_idle * t.t_rfc_pb
        vis = torch.where(n_idle > 0, torch.maximum(vis, drain_end), vis)
        owed = owed - n_idle
        n_forced = torch.clamp_min(owed - pmax, 0)
        vis = vis + n_forced * t.t_rfc_pb
        owed = owed - n_forced
        chain_end = torch.where(n_forced > 0, vis, drain_end)
        shadow = hwr & (owed >= 2)
        act = (n_idle > 0) | (n_forced > 0)
        return vis, dict(pending=act | shadow, due=new_due,
                         debt=owed - shadow.to(I32), act=act, end=chain_end,
                         shadow=shadow)

    def update_ref(ref, directive, hb, vis, comp):
        """Commit each lane's served bank row of the refresh table, in
        place."""
        lanes = torch.arange(ref.shape[0], dtype=torch.long, device=ref.device)
        hb = hb.long()
        old = ref[lanes, hb]                              # [B, REF_F]
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
        ref[lanes, hb] = row_new

    return head_visibility, update_ref


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
                 closed_row: bool, mlp, refresh_fns):
    """Build the lane-batched single-core step ``step(state, i, x)``.

    ``i`` is the request index (a Python int, the same for every lane),
    ``x`` the ``[B, RQ_F]`` request rows, ``mlp`` the ``[B]`` windows. With
    one core the serve order is program order, so the step is the
    reference's ``_build_step1`` with the lane dimension written out.
    Updates ``state`` in place.
    """
    head_visibility, update_ref = refresh_fns
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
        comp = _engine._timing_step(policy, t, refresh_mode, state, req,
                                    closed_row=closed_row)
        if refresh_mode:
            update_ref(state["ref"], directive, hb, vis, comp)
        ring[:, i % _RING] = comp
        state["vis_prev"] = vis
        state["max_comp"] = torch.maximum(state["max_comp"], comp)

    return step1


def run_lanes(policy: int, n_banks: int, n_subarrays: int, t: DramTiming,
              refresh_mode: int, xs, mlp, closed_row: bool = False):
    """The plain lane loop: ``N`` lane-batched steps over ``xs``.

    ``xs`` is the ``[B, N, RQ_F]`` int32 request tensor and ``mlp`` the
    ``[B]`` int32 windows, on any device. Returns ``(scalars [B, SC_F],
    vis_prev [B], max_comp [B])``, the lane kernel's outputs.
    """
    if xs.dtype != I32 or mlp.dtype != I32:
        raise TypeError(f"xs and mlp must be int32, got {xs.dtype}, "
                        f"{mlp.dtype}")
    B, N = xs.shape[0], xs.shape[1]
    fns = _refresh_fns(policy, t, n_subarrays, refresh_mode)
    step1 = _build_step1(policy, t, refresh_mode, closed_row, mlp, fns)
    state = _state1_init(B, n_banks, n_subarrays, t, refresh_mode, xs.device)
    rows = xs.transpose(0, 1).contiguous()               # [N, B, RQ_F]
    for i in range(N):
        step1(state, i, rows[i])
    return state["scalars"], state["vis_prev"], state["max_comp"]

