"""The DRAM controller and timing step, frozen, as a plain per-request loop.

A scalar copy of the simulator's semantics (bank / subarray timing under
BASELINE, SALP-1, SALP-2, MASA and IDEAL; the analytic core's visibility
rule; the request schedulers; the refresh ladder; the closed-row policy),
written for this benchmark and independent of the code under test. One
call simulates one single-core trace (:func:`run_lane`) or one mix of cores
sharing a channel (:func:`run_mix`) and returns the counters the program
reports. All arithmetic is on Python ints; every value the program holds in
int32 stays far inside its range at these lengths, and :func:`_i32` wraps
the two running sums the way the program's int32 would.
"""
from __future__ import annotations

import dataclasses

NEG = -1
RING = 64

BASELINE, SALP1, SALP2, MASA, IDEAL = range(5)
POLICIES = {"BASELINE": BASELINE, "SALP1": SALP1, "SALP2": SALP2,
            "MASA": MASA, "IDEAL": IDEAL}
FCFS, FRFCFS, FRFCFS_SALP, TCM, PALP_RP = range(5)
SCHEDULERS = {"FCFS": FCFS, "FRFCFS": FRFCFS, "FRFCFS_SALP": FRFCFS_SALP,
              "TCM": TCM, "PALP_RP": PALP_RP}
#: refresh modes: 0 off, 1 all-bank, 2 DSARP, 3 per-bank, 4 DARP, 5 SARP
REFRESH = {"none": 0, "all_bank": 1, "dsarp": 2, "per_bank": 3, "darp": 4,
           "sarp": 5}
BIG = 1 << 28
DEAD = 2_000_000_000

COUNTERS = ("total_cycles", "n_requests", "n_act", "n_pre", "n_rd", "n_wr",
            "n_sasel", "n_hit", "sum_latency", "n_reads", "sa_open_cycles")


@dataclasses.dataclass(frozen=True)
class Timing:
    """DRAM timing in command-clock cycles."""
    t_cl: int
    t_cwl: int
    t_rcd: int
    t_rp: int
    t_ras: int
    t_wr: int
    t_rtp: int
    t_bl: int
    t_ccd: int
    t_wtr: int
    t_rtw: int
    t_rrd: int
    t_rrd_sa: int
    t_faw: int
    t_sa: int
    t_refi: int
    t_rfc: int
    t_rfc_pb: int
    ref_postpone_max: int


def _i32(x: int) -> int:
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


class Channel:
    """One channel's bank / subarray timing state and its counters."""

    def __init__(self, policy: int, nb: int, ns: int, t: Timing,
                 refresh: int, closed_row: bool):
        self.policy, self.nb, self.ns, self.t = policy, nb, ns, t
        self.refresh, self.closed_row = refresh, closed_row
        self.open_row = [[NEG] * ns for _ in range(nb)]
        self.act_done = [[0] * ns for _ in range(nb)]
        self.ras_done = [[0] * ns for _ in range(nb)]
        self.wrr_done = [[0] * ns for _ in range(nb)]
        self.pre_done = [[0] * ns for _ in range(nb)]
        self.designated = [NEG] * nb
        self.open_sa = [NEG] * nb
        self.last_act = [0] * nb
        self.act_hist = [0, 0, 0, 0]
        self.col_last, self.col_last_wr, self.wr_data_end = -(10 ** 6), 0, 0
        self.bus_free = self.last_open_time = self.open_count = 0
        self.c = dict.fromkeys(("act", "pre", "rd", "wr", "sasel", "hit",
                                "lat", "reads", "open_cyc", "max_comp"), 0)
        # refresh table: next due, busy until, busy target, debt, last end
        step = max(t.t_refi // max(nb, 1), 1)
        self.ref = [[b * step + t.t_refi, 0, 0, 0, 0] for b in range(nb)]

    # ---- refresh ---------------------------------------------------------
    def gate(self, vis: int, b: int, s: int, wr: bool):
        """Refresh gating of a head's visibility; returns ``(vis, d)`` with
        the directive ``d`` (None when refresh is off). Reads only."""
        mode, t = self.refresh, self.t
        if not mode:
            return vis, None
        due, busy_end, busy_tgt, debt, last_end = self.ref[b]
        masa = self.policy == MASA
        if mode in (1, 2, 3, 5):
            sub = mode == 5 or (mode == 2 and masa)
            if vis < busy_end and (not sub or s == busy_tgt):
                vis = busy_end
            pending = vis >= due
            end = due + (t.t_rfc if mode in (1, 2) else t.t_rfc_pb)
            target = (due // t.t_refi) % self.ns
            if pending and (not sub or s == target):
                vis = max(vis, end)
            return vis, (pending, end, target, due)
        # DARP
        if vis < busy_end:
            vis = busy_end
        crossings = (vis - due) // t.t_refi + 1 if vis >= due else 0
        owed = debt + crossings
        new_due = due + crossings * t.t_refi
        launch = max(last_end, busy_end) + t.t_rfc_pb
        avail = max(vis - launch, 0)
        n_idle = min(owed, (avail + t.t_rfc_pb - 1) // t.t_rfc_pb)
        drain_end = launch + n_idle * t.t_rfc_pb
        if n_idle > 0:
            vis = max(vis, drain_end)
        owed -= n_idle
        n_forced = max(owed - t.ref_postpone_max, 0)
        vis += n_forced * t.t_rfc_pb
        owed -= n_forced
        chain_end = vis if n_forced > 0 else drain_end
        shadow = wr and owed >= 2
        act = n_idle > 0 or n_forced > 0
        return vis, (act or shadow, chain_end, 0, new_due, owed - shadow,
                     act, shadow)

    def commit_ref(self, d, b: int, vis: int, comp: int) -> None:
        row = self.ref[b]
        if self.refresh == 4:
            _, end, _, new_due, debt, act, shadow = d
            shadow_end = comp + self.t.t_rfc_pb if shadow else 0
            busy = max(row[1], max(end if act else 0, shadow_end))
            self.ref[b] = [new_due, busy, 0, debt, max(row[4], comp)]
        elif d[0]:
            _, end, target, due = d
            self.ref[b] = [max(due + self.t.t_refi, vis), end, target,
                           row[3], row[4]]

    # ---- the timing step -------------------------------------------------
    def serve(self, b: int, s: int, w: int, wr: bool, vis: int, d) -> int:
        """Issue one request's commands; returns its completion cycle."""
        t, pol = self.t, self.policy
        masa = pol == MASA
        o_row, a_done = self.open_row[b], self.act_done[b]
        r_done, w_done, p_done = self.ras_done[b], self.wrr_done[b], \
            self.pre_done[b]
        designated, os_ = self.designated[b], self.open_sa[b]
        so = os_ if os_ != NEG else 0
        orow = o_row[s]
        own_ras, own_wrr = r_done[s], w_done[s]
        hit = orow == w
        act = not hit
        pre_own = orow != NEG and act
        pre_oth = (not masa) and os_ != NEG and os_ != s and act

        t_pre_oth = max(vis, r_done[so], w_done[so])
        t_pre_own = max(vis, own_ras, own_wrr)
        h = self.act_hist
        t_act = max(vis, p_done[s], self.last_act[b] + t.t_rrd_sa,
                    h[3] + t.t_rrd, h[0] + t.t_faw)
        if pre_own:
            t_act = max(t_act, t_pre_own + t.t_rp)
        if pre_oth and pol in (BASELINE, IDEAL):
            t_act = max(t_act, t_pre_oth + t.t_rp)
        elif pre_oth and pol == SALP1:
            t_act = max(t_act, t_pre_oth + 1)
        t_col = max(vis, a_done[s]) if hit else t_act + t.t_rcd
        if pol == SALP2 and pre_oth:
            t_col = max(t_col, t_pre_oth + 1)
        sasel = masa and hit and designated != s
        if sasel:
            t_col += t.t_sa
        t_col = max(t_col, self.col_last + t.t_ccd)
        if not wr and self.col_last_wr:
            t_col = max(t_col, self.wr_data_end + t.t_wtr)
        if wr and not self.col_last_wr:
            t_col = max(t_col, self.col_last + t.t_rtw)
        lat = t.t_cwl if wr else t.t_cl
        t_col = max(t_col, self.bus_free - lat)
        data_end = t_col + lat + t.t_bl
        comp = t_col if wr else data_end

        c = self.c
        c["open_cyc"] += (max(self.open_count - 1, 0)
                          * max(t_col - self.last_open_time, 0))
        self.last_open_time = max(t_col, self.last_open_time)
        if pre_oth:
            o_row[so] = NEG
            p_done[so] = t_pre_oth + t.t_rp
        if pre_own:
            o_row[s] = NEG
            p_done[s] = t_pre_own + t.t_rp
        self.open_count += act - pre_oth - pre_own
        if act:
            o_row[s] = w
            a_done[s] = t_act + t.t_rcd
            r_done[s] = t_act + t.t_ras
            w_done[s] = 0
            self.last_act[b] = t_act
            self.act_hist = h[1:] + [t_act]
        if wr:
            w_done[s] = max(w_done[s], data_end + t.t_wr)
        else:
            r_done[s] = max(r_done[s], t_col + t.t_rtp)
        self.open_sa[b] = os_ if masa else s
        self.designated[b] = s
        if self.refresh and d[0]:
            if self.refresh in (2, 5):
                o_row[d[2]] = NEG
            else:
                o_row[:] = [NEG] * self.ns
        if self.closed_row:
            ras_ready = t_act + t.t_ras if act else own_ras
            rtp_ready = 0 if wr else t_col + t.t_rtp
            wr_ready = data_end + t.t_wr if wr else (0 if act else own_wrr)
            auto = max(data_end, ras_ready, rtp_ready, wr_ready)
            o_row[s] = NEG
            p_done[s] = max(p_done[s], auto + t.t_rp)
            if pol in (BASELINE, IDEAL):
                p_done[:] = [max(x, auto + t.t_rp) for x in p_done]
            elif pol == SALP1:
                p_done[:] = [max(x, auto + 1) for x in p_done]
                p_done[s] = max(p_done[s], auto + t.t_rp)
            self.open_sa[b] = NEG
            self.open_count -= act
        self.col_last, self.col_last_wr = t_col, int(wr)
        if wr:
            self.wr_data_end = data_end
        self.bus_free = data_end
        c["act"] += act
        c["pre"] += pre_oth + pre_own
        c["rd"] += not wr
        c["wr"] += wr
        c["sasel"] += sasel
        c["hit"] += hit
        c["lat"] += 0 if wr else comp - vis
        c["reads"] += not wr
        c["max_comp"] = max(c["max_comp"], comp)
        return comp

    def counters(self, n_requests: int, vis_last: int) -> dict[str, int]:
        c = self.c
        vals = (max(c["max_comp"], vis_last), n_requests, c["act"],
                c["pre"], c["rd"], c["wr"], c["sasel"], c["hit"], c["lat"],
                c["reads"], c["open_cyc"])
        return {k: _i32(int(v)) for k, v in zip(COUNTERS, vals)}


def geometry(policy: int, n_banks: int, n_subarrays: int):
    """IDEAL runs as BASELINE with every subarray a bank of its own."""
    if policy == IDEAL:
        return BASELINE, n_banks * n_subarrays, 1
    return policy, n_banks, n_subarrays


def _ideal(policy, ns, bank, sa):
    if policy != IDEAL:
        return bank, sa
    return [b * ns + s for b, s in zip(bank, sa)], [0] * len(bank)


def _visible(i: int, gap: int, dep: bool, vis_prev: int, ring: list,
             mlp: int) -> int:
    """When request ``i`` becomes visible: compute gap, dependence on the
    previous request, and the ROB window on request ``i - mlp``."""
    rob = ring[(i - mlp) % RING] if i >= mlp else 0
    return max(vis_prev + gap, ring[(i - 1) % RING] if dep else 0, rob)


def run_lane(trace, policy: int, n_banks: int, n_subarrays: int, t: Timing,
             refresh: int = 0, closed_row: bool = False) -> dict[str, int]:
    """One single-core trace under one policy: its counters."""
    eff, nb, ns = geometry(policy, n_banks, n_subarrays)
    bank, sa = _ideal(policy, n_subarrays, trace.bank, trace.subarray)
    ch = Channel(eff, nb, ns, t, refresh, closed_row)
    ring, vis_prev, mlp = [0] * RING, 0, trace.mlp_window
    row, is_write, gap, dep = trace.row, trace.is_write, trace.gap, trace.dep
    for i in range(len(bank)):
        b, s, wr = bank[i], sa[i], is_write[i]
        vis = _visible(i, gap[i], dep[i], vis_prev, ring, mlp)
        vis, d = ch.gate(vis, b, s, wr)
        comp = ch.serve(b, s, row[i], wr, vis, d)
        if refresh:
            ch.commit_ref(d, b, vis, comp)
        ring[i % RING] = comp
        vis_prev = vis
    return ch.counters(len(bank), vis_prev)


def _key(scheduler: int, ch: Channel, b, s, w, wr, vis, rank, n_cores,
         urgent_debt) -> int:
    """The scheduler's key of one live head; the lowest key is served."""
    orow = ch.open_row[b][s]
    pending = vis <= ch.bus_free
    hit = pending and orow == w
    if scheduler == FCFS:
        key = vis
    elif scheduler in (FRFCFS, TCM):
        key = vis + (0 if hit else BIG)
        if scheduler == TCM and pending and rank < n_cores // 2:
            key -= 2 * BIG
    elif scheduler == FRFCFS_SALP:
        key = vis + (0 if hit else BIG if pending and orow != NEG
                     else 2 * BIG)
    else:  # PALP_RP
        ready = pending and not wr and ch.wrr_done[b][s] <= ch.bus_free
        key = vis + (0 if hit else BIG if ready else 2 * BIG)
    if urgent_debt and pending:
        key -= 4 * BIG
    return key


def run_mix(traces, ranks, policy: int, scheduler: int, n_banks: int,
            n_subarrays: int, t: Timing, refresh: int = 0,
            closed_row: bool = False):
    """One mix of cores sharing a channel: returns ``(counters of the
    channel, per-core completion cycles)``."""
    eff, nb, ns = geometry(policy, n_banks, n_subarrays)
    C, N = len(traces), len(traces[0].bank)
    cores = []
    for tr in traces:
        bank, sa = _ideal(policy, n_subarrays, tr.bank, tr.subarray)
        cores.append((bank, sa, tr.row, tr.is_write, tr.gap, tr.dep,
                      tr.mlp_window))
    ch = Channel(eff, nb, ns, t, refresh, closed_row)
    ptr, vis_prev, max_comp = [0] * C, [0] * C, [0] * C
    rings = [[0] * RING for _ in range(C)]
    urgent_at = t.ref_postpone_max - 1
    for _ in range(C * N):
        best = None
        for c in range(C):
            if ptr[c] >= N:
                continue
            p = ptr[c]
            bank, sa, row, is_write, gap, dep, mlp = cores[c]
            b, s, wr = bank[p], sa[p], is_write[p]
            vis = _visible(p, gap[p], dep[p], vis_prev[c], rings[c], mlp)
            vis, d = ch.gate(vis, b, s, wr)
            urgent = refresh == 4 and ch.ref[b][3] >= urgent_at
            key = _key(scheduler, ch, b, s, row[p], wr, vis, ranks[c], C,
                       urgent)
            if best is None or key < best[0]:
                best = (key, c, vis, d)
        _, c, vis, d = best
        p = ptr[c]
        bank, sa, row, is_write = cores[c][:4]
        comp = ch.serve(bank[p], sa[p], row[p], is_write[p], vis, d)
        if refresh:
            ch.commit_ref(d, bank[p], vis, comp)
        ptr[c] = p + 1
        vis_prev[c] = vis
        max_comp[c] = max(max_comp[c], comp)
        rings[c][p % RING] = comp
    return ch.counters(C * N, max(vis_prev)), max_comp
