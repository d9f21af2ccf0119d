// The controller's per-request step, shared by the lane and the mix kernel.
//
// The device-side counterparts of the step builders both Pallas kernels of
// the JAX package call (repro/core/dram/controller.py _refresh_fns, and
// repro/core/dram/engine.py _step_math): refresh gating of a head's
// visibility, the bank/subarray timing step, and the refresh-table commit.
// lane_step.cu loops them over one trace, mix_step.cu over the scheduler's
// choice among C cores; neither kernel carries a copy of the timing math.
//
// State layout (repro_torch/core/dram/state_layout.py): a lane's or mix's
// packed [nb][ns + 1][SA_F] bank/subarray plane (row ns of each bank is the
// bank-vector row) and [nb][REF_F] refresh table live in its scratch slice;
// the channel scalars and the ACT history stay in registers (Channel).
//
// Semantics that must match the reference bit for bit:
//  * every / and % below has non-negative operands on the path that uses
//    its result (deadlines are >= 0, avail is clamped at 0), so C's
//    truncation equals the reference's floor division;
//  * all arithmetic is int32; cycle counts stay far below 2^31 for any
//    trace the simulator takes (N * the largest timing constant);
//  * the other-subarray index is made safe (NEG -> 0) before it is read;
//  * bank-granular refresh closes and the closed-row BASELINE / SALP-1
//    precharge bump touch every subarray row of the bank (O(ns) loops), and
//    the bank-vector row is then rebuilt wholesale.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -1;
constexpr int RING = 64;

// request fields (state_layout RQ_*), one [RQ_F] row per request
constexpr int RQ_BANK = 0, RQ_SA = 1, RQ_ROW = 2, RQ_WR = 3, RQ_GAP = 4,
              RQ_DEP = 5, RQ_F = 6;
// per-subarray plane fields (SA_*) and the bank-vector row's lanes (BK_*)
constexpr int SA_OPEN_ROW = 0, SA_ACT_DONE = 1, SA_RAS_DONE = 2,
              SA_WRR_DONE = 3, SA_PRE_DONE = 4, SA_F = 5;
constexpr int BK_DESIGNATED = 0, BK_OPEN_SA = 1, BK_LAST_ACT = 2;
// channel scalars + counters (SC_*)
constexpr int SC_COL_LAST = 0, SC_COL_LAST_WR = 1, SC_WR_DATA_END = 2,
              SC_DATA_BUS_FREE = 3, SC_LAST_OPEN_TIME = 4, SC_OPEN_COUNT = 5,
              SC_C_ACT = 6, SC_C_PRE = 7, SC_C_RD = 8, SC_C_WR = 9,
              SC_C_SASEL = 10, SC_C_HIT = 11, SC_SUM_LAT = 12,
              SC_C_READS = 13, SC_SA_OPEN_CYC = 14, SC_MAX_COMP = 15,
              SC_F = 16;
// refresh table fields (REF_*)
constexpr int REF_NEXT_DUE = 0, REF_BUSY_UNTIL = 1, REF_BUSY_TARGET = 2,
              REF_DEBT = 3, REF_LAST_END = 4, REF_F = 5;
// timing array: DramTiming's fields in declaration order
constexpr int T_CL = 0, T_CWL = 1, T_RCD = 2, T_RP = 3, T_RAS = 4, T_WR = 5,
              T_RTP = 6, T_BL = 7, T_CCD = 8, T_WTR = 9, T_RTW = 10,
              T_RRD = 11, T_RRD_SA = 12, T_FAW = 13, T_SA = 14, T_REFI = 15,
              T_RFC = 16, T_RFC_PB = 17, T_POSTPONE = 18, T_F = 19;
// policies (Policy); IDEAL arrives as BASELINE on the rewritten geometry
constexpr int BASELINE = 0, SALP1 = 1, SALP2 = 2, MASA = 3;

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// The channel's register-resident state: the SC_* scalar pack and the last
// four ACT issue cycles (ah0 oldest).
struct Channel {
  int sc[SC_F];
  int ah0, ah1, ah2, ah3;
};

// One head's refresh directive (controller._refresh_fns head_visibility).
struct Directive {
  bool pending, act, shadow;
  int target, due, end, debt;
};

// Initial state (engine._bank_state0, controller._refresh_table0): every
// row closed, the bank-vector rows' designated / open subarray NEG, the
// staggered tREFI deadlines, the last column issue at -10^6.
__device__ __forceinline__ void init_state(int* sa, int* ref, int nb, int ns,
                                           int refresh_mode, const int* t,
                                           Channel& ch) {
  const int ns_p1 = ns + 1;
  for (int b = 0; b < nb; ++b) {
    for (int r = 0; r < ns_p1; ++r) {
      int* row = sa + (b * ns_p1 + r) * SA_F;
      row[0] = NEG;                 // SA_OPEN_ROW, and BK_DESIGNATED at r == ns
      for (int f = 1; f < SA_F; ++f) row[f] = 0;
    }
    sa[(b * ns_p1 + ns) * SA_F + BK_OPEN_SA] = NEG;
  }
  if (refresh_mode) {
    const int stagger = imax(t[T_REFI] / imax(nb, 1), 1);
    for (int b = 0; b < nb; ++b) {
      int* rr = ref + b * REF_F;
      rr[REF_NEXT_DUE] = b * stagger + t[T_REFI];
      for (int f = 1; f < REF_F; ++f) rr[f] = 0;
    }
  }
#pragma unroll
  for (int k = 0; k < SC_F; ++k) ch.sc[k] = 0;
  ch.sc[SC_COL_LAST] = -1000000;
  ch.ah0 = ch.ah1 = ch.ah2 = ch.ah3 = 0;
}

// Refresh gating of one head's visibility (controller._refresh_fns
// head_visibility): returns the gated visibility and fills the directive.
// A pure function of the head bank's refresh row `rr`, `vis`, the head's
// subarray and its is-write bit; with refresh off it returns `vis` and an
// empty directive.
__device__ __forceinline__ int refresh_gate(const int* rr, int vis, int s,
                                            bool is_wr, int refresh_mode,
                                            bool is_masa, int ns,
                                            const int* t, Directive& d) {
  d.pending = d.act = d.shadow = false;
  d.target = d.due = d.end = d.debt = 0;
  if (refresh_mode == 1 || refresh_mode == 2) {
    const bool gate = refresh_mode == 1 || !is_masa;
    const int busy_end = rr[REF_BUSY_UNTIL];
    if (vis < busy_end && (gate || s == rr[REF_BUSY_TARGET])) vis = busy_end;
    d.due = rr[REF_NEXT_DUE];
    d.pending = vis >= d.due;
    d.end = d.due + t[T_RFC];
    d.target = (d.due / t[T_REFI]) % ns;
    if (d.pending && (gate || s == d.target)) vis = imax(vis, d.end);
  } else if (refresh_mode == 3 || refresh_mode == 5) {
    const bool sarp = refresh_mode == 5;
    const int busy_end = rr[REF_BUSY_UNTIL];
    if (vis < busy_end && (!sarp || s == rr[REF_BUSY_TARGET])) vis = busy_end;
    d.due = rr[REF_NEXT_DUE];
    d.pending = vis >= d.due;
    d.end = d.due + t[T_RFC_PB];
    d.target = (d.due / t[T_REFI]) % ns;
    if (d.pending && (!sarp || s == d.target)) vis = imax(vis, d.end);
  } else if (refresh_mode == 4) {
    const int pb = t[T_RFC_PB];
    const int busy_end = rr[REF_BUSY_UNTIL];
    if (vis < busy_end) vis = busy_end;
    const int due = rr[REF_NEXT_DUE];
    const int crossings = vis >= due ? (vis - due) / t[T_REFI] + 1 : 0;
    int owed = rr[REF_DEBT] + crossings;
    d.due = due + crossings * t[T_REFI];
    const int launch = imax(rr[REF_LAST_END], busy_end) + pb;
    const int avail = imax(vis - launch, 0);
    const int n_idle = imin(owed, (avail + pb - 1) / pb);
    const int drain_end = launch + n_idle * pb;
    if (n_idle > 0) vis = imax(vis, drain_end);
    owed -= n_idle;
    const int n_forced = imax(owed - t[T_POSTPONE], 0);
    vis += n_forced * pb;
    owed -= n_forced;
    d.end = n_forced > 0 ? vis : drain_end;
    d.shadow = is_wr && owed >= 2;
    d.act = n_idle > 0 || n_forced > 0;
    d.pending = d.act || d.shadow;
    d.debt = owed - (d.shadow ? 1 : 0);
  }
  return vis;
}

// The bank/subarray timing step (engine._step_math) of one request to bank
// hb, visible at `vis`; updates the plane and the channel, returns the
// request's completion cycle. `ref_pending` / `ref_target` are the served
// head's refresh directive (closes the refreshed row(s)).
__device__ __forceinline__ int timing_step(int* sa, Channel& ch, int hb, int s,
                                           int w, bool is_wr, int vis,
                                           bool ref_pending, int ref_target,
                                           int policy, int refresh_mode,
                                           bool closed_row, int ns,
                                           const int* t) {
  const bool is_masa = policy == MASA;
  const bool sa_granular = refresh_mode == 2 || refresh_mode == 5;
  int* sc = ch.sc;
  int* bk = sa + hb * (ns + 1) * SA_F;
  int* bv = bk + ns * SA_F;
  const int designated = bv[BK_DESIGNATED];
  const int os = bv[BK_OPEN_SA];
  const int last_act_bank = bv[BK_LAST_ACT];
  const int so = os != NEG ? os : 0;        // gather-safe other subarray
  int* own = bk + s * SA_F;
  int* oth = bk + so * SA_F;
  const int orow = own[SA_OPEN_ROW];
  const int own_act = own[SA_ACT_DONE], own_ras = own[SA_RAS_DONE];
  const int own_wrr = own[SA_WRR_DONE], own_pre = own[SA_PRE_DONE];

  const bool hit = orow == w;
  const bool act_needed = !hit;
  const bool pre_own = orow != NEG && act_needed;
  const bool pre_oth = !is_masa && os != NEG && os != s && act_needed;

  const int t_pre_other =
      imax(vis, imax(oth[SA_RAS_DONE], oth[SA_WRR_DONE]));
  const int t_pre_own = imax(vis, imax(own_ras, own_wrr));

  int t_act = imax(vis, own_pre);
  t_act = imax(t_act, last_act_bank + t[T_RRD_SA]);
  t_act = imax(t_act, ch.ah3 + t[T_RRD]);
  t_act = imax(t_act, ch.ah0 + t[T_FAW]);
  if (pre_own) t_act = imax(t_act, t_pre_own + t[T_RP]);
  if (pre_oth) {
    if (policy == BASELINE) t_act = imax(t_act, t_pre_other + t[T_RP]);
    else if (policy == SALP1) t_act = imax(t_act, t_pre_other + 1);
  }

  int t_col = hit ? imax(vis, own_act) : t_act + t[T_RCD];
  if (policy == SALP2 && pre_oth) t_col = imax(t_col, t_pre_other + 1);
  const bool sasel = is_masa && hit && designated != s;
  if (sasel) t_col += t[T_SA];
  const int col_last = sc[SC_COL_LAST];
  const bool col_last_wr = sc[SC_COL_LAST_WR] != 0;
  t_col = imax(t_col, col_last + t[T_CCD]);
  if (!is_wr && col_last_wr) t_col = imax(t_col, sc[SC_WR_DATA_END] + t[T_WTR]);
  if (is_wr && !col_last_wr) t_col = imax(t_col, col_last + t[T_RTW]);
  const int lat = is_wr ? t[T_CWL] : t[T_CL];
  t_col = imax(t_col, sc[SC_DATA_BUS_FREE] - lat);
  const int data_end = t_col + lat + t[T_BL];
  const int comp = is_wr ? t_col : data_end;

  // subarray-open-count integral (extra activated subarrays)
  const int extra = imax(sc[SC_OPEN_COUNT] - 1, 0);
  sc[SC_SA_OPEN_CYC] += extra * imax(t_col - sc[SC_LAST_OPEN_TIME], 0);
  sc[SC_LAST_OPEN_TIME] = imax(t_col, sc[SC_LAST_OPEN_TIME]);
  sc[SC_OPEN_COUNT] += (act_needed ? 1 : 0) - (pre_oth ? 1 : 0)
                       - (pre_own ? 1 : 0);

  // other subarray's PRE (non-MASA); pre_oth implies so != s
  if (pre_oth) {
    oth[SA_OPEN_ROW] = NEG;
    oth[SA_PRE_DONE] = t_pre_other + t[T_RP];
  }
  // own subarray: PRE, then ACT, then the column command's recovery
  own[SA_OPEN_ROW] = act_needed ? w : orow;
  own[SA_PRE_DONE] = pre_own ? t_pre_own + t[T_RP] : own_pre;
  own[SA_ACT_DONE] = act_needed ? t_act + t[T_RCD] : own_act;
  int ras = act_needed ? t_act + t[T_RAS] : own_ras;
  int wrr = act_needed ? 0 : own_wrr;
  if (is_wr) wrr = imax(wrr, data_end + t[T_WR]);
  else ras = imax(ras, t_col + t[T_RTP]);
  own[SA_RAS_DONE] = ras;
  own[SA_WRR_DONE] = wrr;
  const int last_act_new = act_needed ? t_act : last_act_bank;
  if (act_needed) {
    ch.ah0 = ch.ah1; ch.ah1 = ch.ah2; ch.ah2 = ch.ah3; ch.ah3 = t_act;
  }

  int open_sa_new = is_masa ? os : s;

  if (ref_pending) {
    // refresh needs a precharged target: close the refreshed subarray or
    // every row of the bank
    if (sa_granular) {
      bk[ref_target * SA_F + SA_OPEN_ROW] = NEG;
    } else {
      for (int r = 0; r < ns; ++r) bk[r * SA_F + SA_OPEN_ROW] = NEG;
    }
  }

  if (closed_row) {
    // auto-precharge after the access, gated like an explicit PRE
    const int ras_ready = act_needed ? t_act + t[T_RAS] : own_ras;
    const int rtp_ready = is_wr ? 0 : t_col + t[T_RTP];
    const int wr_ready = is_wr ? data_end + t[T_WR] : (act_needed ? 0 : own_wrr);
    const int auto_pre = imax(imax(data_end, ras_ready), imax(rtp_ready, wr_ready));
    own[SA_OPEN_ROW] = NEG;
    own[SA_PRE_DONE] = imax(own[SA_PRE_DONE], auto_pre + t[T_RP]);
    if (policy == BASELINE || policy == SALP1) {
      // the auto-PRE occupies the bank's global structures
      const int bump = policy == BASELINE ? auto_pre + t[T_RP] : auto_pre + 1;
      for (int r = 0; r < ns; ++r) {
        int* pd = bk + r * SA_F + SA_PRE_DONE;
        *pd = imax(*pd, bump);
      }
    }
    open_sa_new = NEG;
    sc[SC_OPEN_COUNT] -= act_needed ? 1 : 0;
  }

  // bank-vector row, rebuilt wholesale
  bv[BK_DESIGNATED] = s;
  bv[BK_OPEN_SA] = open_sa_new;
  bv[BK_LAST_ACT] = last_act_new;
  bv[3] = 0;
  bv[4] = 0;

  // channel scalars + counters
  sc[SC_COL_LAST] = t_col;
  sc[SC_COL_LAST_WR] = is_wr ? 1 : 0;
  if (is_wr) sc[SC_WR_DATA_END] = data_end;
  sc[SC_DATA_BUS_FREE] = data_end;
  sc[SC_C_ACT] += act_needed ? 1 : 0;
  sc[SC_C_PRE] += (pre_oth ? 1 : 0) + (pre_own ? 1 : 0);
  sc[SC_C_RD] += is_wr ? 0 : 1;
  sc[SC_C_WR] += is_wr ? 1 : 0;
  sc[SC_C_SASEL] += sasel ? 1 : 0;
  sc[SC_C_HIT] += hit ? 1 : 0;
  sc[SC_SUM_LAT] += is_wr ? 0 : comp - vis;
  sc[SC_C_READS] += is_wr ? 0 : 1;
  sc[SC_MAX_COMP] = imax(sc[SC_MAX_COMP], comp);
  return comp;
}

// Commit the served head's bank row of the refresh table (controller.
// _refresh_fns update_ref): DARP rows advance unconditionally, the other
// modes only when the directive fired.
__device__ __forceinline__ void commit_ref(int* rr, const Directive& d,
                                           int refresh_mode, int vis, int comp,
                                           const int* t) {
  if (refresh_mode == 4) {
    const int shadow_end = d.shadow ? comp + t[T_RFC_PB] : 0;
    rr[REF_BUSY_UNTIL] =
        imax(rr[REF_BUSY_UNTIL], imax(d.act ? d.end : 0, shadow_end));
    rr[REF_NEXT_DUE] = d.due;
    rr[REF_BUSY_TARGET] = 0;
    rr[REF_DEBT] = d.debt;
    rr[REF_LAST_END] = imax(rr[REF_LAST_END], comp);
  } else if (refresh_mode && d.pending) {
    rr[REF_NEXT_DUE] = imax(d.due + t[T_REFI], vis);
    rr[REF_BUSY_UNTIL] = d.end;
    rr[REF_BUSY_TARGET] = d.target;
  }
}

}  // namespace
