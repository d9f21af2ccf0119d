// Lane kernel: B independent single-core DRAM controller simulations.
//
// Replaces the Pallas lane kernel of the JAX package
// (repro/core/dram/pallas_step.py, _simulate_lanes_pallas with body
// _lane_kernel): per lane, an N-step loop of the single-core controller step
// (repro/core/dram/controller.py _build_step1) around the bank/subarray
// timing step (repro/core/dram/engine.py _step_math). The plain PyTorch
// version of the same function is controller.run_lanes in this package;
// cuda_step.py binds this file through ctypes.
//
// What bounds it: each lane is a serial dependence chain of N steps (every
// step reads the state the previous one wrote), so the kernel is bound by
// the latency of one step times N, not by bytes or operations. The bytes
// are B * N * 6 * 4 read once (the request stream) plus 72 bytes a lane
// written once. Design: one thread per lane, so B lanes run their chains
// concurrently; the lane's state that is indexed by data (the packed
// [nb][ns + 1][5] bank/subarray plane, the 64-entry completion ring and the
// [nb][5] refresh table) lives in a per-lane slice of a scratch buffer the
// wrapper allocates and this kernel initialises, because ns reaches the
// hundreds in sweeps; the channel scalars and the ACT history stay in
// registers. Blocks of 32 threads spread the lanes over the SMs.
//
// Semantics that must match the reference bit for bit:
//  * ring slots use & (RING - 1): (i - 1) and (i - mlp) are negative at
//    small i, where C's % truncates but the reference's % floors;
//  * every / and % below has non-negative operands on the path that uses
//    its result (deadlines are >= 0, avail is clamped at 0), so C's
//    truncation equals the reference's floor division;
//  * all arithmetic is int32; cycle counts stay far below 2^31 for any
//    trace the simulator takes (N * the largest timing constant);
//  * the other-subarray index is made safe (NEG -> 0) before it is read;
//  * bank-granular refresh closes and the closed-row BASELINE / SALP-1
//    precharge bump touch every subarray row of the bank (O(ns) loops), and
//    the bank-vector row is then rebuilt wholesale.
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

__global__ void lane_step_kernel(const int* __restrict__ xs,
                                 const int* __restrict__ mlp_in,
                                 const int* __restrict__ timing,
                                 int* __restrict__ scratch,
                                 int* __restrict__ sc_out,
                                 int* __restrict__ vis_out,
                                 int* __restrict__ max_out,
                                 int B, int N, int nb, int ns, int policy,
                                 int refresh_mode, int closed_row) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;

  int t[T_F];
#pragma unroll
  for (int k = 0; k < T_F; ++k) t[k] = timing[k];

  const int ns_p1 = ns + 1;
  const int plane = nb * ns_p1 * SA_F;
  const int per_lane = plane + RING + (refresh_mode ? nb * REF_F : 0);
  int* sa = scratch + (size_t)lane * per_lane;   // [nb][ns + 1][SA_F]
  int* ring = sa + plane;                        // [RING]
  int* ref = ring + RING;                        // [nb][REF_F]
  const int* x = xs + (size_t)lane * N * RQ_F;
  const int mlp = mlp_in[lane];
  const bool is_masa = policy == MASA;
  const bool sa_granular = refresh_mode == 2 || refresh_mode == 5;

  // ---- initial state (engine._bank_state0, controller._state1_init)
  for (int b = 0; b < nb; ++b) {
    for (int r = 0; r < ns_p1; ++r) {
      int* row = sa + (b * ns_p1 + r) * SA_F;
      row[0] = NEG;                 // SA_OPEN_ROW, and BK_DESIGNATED at r == ns
      for (int f = 1; f < SA_F; ++f) row[f] = 0;
    }
    sa[(b * ns_p1 + ns) * SA_F + BK_OPEN_SA] = NEG;
  }
  for (int k = 0; k < RING; ++k) ring[k] = 0;
  if (refresh_mode) {
    const int stagger = imax(t[T_REFI] / imax(nb, 1), 1);
    for (int b = 0; b < nb; ++b) {
      int* rr = ref + b * REF_F;
      rr[REF_NEXT_DUE] = b * stagger + t[T_REFI];
      for (int f = 1; f < REF_F; ++f) rr[f] = 0;
    }
  }
  int sc[SC_F];
#pragma unroll
  for (int k = 0; k < SC_F; ++k) sc[k] = 0;
  sc[SC_COL_LAST] = -1000000;
  int ah0 = 0, ah1 = 0, ah2 = 0, ah3 = 0;   // last 4 ACT issue cycles, ah0 oldest
  int vis_prev = 0, max_comp = 0;

  for (int i = 0; i < N; ++i) {
    const int* q = x + (size_t)i * RQ_F;
    const int hb = q[RQ_BANK], s = q[RQ_SA], w = q[RQ_ROW];
    const bool is_wr = q[RQ_WR] != 0;
    const bool hdep = q[RQ_DEP] != 0;

    // ---- visibility (controller._build_step1)
    const int comp_prev = ring[(i - 1) & (RING - 1)];
    const int rob_lim = i >= mlp ? ring[(i - mlp) & (RING - 1)] : 0;
    int vis = imax(vis_prev + q[RQ_GAP], imax(hdep ? comp_prev : 0, rob_lim));

    // ---- refresh gating (controller._refresh_fns head_visibility)
    int* rr = ref + hb * REF_F;
    bool ref_pending = false, d_act = false, d_shadow = false;
    int ref_target = 0, d_due = 0, d_end = 0, d_debt = 0;
    if (refresh_mode == 1 || refresh_mode == 2) {
      const bool gate = refresh_mode == 1 || !is_masa;
      const int busy_end = rr[REF_BUSY_UNTIL];
      if (vis < busy_end && (gate || s == rr[REF_BUSY_TARGET])) vis = busy_end;
      d_due = rr[REF_NEXT_DUE];
      ref_pending = vis >= d_due;
      d_end = d_due + t[T_RFC];
      ref_target = (d_due / t[T_REFI]) % ns;
      if (ref_pending && (gate || s == ref_target)) vis = imax(vis, d_end);
    } else if (refresh_mode == 3 || refresh_mode == 5) {
      const bool sarp = refresh_mode == 5;
      const int busy_end = rr[REF_BUSY_UNTIL];
      if (vis < busy_end && (!sarp || s == rr[REF_BUSY_TARGET])) vis = busy_end;
      d_due = rr[REF_NEXT_DUE];
      ref_pending = vis >= d_due;
      d_end = d_due + t[T_RFC_PB];
      ref_target = (d_due / t[T_REFI]) % ns;
      if (ref_pending && (!sarp || s == ref_target)) vis = imax(vis, d_end);
    } else if (refresh_mode == 4) {
      const int pb = t[T_RFC_PB];
      const int busy_end = rr[REF_BUSY_UNTIL];
      if (vis < busy_end) vis = busy_end;
      const int due = rr[REF_NEXT_DUE];
      const int crossings = vis >= due ? (vis - due) / t[T_REFI] + 1 : 0;
      int owed = rr[REF_DEBT] + crossings;
      d_due = due + crossings * t[T_REFI];
      const int launch = imax(rr[REF_LAST_END], busy_end) + pb;
      const int avail = imax(vis - launch, 0);
      const int n_idle = imin(owed, (avail + pb - 1) / pb);
      const int drain_end = launch + n_idle * pb;
      if (n_idle > 0) vis = imax(vis, drain_end);
      owed -= n_idle;
      const int n_forced = imax(owed - t[T_POSTPONE], 0);
      vis += n_forced * pb;
      owed -= n_forced;
      d_end = n_forced > 0 ? vis : drain_end;
      d_shadow = is_wr && owed >= 2;
      d_act = n_idle > 0 || n_forced > 0;
      ref_pending = d_act || d_shadow;
      d_debt = owed - (d_shadow ? 1 : 0);
    }

    // ---- timing step (engine._step_math) on bank hb
    int* bk = sa + hb * ns_p1 * SA_F;
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
    t_act = imax(t_act, ah3 + t[T_RRD]);
    t_act = imax(t_act, ah0 + t[T_FAW]);
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
    if (act_needed) { ah0 = ah1; ah1 = ah2; ah2 = ah3; ah3 = t_act; }

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

    // ---- refresh table commit (controller._refresh_fns update_ref)
    if (refresh_mode == 4) {
      const int shadow_end = d_shadow ? comp + t[T_RFC_PB] : 0;
      rr[REF_BUSY_UNTIL] =
          imax(rr[REF_BUSY_UNTIL], imax(d_act ? d_end : 0, shadow_end));
      rr[REF_NEXT_DUE] = d_due;
      rr[REF_BUSY_TARGET] = 0;
      rr[REF_DEBT] = d_debt;
      rr[REF_LAST_END] = imax(rr[REF_LAST_END], comp);
    } else if (refresh_mode && ref_pending) {
      rr[REF_NEXT_DUE] = imax(d_due + t[T_REFI], vis);
      rr[REF_BUSY_UNTIL] = d_end;
      rr[REF_BUSY_TARGET] = ref_target;
    }

    ring[i & (RING - 1)] = comp;
    vis_prev = vis;
    max_comp = imax(max_comp, comp);
  }

#pragma unroll
  for (int k = 0; k < SC_F; ++k) sc_out[(size_t)lane * SC_F + k] = sc[k];
  vis_out[lane] = vis_prev;
  max_out[lane] = max_comp;
}

}  // namespace

// Plain C entry, bound with ctypes. All buffers are int32 device pointers:
// xs [B, N, RQ_F], mlp [B], timing [T_F], scratch [B, lane_scratch_ints()],
// sc_out [B, SC_F], vis_out [B], max_out [B]. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int lane_scratch_ints(int nb, int ns, int refresh_mode) {
  return nb * (ns + 1) * SA_F + RING + (refresh_mode ? nb * REF_F : 0);
}

extern "C" int lane_step_launch(const void* xs, const void* mlp,
                                const void* timing, void* scratch,
                                void* sc_out, void* vis_out, void* max_out,
                                int B, int N, int nb, int ns, int policy,
                                int refresh_mode, int closed_row,
                                void* stream) {
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  lane_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)xs, (const int*)mlp, (const int*)timing, (int*)scratch,
      (int*)sc_out, (int*)vis_out, (int*)max_out, B, N, nb, ns, policy,
      refresh_mode, closed_row);
  return (int)cudaGetLastError();
}
