// Mix kernel: M independent multicore mixes, C cores sharing one channel.
//
// Replaces the Pallas mix kernel of the JAX package
// (repro/core/dram/pallas_step.py, _simulate_cores_pallas with body
// _mix_kernel): per mix, C * N steps of the general C-core controller step
// (repro/core/dram/controller.py _build_stepC). Each step computes every
// core's head visibility (compute gap, dependent load, ROB window, refresh
// gating), keys the live heads with the scheduler (schedulers.request_key:
// FCFS, FR-FCFS, FR-FCFS+SALP, TCM, PALP-RP, and DARP's urgency boost),
// serves the argmin core through the bank/subarray timing step and commits
// that core's refresh row, core row and completion-ring slot. The plain
// PyTorch version of the same function is controller.run_cores in this
// package; cuda_step.py binds this file through ctypes.
//
// What bounds it: each mix is a serial chain of C * N steps (every step
// reads the state the previous one wrote), and each step reads the C heads
// and their open rows before it can choose, so the kernel is bound by the
// latency of one step times C * N, not by bytes or operations. The bytes
// are M * C * N * 6 * 4 read once (the request streams) plus the [M, 16]
// counters and two [M, C] vectors written once. Design: one thread per mix,
// so M chains run concurrently in blocks of 32 threads; the mix's state
// that is indexed by data (the [nb][ns + 1][5] plane, the [C][64] rings,
// the [C][3] core rows and the [nb][5] refresh table) lives in a per-mix
// slice of a scratch buffer the wrapper allocates and this kernel
// initialises; the channel scalars, the ACT history and the chosen head
// stay in registers. The step's timing math is dram_step.cuh's, shared
// with the lane kernel.
//
// Semantics that must match the reference bit for bit:
//  * every head's key is computed before anything is written: the open row
//    and SA_WRR_DONE are read from the PRE-step plane at (hb, hs), pending
//    compares with the PRE-step SC_DATA_BUS_FREE, and DARP's debt comes
//    from the PRE-step refresh table;
//  * the refresh directive is a pure function of the pre-step table, so
//    the one computed while keying the eventual argmin core is exactly the
//    one the reference gathers for it: the loop keeps the best head so far
//    (fields, visibility, directive) in registers instead of storing C
//    directives, and only the chosen head's row is committed;
//  * keys add and subtract multiples of 2^28 as unsigned ints cast back to
//    int, so a wrap, if one ever occurred, equals the reference's int32
//    wrap (signed overflow is undefined in C++);
//  * ties go to the lowest core (jnp.argmin): cores ascend, compare with <;
//  * a dead core (ptr == N) keys DEAD but its head is still read at the
//    clamped p = N - 1, in bounds;
//  * ring slots use & (RING - 1), the reference's floor modulo, and the ROB
//    read is gated by p >= mlp; TCM compares rank < C / 2 with C >= 1.
#include "dram_step.cuh"

namespace {

// per-core bookkeeping (state_layout CORE_*)
constexpr int CORE_PTR = 0, CORE_VIS_PREV = 1, CORE_MAX_COMP = 2, CORE_F = 3;
// schedulers (Scheduler); FCFS (0) keys the visibility alone
constexpr int FRFCFS = 1, FRFCFS_SALP = 2, TCM = 3, PALP_RP = 4;
// key constants (schedulers._BIG, _DEAD, _REF_URGENT)
constexpr unsigned BIG = 1u << 28;
constexpr int DEAD = 2000000000;

// One core's head request, as the step sees it.
struct Head {
  int hb, s, w, p, vis;
  bool is_wr;
  Directive d;
};

__global__ void mix_step_kernel(const int* __restrict__ reqs,
                                const int* __restrict__ mlp_in,
                                const int* __restrict__ rank_in,
                                const int* __restrict__ timing,
                                int* __restrict__ scratch,
                                int* __restrict__ sc_out,
                                int* __restrict__ vis_out,
                                int* __restrict__ max_out,
                                int M, int C, int N, int nb, int ns,
                                int policy, int scheduler, int refresh_mode,
                                int closed_row) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;

  int t[T_F];
#pragma unroll
  for (int k = 0; k < T_F; ++k) t[k] = timing[k];

  const int ns_p1 = ns + 1;
  const int plane = nb * ns_p1 * SA_F;
  const size_t per_mix =
      plane + C * (RING + CORE_F) + (refresh_mode ? nb * REF_F : 0);
  int* sa = scratch + (size_t)m * per_mix;       // [nb][ns + 1][SA_F]
  int* rings = sa + plane;                       // [C][RING]
  int* core = rings + C * RING;                  // [C][CORE_F]
  int* ref = core + C * CORE_F;                  // [nb][REF_F]
  const int* x = reqs + (size_t)m * C * N * RQ_F;
  const int* mlp = mlp_in + (size_t)m * C;
  const int* rank = rank_in + (size_t)m * C;
  const bool is_masa = policy == MASA;
  const int ref_urgent = t[T_POSTPONE] - 1;
  const int half = C / 2;

  // ---- initial state (engine._bank_state0, controller._stateC_init)
  Channel ch;
  init_state(sa, ref, nb, ns, refresh_mode, t, ch);
  for (int k = 0; k < C * (RING + CORE_F); ++k) rings[k] = 0;

  // One core's head at the current step: fills its fields, gated
  // visibility and refresh directive from the PRE-step state and returns its
  // scheduler key (schedulers.request_key); DEAD once the stream is done.
  auto eval_head = [&](int c, int bus_free, Head& h) -> int {
    const int* cr = core + c * CORE_F;
    const int ptr = cr[CORE_PTR];
    h.p = imin(ptr, N - 1);
    const int* q = x + ((size_t)c * N + h.p) * RQ_F;
    h.hb = q[RQ_BANK];
    h.s = q[RQ_SA];
    h.w = q[RQ_ROW];
    h.is_wr = q[RQ_WR] != 0;

    // ---- visibility of the head (controller._build_stepC)
    const int* ring = rings + c * RING;
    const int mw = mlp[c];
    const int comp_prev = ring[(h.p - 1) & (RING - 1)];
    const int rob_lim = h.p >= mw ? ring[(h.p - mw) & (RING - 1)] : 0;
    const int vis = imax(cr[CORE_VIS_PREV] + q[RQ_GAP],
                         imax(q[RQ_DEP] != 0 ? comp_prev : 0, rob_lim));
    const int* rr = ref + h.hb * REF_F;
    h.vis = refresh_gate(rr, vis, h.s, h.is_wr, refresh_mode, is_masa, ns, t,
                         h.d);
    if (ptr >= N) return DEAD;

    // ---- the scheduler's key
    const int* own = sa + (h.hb * ns_p1 + h.s) * SA_F;
    const int orow = own[SA_OPEN_ROW];
    const bool pending = h.vis <= bus_free;
    const bool pending_hit = pending && orow == h.w;
    unsigned k = (unsigned)h.vis;
    if (scheduler == FRFCFS) {
      k += pending_hit ? 0u : BIG;
    } else if (scheduler == FRFCFS_SALP) {
      k += pending_hit ? 0u : (pending && orow != NEG ? BIG : 2u * BIG);
    } else if (scheduler == TCM) {
      k += pending_hit ? 0u : BIG;
      if (pending && rank[c] < half) k -= 2u * BIG;
    } else if (scheduler == PALP_RP) {
      const bool wr_ready = own[SA_WRR_DONE] <= bus_free;
      k += pending_hit ? 0u
                       : (pending && !h.is_wr && wr_ready ? BIG : 2u * BIG);
    }
    if (refresh_mode == 4 && pending && rr[REF_DEBT] >= ref_urgent)
      k -= 4u * BIG;
    return (int)k;
  };

  const int steps = C * N;
  for (int step = 0; step < steps; ++step) {
    const int bus_free = ch.sc[SC_DATA_BUS_FREE];
    Head best, h;
    int best_c = 0;
    int best_key = eval_head(0, bus_free, best);
    for (int c = 1; c < C; ++c) {
      const int key = eval_head(c, bus_free, h);
      if (key < best_key) {
        best_c = c;
        best_key = key;
        best = h;
      }
    }

    // ---- serve the chosen head
    const int comp = timing_step(sa, ch, best.hb, best.s, best.w, best.is_wr,
                                 best.vis, best.d.pending, best.d.target,
                                 policy, refresh_mode, closed_row != 0, ns, t);
    commit_ref(ref + best.hb * REF_F, best.d, refresh_mode, best.vis, comp, t);
    // C * N steps over C * N requests: the chosen core is live, so its
    // pointer was never clamped
    int* cr = core + best_c * CORE_F;
    cr[CORE_PTR] = best.p + 1;
    cr[CORE_VIS_PREV] = best.vis;
    cr[CORE_MAX_COMP] = imax(cr[CORE_MAX_COMP], comp);
    rings[best_c * RING + (best.p & (RING - 1))] = comp;
  }

#pragma unroll
  for (int k = 0; k < SC_F; ++k) sc_out[(size_t)m * SC_F + k] = ch.sc[k];
  for (int c = 0; c < C; ++c) {
    vis_out[(size_t)m * C + c] = core[c * CORE_F + CORE_VIS_PREV];
    max_out[(size_t)m * C + c] = core[c * CORE_F + CORE_MAX_COMP];
  }
}

}  // namespace

// Plain C entry, bound with ctypes. All buffers are int32 device pointers:
// reqs [M, C, N, RQ_F], mlp [M, C], rank [M, C], timing [T_F],
// scratch [M, mix_scratch_ints()], sc_out [M, SC_F], vis_out [M, C],
// max_out [M, C]. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int mix_scratch_ints(int nb, int ns, int C, int refresh_mode) {
  return nb * (ns + 1) * SA_F + C * (RING + CORE_F)
         + (refresh_mode ? nb * REF_F : 0);
}

extern "C" int mix_step_launch(const void* reqs, const void* mlp,
                               const void* rank, const void* timing,
                               void* scratch, void* sc_out, void* vis_out,
                               void* max_out, int M, int C, int N, int nb,
                               int ns, int policy, int scheduler,
                               int refresh_mode, int closed_row,
                               void* stream) {
  const int threads = 32;
  const int blocks = (M + threads - 1) / threads;
  mix_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)reqs, (const int*)mlp, (const int*)rank,
      (const int*)timing, (int*)scratch, (int*)sc_out, (int*)vis_out,
      (int*)max_out, M, C, N, nb, ns, policy, scheduler, refresh_mode,
      closed_row);
  return (int)cudaGetLastError();
}
