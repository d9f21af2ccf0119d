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
// counters and two [M, C] vectors written once. Two bodies, picked by shape
// before the launch (cuda_step.body()):
//
//  * smem (mix_step_smem): one warp a mix, lane c keying core c (with
//    C > 32, cores c, c + 32, ... in ascending order, keeping its best). A
//    lane holds its cores' rows (ptr, vis_prev, max_comp), last completion,
//    head and next request in registers; the mix's plane, [C][64] rings,
//    [nb][5] refresh table and each core's request ring, staged in chunks
//    by cp.async (dram_step.cuh stage_chunk), live in its block's
//    dynamic shared memory. A step keys the heads in parallel, takes the
//    argmin with __reduce_min_sync and __ballot_sync, hands the served
//    head's fields and refresh directive to every lane by __shfl_sync, and
//    all lanes then run the served step uniformly (each carries the channel
//    scalars, so the next keys read the bus from a register). The served
//    core's owner lane writes its ring slot and moves its head on. One warp
//    a block: a mix is latency-bound, so the mixes spread over the SMs.
//  * global (mix_step_global): one thread a mix, the same state in a
//    per-mix slice of a scratch buffer the wrapper allocates, in blocks of
//    32 threads; for geometries whose state does not fit a block's shared
//    memory, or C above 128.
//
// The step's timing math is dram_step.cuh's, shared with the lane kernel.
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
//    across lanes the lowest lane among the minima (C <= 32) or the lowest
//    core among them (C > 32);
//  * a dead core (ptr == N) keys DEAD but its head is still read at the
//    clamped p = N - 1, in bounds;
//  * ring slots use & (RING - 1), the reference's floor modulo, and the ROB
//    read is gated by p >= mlp; TCM compares rank < C / 2 with C >= 1.
#include "dram_step.cuh"

#include <limits.h>

namespace {

// per-core bookkeeping (state_layout CORE_*)
constexpr int CORE_PTR = 0, CORE_VIS_PREV = 1, CORE_MAX_COMP = 2, CORE_F = 3;
// schedulers (Scheduler); FCFS (0) keys the visibility alone
constexpr int FRFCFS = 1, FRFCFS_SALP = 2, TCM = 3, PALP_RP = 4;
// key constants (schedulers._BIG, _DEAD, _REF_URGENT)
constexpr unsigned BIG = 1u << 28;
constexpr int DEAD = 2000000000;

// The scheduler's key (schedulers.request_key) of a live head at gated
// visibility `vis`, from its PRE-step plane row `own` and bank refresh row
// `rr`.
__device__ __forceinline__ int sched_key(const int* own, const int* rr,
                                         int vis, int w, bool is_wr, int rank,
                                         int half, int bus_free,
                                         int scheduler, int refresh_mode,
                                         int ref_urgent) {
  const int orow = own[SA_OPEN_ROW];
  const bool pending = vis <= bus_free;
  const bool pending_hit = pending && orow == w;
  unsigned k = (unsigned)vis;
  if (scheduler == FRFCFS) {
    k += pending_hit ? 0u : BIG;
  } else if (scheduler == FRFCFS_SALP) {
    k += pending_hit ? 0u : (pending && orow != NEG ? BIG : 2u * BIG);
  } else if (scheduler == TCM) {
    k += pending_hit ? 0u : BIG;
    if (pending && rank < half) k -= 2u * BIG;
  } else if (scheduler == PALP_RP) {
    const bool wr_ready = own[SA_WRR_DONE] <= bus_free;
    k += pending_hit ? 0u : (pending && !is_wr && wr_ready ? BIG : 2u * BIG);
  }
  if (refresh_mode == 4 && pending && rr[REF_DEBT] >= ref_urgent)
    k -= 4u * BIG;
  return (int)k;
}

// One core's head request, as the global body's step sees it.
struct Head {
  int hb, s, w, p, vis;
  bool is_wr;
  Directive d;
};

__global__ void mix_step_global(const int* __restrict__ reqs,
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
  // scheduler key; DEAD once the stream is done.
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
    return sched_key(sa + (h.hb * ns_p1 + h.s) * SA_F, rr, h.vis, h.w,
                     h.is_wr, rank[c], half, bus_free, scheduler,
                     refresh_mode, ref_urgent);
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
    const int comp = timing_step<false>(sa, ch, best.hb, best.s, best.w,
                                        best.is_wr, best.vis, best.d.pending,
                                        best.d.target, policy, refresh_mode,
                                        closed_row != 0, ns, t, 0);
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

// One core as its lane holds it in the smem body: the core row, the head
// (request min(ptr, N - 1)) with its visibility before refresh gating, and
// the request after it.
struct Core {
  int ptr, vis_prev, max_comp, mlp, rank, vis0;
  Req head, nxt;
};

// One warp a mix, one mix a block; lane c keys cores c, c + 32, ... (CPL
// slots a lane, so C <= 32 * CPL). The block's dynamic shared memory holds
// the plane, the [C][RING] rings, the refresh table and the [C] request
// rings.
template <int CPL>
__global__ void mix_step_smem(const int* __restrict__ reqs,
                              const int* __restrict__ mlp_in,
                              const int* __restrict__ rank_in,
                              const int* __restrict__ timing,
                              int* __restrict__ sc_out,
                              int* __restrict__ vis_out,
                              int* __restrict__ max_out,
                              int M, int C, int N, int nb, int ns,
                              int policy, int scheduler, int refresh_mode,
                              int closed_row) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x, m = blockIdx.x;

  int t[T_F];
#pragma unroll
  for (int k = 0; k < T_F; ++k) t[k] = timing[k];

  const int ns_p1 = ns + 1;
  constexpr int per_stream = STAGE_D * STAGE_K * RQ_F;
  int* sa = smem;                                // [nb][ns + 1][SA_F]
  int* rings = sa + nb * ns_p1 * SA_F;           // [C][RING]
  int* ref = rings + C * RING;                   // [nb][REF_F]
  int* stage = ref + (refresh_mode ? nb * REF_F : 0);  // [C][per_stream]
  const int* x = reqs + (size_t)m * C * N * RQ_F;
  const bool is_masa = policy == MASA;
  const int ref_urgent = t[T_POSTPONE] - 1;
  const int half = C / 2;

  // ---- initial state (engine._bank_state0, controller._stateC_init) and
  // the first STAGE_D chunks of every core's requests
  Channel ch;
  init_state_warp(sa, C * RING, nb, ns, refresh_mode, t, ch, lane);
  for (int c = 0; c < C; ++c)
    for (int q = 0; q < STAGE_D; ++q)
      stage_chunk(stage + c * per_stream, x + (size_t)c * N * RQ_F, N, q,
                  lane);
  stage_commit();
  stage_wait<0>();
  __syncwarp();

  Core k[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    Core& o = k[j];
    o = Core{};
    if (c >= C) continue;
    const int* st = stage + c * per_stream;
    o.mlp = mlp_in[(size_t)m * C + c];
    o.rank = rank_in[(size_t)m * C + c];
    o.head = load_req(staged(st, 0));
    o.nxt = load_req(staged(st, imin(1, N - 1)));
    o.vis0 = imax(o.head.gap, 0);                // empty ring, p = 0 < mlp
  }

  const int steps = C * N;
  for (int step = 0; step < steps; ++step) {
    // ---- key this lane's heads against the PRE-step state
    const int bus_free = ch.sc[SC_DATA_BUS_FREE];
    int best_key = INT_MAX, best_j = 0, best_vis = 0;
    Directive best_d;
    best_d.pending = best_d.act = best_d.shadow = false;
    best_d.target = best_d.due = best_d.end = best_d.debt = 0;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      if (lane + 32 * j >= C) continue;
      const Core& o = k[j];
      const int* rr = ref + o.head.hb * REF_F;
      Directive d;
      const int vis = refresh_gate(rr, o.vis0, o.head.s, o.head.is_wr,
                                   refresh_mode, is_masa, ns, t, d);
      const int key =
          o.ptr >= N ? DEAD
                     : sched_key(sa + (o.head.hb * ns_p1 + o.head.s) * SA_F,
                                 rr, vis, o.head.w, o.head.is_wr, o.rank,
                                 half, bus_free, scheduler, refresh_mode,
                                 ref_urgent);
      if (key < best_key) {
        best_key = key;
        best_j = j;
        best_vis = vis;
        best_d = d;
      }
    }

    // ---- the argmin over the warp: the lowest core among the minima
    const int kmin = __reduce_min_sync(FULL, best_key);
    int win;
    if (CPL == 1)
      win = __ffs(__ballot_sync(FULL, best_key == kmin)) - 1;
    else
      win = __reduce_min_sync(FULL,
                              best_key == kmin ? lane + 32 * best_j : INT_MAX);
    const int wl = win & 31;

    // ---- the served head's fields and directive, from its lane
    Req h = k[0].head;
    int ptr = k[0].ptr;
#pragma unroll
    for (int j = 1; j < CPL; ++j)
      if (j == best_j) {
        h = k[j].head;
        ptr = k[j].ptr;
      }
    const int hb = __shfl_sync(FULL, h.hb, wl);
    const int s = __shfl_sync(FULL, h.s, wl);
    const int w = __shfl_sync(FULL, h.w, wl);
    const int vis = __shfl_sync(FULL, best_vis, wl);
    const int p = __shfl_sync(FULL, ptr, wl);
    const int flags = __shfl_sync(
        FULL, (h.is_wr ? 1 : 0) | (best_d.pending ? 2 : 0) |
                  (best_d.act ? 4 : 0) | (best_d.shadow ? 8 : 0), wl);
    const bool is_wr = flags & 1;
    Directive d;
    d.pending = flags & 2;
    d.act = flags & 4;
    d.shadow = flags & 8;
    d.target = d.due = d.end = d.debt = 0;
    if (refresh_mode) {
      d.target = __shfl_sync(FULL, best_d.target, wl);
      d.due = __shfl_sync(FULL, best_d.due, wl);
      d.end = __shfl_sync(FULL, best_d.end, wl);
      d.debt = __shfl_sync(FULL, best_d.debt, wl);
    }

    // ---- serve it, every lane alike
    const int comp = timing_step<true>(sa, ch, hb, s, w, is_wr, vis,
                                       d.pending, d.target, policy,
                                       refresh_mode, closed_row != 0, ns, t,
                                       lane);
    commit_ref(ref + hb * REF_F, d, refresh_mode, vis, comp, t);

    // ---- the served core moves on. C * N steps over C * N requests: it
    // is live, so p = ptr was never clamped. When its next request pn + 1
    // enters chunk q, q has landed (issued STAGE_D - 1 of this core's
    // events ago, so at least STAGE_D - 2 groups back) and the slot of the
    // chunk being left takes chunk q + STAGE_D - 1, as in the lane kernel.
    const int pn = p + 1;
    const int* st = stage + win * per_stream;
    if ((pn + 1) % STAGE_K == 0 && pn + 1 < N) {
      stage_wait<STAGE_D - 2>();
      __syncwarp();
      stage_chunk(stage + win * per_stream, x + (size_t)win * N * RQ_F, N,
                  (pn + 1) / STAGE_K + STAGE_D - 1, lane);
      stage_commit();
    }
    if (lane == wl) {
      rings[win * RING + (p & (RING - 1))] = comp;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (j != (win >> 5)) continue;
        Core& o = k[j];
        o.ptr = pn;
        o.vis_prev = vis;
        o.max_comp = imax(o.max_comp, comp);
        o.head = o.nxt;                          // request min(pn, N - 1)
        o.nxt = load_req(staged(st, imin(pn + 1, N - 1)));
        // visibility of the new head before gating (controller._build_stepC;
        // a dead core's is never used)
        const int rob_lim =
            pn >= o.mlp ? rings[win * RING + ((pn - o.mlp) & (RING - 1))] : 0;
        o.vis0 = imax(vis + o.head.gap,
                      imax(o.head.dep ? comp : 0, rob_lim));
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int f = 0; f < SC_F; ++f) sc_out[(size_t)m * SC_F + f] = ch.sc[f];
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    if (c >= C) continue;
    vis_out[(size_t)m * C + c] = k[j].vis_prev;
    max_out[(size_t)m * C + c] = k[j].max_comp;
  }
}

template <int CPL>
int launch_smem(const void* reqs, const void* mlp, const void* rank,
                const void* timing, void* sc_out, void* vis_out,
                void* max_out, int M, int C, int N, int nb, int ns,
                int policy, int scheduler, int refresh_mode, int closed_row,
                int chain_bytes, cudaStream_t st) {
  const int err = allow_smem(mix_step_smem<CPL>, chain_bytes);
  if (err) return err;
  mix_step_smem<CPL><<<M, 32, chain_bytes, st>>>(
      (const int*)reqs, (const int*)mlp, (const int*)rank,
      (const int*)timing, (int*)sc_out, (int*)vis_out, (int*)max_out, M, C,
      N, nb, ns, policy, scheduler, refresh_mode, closed_row);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, bound with ctypes. All buffers are int32 device pointers:
// reqs [M, C, N, RQ_F], mlp [M, C], rank [M, C], timing [T_F],
// sc_out [M, SC_F], vis_out [M, C], max_out [M, C]; scratch
// [M, mix_scratch_ints()] for the global body (body 0), unused by the smem
// body (body 1, C <= 128), which takes `chain_bytes` of shared memory a mix
// (cuda_step.chain_bytes). Launches on `stream` and returns the CUDA error
// code (0 on success).
extern "C" int mix_scratch_ints(int nb, int ns, int C, int refresh_mode) {
  return nb * (ns + 1) * SA_F + C * (RING + CORE_F)
         + (refresh_mode ? nb * REF_F : 0);
}

extern "C" int mix_step_launch(const void* reqs, const void* mlp,
                               const void* rank, const void* timing,
                               void* scratch, void* sc_out, void* vis_out,
                               void* max_out, int M, int C, int N, int nb,
                               int ns, int policy, int scheduler,
                               int refresh_mode, int closed_row, int body,
                               int chain_bytes, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (body == 0) {
    const int threads = 32;
    const int blocks = (M + threads - 1) / threads;
    mix_step_global<<<blocks, threads, 0, st>>>(
        (const int*)reqs, (const int*)mlp, (const int*)rank,
        (const int*)timing, (int*)scratch, (int*)sc_out, (int*)vis_out,
        (int*)max_out, M, C, N, nb, ns, policy, scheduler, refresh_mode,
        closed_row);
    return (int)cudaGetLastError();
  }
  if (body != 1 || C > 128) return (int)cudaErrorInvalidValue;
  if (C <= 32)
    return launch_smem<1>(reqs, mlp, rank, timing, sc_out, vis_out, max_out,
                          M, C, N, nb, ns, policy, scheduler, refresh_mode,
                          closed_row, chain_bytes, st);
  return launch_smem<4>(reqs, mlp, rank, timing, sc_out, vis_out, max_out, M,
                        C, N, nb, ns, policy, scheduler, refresh_mode,
                        closed_row, chain_bytes, st);
}
