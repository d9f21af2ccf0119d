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
// written once. Two bodies, picked by shape before the launch
// (cuda_step.body()):
//
//  * smem (lane_step_smem): one warp a lane. The lane's state that is
//    indexed by data (the packed [nb][ns + 1][5] bank/subarray plane, the
//    64-entry completion ring, the [nb][5] refresh table) and its request
//    stream, staged in chunks by cp.async (dram_step.cuh stage_chunk), live
//    in its block's dynamic shared memory, so a step's dependent
//    reads (the bank-vector row, then the other subarray's row it names)
//    are shared-memory reads and no global load sits on the chain. All 32
//    lanes run the step uniformly; they split the O(ns) loops of the
//    refresh close and the closed-row bump. The next request is read a step
//    ahead, and the last completion stays in a register. One warp a block:
//    a chain is latency-bound, so the chains spread over the SMs.
//  * global (lane_step_global): one thread a lane, the same state in a
//    per-lane slice of a scratch buffer the wrapper allocates, in blocks of
//    32 threads; for geometries whose state does not fit a block's shared
//    memory (ns reaches the hundreds in sweeps).
//
// The step itself (refresh gating, timing step, refresh commit) is
// dram_step.cuh's, shared with the mix kernel. Ring slots use & (RING - 1):
// (i - 1) and (i - mlp) are negative at small i, where C's % truncates but
// the reference's % floors.
#include "dram_step.cuh"

namespace {

__global__ void lane_step_global(const int* __restrict__ xs,
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

  const int plane = nb * (ns + 1) * SA_F;
  const int per_lane = plane + RING + (refresh_mode ? nb * REF_F : 0);
  int* sa = scratch + (size_t)lane * per_lane;   // [nb][ns + 1][SA_F]
  int* ring = sa + plane;                        // [RING]
  int* ref = ring + RING;                        // [nb][REF_F]
  const int* x = xs + (size_t)lane * N * RQ_F;
  const int mlp = mlp_in[lane];
  const bool is_masa = policy == MASA;

  // ---- initial state (engine._bank_state0, controller._state1_init)
  Channel ch;
  init_state(sa, ref, nb, ns, refresh_mode, t, ch);
  for (int k = 0; k < RING; ++k) ring[k] = 0;
  int vis_prev = 0, max_comp = 0;

  for (int i = 0; i < N; ++i) {
    const int* q = x + (size_t)i * RQ_F;
    const int hb = q[RQ_BANK], s = q[RQ_SA];
    const bool is_wr = q[RQ_WR] != 0;

    // ---- visibility (controller._build_step1)
    const int comp_prev = ring[(i - 1) & (RING - 1)];
    const int rob_lim = i >= mlp ? ring[(i - mlp) & (RING - 1)] : 0;
    int vis = imax(vis_prev + q[RQ_GAP],
                   imax(q[RQ_DEP] != 0 ? comp_prev : 0, rob_lim));

    // ---- refresh gating, timing step, refresh commit
    int* rr = ref + hb * REF_F;
    Directive d;
    vis = refresh_gate(rr, vis, s, is_wr, refresh_mode, is_masa, ns, t, d);
    const int comp = timing_step<false>(sa, ch, hb, s, q[RQ_ROW], is_wr, vis,
                                        d.pending, d.target, policy,
                                        refresh_mode, closed_row != 0, ns, t,
                                        0);
    commit_ref(rr, d, refresh_mode, vis, comp, t);

    ring[i & (RING - 1)] = comp;
    vis_prev = vis;
    max_comp = imax(max_comp, comp);
  }

#pragma unroll
  for (int k = 0; k < SC_F; ++k) sc_out[(size_t)lane * SC_F + k] = ch.sc[k];
  vis_out[lane] = vis_prev;
  max_out[lane] = max_comp;
}

// One warp a lane, one lane a block; the block's dynamic shared memory
// holds the plane, the ring, the refresh table and the request ring.
__global__ void lane_step_smem(const int* __restrict__ xs,
                               const int* __restrict__ mlp_in,
                               const int* __restrict__ timing,
                               int* __restrict__ sc_out,
                               int* __restrict__ vis_out,
                               int* __restrict__ max_out,
                               int B, int N, int nb, int ns, int policy,
                               int refresh_mode, int closed_row) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x, chain = blockIdx.x;

  int t[T_F];
#pragma unroll
  for (int k = 0; k < T_F; ++k) t[k] = timing[k];

  int* sa = smem;                                // [nb][ns + 1][SA_F]
  int* ring = sa + nb * (ns + 1) * SA_F;         // [RING]
  int* ref = ring + RING;                        // [nb][REF_F]
  int* stage = ref + (refresh_mode ? nb * REF_F : 0);  // [STAGE_D][STAGE_K][RQ_F]
  const int* x = xs + (size_t)chain * N * RQ_F;
  const bool is_masa = policy == MASA;

  // ---- initial state (engine._bank_state0, controller._state1_init) and
  // the first STAGE_D chunks of requests
  Channel ch;
  init_state_warp(sa, RING, nb, ns, refresh_mode, t, ch, lane);
  for (int q = 0; q < STAGE_D; ++q) stage_chunk(stage, x, N, q, lane);
  stage_commit();
  stage_wait<0>();
  __syncwarp();
  const int mlp = mlp_in[chain];
  int vis_prev = 0, max_comp = 0, comp_prev = 0;

  Req cur = load_req(staged(stage, 0));
  for (int i = 0; i < N; ++i) {
    // the next request enters chunk q: q (issued STAGE_D - 1 events ago,
    // STAGE_D - 2 groups back) has landed; the slot of the chunk being left
    // takes chunk q + STAGE_D - 1
    const int nx = i + 1;
    if (nx % STAGE_K == 0 && nx < N) {
      stage_wait<STAGE_D - 2>();
      __syncwarp();
      stage_chunk(stage, x, N, nx / STAGE_K + STAGE_D - 1, lane);
      stage_commit();
    }
    const Req nxt = load_req(staged(stage, imin(nx, N - 1)));

    // ---- visibility (controller._build_step1)
    const int rob_lim = i >= mlp ? ring[(i - mlp) & (RING - 1)] : 0;
    int vis = imax(vis_prev + cur.gap, imax(cur.dep ? comp_prev : 0, rob_lim));

    // ---- refresh gating, timing step, refresh commit
    int* rr = ref + cur.hb * REF_F;
    Directive d;
    vis = refresh_gate(rr, vis, cur.s, cur.is_wr, refresh_mode, is_masa, ns,
                       t, d);
    const int comp = timing_step<true>(sa, ch, cur.hb, cur.s, cur.w,
                                       cur.is_wr, vis, d.pending, d.target,
                                       policy, refresh_mode, closed_row != 0,
                                       ns, t, lane);
    commit_ref(rr, d, refresh_mode, vis, comp, t);

    ring[i & (RING - 1)] = comp;
    comp_prev = comp;
    vis_prev = vis;
    max_comp = imax(max_comp, comp);
    cur = nxt;
  }

  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < SC_F; ++k) sc_out[(size_t)chain * SC_F + k] = ch.sc[k];
    vis_out[chain] = vis_prev;
    max_out[chain] = max_comp;
  }
}

}  // namespace

// Plain C entry, bound with ctypes. All buffers are int32 device pointers:
// xs [B, N, RQ_F], mlp [B], timing [T_F], sc_out [B, SC_F], vis_out [B],
// max_out [B]; scratch [B, lane_scratch_ints()] for the global body (body
// 0), unused by the smem body (body 1), which takes `chain_bytes` of shared
// memory a lane (cuda_step.chain_bytes). Launches on `stream` and returns
// the CUDA error code (0 on success).
extern "C" int lane_scratch_ints(int nb, int ns, int refresh_mode) {
  return nb * (ns + 1) * SA_F + RING + (refresh_mode ? nb * REF_F : 0);
}

extern "C" int lane_step_launch(const void* xs, const void* mlp,
                                const void* timing, void* scratch,
                                void* sc_out, void* vis_out, void* max_out,
                                int B, int N, int nb, int ns, int policy,
                                int refresh_mode, int closed_row, int body,
                                int chain_bytes, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (body == 0) {
    const int threads = 32;
    const int blocks = (B + threads - 1) / threads;
    lane_step_global<<<blocks, threads, 0, st>>>(
        (const int*)xs, (const int*)mlp, (const int*)timing, (int*)scratch,
        (int*)sc_out, (int*)vis_out, (int*)max_out, B, N, nb, ns, policy,
        refresh_mode, closed_row);
    return (int)cudaGetLastError();
  }
  if (body != 1) return (int)cudaErrorInvalidValue;
  const int err = allow_smem(lane_step_smem, chain_bytes);
  if (err) return err;
  lane_step_smem<<<B, 32, chain_bytes, st>>>(
      (const int*)xs, (const int*)mlp, (const int*)timing, (int*)sc_out,
      (int*)vis_out, (int*)max_out, B, N, nb, ns, policy, refresh_mode,
      closed_row);
  return (int)cudaGetLastError();
}
