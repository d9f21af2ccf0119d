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
// The step itself (refresh gating, timing step, refresh commit) is
// dram_step.cuh's, shared with the mix kernel. Ring slots use & (RING - 1):
// (i - 1) and (i - mlp) are negative at small i, where C's % truncates but
// the reference's % floors.
#include "dram_step.cuh"

namespace {

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
    const int comp = timing_step(sa, ch, hb, s, q[RQ_ROW], is_wr, vis,
                                 d.pending, d.target, policy, refresh_mode,
                                 closed_row != 0, ns, t);
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
