// MASA-tiled matmul C = A @ B for Hopper (sm_90a).
//
// Replaces the TPU kernel masa_gemm_kernel (src/repro/kernels/masa_gemm/
// kernel.py:53, pallas_call :66 output-stationary / :81 weight-stationary,
// bodies _kernel_os and _kernel_ws): A [M, K], B [K, N], both f32 or both
// bf16, products summed in fp32 and C written once in A's type. Two
// residency orders, as on the TPU, and three bodies, chosen by the wrapper
// (kernel.py's body()) before the launch and counted there:
//
// wgmma body (bf16, K % 8 == 0, N % 8 == 0, 16-byte aligned bases: TMA's
// global strides and addresses need whole 16-byte units). What bounds it:
// operations. At the port's timing shape (M 2048, K 4096, N 14336) the
// product is 240.5 GFLOP against 0.2 GB of traffic, 0.243 ms at the bf16
// tensor-core peak, so the design keeps the tensor cores fed:
//   output-stationary  hopper_gemm.cuh's ring kernel: one block per
//                      128 x 256 tile of C, two consumer warpgroups of 64
//                      rows, each issuing wgmma m64n256k16 (128 fp32
//                      accumulators a thread), and a producer warpgroup
//                      whose one thread keeps TMA loads of A [128 x 64]
//                      (16 KB) and B [64 x 256] (32 KB) in flight through
//                      a ring of 4 stages (192 KB). Tiles launch in
//                      groups of 16 row tiles, M fastest within a column
//                      tile (hopper::raster), so a wave shares B's column
//                      tiles and keeps A in L2. The epilogue rounds to
//                      bf16 once and writes through shared memory in
//                      16-byte pieces (written straight from the
//                      fragment, 4 bytes a lane, it took most of a K 256
//                      tile's time).
//   weight-stationary  one block per 128-column panel of B: the [K, 128]
//                      panel is loaded into shared memory once by TMA and
//                      stays there while the block walks every 64-row tile
//                      of A against it (the Pallas grid (N/bn, M/bm), M
//                      innermost). The two consumer warpgroups take
//                      alternate row tiles (m64n128k16), each through its
//                      own ring of 3 stages of [64 x 64] (48 KB in all), so
//                      one's epilogue overlaps the other's wgmmas.
//                      The ops fallback is decided by
//                      kernel.py's ws_panel_bytes alone; for every K it
//                      admits in bf16 (K <= 605) this layout (the panel
//                      rounded up to 64 rows, the rings, 10 KB of epilogue
//                      staging and 1 KB of alignment) fits a block's 232,448 bytes, and the
//                      launch refuses (-1) if it would not. The grid is
//                      N / 128 blocks (112 at N 14336, on 132 SMs): the
//                      order's price, since splitting the panel would undo
//                      its residency.
// tf32x3 body (fp32, K % 4 == 0, N % 4 == 0, 16-byte aligned bases: rows
// of whole 16-byte cp.async units). What bounds it: operations. fp32 on
// the CUDA cores peaks at 67 TFLOP/s (3.59 ms at the timing shape); three
// TF32 mma.sync a product (tf32x3.cuh: each operand split into a big and a
// small TF32 part, the small-by-small product dropped) keep fp32's
// accuracy at up to 494.7 / 3 TFLOP/s of the TF32 tensor cores (1.46 ms).
// Fragments are read from padded shared memory by plain loads (B is
// MN-major, which TF32 wgmma cannot read) and split as they are loaded.
// 8 warps a block, each 64 x 32 of C (4 x 4 mma tiles, 64 fp32 sums a
// thread and a stage's 64 partial sums: each 32-deep stage sums into a
// fresh tile that an fp32 add takes into the running sum, as tf32x3.cuh
// explains):
//   output-stationary  one block per 128 x 128 tile of C; K in stages of 32
//                      through a 4-stage cp.async ring of A [128][40] and
//                      B [32][132] (146 KB; pitches for conflict-free
//                      fragment loads), one barrier a stage; tiles in
//                      hopper::raster's groups, as the wgmma body's.
//   weight-stationary  the [K, 128] panel of B (K rounded up to 32 rows,
//                      zero-filled; pitch 132) is loaded once by cp.async
//                      and stays resident; A streams through a 3-stage ring
//                      of [128][32] stages, one ring across all row tiles,
//                      so the next tile's loads overlap this one's last
//                      steps. At K 300, the deepest the body takes within
//                      ws_panel_bytes's budget, 165 KB of panel and 60 KB
//                      of ring fit a block; the launch refuses (-1) past
//                      232,448 bytes. The grid is N / 128 blocks, as the
//                      wgmma body's.
//   Edges: M is masked; K and N are multiples of 4, so a 16-byte chunk lies
//   wholly inside or outside B and is copied or zero-filled whole.
// simt body (fp32 and bf16 shapes the other bodies do not take, e.g. K 250
// in fp32, K 500 in bf16, or unaligned bases): fp32 FMAs on the CUDA cores,
// both operands from shared memory.
//   output-stationary  one block per 128 x 128 tile of C; K walked in
//                      steps of 16, the accumulator in registers (8 x 8 a
//                      thread).
//   weight-stationary  the [K, 128] panel and a [64, K] tile of A in
//                      shared memory, (64 + 128) * K elements: the
//                      wrapper's ws_panel_bytes, passed to the launch.
// Edges are masked (TMA's zero fill and a masked epilogue on the wgmma
// body, zero-filled stages on the tf32x3 body), so any M, K, N that a body
// takes is taken; the wrapper keeps the reference's divisibility checks.
#include "../../csrc/hopper_gemm.cuh"
#include "../../csrc/tf32x3.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBN = 128;   // columns of a tile of C (both orders)
constexpr int kRN = 8;     // columns of C a thread owns
constexpr int kStepK = 16;    // depth of one K step (output-stationary)
constexpr int kOsBM = 128, kOsRM = 8;   // rows of a tile / of a thread
constexpr int kWsBM = 64, kWsRM = 4;
constexpr int kThreads = 256;
static_assert((kOsBM / kOsRM) * (kBN / kRN) == kThreads, "os threads");
static_assert((kWsBM / kWsRM) * (kBN / kRN) == kThreads, "ws threads");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
masa_os_kernel(const T* __restrict__ a, const T* __restrict__ b,
               T* __restrict__ c, int M, int K, int N) {
  __shared__ float As[kStepK][kOsBM + 4];   // A tile, transposed
  __shared__ float Bs[kStepK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kRN), ty = tid / (kBN / kRN);
  const int m0 = blockIdx.y * kOsBM, n0 = blockIdx.x * kBN;
  float acc[kOsRM][kRN];
#pragma unroll
  for (int i = 0; i < kOsRM; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kStepK) {
    for (int e = tid; e < kOsBM * kStepK; e += kThreads) {
      const int r = e / kStepK, k = e - r * kStepK;
      const int gm = m0 + r, gk = k0 + k;
      As[k][r] = gm < M && gk < K ? to_f(a[(size_t)gm * K + gk]) : 0.f;
    }
    for (int e = tid; e < kStepK * kBN; e += kThreads) {
      const int k = e / kBN, n = e - k * kBN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = gk < K && gn < N ? to_f(b[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kStepK; ++k) {
      float av[kOsRM], bv[kRN];
#pragma unroll
      for (int i = 0; i < kOsRM; ++i) av[i] = As[k][ty * kOsRM + i];
#pragma unroll
      for (int j = 0; j < kRN; ++j) bv[j] = Bs[k][tx * kRN + j];
#pragma unroll
      for (int i = 0; i < kOsRM; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kOsRM; ++i) {
    const int gm = m0 + ty * kOsRM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int gn = n0 + tx * kRN + j;
      if (gn < N) from_f(acc[i][j], &c[(size_t)gm * N + gn]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
masa_ws_kernel(const T* __restrict__ a, const T* __restrict__ b,
               T* __restrict__ c, int M, int K, int N) {
  extern __shared__ float4 smem4[];
  T* panel = reinterpret_cast<T*>(smem4);    // B[:, n0:n0+kBN]  [K][kBN]
  T* at = panel + (size_t)K * kBN;           // A tile, transposed [K][kWsBM]
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kRN), ty = tid / (kBN / kRN);
  const int n0 = blockIdx.x * kBN;

  for (int e = tid; e < K * kBN; e += kThreads) {
    const int k = e / kBN, n = e - k * kBN;
    if (n0 + n < N) panel[e] = b[(size_t)k * N + n0 + n];
    else from_f(0.f, &panel[e]);
  }
  for (int m0 = 0; m0 < M; m0 += kWsBM) {
    __syncthreads();   // the panel is written; the last A tile is read
    for (int e = tid; e < kWsBM * K; e += kThreads) {
      const int r = e / K, k = e - r * K;
      if (m0 + r < M) at[k * kWsBM + r] = a[(size_t)(m0 + r) * K + k];
      else from_f(0.f, &at[k * kWsBM + r]);
    }
    __syncthreads();
    float acc[kWsRM][kRN];
#pragma unroll
    for (int i = 0; i < kWsRM; ++i)
#pragma unroll
      for (int j = 0; j < kRN; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      float av[kWsRM], bv[kRN];
#pragma unroll
      for (int i = 0; i < kWsRM; ++i) av[i] = to_f(at[k * kWsBM + ty * kWsRM + i]);
#pragma unroll
      for (int j = 0; j < kRN; ++j) bv[j] = to_f(panel[k * kBN + tx * kRN + j]);
#pragma unroll
      for (int i = 0; i < kWsRM; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) acc[i][j] += av[i] * bv[j];
    }
#pragma unroll
    for (int i = 0; i < kWsRM; ++i) {
      const int gm = m0 + ty * kWsRM + i;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        const int gn = n0 + tx * kRN + j;
        if (gn < N) from_f(acc[i][j], &c[(size_t)gm * N + gn]);
      }
    }
  }
}

template <typename T>
int launch_simt(const void* a, const void* b, void* c, int M, int K,
                int N, int weight_stationary, long long smem,
                cudaStream_t stream) {
  const T* a_ = static_cast<const T*>(a);
  const T* b_ = static_cast<const T*>(b);
  T* c_ = static_cast<T*>(c);
  if (weight_stationary) {
    auto kernel = masa_ws_kernel<T>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(N + kBN - 1) / kBN, kThreads, smem, stream>>>(a_, b_, c_, M, K,
                                                            N);
  } else {
    auto kernel = masa_os_kernel<T>;
    dim3 grid((N + kBN - 1) / kBN, (M + kOsBM - 1) / kOsBM);
    kernel<<<grid, kThreads, 0, stream>>>(a_, b_, c_, M, K, N);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ the wgmma bodies
constexpr int kWsStages = 3;                            // a ring
constexpr int kWsBytesA = 64 * hopper::kBK * 2;         // one A stage
constexpr int kWsBytesPanel = hopper::kBK * kBN * 2;    // 64 rows of panel

// Weight-stationary: block b keeps B[:, 128 b : 128 b + 128] resident and
// walks A in 64-row tiles. Consumer warpgroup w takes the tiles w, w + 2,
// ... through a ring of its own, so one warpgroup's epilogue runs while the
// other's wgmmas do; the producer fills the two rings in tile order.
__global__ void __launch_bounds__(3 * hopper::kWarpgroup, 1)
masa_ws_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, int M, int N,
                     int K, __nv_bfloat16* __restrict__ c) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (smem_u32(smem_raw) + kSmemAlign - 1) & ~(uint32_t)(kSmemAlign - 1);
  const int nk = (K + hopper::kBK - 1) / hopper::kBK;
  const int mt = (M + 63) / 64;
  const uint32_t panel = base;                        // nk x [64][128]
  const uint32_t a0 = panel + nk * kWsBytesPanel;     // 2 rings x A
  const uint32_t staging = a0 + 2 * kWsStages * kWsBytesA;
  const uint32_t full0 = staging + 8 * kStageWarpBytes;
  const uint32_t empty0 = full0 + 2 * kWsStages * 8;
  const uint32_t panel_bar = empty0 + 2 * kWsStages * 8;
  const int wg = threadIdx.x / kWarpgroup, t = threadIdx.x % kWarpgroup;
  const int n0 = blockIdx.x * kBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * kWsStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);   // the ring's warpgroup's warps
    }
    mbar_init(panel_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {   // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t != 0) return;
    mbar_expect_tx(panel_bar, nk * kWsBytesPanel);
    for (int kb = 0; kb < nk; ++kb)
      for (int j = 0; j < 2; ++j)
        tma_load_2d(panel + (kb * 2 + j) * kBoxBytes, &map_b, panel_bar,
                    n0 + 64 * j, kb * hopper::kBK);
    int s[2] = {0, 0}, phase[2] = {0, 0};
    for (int tile = 0; tile < mt; ++tile) {
      const int w = tile & 1;
      for (int kb = 0; kb < nk; ++kb) {
        const int r = w * kWsStages + s[w];   // ring w's stage
        mbar_wait(empty0 + 8 * r, phase[w] ^ 1);
        mbar_expect_tx(full0 + 8 * r, kWsBytesA);
        tma_load_2d(a0 + r * kWsBytesA, &map_a, full0 + 8 * r,
                    kb * hopper::kBK, tile * 64);
        if (++s[w] == kWsStages) { s[w] = 0; phase[w] ^= 1; }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  mbar_wait(panel_bar, 0);
  int s = 0, phase = 0;
  for (int tile = wg; tile < mt; tile += 2) {
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < nk; ++kb) {
      const int r = wg * kWsStages + s;
      mbar_wait(full0 + 8 * r, phase);
      const uint32_t a = a0 + r * kWsBytesA;
      const uint32_t b = panel + kb * kWsBytesPanel;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < hopper::kBK / 16; ++kk)
        wgmma_m64n128k16(acc, desc_a(a + kk * 32), desc_b(b + kk * 2048));
      wgmma_commit();
      wgmma_wait_all();
      release(empty0 + 8 * r, t);
      if (++s == kWsStages) { s = 0; phase ^= 1; }
    }
    store_tile<kBN>(acc,
                    smem_raw + (staging - smem_u32(smem_raw)) +
                        (threadIdx.x / 32) * kStageWarpBytes,
                    c, M, N, tile * 64, n0, t);
  }
}

// Shared memory of one weight-stationary wgmma launch at depth K.
long long ws_wgmma_smem(int K) {
  const long long nk = (K + hopper::kBK - 1) / hopper::kBK;
  return hopper::kSmemAlign + nk * kWsBytesPanel +
         2 * kWsStages * kWsBytesA + 8 * hopper::kStageWarpBytes +
         (4 * kWsStages + 1) * 8;
}

constexpr int kMaxSmem = 232448;

int launch_wgmma(const void* a, const void* b, void* c, int M, int K, int N,
                 int weight_stationary, int group_m, cudaStream_t stream) {
  using namespace hopper;
  if (K % 8 || N % 8 || (reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c)) % 16)
    return -1;
  CUtensorMap map_a, map_b;   // A in boxes of 128 rows (64 weight-stationary)
  int err = make_map_2d(&map_a, a, M, K, weight_stationary ? 64 : 128);
  if (err) return err;
  err = make_map_2d(&map_b, b, K, N, 64);
  if (err) return err;
  auto* c_ = static_cast<__nv_bfloat16*>(c);
  if (!weight_stationary) {
    const Problem p{M, N, K, (M + 127) / 128, (N + 255) / 256, group_m, 1,
                    nullptr, c_};
    return launch_ring<256, 2, 4>(map_a, map_b, p, stream);
  }
  const long long smem = ws_wgmma_smem(K);
  if (smem > kMaxSmem) return -1;
  cudaError_t e = cudaFuncSetAttribute(
      masa_ws_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  masa_ws_wgmma_kernel<<<(N + kBN - 1) / kBN, 3 * kWarpgroup, smem,
                         stream>>>(map_a, map_b, M, N, K, c_);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------- the tf32x3 bodies
// fp32 products on the TF32 tensor cores, three mma.sync a product
// (tf32x3.cuh). Both orders take 8 warps of 64 x 32 outputs (4 x 4 mma
// tiles) and split each fragment as it is loaded from shared memory; each
// 32-deep stage sums into a fresh tile (tf32x3::stage, which says why).
using tf32x3::kTfBK;
using tf32x3::kTfPitchA;
using tf32x3::kTfPitchB;
static_assert(tf32x3::kTfBN == kBN, "the tf32x3 tile's columns are C's");
constexpr int kTfThreads = 256;
constexpr int kTfStageA = 128 * kTfPitchA;   // one [128][32] A stage, floats
// Output-stationary: a 128 x 128 tile of C a block, a ring of 4 stages of
// A [128][32] and B [32][128] (37 KB a stage).
constexpr int kTfOsStages = 4;
constexpr int kTfOsStage = kTfStageA + kTfBK * kTfPitchB;
constexpr int kTfOsSmem = kTfOsStages * kTfOsStage * 4;
// Weight-stationary: the [K, 128] panel of B resident, K rounded up to a
// stage and zero-filled; A through a ring of 3 stages of [128][32].
constexpr int kTfWsStages = 3;

__global__ void __launch_bounds__(kTfThreads, 1)
masa_os_tf32x3_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* __restrict__ c,
                      int M, int K, int N, int group_m) {
  using namespace tf32x3;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int tm, tn;
  hopper::raster(blockIdx.x, (M + 127) / 128, (N + kBN - 1) / kBN, group_m,
                 &tm, &tn);
  const int m0 = tm * 128, n0 = tn * kBN;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int nk = (K + kTfBK - 1) / kTfBK;
  auto load_stage = [&](int kb) {
    float* as = smem + (kb % kTfOsStages) * kTfOsStage;
    load_tile<128, kTfBK, kTfThreads>(as, kTfPitchA, a, K, m0, kb * kTfBK, M,
                                      K, tid);
    load_tile<kTfBK, kBN, kTfThreads>(as + kTfStageA, kTfPitchB, b, N,
                                      kb * kTfBK, n0, K, N, tid);
  };

  float acc[4][4][4] = {};
#pragma unroll
  for (int s = 0; s < kTfOsStages - 1; ++s) {
    if (s < nk) load_stage(s);
    async_cluster::commit_async();
  }
  for (int kb = 0; kb < nk; ++kb) {
    // stage kb has landed; every warp is past stage kb - 1, whose slot the
    // next load takes
    async_cluster::wait_async<kTfOsStages - 2>();
    __syncthreads();
    if (kb + kTfOsStages - 1 < nk) load_stage(kb + kTfOsStages - 1);
    async_cluster::commit_async();
    const float* as = smem + (kb % kTfOsStages) * kTfOsStage;
    tf32x3::stage(acc, as, as + kTfStageA, wm, wn, lane);
  }
  tf32x3::store(acc, c, M, N, m0 + wm, n0 + wn, lane);
}

// Depth of the resident panel: K rounded up to whole stages.
__host__ __device__ inline int ws_panel_rows(int K) {
  return (K + kTfBK - 1) / kTfBK * kTfBK;
}

// Block b keeps B[:, 128 b : 128 b + 128] resident and walks A in 128-row
// tiles through one ring: stage s is row tile s / nk, depth step s % nk, so
// the next tile's first stages load while this one's last ones compute.
__global__ void __launch_bounds__(kTfThreads, 1)
masa_ws_tf32x3_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* __restrict__ c,
                      int M, int K, int N) {
  using namespace tf32x3;
  extern __shared__ float4 smem4[];
  const int kp = ws_panel_rows(K);
  float* panel = reinterpret_cast<float*>(smem4);   // [kp][132]
  float* ring = panel + kp * kTfPitchB;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int n0 = blockIdx.x * kBN;
  const int nk = kp / kTfBK, total = (M + 127) / 128 * nk;

  for (int e = tid; e < kp * (kBN / 4); e += kTfThreads) {
    const int r = e / (kBN / 4), col = (e % (kBN / 4)) * 4;
    float* d = panel + r * kTfPitchB + col;
    if (r < K && n0 + col < N)
      async_cluster::copy_async(d, b + (size_t)r * N + n0 + col, 16);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  async_cluster::commit_async();
  auto load_stage = [&](int s) {
    load_tile<128, kTfBK, kTfThreads>(ring + (s % kTfWsStages) * kTfStageA,
                                      kTfPitchA, a, K, (s / nk) * 128,
                                      (s % nk) * kTfBK, M, K, tid);
  };
#pragma unroll
  for (int s = 0; s < kTfWsStages - 1; ++s) {
    if (s < total) load_stage(s);
    async_cluster::commit_async();
  }

  float acc[4][4][4] = {};
  for (int s = 0; s < total; ++s) {
    // the panel and stage s have landed; every warp is past stage s - 1
    async_cluster::wait_async<kTfWsStages - 2>();
    __syncthreads();
    if (s + kTfWsStages - 1 < total) load_stage(s + kTfWsStages - 1);
    async_cluster::commit_async();
    const int kb = s % nk;
    tf32x3::stage(acc, ring + (s % kTfWsStages) * kTfStageA,
                  panel + kb * kTfBK * kTfPitchB, wm, wn, lane);
    if (kb == nk - 1)
      tf32x3::store(acc, c, M, N, (s / nk) * 128 + wm, n0 + wn, lane);
  }
}

// Shared memory of one weight-stationary tf32x3 launch at depth K.
long long ws_tf32x3_smem(int K) {
  return 4LL * ((long long)ws_panel_rows(K) * kTfPitchB +
                kTfWsStages * kTfStageA);
}

int launch_tf32x3(const void* a, const void* b, void* c, int M, int K, int N,
                  int weight_stationary, int group_m, cudaStream_t stream) {
  if (K % 4 || N % 4 || (reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c)) % 16)
    return -1;
  const float* a_ = static_cast<const float*>(a);
  const float* b_ = static_cast<const float*>(b);
  float* c_ = static_cast<float*>(c);
  if (!weight_stationary) {
    const long long tiles =
        (long long)((M + 127) / 128) * ((N + kBN - 1) / kBN);
    if (group_m < 1 || tiles > 0x7fffffff) return -1;
    int err = async_cluster::allow_smem(masa_os_tf32x3_kernel, kTfOsSmem);
    if (err) return err;
    masa_os_tf32x3_kernel<<<(unsigned)tiles, kTfThreads, kTfOsSmem, stream>>>(
        a_, b_, c_, M, K, N, group_m);
    return (int)cudaGetLastError();
  }
  const long long smem = ws_tf32x3_smem(K);
  if (smem > kMaxSmem) return -1;
  int err = async_cluster::allow_smem(masa_ws_tf32x3_kernel, (size_t)smem);
  if (err) return err;
  masa_ws_tf32x3_kernel<<<(N + kBN - 1) / kBN, kTfThreads, smem, stream>>>(
      a_, b_, c_, M, K, N);
  return (int)cudaGetLastError();
}

// The C entry's body codes (kernel.py's _BODY_CODE).
enum Body { kSimt = 0, kWgmma = 1, kTf32x3 = 2 };

}  // namespace

// One launch on `stream`: a [M, K], b [K, N], both bf16 if bf16 else f32
// -> c [M, N] in the same type. order 0 is output-stationary, 1
// weight-stationary. body 1 takes the wgmma body (bf16 only; tiles of
// output-stationary raster in groups of group_m row tiles), 2 the tf32x3
// body (fp32 only; K and N multiples of 4, 16-byte aligned bases; the same
// raster), 0 the simt body, whose weight-stationary order takes `smem`
// bytes of dynamic shared memory (the panel and the A tile). Returns the
// CUDA error of the launch (0 on success), -1 for arguments the body does
// not take, or one of hopper_gemm.cuh's tensor-map codes (100000 and up).
extern "C" int masa_gemm_launch(const void* a, const void* b, void* c, int M,
                                int K, int N, int order, int bf16, int body,
                                int group_m, long long smem, void* stream) {
  if (M < 1 || K < 1 || N < 1 || (order != 0 && order != 1)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (body) {
    case kWgmma:
      if (!bf16 || group_m < 1) return -1;
      return launch_wgmma(a, b, c, M, K, N, order, group_m, st);
    case kTf32x3:
      if (bf16) return -1;
      return launch_tf32x3(a, b, c, M, K, N, order, group_m, st);
    case kSimt:
      if (bf16)
        return launch_simt<__nv_bfloat16>(a, b, c, M, K, N, order, smem, st);
      return launch_simt<float>(a, b, c, M, K, N, order, smem, st);
    default:
      return -1;
  }
}
