// MASA-tiled matmul C = A @ B for Hopper (sm_90a).
//
// Replaces the TPU kernel masa_gemm_kernel (src/repro/kernels/masa_gemm/
// kernel.py:53, pallas_call :66 output-stationary / :81 weight-stationary,
// bodies _kernel_os and _kernel_ws): A [M, K], B [K, N], both f32 or both
// bf16, products summed in fp32 and C written once in A's type. Two
// residency orders, as on the TPU, and two bodies, chosen by the wrapper
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
// simt body (fp32, and bf16 shapes the wgmma body does not take, e.g. K
// 500): fp32 FMAs on the CUDA cores, both operands from shared memory.
//   output-stationary  one block per 128 x 128 tile of C; K walked in
//                      steps of 16, the accumulator in registers (8 x 8 a
//                      thread).
//   weight-stationary  the [K, 128] panel and a [64, K] tile of A in
//                      shared memory, (64 + 128) * K elements: the
//                      wrapper's ws_panel_bytes, passed to the launch.
// Edges are masked (TMA's zero fill and a masked epilogue on the wgmma
// body), so any M, K, N is taken; the wrapper keeps the reference's
// divisibility checks.
#include "../../csrc/hopper_gemm.cuh"

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

}  // namespace

// One launch on `stream`: a [M, K], b [K, N], both bf16 if bf16 else f32
// -> c [M, N] in the same type. order 0 is output-stationary, 1
// weight-stationary. wgmma 1 takes the wgmma body (bf16 only; tiles of
// output-stationary raster in groups of group_m row tiles), 0 the simt
// body, whose weight-stationary order takes `smem` bytes of dynamic shared
// memory (the panel and the A tile). Returns the CUDA error of the launch
// (0 on success), -1 for arguments the body does not take, or one of
// hopper_gemm.cuh's tensor-map codes (100000 and up).
extern "C" int masa_gemm_launch(const void* a, const void* b, void* c, int M,
                                int K, int N, int order, int bf16, int wgmma,
                                int group_m, long long smem, void* stream) {
  if (M < 1 || K < 1 || N < 1 || (order != 0 && order != 1)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wgmma) {
    if (!bf16 || group_m < 1) return -1;
    return launch_wgmma(a, b, c, M, K, N, order, group_m, st);
  }
  if (bf16)
    return launch_simt<__nv_bfloat16>(a, b, c, M, K, N, order, smem, st);
  return launch_simt<float>(a, b, c, M, K, N, order, smem, st);
}
