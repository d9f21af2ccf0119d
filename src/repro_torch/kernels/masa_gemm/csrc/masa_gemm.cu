// MASA-tiled matmul C = A @ B for Hopper (sm_90a), fp32 FMA loops.
//
// Replaces the TPU kernel masa_gemm_kernel (src/repro/kernels/masa_gemm/
// kernel.py, bodies _kernel_os and _kernel_ws): A [M, K], B [K, N], both
// f32 or both bf16, products summed in fp32 and C written once in A's type.
// Two residency orders, as on the TPU:
//
//   output-stationary  one block per 128 x 128 tile of C; K is walked
//                      innermost in steps of 16 through shared memory and
//                      the fp32 accumulator stays in registers (8 x 8 a
//                      thread).
//   weight-stationary  one block per 128-column panel of B: the [K, 128]
//                      panel is loaded into shared memory once and stays
//                      there while the block walks every 64-row tile of A
//                      ([64, K], also in shared memory) against it, the
//                      Pallas grid (N/bn, M/bm) with M innermost. The
//                      panel and the A tile take (64 + 128) * K elements of
//                      shared memory, which the wrapper counts
//                      (kernel.py's ws_panel_bytes) and passes to the
//                      launch; ops.py falls back to output-stationary when
//                      that exceeds what a block may have.
//
// What bounds it: operations. At the shapes the port times (M 2048, K
// 4096, N 14336) the product is 240 GFLOP against 0.2 GB of traffic; in
// bf16 the tensor cores would finish it in 0.24 ms. This first form runs
// fp32 FMAs on the CUDA cores (67 TFLOP/s at best), reading both operands
// from shared memory, so it stays well above the bf16 bound; wgmma, TMA
// and a pipelined ring of tiles are later work. Edges are masked, so any
// M, K, N is taken; the wrapper keeps the reference's divisibility checks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBN = 128;   // columns of a tile of C (both orders)
constexpr int kRN = 8;     // columns of C a thread owns
constexpr int kBK = 16;    // depth of one K step (output-stationary)
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
  __shared__ float As[kBK][kOsBM + 4];   // A tile, transposed
  __shared__ float Bs[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kRN), ty = tid / (kBN / kRN);
  const int m0 = blockIdx.y * kOsBM, n0 = blockIdx.x * kBN;
  float acc[kOsRM][kRN];
#pragma unroll
  for (int i = 0; i < kOsRM; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kOsBM * kBK; e += kThreads) {
      const int r = e / kBK, k = e - r * kBK;
      const int gm = m0 + r, gk = k0 + k;
      As[k][r] = gm < M && gk < K ? to_f(a[(size_t)gm * K + gk]) : 0.f;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int k = e / kBN, n = e - k * kBN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = gk < K && gn < N ? to_f(b[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
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
int launch(const void* a, const void* b, void* c, int M, int K, int N,
           int weight_stationary, long long smem, cudaStream_t stream) {
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

}  // namespace

// One launch on `stream`: a [M, K], b [K, N], both bf16 if bf16 else f32
// -> c [M, N] in the same type. order 0 is output-stationary, 1
// weight-stationary with `smem` bytes of dynamic shared memory (the panel
// and the A tile; unused by order 0). Returns the CUDA error of the launch
// (0 on success), or -1 for arguments the kernel does not take.
extern "C" int masa_gemm_launch(const void* a, const void* b, void* c, int M,
                                int K, int N, int order, int bf16,
                                long long smem, void* stream) {
  if (M < 1 || K < 1 || N < 1 || (order != 0 && order != 1)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(a, b, c, M, K, N, order, smem, st);
  return launch<float>(a, b, c, M, K, N, order, smem, st);
}
