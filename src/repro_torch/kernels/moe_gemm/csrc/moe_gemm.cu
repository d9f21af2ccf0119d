// Grouped expert GEMM for Hopper (sm_90a), fp32 FMA loops.
//
// Replaces the TPU kernel grouped_matmul_kernel (src/repro/kernels/moe_gemm/
// kernel.py, body _body):
//
//   y[T, F] = x_sorted[T, D] @ W[block_eids[t / bt], D, F]
//
// x and W both f32 or both bf16, products summed in fp32, y written once in
// x's type. Tokens arrive sorted by expert in blocks of bt rows; each block's
// expert id designates the weight panel it multiplies (the TPU kernel's
// scalar-prefetched index map). Here one block of threads owns a tile of TM
// token rows by 128 columns of F: it reads its expert id from block_eids and
// walks D innermost in steps of 16 through shared memory, with the fp32
// accumulator in registers. TM is the largest of 128, 64, 32, 16, 8 and 1
// that divides bt, so a tile never straddles two token blocks.
//
// What bounds it: operations. At jamba's MoE shape (16 experts x 384
// tokens, D 4096, F 14336) the product is 722 GFLOP and W holds 1.9 GB in
// bf16, read by each of an expert's 3 token blocks (L2 catches some of it).
// The bf16 tensor cores would need 0.73 ms; this first form runs fp32 FMAs
// on the CUDA cores and stays well above that (wgmma, TMA and a pipelined
// ring of tiles are later work). Edges of D and F are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBN = 128;   // columns of F a tile covers
constexpr int kRN = 8;     // columns a thread owns
constexpr int kBK = 16;    // depth of one D step

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

// Rows a thread owns in a tile of TM rows, and the threads of a block.
template <int TM>
__host__ __device__ constexpr int rows_per_thread() {
  return TM >= 16 ? TM / 16 : 1;
}
template <int TM>
__host__ __device__ constexpr int threads() {
  return (TM / rows_per_thread<TM>()) * (kBN / kRN);
}

template <typename T, int TM>
__global__ void __launch_bounds__(threads<TM>())
moe_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const int* __restrict__ eids, T* __restrict__ y, int D,
                int F, int bt) {
  constexpr int RM = rows_per_thread<TM>();
  constexpr int NT = threads<TM>();
  __shared__ float Xs[kBK][TM + 4];   // x tile, transposed
  __shared__ float Ws[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kRN), ty = tid / (kBN / kRN);
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * kBN;
  // the designation: this token block's expert selects W's panel
  const T* we = w + (size_t)eids[m0 / bt] * D * F;
  float acc[RM][kRN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kBK) {
    for (int e = tid; e < TM * kBK; e += NT) {
      const int r = e / kBK, k = e - r * kBK;
      Xs[k][r] = k0 + k < D ? to_f(x[(size_t)(m0 + r) * D + k0 + k]) : 0.f;
    }
    for (int e = tid; e < kBK * kBN; e += NT) {
      const int k = e / kBN, n = e - k * kBN;
      const int gk = k0 + k, gn = n0 + n;
      Ws[k][n] = gk < D && gn < F ? to_f(we[(size_t)gk * F + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float av[RM], bv[kRN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = Xs[k][ty * RM + i];
#pragma unroll
      for (int j = 0; j < kRN; ++j) bv[j] = Ws[k][tx * kRN + j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const size_t gm = m0 + ty * RM + i;
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int gn = n0 + tx * kRN + j;
      if (gn < F) from_f(acc[i][j], &y[gm * F + gn]);
    }
  }
}

template <typename T, int TM>
int launch(const void* x, const void* w, const int* eids, void* y, int T_,
           int D, int F, int bt, cudaStream_t stream) {
  if (T_ / TM > 65535) return -1;   // the grid's y limit
  auto kernel = moe_gemm_kernel<T, TM>;
  dim3 grid((F + kBN - 1) / kBN, T_ / TM);
  kernel<<<grid, threads<TM>(), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), eids,
      static_cast<T*>(y), D, F, bt);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, const int* eids, void* y, int T_,
             int D, int F, int bt, cudaStream_t st) {
  if (bt % 128 == 0) return launch<T, 128>(x, w, eids, y, T_, D, F, bt, st);
  if (bt % 64 == 0) return launch<T, 64>(x, w, eids, y, T_, D, F, bt, st);
  if (bt % 32 == 0) return launch<T, 32>(x, w, eids, y, T_, D, F, bt, st);
  if (bt % 16 == 0) return launch<T, 16>(x, w, eids, y, T_, D, F, bt, st);
  if (bt % 8 == 0) return launch<T, 8>(x, w, eids, y, T_, D, F, bt, st);
  return launch<T, 1>(x, w, eids, y, T_, D, F, bt, st);
}

}  // namespace

// One launch on `stream`: x [T, D], w [E, D, F], both bf16 if bf16 else
// f32, block_eids [T / bt] int32 in [0, E) -> y [T, F] in x's type. Returns
// the CUDA error of the launch (0 on success), or -1 for arguments the
// kernel does not take.
extern "C" int moe_gemm_launch(const void* x, const void* w, const void* eids,
                               void* y, int T_, int D, int F, int bt,
                               int bf16, void* stream) {
  if (T_ < 1 || D < 1 || F < 1 || bt < 1 || T_ % bt != 0) return -1;
  const int* ids = static_cast<const int*>(eids);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(x, w, ids, y, T_, D, F, bt, st);
  return dispatch<float>(x, w, ids, y, T_, D, F, bt, st);
}
