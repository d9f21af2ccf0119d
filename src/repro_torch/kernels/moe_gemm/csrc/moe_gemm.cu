// Grouped expert GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel grouped_matmul_kernel (src/repro/kernels/moe_gemm/
// kernel.py:28, pallas_call :47, body _body):
//
//   y[T, F] = x_sorted[T, D] @ W[block_eids[t / bt], D, F]
//
// x and W both f32 or both bf16, products summed in fp32, y written once in
// x's type. Tokens arrive sorted by expert in blocks of bt rows; each block's
// expert id designates the weight panel it multiplies (the TPU kernel's
// scalar-prefetched index map). Two bodies, chosen by the wrapper (kernel.py's
// body()) before the launch and counted there:
//
// wgmma body (bf16, D % 8 == 0, F % 8 == 0, bt % 64 == 0, 16-byte aligned
// bases). What bounds it: at jamba's MoE shape (16 experts x 384 tokens, D
// 4096, F 14336) the product is 722 GFLOP, 0.73 ms at the bf16 tensor-core
// peak, and W holds 1.88 GB, 0.56 ms at 3.35 TB/s if each byte is read
// once: nearly balanced, so both the tensor cores and the W reads matter.
//   * hopper_gemm.cuh's ring kernel: one block per tile of 128 token rows
//     (two consumer warpgroups, when bt % 128 == 0) or 64 (one, when only
//     bt % 64 == 0) by 256 columns of F, wgmma m64n256k16 with fp32
//     accumulators in registers, a producer thread keeping TMA loads of x
//     and W in flight through a ring of 4 stages. A tile never straddles two
//     token blocks; the producer reads block_eids[m0 / bt] and loads W
//     through a rank-3 tensor map [E, D, F] at that expert's coordinate, so
//     D's ragged edge is zero-filled inside the expert. The epilogue rounds
//     to bf16 once and writes through shared memory in 16-byte pieces.
//   * The raster is the designation's row-buffer hit moved to L2: tiles
//     launch in groups of 12 row tiles, M fastest within one 256-column
//     tile of F (hopper::raster), so the token blocks of one expert (3 at
//     jamba's capacity) read the same [D, 256] W tile side by side and W
//     comes from device memory about once, while the group's 12 MB of x
//     stays in L2 across its columns. The raster follows the linear token
//     block index whatever block_eids holds.
// simt body (fp32, and the shapes above it does not take, e.g. bt 24): one
// block of threads per tile of TM token rows by 128 columns of F, D walked
// in steps of 16 through shared memory with fp32 FMAs on the CUDA cores;
// TM is the largest of 128, 64, 32, 16, 8 and 1 that divides bt. Edges of
// D and F are masked.
#include "../../csrc/hopper_gemm.cuh"

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
int launch_simt(const void* x, const void* w, const int* eids, void* y, int T_,
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
int dispatch_simt(const void* x, const void* w, const int* eids, void* y, int T_,
             int D, int F, int bt, cudaStream_t st) {
  if (bt % 128 == 0) return launch_simt<T, 128>(x, w, eids, y, T_, D, F, bt, st);
  if (bt % 64 == 0) return launch_simt<T, 64>(x, w, eids, y, T_, D, F, bt, st);
  if (bt % 32 == 0) return launch_simt<T, 32>(x, w, eids, y, T_, D, F, bt, st);
  if (bt % 16 == 0) return launch_simt<T, 16>(x, w, eids, y, T_, D, F, bt, st);
  if (bt % 8 == 0) return launch_simt<T, 8>(x, w, eids, y, T_, D, F, bt, st);
  return launch_simt<T, 1>(x, w, eids, y, T_, D, F, bt, st);
}

// One wgmma launch (see the header). The tile is 128 rows when bt allows
// it, else 64.
int launch_wgmma(const void* x, const void* w, const int* eids, void* y,
                 int T_, int D, int F, int E, int bt, int group_m,
                 cudaStream_t stream) {
  if (D % 8 || F % 8 || bt % 64 || group_m < 1 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(y)) % 16)
    return -1;
  const int bm = bt % 128 == 0 ? 128 : 64;
  CUtensorMap map_x, map_w;
  int err = hopper::make_map_2d(&map_x, x, T_, D, bm);
  if (err) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)F, (cuuint64_t)D, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)F * 2, (cuuint64_t)D * F * 2};
  err = hopper::make_map(&map_w, w, 3, dims, strides, 64);
  if (err) return err;
  const hopper::Problem p{T_, F, D, T_ / bm, (F + 255) / 256, group_m, bt,
                          eids, static_cast<__nv_bfloat16*>(y)};
  if (bm == 128)
    return hopper::launch_ring<256, 2, 4>(map_x, map_w, p, stream);
  return hopper::launch_ring<256, 1, 4>(map_x, map_w, p, stream);
}

}  // namespace

// One launch on `stream`: x [T, D], w [E, D, F], both bf16 if bf16 else
// f32, block_eids [T / bt] int32 in [0, E) -> y [T, F] in x's type. wgmma 1
// takes the wgmma body (bf16 only; tiles raster in groups of group_m row
// tiles), 0 the simt body. Returns the CUDA error of the launch (0 on
// success), -1 for arguments the body does not take, or one of
// hopper_gemm.cuh's tensor-map codes (100000 and up).
extern "C" int moe_gemm_launch(const void* x, const void* w, const void* eids,
                               void* y, int T_, int D, int F, int E, int bt,
                               int bf16, int wgmma, int group_m,
                               void* stream) {
  if (T_ < 1 || D < 1 || F < 1 || E < 1 || bt < 1 || T_ % bt != 0)
    return -1;
  const int* ids = static_cast<const int*>(eids);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wgmma) {
    if (!bf16) return -1;
    return launch_wgmma(x, w, ids, y, T_, D, F, E, bt, group_m, st);
  }
  if (bf16)
    return dispatch_simt<__nv_bfloat16>(x, w, ids, y, T_, D, F, bt, st);
  return dispatch_simt<float>(x, w, ids, y, T_, D, F, bt, st);
}
