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
// scalar-prefetched index map). Four bodies, chosen by the wrapper
// (kernel.py's body()) before the launch and counted there:
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
// stream body (fp32 or bf16, bt a multiple of 8 up to 32, F's rows whole
// 16-byte units, 16-byte aligned bases): the token blocks too short for the
// tensor cores, as moonshot's MoE FFN sends them (capacity 16 at a
// 128-token prefill, 8 at a decode step). What bounds it: each W element is
// used bt times, 2 bt FLOP for its 4 bytes in fp32 (8 FLOP a byte at bt 16),
// below the ~20 FLOP a byte at which the CUDA cores (67 TFLOP/s) and not
// the memory (3.35 TB/s) would be the limit. So the launch is bound by
// reading the expert weights once: at moonshot's shapes (64 experts, D
// 2048, F 1408) 738 MB, 0.2246 ms at C 16 and 0.2225 ms at C 8 with x and
// y. The simt body reached 20% of that: each block loaded one 16-row tile
// of W by scalar loads, then computed while nothing was in flight, so an
// SM had a few KB of requests outstanding where 3.35 TB/s at the memory's
// latency needs some 20 KB or more on each SM. This body keeps the copies
// in flight while it computes:
//   * one block of 4 warps per (token block, 128 columns of F); at the
//     capacity layout a token block is one expert's, so each W byte is
//     read from device memory once;
//   * the block streams its expert's [D, 128] panel through a ring of
//     kStages (4) stages of kWBytes (16 KB) of W (32 rows in fp32, 64 in
//     bf16) by 16-byte cp.async copies (async_cluster.cuh), x's [bt, depth]
//     slice in the same stage (1 KB at bt 8 to 4 KB at bt 32); 3 stages are
//     in flight while one is multiplied, 51 KB a block at bt 8 to 60 KB at
//     bt 32. Shared memory holds 3 blocks a SM up to bt 16 and 2 above it,
//     and registers (4 bt sums a thread) 2 from bt 16 in fp32 and bt 24 in
//     bf16, so 108 to 162 KB are outstanding on each SM. The ring is the
//     one bt 32 runs well: rings of 3 stages of 32 KB
//     are some 3% faster at bt 8 and 16 but hold one block a SM and run bt
//     32 at half the speed, and 8 KB stages keep too little in flight
//     (PERF.md has the timings);
//   * each thread owns 4 adjacent columns for all bt rows (4 bt fp32
//     accumulators; bf16 is widened to fp32 on the read: 8 columns would
//     need 256 accumulators at bt 32, more than a thread's 255 registers),
//     and the 4 warps take a quarter of each stage's depth each;
//   * the warps' partial sums are added through shared memory in one fixed
//     order at the end (warp 0's + warp 1's + warp 2's + warp 3's), so two
//     launches on the same inputs are bit-equal: no atomics, D is never
//     split across blocks. D's ragged edge, and F's past the last whole
//     tile, are zero-filled; x's rows are copied in the largest unit of 16,
//     8, 4 (or, for bf16 at odd D, 2 bytes by plain loads) that their
//     alignment allows.
// tf32x3 body (fp32, bt a multiple of 8 past 32, D and F multiples of 4,
// 16-byte aligned bases: rows of whole 16-byte cp.async units). What
// bounds it: operations. At jamba's shape the product is 721.6 GFLOP,
// 10.77 ms at the CUDA cores' 67 TFLOP/s (the simt body took 25.66 and
// torch.bmm's SGEMM 13.60 on an H100), 4.376 ms as three TF32 products a
// product at 494.7 TFLOP/s. So it is masa's output-stationary tf32x3 tile
// (tf32x3.cuh) with the token block's expert panel as B:
//   * one block of 8 warps per 128 x 128 tile of y, each warp 64 x 32
//     outputs as 4 x 4 mma.sync m16n8k8 tiles, three TF32 products a
//     product (each fragment split as it is loaded); or 4 warps per 64 x
//     128 tile (below). D in stages of 32 through a 4-stage cp.async ring
//     of x [rows][40] and W [32][132] (146 KB at 128 rows, 109 KB at 64,
//     two blocks a SM); each stage sums into a fresh tile that an fp32 add
//     takes into the running sum (jamba's D is 4096);
//   * a tile never straddles two token blocks: block i's rows [i bt,
//     (i + 1) bt) are cut into ceil(bt / rows) row tiles, rows past the
//     token block's end are zero-filled on load and masked on store, and
//     the tile reads W from w + block_eids[i] D F. D's ragged edge past
//     the last stage and F's past the last 128 columns are zero-filled;
//   * tiles launch in hopper::raster's groups of group_m row tiles, M
//     fastest within one column tile, so the token blocks of one expert
//     (3 at jamba's capacity 384) read the same [D, 128] W tile side by
//     side and W comes from device memory about once;
//   * rows a tile: 64 when 64-row tiles cover the token block in fewer
//     rows than 128-row ones (bt 40 to 64, 136 to 192, 264 to 320, ...),
//     else 128 (bt 72 to 128, such as moonshot's capacity 120 at a
//     1024-token prefill and jamba's 128, and 200 to 256, ...). Built with
//     -DMOE_TF32X3_ROWS=64 or =128 every launch takes that tile instead;
//     tests/check_torch_tf32x3.py times both. On an H100 the rule picked
//     the faster tile at 9 of 11 shapes: 64 rows took 0.53x the time at
//     moonshot's bt 40 and 64 and 0.76x at 192, 128 rows 0.96x at 240,
//     256 and 384, 0.96x on the down product at 120 and 0.90x at jamba's
//     shape; it lost 4.5% and 5.4% on moonshot's up product at 120 and
//     128.
// simt body (fp32 and bf16 at every other shape, e.g. bf16 at bt 40 or
// 120, bt 12, or F's rows not whole 16-byte units): one block of threads
// per tile of TM token rows by 128 columns of F, D walked in steps of 16
// through shared memory with fp32 FMAs on the CUDA cores; TM is the
// largest of 128, 64, 32, 16, 8 and 1 that divides bt. Edges of D and F
// are masked.
#include "../../csrc/async_cluster.cuh"
#include "../../csrc/hopper_gemm.cuh"
#include "../../csrc/tf32x3.cuh"

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

// ---- the stream body (see the header)
namespace stream_body {

namespace ac = async_cluster;

constexpr int kN = 128;              // columns of F a block covers
constexpr int kWarps = 4;            // warps a block; they split the depth
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 4;           // stages of the ring
constexpr int kWBytes = 16384;       // W bytes of one stage

// Rows of W one stage holds, the bytes of a stage (W, then x's [bt, depth]
// slice) and of the block's shared memory: the ring, or the warps'
// partial sums at the end if those are larger.
template <typename T>
__host__ __device__ constexpr int depth() {
  return kWBytes / (kN * (int)sizeof(T));
}
template <typename T, int BT>
__host__ __device__ constexpr int stage_bytes() {
  return kWBytes + BT * depth<T>() * (int)sizeof(T);
}
template <typename T, int BT>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<T, BT>() > kWarps * BT * kN * 4
             ? kStages * stage_bytes<T, BT>()
             : kWarps * BT * kN * 4;
}

// Zeros for a unit of `unit` bytes (16, 8, 4 or 2) past D or F, where
// ac::copy_async would have copied one.
__device__ __forceinline__ void zero_unit(void* dst, int unit) {
  if (unit == 16)
    *static_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  else if (unit == 8)
    *static_cast<uint2*>(dst) = make_uint2(0, 0);
  else if (unit == 4)
    *static_cast<unsigned*>(dst) = 0;
  else
    *static_cast<unsigned short*>(dst) = 0;
}

// Four adjacent elements from shared memory, widened to fp32 (bf16 to
// fp32 is exact: its bits are the high half of the float's).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, float4 s) {
  *reinterpret_cast<float4*>(p) = s;
}
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         (unsigned)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 s) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16_pair(s.x, s.y), bf16_pair(s.z, s.w));
}

// Copy stage k0 (W rows [k0, k0 + depth) of the block's 128 columns, and
// x's [BT, depth] slice) into `st`; every thread issues its share.
template <typename T, int BT>
__device__ __forceinline__ void load_stage(char* st, const T* xb, const T* we,
                                           int k0, int D, int F, int n0,
                                           int xunit) {
  constexpr int KS = depth<T>();
  constexpr int EPC = 16 / (int)sizeof(T);   // elements of a 16-byte chunk
  constexpr int CPR = kN / EPC;              // chunks of a W row
  T* ws = reinterpret_cast<T*>(st);
  for (int c = threadIdx.x; c < KS * CPR; c += kThreads) {
    const int r = c / CPR, n = (c - r * CPR) * EPC;
    if (k0 + r < D && n0 + n < F)
      ac::copy_async(ws + r * kN + n, we + (size_t)(k0 + r) * F + n0 + n,
                     16);
    else
      zero_unit(ws + r * kN + n, 16);
  }
  T* xs = reinterpret_cast<T*>(st + kWBytes);
  const int epu = xunit / (int)sizeof(T);    // elements of a unit
  const int upr = KS / epu;                  // units of a row of the slice
  for (int c = threadIdx.x; c < BT * upr; c += kThreads) {
    const int r = c / upr, k = (c - r * upr) * epu;
    if (k0 + k < D)
      ac::copy_async(xs + r * KS + k, xb + (size_t)r * D + k0 + k, xunit);
    else
      zero_unit(xs + r * KS + k, xunit);
  }
}

// One block: token block tb = blockIdx.x / n_tiles (its expert is
// eids[tb]), columns n0 = (blockIdx.x % n_tiles) * 128.
template <typename T, int BT>
__global__ void __launch_bounds__(kThreads)
moe_gemm_stream_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const int* __restrict__ eids, T* __restrict__ y,
                       int D, int F, int n_tiles, int xunit) {
  constexpr int KS = depth<T>(), KW = KS / kWarps;
  constexpr int SB = stage_bytes<T, BT>();
  static_assert(KW % 4 == 0, "a warp's share of a stage is whole fours");
  extern __shared__ __align__(16) char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tb = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x - tb * n_tiles) * kN;
  const T* xb = x + (size_t)tb * BT * D;
  // the designation: this token block's expert selects W's panel
  const T* we = w + (size_t)eids[tb] * D * F;
  const int nk = (D + KS - 1) / KS;
  float acc[BT][4];
#pragma unroll
  for (int r = 0; r < BT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage<T, BT>(smem + s * SB, xb, we, s * KS, D, F, n0,
                                  xunit);
    ac::commit_async();
  }
  for (int kt = 0; kt < nk; ++kt) {
    // this thread's copies of stage kt have landed
    ac::wait_async<kStages - 2>();
    __syncthreads();       // everyone's; and stage kt - 1 is free again
    const int next = kt + kStages - 1;
    if (next < nk)
      load_stage<T, BT>(smem + (next % kStages) * SB, xb, we, next * KS, D,
                        F, n0, xunit);
    ac::commit_async();
    const char* st = smem + (kt % kStages) * SB;
    const T* ws = reinterpret_cast<const T*>(st) + warp * KW * kN + lane * 4;
    const T* xs = reinterpret_cast<const T*>(st + kWBytes) + warp * KW;
#pragma unroll
    for (int kk = 0; kk < KW; kk += 4) {
      float wv[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) load4(ws + (kk + j) * kN, wv[j]);
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        float xv[4];
        load4(xs + r * KS + kk, xv);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = fmaf(xv[j], wv[j][c], acc[r][c]);
      }
    }
  }
  ac::wait_async<0>();
  __syncthreads();
  // the warps' partial sums, added in one fixed order
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < BT; ++r)
    *reinterpret_cast<float4*>(part + (warp * BT + r) * kN + lane * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int i = threadIdx.x; i < BT * (kN / 4); i += kThreads) {
    const int r = i / (kN / 4), n = (i - r * (kN / 4)) * 4;
    if (n0 + n >= F) continue;
    float4 s = *reinterpret_cast<const float4*>(part + r * kN + n);
#pragma unroll
    for (int v = 1; v < kWarps; ++v) {
      const float4 p =
          *reinterpret_cast<const float4*>(part + (v * BT + r) * kN + n);
      s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
    }
    store4(y + (size_t)(tb * BT + r) * F + n0 + n, s);
  }
}

template <typename T, int BT>
int launch(const void* x, const void* w, const int* eids, void* y, int T_,
           int D, int F, int xunit, cudaStream_t stream) {
  const int err =
      ac::allow_smem(moe_gemm_stream_kernel<T, BT>, smem_bytes<T, BT>());
  if (err) return err;
  const int n_tiles = (F + kN - 1) / kN;
  const long long blocks = (long long)(T_ / BT) * n_tiles;
  if (blocks > 0x7fffffffLL) return -1;
  moe_gemm_stream_kernel<T, BT>
      <<<(unsigned)blocks, kThreads, smem_bytes<T, BT>(), stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(w), eids,
          static_cast<T*>(y), D, F, n_tiles, xunit);
  return (int)cudaGetLastError();
}

// The stream body's shapes: bt 8, 16, 24 or 32, F's rows whole 16-byte
// units, w and y 16-byte aligned; x's rows are copied in the largest unit
// of 16, 8, 4 or 2 bytes that divides both its base and its row's bytes.
template <typename T>
int dispatch(const void* x, const void* w, const int* eids, void* y, int T_,
             int D, int F, int bt, cudaStream_t st) {
  if ((F * sizeof(T)) % 16 ||
      (reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(y)) % 16)
    return -1;
  const int xunit =
      ac::copy_unit({reinterpret_cast<uintptr_t>(x), D * sizeof(T)});
  switch (bt) {
    case 8: return launch<T, 8>(x, w, eids, y, T_, D, F, xunit, st);
    case 16: return launch<T, 16>(x, w, eids, y, T_, D, F, xunit, st);
    case 24: return launch<T, 24>(x, w, eids, y, T_, D, F, xunit, st);
    case 32: return launch<T, 32>(x, w, eids, y, T_, D, F, xunit, st);
    default: return -1;
  }
}

}  // namespace stream_body

// ---- the tf32x3 body (see the header)
namespace tf32x3_body {

namespace tx = tf32x3;

#ifndef MOE_TF32X3_ROWS
#define MOE_TF32X3_ROWS 0
#endif
constexpr int kForcedRows = MOE_TF32X3_ROWS;   // 0: rows by tile_rows
constexpr int kStages = 4;                     // stages of the ring
constexpr int kMinBt = 33;   // shorter token blocks are the stream body's

// Threads of a block with a tile of BM rows (a warp a 64 x 32 block of
// outputs) and its shared memory: kStages stages of x [BM][40] and W
// [32][132].
template <int BM>
__host__ __device__ constexpr int threads() {
  return BM / 64 * 4 * 32;
}
template <int BM>
__host__ __device__ constexpr int stage_floats() {
  return BM * tx::kTfPitchA + tx::kTfBK * tx::kTfPitchB;
}
template <int BM>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_floats<BM>() * 4;
}

// Row tile tm holds rows [r0, min(r0 + BM, (tb + 1) bt)) of token block tb
// = tm / tpb, where r0 = tb bt + (tm % tpb) BM and tpb = ceil(bt / BM)
// (kernel.py's tf32x3_tiles mirrors it).
template <int BM>
__global__ void __launch_bounds__(threads<BM>(), 128 / BM)
moe_gemm_tf32x3_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const int* __restrict__ eids, float* __restrict__ y,
                       int D, int F, int bt, int tpb, int mt, int group_m) {
  constexpr int NT = threads<BM>();
  constexpr int SA = BM * tx::kTfPitchA;   // floats of a stage's x tile
  constexpr int SS = stage_floats<BM>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int tm, tn;
  hopper::raster(blockIdx.x, mt, (F + tx::kTfBN - 1) / tx::kTfBN, group_m,
                 &tm, &tn);
  const int tb = tm / tpb;
  const int r0 = tb * bt + (tm - tb * tpb) * BM, r_end = (tb + 1) * bt;
  const int n0 = tn * tx::kTfBN;
  // the designation: this token block's expert selects W's panel
  const float* we = w + (size_t)eids[tb] * D * F;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int nk = (D + tx::kTfBK - 1) / tx::kTfBK;
  auto load_stage = [&](int kb) {
    float* st = smem + (kb % kStages) * SS;
    // rows past the token block's end read as zeros
    tx::load_tile<BM, tx::kTfBK, NT>(st, tx::kTfPitchA, x, D, r0,
                                     kb * tx::kTfBK, r_end, D, tid);
    tx::load_tile<tx::kTfBK, tx::kTfBN, NT>(st + SA, tx::kTfPitchB, we, F,
                                            kb * tx::kTfBK, n0, D, F, tid);
  };

  float acc[4][4][4] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s);
    async_cluster::commit_async();
  }
  for (int kb = 0; kb < nk; ++kb) {
    // stage kb has landed; every warp is past stage kb - 1, whose slot the
    // next load takes
    async_cluster::wait_async<kStages - 2>();
    __syncthreads();
    if (kb + kStages - 1 < nk) load_stage(kb + kStages - 1);
    async_cluster::commit_async();
    const float* st = smem + (kb % kStages) * SS;
    tx::stage(acc, st, st + SA, wm, wn, lane);
  }
  tx::store(acc, y, r_end, F, r0 + wm, n0 + wn, lane);
}

template <int BM>
int launch(const float* x, const float* w, const int* eids, float* y, int T_,
           int D, int F, int bt, int group_m, cudaStream_t stream) {
  const int tpb = (bt + BM - 1) / BM;
  const long long mt = (long long)(T_ / bt) * tpb;
  const long long tiles = mt * ((F + tx::kTfBN - 1) / tx::kTfBN);
  if (tiles > 0x7fffffffLL) return -1;
  const int err =
      async_cluster::allow_smem(moe_gemm_tf32x3_kernel<BM>, smem_bytes<BM>());
  if (err) return err;
  moe_gemm_tf32x3_kernel<BM>
      <<<(unsigned)tiles, threads<BM>(), smem_bytes<BM>(), stream>>>(
          x, w, eids, y, D, F, bt, tpb, (int)mt, group_m);
  return (int)cudaGetLastError();
}

// Rows of a tile at token blocks of bt: 64 when 64-row tiles cover the
// block in fewer rows than 128-row ones, else 128 (kernel.py's
// tf32x3_rows mirrors it).
int tile_rows(int bt) {
  if (kForcedRows) return kForcedRows;
  return (bt + 63) / 64 * 64 < (bt + 127) / 128 * 128 ? 64 : 128;
}

// The tf32x3 body's shapes (see the header).
int dispatch(const void* x, const void* w, const int* eids, void* y, int T_,
             int D, int F, int bt, int group_m, cudaStream_t st) {
  if (D % 4 || F % 4 || bt % 8 || bt < kMinBt || group_m < 1 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(y)) % 16)
    return -1;
  const auto* x_ = static_cast<const float*>(x);
  const auto* w_ = static_cast<const float*>(w);
  auto* y_ = static_cast<float*>(y);
  if (tile_rows(bt) == 64)
    return launch<64>(x_, w_, eids, y_, T_, D, F, bt, group_m, st);
  return launch<128>(x_, w_, eids, y_, T_, D, F, bt, group_m, st);
}

}  // namespace tf32x3_body

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
// f32, block_eids [T / bt] int32 in [0, E) -> y [T, F] in x's type. body 1
// takes the wgmma body (bf16 only; tiles raster in groups of group_m row
// tiles), 2 the stream body, 3 the tf32x3 body (f32 only; the same
// raster), 0 the simt body. Returns the CUDA error of the launch (0 on
// success), -1 for arguments the body does not take, or one of
// hopper_gemm.cuh's tensor-map codes (100000 and up).
extern "C" int moe_gemm_launch(const void* x, const void* w, const void* eids,
                               void* y, int T_, int D, int F, int E, int bt,
                               int bf16, int body, int group_m,
                               void* stream) {
  if (T_ < 1 || D < 1 || F < 1 || E < 1 || bt < 1 || T_ % bt != 0)
    return -1;
  const int* ids = static_cast<const int*>(eids);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (!bf16) return -1;
    return launch_wgmma(x, w, ids, y, T_, D, F, E, bt, group_m, st);
  }
  if (body == 2) {
    if (bf16)
      return stream_body::dispatch<__nv_bfloat16>(x, w, ids, y, T_, D, F, bt,
                                                  st);
    return stream_body::dispatch<float>(x, w, ids, y, T_, D, F, bt, st);
  }
  if (body == 3) {
    if (bf16) return -1;
    return tf32x3_body::dispatch(x, w, ids, y, T_, D, F, bt, group_m, st);
  }
  if (body != 0) return -1;
  if (bf16)
    return dispatch_simt<__nv_bfloat16>(x, w, ids, y, T_, D, F, bt, st);
  return dispatch_simt<float>(x, w, ids, y, T_, D, F, bt, st);
}
