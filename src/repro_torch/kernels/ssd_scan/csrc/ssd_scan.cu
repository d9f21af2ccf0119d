// Mamba-2 SSD chunked scan for Hopper (sm_90a), fp32 FMA loops.
//
// Replaces the TPU kernel ssd_scan_kernel (src/repro/kernels/ssd_scan/
// kernel.py, body _ssd_body): per (batch*head) it walks the sequence chunk
// by chunk, carrying the fp32 [ds, hd] state S, and for each chunk of Q
// steps with cum = cumsum(l), total = cum[Q-1]:
//
//   y = ((C B^T) . tril(exp(cum_i - cum_j))) @ xr + exp(cum) . (C @ S)
//   S <- exp(total) S + (B^T . exp(total - cum)) @ xr
//
// and writes hT = S after the last chunk. B and C are shared by the heads
// of one batch element (bh / n_heads).
//
// What bounds it: fp32 arithmetic. At mamba2-780m's serve shape (L 256, 48
// heads of 64, ds 128, chunk 64) a launch does about 0.7 GFLOP against about
// 8 MB of traffic, roughly 10 us at the fp32 FMA peak and 2.4 us at the HBM
// rate. The TPU kernel's sequential grid axis becomes a loop inside one
// block (one block per batch*head, 256 threads); nothing carries between
// blocks. S stays in shared memory for the whole sequence. A whole chunk
// does not fit in shared memory at chunk 256 and ds 128, so each chunk is
// cut into row tiles of TQ (32, or 16 when the chunk is not a multiple of
// 32): y is built tile by tile (its inter-chunk term first, from the S
// before the chunk, then one masked product per lower tile J <= I), and S
// is updated tile by tile after all of y. Every product reads one operand
// from registers or as a warp-wide broadcast float4 of shared memory and
// keeps its sums in registers. Only the lower triangle of each chunk is
// exponentiated: for j > i, exp(cum_i - cum_j) can overflow, and inf * 0
// would be NaN, so those terms are never formed. The card is under-filled
// when batch*heads is small (48 blocks on 132 SMs at the serve shape); that
// is accepted in this simple form (no wgmma, no TMA).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHd = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

// Shared-memory layout, in floats; every piece starts 16-byte aligned
// (ds, hd, TQ are multiples of 4).
struct Smem {
  int s, c, b, x, g, cum, total;
};

__host__ __device__ inline Smem layout(int tq, int q, int hd, int ds) {
  Smem m;
  const int row = ds + 4;                 // C and B rows, padded
  const int bt = ds * (tq + 4);           // B transposed for the S update
  const int b = tq * row > bt ? tq * row : bt;
  m.s = 0;
  m.c = m.s + ds * hd;
  m.b = m.c + tq * row;
  m.x = m.b + b;
  m.g = m.x + tq * hd;
  m.cum = m.g + tq * tq;
  m.total = m.cum + ((q + 3) / 4) * 4;
  return m;
}

template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride,
                                          const T* src, int rows, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int r = e / cols, k = e - r * cols;
    dst[r * dst_stride + k] = to_f(src[(size_t)r * cols + k]);
  }
}

template <int TQ, typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ xr, const float* __restrict__ l,
                const T* __restrict__ b, const T* __restrict__ c,
                T* __restrict__ y, float* __restrict__ hT, int L, int hd,
                int ds, int q, int n_heads) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Smem m = layout(TQ, q, hd, ds);
  float* S = smem + m.s;
  float* Cs = smem + m.c;
  float* Bs = smem + m.b;
  float* Xs = smem + m.x;
  float* Gs = smem + m.g;
  float* cum = smem + m.cum;
  const int row = ds + 4;

  const int bh = blockIdx.x;
  const int bi = bh / n_heads;
  const T* xr_h = xr + (size_t)bh * L * hd;
  const float* l_h = l + (size_t)bh * L;
  const T* b_b = b + (size_t)bi * L * ds;
  const T* c_b = c + (size_t)bi * L * ds;
  T* y_h = y + (size_t)bh * L * hd;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // each thread owns column d of hd and rows r0, r0 + rstep, ...
  const int d = tid % hd, r0 = tid / hd, rstep = kThreads / hd;
  constexpr int kMaxRows = TQ * kMaxHd / kThreads;
  const int ny = (TQ - r0 + rstep - 1) / rstep;   // y rows of this thread

  for (int e = tid; e < ds * hd; e += kThreads) S[e] = 0.f;

  for (int t0 = 0; t0 < L; t0 += q) {
    __syncthreads();   // S written, cum of the last chunk no longer read
    if (warp == 0) {   // inclusive scan of the chunk's log decays
      float carry = 0.f;
      for (int base = 0; base < q; base += 32) {
        float v = base + lane < q ? l_h[t0 + base + lane] : 0.f;
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        if (base + lane < q) cum[base + lane] = carry + v;
        carry += __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float total = cum[q - 1];

    // ---- y, one row tile I at a time
    for (int i0 = 0; i0 < q; i0 += TQ) {
      __syncthreads();   // Cs, Bs, Xs, Gs free
      load_rows(Cs, row, c_b + (size_t)(t0 + i0) * ds, TQ, ds);
      __syncthreads();
      float acc[kMaxRows];
#pragma unroll
      for (int k = 0; k < kMaxRows; ++k) acc[k] = 0.f;
      // inter-chunk: exp(cum_i) * C_i . S
      for (int s = 0; s < ds; s += 4) {
        const float s0 = S[(s + 0) * hd + d], s1 = S[(s + 1) * hd + d];
        const float s2 = S[(s + 2) * hd + d], s3 = S[(s + 3) * hd + d];
#pragma unroll
        for (int k = 0; k < kMaxRows; ++k) {
          if (k < ny) {
            const float4 cv =
                *reinterpret_cast<const float4*>(&Cs[(r0 + k * rstep) * row + s]);
            acc[k] += cv.x * s0 + cv.y * s1 + cv.z * s2 + cv.w * s3;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxRows; ++k)
        if (k < ny) acc[k] *= expf(cum[i0 + r0 + k * rstep]);

      // intra-chunk: sum over j <= i of (C_i . B_j) exp(cum_i - cum_j) xr_j
      for (int j0 = 0; j0 <= i0; j0 += TQ) {
        __syncthreads();   // Bs, Xs, Gs free
        load_rows(Bs, row, b_b + (size_t)(t0 + j0) * ds, TQ, ds);
        load_rows(Xs, hd, xr_h + (size_t)(t0 + j0) * hd, TQ, hd);
        __syncthreads();
        for (int e = tid; e < TQ * TQ; e += kThreads) {
          const int i = e / TQ, j = e - i * TQ;
          float g = 0.f;
          if (j0 + j <= i0 + i) {
            const float* ci = &Cs[i * row];
            const float* bj = &Bs[j * row];
            for (int s = 0; s < ds; s += 4) {
              const float4 cv = *reinterpret_cast<const float4*>(ci + s);
              const float4 bv = *reinterpret_cast<const float4*>(bj + s);
              g += cv.x * bv.x + cv.y * bv.y + cv.z * bv.z + cv.w * bv.w;
            }
            g *= expf(cum[i0 + i] - cum[j0 + j]);
          }
          Gs[e] = g;
        }
        __syncthreads();
        float xc[TQ];
#pragma unroll
        for (int j = 0; j < TQ; ++j) xc[j] = Xs[j * hd + d];
#pragma unroll
        for (int k = 0; k < kMaxRows; ++k) {
          if (k < ny) {
            const float* gi = &Gs[(r0 + k * rstep) * TQ];
            float a = acc[k];
#pragma unroll
            for (int j = 0; j < TQ; j += 4) {
              const float4 gv = *reinterpret_cast<const float4*>(gi + j);
              a += gv.x * xc[j] + gv.y * xc[j + 1] + gv.z * xc[j + 2] +
                   gv.w * xc[j + 3];
            }
            acc[k] = a;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxRows; ++k)
        if (k < ny)
          from_f(acc[k], &y_h[(size_t)(t0 + i0 + r0 + k * rstep) * hd + d]);
    }

    // ---- state update, one row tile J at a time (after all of y read S)
    const float decay = expf(total);
    for (int j0 = 0; j0 < q; j0 += TQ) {
      __syncthreads();   // Bs, Xs free; every read of the old S done
      const T* bsrc = b_b + (size_t)(t0 + j0) * ds;
      for (int e = tid; e < TQ * ds; e += kThreads) {
        const int j = e / ds, s = e - j * ds;
        Bs[s * (TQ + 4) + j] = to_f(bsrc[e]);
      }
      load_rows(Xs, hd, xr_h + (size_t)(t0 + j0) * hd, TQ, hd);
      __syncthreads();
      float xw[TQ];
#pragma unroll
      for (int j = 0; j < TQ; ++j)
        xw[j] = Xs[j * hd + d] * expf(total - cum[j0 + j]);
      for (int s = r0; s < ds; s += rstep) {
        float v = S[s * hd + d];
        if (j0 == 0) v *= decay;
        const float* bs = &Bs[s * (TQ + 4)];
#pragma unroll
        for (int j = 0; j < TQ; j += 4) {
          const float4 bv = *reinterpret_cast<const float4*>(bs + j);
          v += bv.x * xw[j] + bv.y * xw[j + 1] + bv.z * xw[j + 2] +
               bv.w * xw[j + 3];
        }
        S[s * hd + d] = v;
      }
    }
  }
  __syncthreads();
  float* hT_h = hT + (size_t)bh * ds * hd;
  for (int e = tid; e < ds * hd; e += kThreads) hT_h[e] = S[e];
}

int tile_rows(int q) { return q % 32 == 0 ? 32 : 16; }

template <int TQ, typename T>
int launch(const void* xr, const void* l, const void* b, const void* c,
           void* y, void* hT, int bh, int L, int hd, int ds, int q,
           int n_heads, size_t smem, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<TQ, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<bh, kThreads, smem, stream>>>(
      static_cast<const T*>(xr), static_cast<const float*>(l),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<T*>(y), static_cast<float*>(hT), L, hd, ds, q, n_heads);
  return (int)cudaGetLastError();
}

template <int TQ>
int dispatch(const void* xr, const void* l, const void* b, const void* c,
             void* y, void* hT, int bh, int L, int hd, int ds, int q,
             int n_heads, int bf16, size_t smem, cudaStream_t st) {
  if (bf16)
    return launch<TQ, __nv_bfloat16>(xr, l, b, c, y, hT, bh, L, hd, ds, q,
                                     n_heads, smem, st);
  return launch<TQ, float>(xr, l, b, c, y, hT, bh, L, hd, ds, q, n_heads,
                           smem, st);
}

}  // namespace

// Dynamic shared memory one launch needs at (chunk, hd, ds), in bytes, or
// -1 for a shape the kernel does not take: chunk a multiple of 16, hd a
// power of two from 4 to 128, ds a multiple of 4.
extern "C" long long ssd_scan_smem_bytes(int q, int hd, int ds) {
  if (q < 16 || q % 16 != 0 || ds < 4 || ds % 4 != 0 || hd < 4 ||
      hd > kMaxHd || (hd & (hd - 1)) != 0)
    return -1;
  return (long long)layout(tile_rows(q), q, hd, ds).total * sizeof(float);
}

// One launch on `stream`: xr [BH, L, hd], b and c [BH / n_heads, L, ds],
// all three bf16 if bf16 else f32, and l [BH, L] f32 -> y [BH, L, hd]
// (xr's type), hT [BH, ds, hd] f32. Returns the CUDA error of the launch
// (0 on success), or -1 for a shape the kernel does not take.
extern "C" int ssd_scan_launch(const void* xr, const void* l, const void* b,
                               const void* c, void* y, void* hT, int bh,
                               int L, int hd, int ds, int q, int n_heads,
                               int bf16, void* stream) {
  const long long smem = ssd_scan_smem_bytes(q, hd, ds);
  if (smem < 0 || L % q != 0 || n_heads < 1 || bh % n_heads != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_rows(q) == 32)
    return dispatch<32>(xr, l, b, c, y, hT, bh, L, hd, ds, q, n_heads, bf16,
                        (size_t)smem, st);
  return dispatch<16>(xr, l, b, c, y, hT, bh, L, hd, ds, q, n_heads, bf16,
                      (size_t)smem, st);
}
