// Mamba-2 SSD chunked scan for Hopper (sm_90a), fp32 FMAs.
//
// Replaces the TPU kernel ssd_scan_kernel (src/repro/kernels/ssd_scan/
// kernel.py, body _ssd_body). Per batch*head it walks the sequence in order,
// carrying the fp32 [ds, hd] state S, and for each chunk of Q steps with
// cum = cumsum(l), total = cum[Q-1]:
//
//   y = ((C B^T) . tril(exp(cum_i - cum_j))) @ xr + exp(cum) . (C @ S)
//   S <- exp(total) S + (B^T . exp(total - cum)) @ xr
//
// and writes hT = S after the last chunk. B and C are shared by the heads
// of one batch element (bh / n_heads).
//
// What bounds it: fp32 arithmetic (0.40 GFLOP of the per-step recurrence
// at mamba2-780m's serve shape, L 256, 48 heads of 64, ds 128, chunk 64,
// against 8 MB of traffic: 6.0 us at the fp32 peak, 2.4 us at the HBM
// rate); in practice the latency of one block's walk and the SM's one
// shared-memory pipe. The design:
//  * Columns spread over the card. Column d of y and of S reads only
//    column d of xr, so the grid is (batch*head, hd / TD): one block for TD
//    state columns (TD = min(32, hd)) of TD / 4 column warps and four C B^T
//    warps, 12 warps at TD 32, 96 blocks at the serve shape where one block
//    a head gave 48. The blocks need nothing from each other, and each
//    recomputes the sub-chunk's C B^T. Built with -DSSD_CB_CLUSTER=n (2 or
//    4), the hd / TD blocks of a head run as clusters of n that share it
//    instead: each block's 4 / n C B^T warps sum 16 / n of its rows and
//    store them into every block of the cluster, one cluster barrier a
//    sub-chunk, the decayed C B^T in two buffers. That form is a study,
//    timed by tests/check_torch_ssd_paged.py (17-20% slower at TD 32 on
//    the H100: PERF.md); the port builds n = 1.
//  * Sub-chunks of 16 steps. A block walks each chunk as Q / 16 sub-chunks
//    of kQ = 16 steps, the state carried between them: the same recurrence,
//    exact in real arithmetic (the decays factor as exp(cum_i - cum_j) =
//    exp(cum_i - cum_m) exp(cum_m - cum_j)), with a quarter of the masked
//    C B^T work of 64-step chunks, for any chunk that is a multiple of 16.
//  * Staged ahead. Sub-chunk k + 2's C, B, xr tile and l are copied by
//    cp.async (16-byte units where the bases allow) into a ring of three
//    stages while sub-chunk k computes; no integer division per element.
//  * The state in registers, lanes over its rows. Lane l of column warp w
//    holds S[s][4w .. 4w + 3] for the s of its float4s of ds (s / 4 = l +
//    32 q), so the state update is 16 FMAs a float4 of B, thread-private,
//    and C @ S and C B^T are per-lane partial products over the lane's s
//    (every shared load a float4 of contiguous C or B that feeds 16 FMAs),
//    summed across the warp by a transposed shuffle reduction that leaves
//    each lane two of the 64 sums (62 shuffles, not 64 x 5). A column warp
//    sums C @ S for its four columns (16 rows x 4), a C B^T warp four rows
//    of C B^T (4 x 16): equal work, side by side. Each warp scans the 16
//    log decays itself; two barriers a sub-chunk.
//  * Only the lower triangle is exponentiated: for j > i, exp(cum_i -
//    cum_j) can overflow, and inf * 0 would be NaN, so those entries are
//    set to 0 without the product.
// bf16 inputs are staged as bf16 and converted as they are read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../csrc/async_cluster.cuh"

namespace {

namespace ac = async_cluster;

constexpr int kQ = 16;             // steps a sub-chunk
constexpr int kStages = 3;         // staging ring: two sub-chunks ahead
constexpr int kGStride = kQ + 4;   // C B^T rows, 16-byte aligned
constexpr int kMaxHd = 128;
constexpr int kMaxTile = 32;       // state columns a block: 4 a warp
constexpr int kMaxDs = 512;        // 4 float4s of ds a lane
#ifndef SSD_CB_CLUSTER
#define SSD_CB_CLUSTER 1
#endif
constexpr int kCluster = SSD_CB_CLUSTER;   // blocks that share C B^T
static_assert(kCluster == 1 || kCluster == 2 || kCluster == 4,
              "SSD_CB_CLUSTER is 1, 2 or 4");
constexpr int kCbWarps = 4 / kCluster;     // C B^T warps a block
constexpr int kGBufs = kCluster > 1 ? 2 : 1;
// Threads of a block with td state columns: td / 4 column warps and the
// C B^T warps, four rows each.
__host__ __device__ constexpr int threads(int td) {
  return 32 * (td / 4 + kCbWarps);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One step of warp_sum64 on the first 2 kHalf entries: a lane keeps the
// half that its lane bit kHalf / 2 names and adds its partner's copy of it.
template <int kHalf>
__device__ __forceinline__ void fold(float (&v)[64], int lane) {
  const bool upper = lane & (kHalf / 2);
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const float send = upper ? v[k] : v[k + kHalf];
    const float keep = upper ? v[k + kHalf] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf / 2);
  }
}

// Sum v[0..63] over the warp's 32 lanes: afterwards lane l holds the sums
// of entries 2l and 2l + 1 in v[0] and v[1] (62 shuffles).
__device__ __forceinline__ void warp_sum64(float (&v)[64], int lane) {
  fold<32>(v, lane);
  fold<16>(v, lane);
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
}

// Shared-memory layout, in bytes; every piece 16-byte aligned. A stage
// holds one sub-chunk's C and B rows [kQ][ds] and xr tile [kQ][TD] in the
// inputs' type and its l [kQ] in fp32; G is the decayed C B^T,
// [kGBufs][kQ][kGStride]; W the xr tile times exp(total - cum_j), [kQ][TD].
struct Smem {
  int c, b, x, l, stage, g, w, total;
};

__host__ __device__ inline int align16(int n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline Smem layout(int td, int ds, int es) {
  Smem m;
  m.c = 0;
  m.b = kQ * ds * es;
  m.x = 2 * kQ * ds * es;
  m.l = m.x + align16(kQ * td * es);
  m.stage = m.l + kQ * 4;
  m.g = kStages * m.stage;
  m.w = m.g + kGBufs * kQ * kGStride * 4;
  m.total = m.w + align16(kQ * td * 4);
  return m;
}

// TD state columns (4, 8, 16 or 32) a block; M float4s of ds a lane (1, 2,
// 4). Warps 0 .. TD / 4 - 1 own four state columns each, the last
// kCbWarps four rows each of C B^T (of the cluster's 16 rows).
template <typename T, int TD, int M>
__global__ void __launch_bounds__(threads(kMaxTile))
ssd_scan_kernel(const T* __restrict__ xr, const float* __restrict__ l,
                const T* __restrict__ b, const T* __restrict__ c,
                T* __restrict__ y, float* __restrict__ hT, int L, int hd,
                int ds, int n_heads, int unit, int l_unit) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kThreads = threads(TD);
  constexpr int kColWarps = TD / 4;
  constexpr int kRowBytes = TD * (int)sizeof(T);
  const Smem m = layout(TD, ds, sizeof(T));
  float* G = reinterpret_cast<float*>(smem + m.g);
  float* W = reinterpret_cast<float*>(smem + m.w);
  const int nq = ds / 4;

  const int bh = blockIdx.x, d0 = blockIdx.y * TD;
  const int bi = bh / n_heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_sub = L / kQ;
  const bool cols = warp < kColWarps;
  // a C B^T warp's rows 4 rw .. + 3
  int rw = warp - kColWarps;
  if constexpr (kCluster > 1) {
    rw += kCbWarps * (int)ac::cluster_rank();
    ac::cluster_sync();   // every block of the cluster runs before a store
  }

  const unsigned char* c_b =
      reinterpret_cast<const unsigned char*>(c + (size_t)bi * L * ds);
  const unsigned char* b_b =
      reinterpret_cast<const unsigned char*>(b + (size_t)bi * L * ds);
  const unsigned char* x_h = reinterpret_cast<const unsigned char*>(
      xr + (size_t)bh * L * hd + d0);
  const unsigned char* l_h =
      reinterpret_cast<const unsigned char*>(l + (size_t)bh * L);
  const int blk = kQ * ds * (int)sizeof(T);   // bytes of a stage's C or B
  const int x_stride = hd * (int)sizeof(T);

  // Issue sub-chunk k's copies into its stage and commit them as one group
  // (an empty group past the end, so the waits count alike).
  auto stage_in = [&](int k) {
    if (k < n_sub) {
      unsigned char* s = smem + (k % kStages) * m.stage;
      const size_t t0 = (size_t)k * kQ;
      const unsigned char* cs = c_b + t0 * ds * sizeof(T);
      const unsigned char* bs = b_b + t0 * ds * sizeof(T);
      for (int e = tid * unit; e < blk; e += kThreads * unit) {
        ac::copy_async(s + m.c + e, cs + e, unit);
        ac::copy_async(s + m.b + e, bs + e, unit);
      }
      const unsigned char* xs = x_h + t0 * x_stride;
      for (int e = tid * unit; e < kQ * kRowBytes; e += kThreads * unit) {
        const int r = e / kRowBytes;   // a power of two: a shift
        ac::copy_async(s + m.x + e,
                       xs + (size_t)r * x_stride + (e - r * kRowBytes), unit);
      }
      const unsigned char* ls = l_h + t0 * 4;
      for (int e = tid * l_unit; e < kQ * 4; e += kThreads * l_unit)
        ac::copy_async(s + m.l + e, ls + e, l_unit);
    }
    ac::commit_async();
  };
  stage_in(0);
  stage_in(1);

  // S[4 (lane + 32 q) + 0..3][4 warp + dd] as st[q][dd] (column warps)
  float4 st[M][4];
#pragma unroll
  for (int q = 0; q < M; ++q)
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) st[q][dd] = make_float4(0.f, 0.f, 0.f, 0.f);
  // after warp_sum64: a column warp's y entries (row yi, columns yd, yd + 1
  // of the tile), a C B^T warp's entries (row gi, columns gj, gj + 1)
  const int yi = lane >> 1, yd = 4 * warp + 2 * (lane & 1);
  const int gi = (4 * rw + (lane >> 3)) & (kQ - 1), gj = 2 * (lane & 7);

  for (int k = 0; k < n_sub; ++k) {
    ac::wait_async<1>();
    __syncthreads();   // stage k landed; sub-chunk k - 1 read G and W
    stage_in(k + 2);
    // with a cluster, G alternates: a peer stores sub-chunk k + 1's rows
    // while this block may still read sub-chunk k's
    float* Gk = G + (k % kGBufs) * kQ * kGStride;
    const unsigned char* s = smem + (k % kStages) * m.stage;
    const T* Cs = reinterpret_cast<const T*>(s + m.c);
    const T* Bs = reinterpret_cast<const T*>(s + m.b);
    const T* Xs = reinterpret_cast<const T*>(s + m.x);
    const float* ls = reinterpret_cast<const float*>(s + m.l);

    // every warp scans the 16 log decays: lane j (and j + 16) holds cum_j
    float cum = ls[lane & (kQ - 1)];
#pragma unroll
    for (int off = 1; off < kQ; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, cum, off, kQ);
      if ((lane & (kQ - 1)) >= off) cum += u;
    }
    const float total = __shfl_sync(0xffffffffu, cum, kQ - 1);
    const float cum_y = __shfl_sync(0xffffffffu, cum, yi);
    const float cum_g = __shfl_sync(0xffffffffu, cum, gi);
    const float cum_j0 = __shfl_sync(0xffffffffu, cum, gj);
    const float cum_j1 = __shfl_sync(0xffffffffu, cum, gj + 1);

    // ---- phase A: W; C @ S in the column warps, C B^T in the others
#pragma unroll
    for (int e = tid; e < kQ * TD; e += kThreads) {
      const float cj = __shfl_sync(0xffffffffu, cum, e / TD);
      W[e] = to_f(Xs[e]) * expf(total - cj);
    }
    float v[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) v[e] = 0.f;
    float y0 = 0.f, y1 = 0.f;
    if (cols) {
#pragma unroll
      for (int q = 0; q < M; ++q) {
        const int sq = lane + 32 * q;
        if (sq < nq) {
#pragma unroll
          for (int i = 0; i < kQ; ++i) {
            const float4 ci = load4(Cs + i * ds + 4 * sq);
#pragma unroll
            for (int dd = 0; dd < 4; ++dd)
              v[i * 4 + dd] = dot4(ci, st[q][dd], v[i * 4 + dd]);
          }
        }
      }
      warp_sum64(v, lane);
      const float e = expf(cum_y);
      y0 = v[0] * e;
      y1 = v[1] * e;
    } else {
#pragma unroll
      for (int q = 0; q < M; ++q) {
        const int sq = lane + 32 * q;
        if (sq < nq) {
          float4 cr[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cr[r] = load4(Cs + (4 * rw + r) * ds + 4 * sq);
#pragma unroll
          for (int j = 0; j < kQ; ++j) {
            const float4 bj = load4(Bs + j * ds + 4 * sq);
#pragma unroll
            for (int r = 0; r < 4; ++r)
              v[r * kQ + j] = dot4(cr[r], bj, v[r * kQ + j]);
          }
        }
      }
      warp_sum64(v, lane);
      const float2 g2 =
          make_float2(gj <= gi ? v[0] * expf(cum_g - cum_j0) : 0.f,
                      gj + 1 <= gi ? v[1] * expf(cum_g - cum_j1) : 0.f);
      float* gp = Gk + gi * kGStride + gj;
      if constexpr (kCluster == 1) {
        *reinterpret_cast<float2*>(gp) = g2;
      } else {
#pragma unroll
        for (int r = 0; r < kCluster; ++r)
          ac::store_peer(ac::peer_addr(gp, r), g2);
      }
    }
    if constexpr (kCluster == 1)
      __syncthreads();   // G and W written
    else
      ac::cluster_sync();   // G of every block of the cluster, and W

    // ---- phase B: y += masked (C B^T) @ xr, written once; S updated
    if (cols) {
#pragma unroll
      for (int j = 0; j < kQ; j += 4) {
        const float4 g =
            *reinterpret_cast<const float4*>(Gk + yi * kGStride + j);
        const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          y0 = fmaf(gv[a], to_f(Xs[(j + a) * TD + yd]), y0);
          y1 = fmaf(gv[a], to_f(Xs[(j + a) * TD + yd + 1]), y1);
        }
      }
      T* yo = y + ((size_t)bh * L + (size_t)k * kQ + yi) * hd + d0 + yd;
      from_f(y0, yo);
      from_f(y1, yo + 1);

      const float decay = expf(total);
#pragma unroll
      for (int q = 0; q < M; ++q)
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          st[q][dd].x *= decay;
          st[q][dd].y *= decay;
          st[q][dd].z *= decay;
          st[q][dd].w *= decay;
        }
#pragma unroll 4
      for (int j = 0; j < kQ; ++j) {
        const float4 w4 =
            *reinterpret_cast<const float4*>(W + j * TD + 4 * warp);
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int q = 0; q < M; ++q) {
          const int sq = lane + 32 * q;
          if (sq < nq) {
            const float4 bv = load4(Bs + j * ds + 4 * sq);
#pragma unroll
            for (int dd = 0; dd < 4; ++dd) {
              st[q][dd].x = fmaf(bv.x, wv[dd], st[q][dd].x);
              st[q][dd].y = fmaf(bv.y, wv[dd], st[q][dd].y);
              st[q][dd].z = fmaf(bv.z, wv[dd], st[q][dd].z);
              st[q][dd].w = fmaf(bv.w, wv[dd], st[q][dd].w);
            }
          }
        }
      }
    }
  }
  // hT[s][d0 + 4 warp .. + 3] = S, one float4 a row
  if (cols) {
    float* h = hT + (size_t)bh * ds * hd + d0 + 4 * warp;
#pragma unroll
    for (int q = 0; q < M; ++q) {
      const int sq = lane + 32 * q;
      if (sq < nq) {
        const float4* a = st[q];
        float* row = h + (size_t)(4 * sq) * hd;
        *reinterpret_cast<float4*>(row) =
            make_float4(a[0].x, a[1].x, a[2].x, a[3].x);
        *reinterpret_cast<float4*>(row + hd) =
            make_float4(a[0].y, a[1].y, a[2].y, a[3].y);
        *reinterpret_cast<float4*>(row + 2 * hd) =
            make_float4(a[0].z, a[1].z, a[2].z, a[3].z);
        *reinterpret_cast<float4*>(row + 3 * hd) =
            make_float4(a[0].w, a[1].w, a[2].w, a[3].w);
      }
    }
  }
}

template <typename T, int TD, int M>
int launch(const void* xr, const void* l, const void* b, const void* c,
           void* y, void* hT, int bh, int L, int hd, int ds, int n_heads,
           int unit, int l_unit, size_t smem, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T, TD, M>;
  int err = ac::allow_smem(kernel, smem);
  if (err) return err;
  if constexpr (kCluster > 1)
    return ac::launch_cluster(
        kernel, dim3(bh, hd / TD), dim3(threads(TD)), smem,
        dim3(1, kCluster, 1), stream, static_cast<const T*>(xr),
        static_cast<const float*>(l), static_cast<const T*>(b),
        static_cast<const T*>(c), static_cast<T*>(y),
        static_cast<float*>(hT), L, hd, ds, n_heads, unit, l_unit);
  kernel<<<dim3(bh, hd / TD), threads(TD), smem, stream>>>(
      static_cast<const T*>(xr), static_cast<const float*>(l),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(y),
      static_cast<float*>(hT), L, hd, ds, n_heads, unit, l_unit);
  return (int)cudaGetLastError();
}

template <typename T, int TD>
int by_depth(const void* xr, const void* l, const void* b, const void* c,
             void* y, void* hT, int bh, int L, int hd, int ds, int n_heads,
             int unit, int l_unit, size_t smem, cudaStream_t st) {
  if (ds <= 128)
    return launch<T, TD, 1>(xr, l, b, c, y, hT, bh, L, hd, ds, n_heads, unit,
                            l_unit, smem, st);
  if (ds <= 256)
    return launch<T, TD, 2>(xr, l, b, c, y, hT, bh, L, hd, ds, n_heads, unit,
                            l_unit, smem, st);
  return launch<T, TD, 4>(xr, l, b, c, y, hT, bh, L, hd, ds, n_heads, unit,
                          l_unit, smem, st);
}

template <typename T>
int by_tile(int td, const void* xr, const void* l, const void* b,
            const void* c, void* y, void* hT, int bh, int L, int hd, int ds,
            int n_heads, int unit, int l_unit, size_t smem,
            cudaStream_t st) {
  if (td == 32)
    return by_depth<T, 32>(xr, l, b, c, y, hT, bh, L, hd, ds, n_heads, unit,
                           l_unit, smem, st);
  if (td == 16)
    return by_depth<T, 16>(xr, l, b, c, y, hT, bh, L, hd, ds, n_heads, unit,
                           l_unit, smem, st);
  if (td == 8)
    return by_depth<T, 8>(xr, l, b, c, y, hT, bh, L, hd, ds, n_heads, unit,
                          l_unit, smem, st);
  return by_depth<T, 4>(xr, l, b, c, y, hT, bh, L, hd, ds, n_heads, unit,
                        l_unit, smem, st);
}

}  // namespace

// Dynamic shared memory of one launch at (chunk, hd, ds) with td state
// columns a block, in bytes, or -1 for a shape the kernel does not take:
// chunk a multiple of 16, hd a power of two from 4 to 128 and a multiple of
// td (4, 8, 16 or 32), ds a multiple of 4 up to 512 (and, built with
// SSD_CB_CLUSTER n, hd / td a multiple of n).
extern "C" long long ssd_scan_smem_bytes(int q, int hd, int ds, int td,
                                         int bf16) {
  if (q < 16 || q % 16 != 0 || ds < 4 || ds % 4 != 0 || ds > kMaxDs ||
      hd < 4 || hd > kMaxHd || (hd & (hd - 1)) != 0 ||
      (td != 4 && td != 8 && td != 16 && td != kMaxTile) || hd % td != 0 ||
      (hd / td) % kCluster != 0)
    return -1;
  return (long long)layout(td, ds, bf16 ? 2 : 4).total;
}

// One launch on `stream`: xr [BH, L, hd], b and c [BH / n_heads, L, ds],
// all three bf16 if bf16 else f32, and l [BH, L] f32 -> y [BH, L, hd]
// (xr's type), hT [BH, ds, hd] f32; hd / td blocks a batch*head. Returns
// the CUDA error of the launch (0 on success), or -1 for a shape the kernel
// does not take.
extern "C" int ssd_scan_launch(const void* xr, const void* l, const void* b,
                               const void* c, void* y, void* hT, int bh,
                               int L, int hd, int ds, int q, int n_heads,
                               int bf16, int td, void* stream) {
  const long long smem = ssd_scan_smem_bytes(q, hd, ds, td, bf16);
  if (smem < 0 || L % q != 0 || n_heads < 1 || bh % n_heads != 0)
    return -1;
  const int es = bf16 ? 2 : 4;
  // the largest copy unit every base and row allows
  const int unit = ac::copy_unit(
      {(unsigned long long)xr, (unsigned long long)b,
       (unsigned long long)c, (unsigned long long)(td * es),
       (unsigned long long)(hd * es)});
  const int l_unit = ac::copy_unit({(unsigned long long)l});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return by_tile<__nv_bfloat16>(td, xr, l, b, c, y, hT, bh, L, hd, ds,
                                  n_heads, unit, l_unit, (size_t)smem, st);
  return by_tile<float>(td, xr, l, b, c, y, hT, bh, L, hd, ds, n_heads, unit,
                        l_unit, (size_t)smem, st);
}
