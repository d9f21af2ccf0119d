// 3xTF32 building blocks for Hopper (sm_90a): fp32-accurate products on the
// TF32 tensor cores by mma.sync m16n8k8, shared by the tf32x3 bodies of
// masa_gemm.cu, moe_gemm.cu and flash_attention.cu.
//
// The split. A float x is carried as big = tf32(x), rounded to nearest
// with ties away from zero as cvt.rna.tf32.f32 rounds, and small = x -
// big, which is exact in fp32. The tensor cores read a TF32 operand's top
// 19 bits, so they take small truncated to 11 significant bits: big +
// small keeps at least 21 of x's 24. The rounding of big is an integer add
// of half a TF32 ulp and a mask (2 instructions; ptxas expands cvt.rna
// into a longer sequence with NaN tests), and small needs none: on an H100
// that split took the masa and flash bodies 4-7% less time than rounding
// small as well, with the same errors (tests/check_torch_tf32x3.py). A
// product a b is then a_small b_big + a_big b_small + a_big b_big, summed
// in fp32 by the tensor cores; the dropped a_small b_small and small's
// truncation are each about 2^-21 of it. Three TF32 products for one
// fp32-accurate one, small products first, as CUTLASS's
// OpMultiplyAddFastF32 orders them. One TF32 product alone keeps 11 bits
// of each operand: about 1e-3 of error at K 4096, past the fp32 tolerance
// of 2e-4.
//
// Fragments (PTX ISA, mma.m16n8k8 with .tf32; g = lane / 4, t = lane % 4):
//   A 16 x 8 (row-major)  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                         a3 (g + 8, t + 4)
//   B 8 x 8 (k x n)       b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C 16 x 8              c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                         c3 (g + 8, 2t + 1)
// mma.sync reads its fragments from registers, so they are loaded from
// shared memory by plain loads from any layout (TF32 wgmma would need both
// operands K-major in shared memory, and masa's B [K, N] and flash's V
// [keys, hd] are MN-major). The k order inside each 8-deep slice is a
// dummy: every load here takes fragment column (A) or row (B) t as k = 2t
// and t + 4 as k = 2t + 1, the same for both operands of a product. So an
// operand stored k-contiguous gives a thread's two k values in one 64-bit
// load, and an accumulator feeds the next product as its A operand with no
// shuffle (a_from_c). The callers pad row pitches so that each load of a
// warp falls in distinct banks:
//   [rows][k] read in 64-bit pairs (A; flash's K as B [n][k]): pitch = 8
//   mod 32 words, banks 8g + 2t, 8g + 2t + 1 in each half-warp;
//   [k][n] read at rows 2t and 2t + 1 (masa's B, flash's V): pitch = 4
//   mod 32, banks 8t + g and 8t + 4 + g.
// Every fragment is split as it is loaded: a pre-split copy of a tile would
// double its shared memory.
//
// load_tile copies a tile of a row-major fp32 tensor into padded shared
// memory by 16-byte cp.async (async_cluster.cuh), zero-filling what lies
// outside the tensor, so a ragged edge adds nothing to the products.
//
// The GEMM tile of masa's and moe's bodies: warps of 64 x 32 outputs (4 x
// 4 mma tiles) over 128 columns, K in stages of 32 through A [rows][40]
// and B [32][132]. The tensor cores' fp32 sums are not rounded to nearest:
// accumulated over all of K (3 K / 8 mma.sync into one running sum) they
// drifted by 1.9e-4 at K 4096 on an H100, past the 1e-4 that fp32 is held
// to. So stage() sums each 32-deep stage into a fresh tile (12 mma.sync on
// a small sum) that an fp32 add takes into the running sum.
#pragma once
#include "async_cluster.cuh"

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the value cvt.rna.tf32.f32 gives for every finite x and infinity.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// big exactly TF32, so that x - big is what the small products must add;
// small as fp32 bits, whose low 13 the tensor cores do not read.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  FragA f;
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
  return f;
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split(b0, f.big[0], f.small[0]);
  split(b1, f.big[1], f.small[1]);
  return f;
}

// The A fragment of the 16 x 8 tile whose (0, 0) is at p, stored [row][k]
// with rows `pitch` floats apart: row g at k 2t, 2t + 1 in one load, row
// g + 8 in another.
__device__ __forceinline__ FragA load_a(const float* p, int pitch, int lane) {
  const float* r = p + (lane >> 2) * pitch + 2 * (lane & 3);
  const float2 lo = *reinterpret_cast<const float2*>(r);
  const float2 hi = *reinterpret_cast<const float2*>(r + 8 * pitch);
  return split_a(lo.x, hi.x, lo.y, hi.y);
}

// The B fragment of the 8 (k) x 8 (n) tile at p, stored [n][k] (flash's K
// for S = Q K^T: n a key, k a head dim): k 2t, 2t + 1 in one load.
__device__ __forceinline__ FragB load_b_nk(const float* p, int pitch,
                                           int lane) {
  const float2 v = *reinterpret_cast<const float2*>(
      p + (lane >> 2) * pitch + 2 * (lane & 3));
  return split_b(v.x, v.y);
}

// The B fragment of the 8 (k) x 8 (n) tile at p, stored [k][n]: rows 2t
// and 2t + 1 at column g.
__device__ __forceinline__ FragB load_b(const float* p, int pitch, int lane) {
  const float* r = p + 2 * (lane & 3) * pitch + (lane >> 2);
  return split_b(r[0], r[pitch]);
}

// An accumulator tile (row g at columns 2t and 2t + 1, row g + 8 likewise)
// as the A operand of the next product, in the same k order as load_a.
__device__ __forceinline__ FragA a_from_c(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// d += a b on one 16 x 8 x 8 tile, TF32 operands, fp32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[m][n] += a[m] b[n] for M x N tiles of one k8 step, in three passes
// (small x big, big x small, big x big): M * N independent products lie
// between two that update one accumulator, so the tensor pipe is not held
// by one tile's dependent chain.
template <int M, int N>
__device__ __forceinline__ void mma3(float (&acc)[M][N][4],
                                     const FragA (&a)[M],
                                     const FragB (&b)[N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma(acc[i][j], a[i].small, b[j].big);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma(acc[i][j], a[i].big, b[j].small);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma(acc[i][j], a[i].big, b[j].big);
}

// Rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of the row-major fp32
// tensor src (R x C, ld floats a row) into dst (pitch floats a row) by
// THREADS threads, one 16-byte cp.async a chunk; chunks outside the tensor
// are zero-filled by a plain store. C, c0, ld and pitch are multiples of 4
// and src's base 16-byte aligned, so a chunk lies wholly inside or outside.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const float* src, long long ld,
                                          int r0, int c0, int R, int C,
                                          int tid) {
  constexpr int kRowChunks = COLS / 4;
  constexpr int kChunks = ROWS * kRowChunks;
  static_assert(COLS % 4 == 0 && kChunks % THREADS == 0, "tile chunks");
#pragma unroll
  for (int i = 0; i < kChunks / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / kRowChunks, c = (e % kRowChunks) * 4;
    float* d = dst + r * pitch + c;
    if (r0 + r < R && c0 + c < C)
      async_cluster::copy_async(d, src + (r0 + r) * ld + c0 + c, 16);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

constexpr int kTfBK = 32;              // depth of a stage (128 bytes)
constexpr int kTfBN = 128;             // columns of a tile
constexpr int kTfPitchA = kTfBK + 8;   // A [rows][40]: 64-bit pairs
constexpr int kTfPitchB = kTfBN + 4;   // B [k][132]: rows 2t, 2t + 1

// acc += the products of one 32-deep stage: A [rows][40] at as, B [k][132]
// at bs (the stage's first row), the warp's rows wm.. and columns wn..
__device__ __forceinline__ void stage(float (&acc)[4][4][4], const float* as,
                                      const float* bs, int wm, int wn,
                                      int lane) {
  float part[4][4][4] = {};
#pragma unroll
  for (int kk = 0; kk < kTfBK / 8; ++kk) {
    FragA fa[4];
    FragB fb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      fa[i] = load_a(as + (wm + 16 * i) * kTfPitchA + 8 * kk, kTfPitchA, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      fb[j] = load_b(bs + 8 * kk * kTfPitchB + wn + 8 * j, kTfPitchB, lane);
    mma3(part, fa, fb);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

// Store the warp's 64 x 32 sums at rows m0 + wm.., columns n0 + wn.. of c
// [.., N], rows below M only (N % 4 == 0, so col < N puts col + 1 inside
// too), then zero them.
__device__ __forceinline__ void store(float (&acc)[4][4][4], float* c, int M,
                                      int N, int m0, int n0, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 16 * i + g + 8 * h;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (row < M && col < N)
          *reinterpret_cast<float2*>(&c[(size_t)row * N + col]) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0.f;
      }
    }
}

}  // namespace tf32x3
