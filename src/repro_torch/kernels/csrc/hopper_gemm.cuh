// Hopper building blocks of the bf16 wgmma bodies of masa_gemm.cu,
// moe_gemm.cu and flash_attention.cu: TMA loads into a ring of
// shared-memory stages guarded by mbarriers, wgmma on those stages with
// fp32 accumulators in registers (B MN-major or K-major, A from shared
// memory or, as bf16, from an accumulator in registers: a_fragment), one
// producer warpgroup and one or two consumer warpgroups (warp
// specialisation with setmaxnreg), the masked epilogue, the GEMMs' ring
// kernel and tile raster, and the host's tensor maps.
//
// Layouts. Every tile in shared memory is in TMA's 128-byte swizzle, in
// boxes of 64 bf16 along the contiguous dimension (128 bytes, the widest
// box that swizzle allows):
//   A [rows][64 k]       K-major: row r at r * 128 bytes. A wgmma
//                        descriptor for 64 rows starts at the warpgroup's
//                        first row; the 16-deep slice kk of the 64 starts
//                        kk * 32 bytes further (inside the swizzle atom),
//                        8-row groups 1024 bytes apart (SBO).
//   B [64 k][BN]         MN-major (B is [K, N] with N contiguous): BN / 64
//                        boxes of [64 k rows][64 n], 8192 bytes apart
//                        (LBO: the next 64 columns), 8-row groups 1024
//                        bytes apart (SBO); slice kk starts kk * 2048 bytes
//                        in. wgmma reads it transposed (tnspB = 1). desc_b
//                        takes boxes of another depth too (flash's V: 128
//                        keys, 16384 bytes apart).
//   B [BN][64 k]         K-major (B stored [N, K] with K contiguous, as
//                        flash's K for S = Q K^T): A's layout and desc_a,
//                        read with tnspB = 0.
// Ragged edges: TMA fills what lies outside the tensor with zeros, so a
// partial K step adds nothing, and the epilogue masks rows >= M and
// columns >= N.
//
// Ring protocol. full[s] is armed by the producer with the stage's bytes
// (arrive.expect_tx, count 1) and completes when TMA has written them;
// empty[s] completes when every consumer warp has arrived after its
// wgmmas on stage s retired (count 4 a consumer warpgroup). A fresh
// barrier's phase 0 is pending, so the producer waits on parity phase ^ 1
// (the first pass through the ring does not wait) and the consumers on
// parity phase; both flip phase when the stage index wraps. A consumer
// releases a stage once its wgmmas have retired (keeping one stage's group
// in flight while issuing the next measured no faster). A wait that
// spins for about two seconds traps, so a protocol fault surfaces as a
// launch error and not as a hung card.
#pragma once
#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kBK = 64;                 // depth of one ring stage (128 bytes)
constexpr int kBoxBytes = 64 * 64 * 2;  // one [64][64] bf16 box
constexpr int kWarpgroup = 128;
constexpr int kSmemAlign = 1024;        // the 128-byte swizzle's atom

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 4000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until every committed wgmma group of the warpgroup has retired.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// A consumer warpgroup releases a ring stage: one arrival a warp, after
// the warp's wgmmas that read the stage have retired.
__device__ __forceinline__ void release(uint32_t empty, int t) {
  __syncwarp();
  if (t % 32 == 0) mbar_arrive(empty);
}

// A shared-memory matrix descriptor in the 128-byte swizzle (layout 1).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}
// A, or a K-major B (stored [N][K]): rows of 128 bytes (LBO unused in this
// layout).
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}
// B: MN-major boxes of 64 columns, box_bytes apart.
__device__ __forceinline__ uint64_t desc_b(uint32_t addr,
                                          uint32_t box_bytes = kBoxBytes) {
  return smem_desc(addr, box_bytes, 1024);
}

// d += A[64 x 16] (K-major, desc_a) @ B[16 x 256] (MN-major, desc_b), bf16
// operands from shared memory, fp32 accumulators: 128 a thread.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d += A[64 x 16] (K-major, desc_a) @ B[16 x 128], bf16 operands from
// shared memory, fp32 accumulators: 64 a thread. B is MN-major (desc_b,
// TNSP_B 1) or K-major, stored [128][16] (desc_a, TNSP_B 0). scale_d 0
// overwrites d instead of adding to it.
template <int TNSP_B = 1>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TNSP_B));
}

// Pin wgmma registers in place: the compiler may move no read or write of
// them across this point (put after wgmma_wait_all and before a wgmma_fence,
// between which the registers belong to the asynchronous unit).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A[64 x 16] @ B[16 x 128]: A bf16 from registers (the fragment of
// a_fragment), B MN-major from shared memory (desc_b; tnspB = 1),
// fp32 accumulators: 64 a thread.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A[64 x 16] @ B[16 x 64]: A bf16 from registers (the fragment of
// a_fragment), B MN-major from shared memory (desc_b; tnspB = 1),
// fp32 accumulators: 32 a thread.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The A fragment of a register-A wgmma for the 16-deep slice kk of a
// product whose A is an fp32 accumulator d of m64nNk16 (N >= 16 kk + 16):
// columns 16 kk .. 16 kk + 15 of d, rounded to bf16. The two layouts agree
// thread for thread: register r holds (row g + 8 (r % 2), columns 2 (t %
// 4) + 8 (r / 2) and the next) of the slice, which d keeps at
// d[8 kk + 2 r] and d[8 kk + 2 r + 1].
template <int N>
__device__ __forceinline__ void a_fragment(const float (&d)[N], int kk,
                                           uint32_t (&a)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    __nv_bfloat162 p = __floats2bfloat162_rn(d[8 * kk + 2 * r],
                                             d[8 * kk + 2 * r + 1]);
    a[r] = *reinterpret_cast<uint32_t*>(&p);
  }
}

// The epilogue's staging buffer: each consumer warp owns 16 rows x 32
// columns of bf16, rows 80 bytes apart (64 + 16 of padding, so the
// fragment's stores hit 32 distinct banks).
constexpr int kStagePitch = 80;
constexpr int kStageWarpBytes = 16 * kStagePitch;

// Round a warpgroup's [64 x BN] accumulator to bf16 once and store it at
// rows m0.., columns n0.. of c [M, N], masked at the edges. Thread t holds
// rows (t / 32) * 16 + (t % 32) / 4 (+ 8) and column pairs (t % 4) * 2 +
// 8 j of the wgmma fragment; each warp passes its 16 rows through its
// staging buffer `stage` 32 columns at a time, so that every global store
// is 16 bytes and 4 lanes write 64 contiguous bytes of a row (stored
// straight from the fragment, 4 bytes a lane over 8 rows, the epilogue
// took most of a 128 x 256 x 256 tile's time). N % 8 == 0, so a 16-byte
// piece lies wholly inside or outside c.
template <int BN>
__device__ __forceinline__ void store_tile(const float (&d)[BN / 2],
                                           uint8_t* stage, __nv_bfloat16* c,
                                           int M, int N, int m0, int n0,
                                           int t) {
  const int lane = t % 32;
  const int row0 = m0 + (t / 32) * 16;
#pragma unroll
  for (int q = 0; q < BN / 32; ++q) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = q * 4 + jj;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(
            stage + (lane / 4 + 8 * h) * kStagePitch + jj * 16 +
            (lane % 4) * 4) =
            __floats2bfloat162_rn(d[j * 4 + h * 2], d[j * 4 + h * 2 + 1]);
    }
    __syncwarp();
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int i = lane + 32 * p, r = i / 4, piece = i % 4;
      const int row = row0 + r, col = n0 + q * 32 + piece * 8;
      if (row < M && col < N)
        *reinterpret_cast<uint4*>(c + (size_t)row * N + col) =
            *reinterpret_cast<const uint4*>(stage + r * kStagePitch +
                                            piece * 16);
    }
    __syncwarp();
  }
}

// The tile raster: tile t of an mt x nt grid -> (m, n). Groups of group_m
// row tiles are walked one after the other; inside a group, M runs fastest
// within one column tile, so the blocks that read one tile of B (one
// expert's panel for moe_gemm) run side by side and share it through L2,
// and the group's rows of A stay in L2 across its columns. Mirrored by
// repro_torch/kernels/hopper_gemm.py:raster.
__host__ __device__ __forceinline__ void raster(int t, int mt, int nt,
                                                int group_m, int* m, int* n) {
  const int per_group = group_m * nt;
  const int g = t / per_group;
  const int first = g * group_m;
  const int rows = mt - first < group_m ? mt - first : group_m;
  const int r = t - g * per_group;
  *m = first + r % rows;
  *n = r / rows;
}

// What one ring kernel launch covers: c [M, N] = A [M, K] @ B; for
// moe_gemm B is w [E, K, N] and token block m / bt takes expert eids[..].
struct Problem {
  int M, N, K;
  int mt, nt, group_m;
  int bt;
  const int* eids;   // nullptr: B is one [K, N] matrix
  __nv_bfloat16* c;
};

// The ring kernel: one block per [64 * NC, BN] tile of C, K walked in
// stages of kBK through a ring of STAGES. Warpgroups 0..NC-1 consume (64
// rows each), warpgroup NC produces (one thread issues the TMA loads).
template <int BN, int NC, int STAGES>
struct Ring {
  static constexpr int kBM = 64 * NC;
  static constexpr int kThreads = (NC + 1) * kWarpgroup;
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBBytes = kBK * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStagingBytes = NC * 4 * kStageWarpBytes;
  static constexpr int kSmemBytes =
      kSmemAlign + STAGES * kStageBytes + kStagingBytes + 2 * STAGES * 8;
};

template <int BN, int NC, int STAGES>
__global__ void __launch_bounds__(Ring<BN, NC, STAGES>::kThreads, 1)
ring_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, Problem p) {
  using R = Ring<BN, NC, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (smem_u32(smem_raw) + kSmemAlign - 1) & ~(uint32_t)(kSmemAlign - 1);
  const uint32_t a0 = base;                          // STAGES x A stage
  const uint32_t b0 = base + STAGES * R::kABytes;    // STAGES x B stage
  const uint32_t staging = base + STAGES * R::kStageBytes;
  const uint32_t full0 = staging + R::kStagingBytes;
  const uint32_t empty0 = full0 + STAGES * 8;
  const int wg = threadIdx.x / kWarpgroup, t = threadIdx.x % kWarpgroup;
  int mtile, ntile;
  raster(blockIdx.x, p.mt, p.nt, p.group_m, &mtile, &ntile);
  const int m0 = mtile * R::kBM, n0 = ntile * BN;
  const int nk = (p.K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {   // producer
    if constexpr (NC > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t != 0) return;
    const int expert = p.eids ? p.eids[m0 / p.bt] : 0;
    int s = 0, phase = 0;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(empty0 + 8 * s, phase ^ 1);
      const uint32_t full = full0 + 8 * s;
      mbar_expect_tx(full, R::kStageBytes);
      tma_load_2d(a0 + s * R::kABytes, &map_a, full, kb * kBK, m0);
#pragma unroll
      for (int j = 0; j < BN / 64; ++j) {
        const uint32_t dst = b0 + s * R::kBBytes + j * kBoxBytes;
        if (p.eids)
          tma_load_3d(dst, &map_b, full, n0 + 64 * j, kb * kBK, expert);
        else
          tma_load_2d(dst, &map_b, full, n0 + 64 * j, kb * kBK);
      }
      if (++s == STAGES) { s = 0; phase ^= 1; }
    }
    return;
  }

  // consumers
  if constexpr (NC > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int s = 0, phase = 0;
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(full0 + 8 * s, phase);
    const uint32_t a = a0 + s * R::kABytes + wg * 64 * 128;
    const uint32_t b = b0 + s * R::kBBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if constexpr (BN == 256)
        wgmma_m64n256k16(acc, desc_a(a + kk * 32), desc_b(b + kk * 2048));
      else
        wgmma_m64n128k16(acc, desc_a(a + kk * 32), desc_b(b + kk * 2048));
    }
    wgmma_commit();
    wgmma_wait_all();
    release(empty0 + 8 * s, t);
    if (++s == STAGES) { s = 0; phase ^= 1; }
  }
  store_tile<BN>(acc, smem_raw + (staging - smem_u32(smem_raw)) +
                          (threadIdx.x / 32) * kStageWarpBytes,
                 p.c, p.M, p.N, m0 + wg * 64, n0, t);
}

// ---------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn) return fn;
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                   cudaEnableDefault, &q);
#else
  cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                          &q);
#endif
  if (q == cudaDriverEntryPointSuccess && ptr)
    fn = reinterpret_cast<EncodeTiled>(ptr);
  return fn;
}

// Error codes the launchers return beside CUDA's: the entry point is
// missing, or the driver refused a tensor map (kMapError + its CUresult).
constexpr int kNoEncoder = 100000;
constexpr int kMapError = 100001;

// A bf16 tensor map of rank 2 or 3 (dims innermost first, strides in
// bytes of dims 1..) with boxes of 64 x box1 (x 1), 128-byte swizzle, and
// zeros outside the tensor. Returns 0 or an error code.
inline int make_map(CUtensorMap* map, const void* ptr, int rank,
                    const cuuint64_t* dims, const cuuint64_t* strides,
                    cuuint32_t box1) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return kNoEncoder;
  const cuuint32_t box[3] = {64, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                   const_cast<void*>(ptr), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

// A row-major [rows, cols] bf16 matrix, boxes of 64 columns x box_rows.
inline int make_map_2d(CUtensorMap* map, const void* ptr, int rows, int cols,
                       int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  return make_map(map, ptr, 2, dims, strides, (cuuint32_t)box_rows);
}

// Launch the ring kernel on `p` with tensor maps of A and B made by the
// caller.
template <int BN, int NC, int STAGES>
int launch_ring(const CUtensorMap& map_a, const CUtensorMap& map_b,
                const Problem& p, cudaStream_t stream) {
  using R = Ring<BN, NC, STAGES>;
  auto kernel = ring_gemm_kernel<BN, NC, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.mt * p.nt, R::kThreads, R::kSmemBytes, stream>>>(map_a, map_b,
                                                              p);
  return (int)cudaGetLastError();
}

}  // namespace hopper
