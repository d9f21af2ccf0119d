// Fused attention forward (flash schedule) for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_kernel (src/repro/kernels/
// flash_attention/kernel.py:60, pallas_call :69, body _body :24): q
// [BH, S, hd], k and v [BH / group, S, hd], all f32 or all bf16 -> out
// [BH, S, hd] in q's type, with scores q . k * scale (scale = hd ** -0.5,
// passed by the wrapper), an optional causal mask at -1e30 per element, and
// the fp32 online softmax (m, l, acc) over key tiles; out = acc / max(l,
// 1e-30). The S x S score matrix never reaches device memory. GQA is
// indexed, not expanded: q's row bh (b * H + h) reads k/v row bh / group
// (b * Hkv + h / group, group = H / Hkv). One block per (query tile,
// batch*head) walks the key tiles in order, so the TPU kernel's sequential
// key axis becomes that loop and nothing carries between blocks; causal key
// tiles wholly above the diagonal are skipped (their terms are exp(-1e30 -
// m) = 0), and the query tiles with the most key tiles launch first. Three
// bodies, chosen by the wrapper (kernel.py's body()) before the launch and
// counted there:
//
// wgmma body (bf16, hd 64, 96 or 128, 16-byte aligned bases). What bounds
// it: operations. At jamba's attention shape (S 2048, 32 query heads on 8
// kv heads of 128, causal) the forward is 34.4 GFLOP against 42 MB of
// traffic, 35 us at the bf16 tensor-core peak. The design keeps the two
// products on the tensor cores and the softmax in registers:
//   - one block per 128 query rows: two consumer warpgroups of 64 rows and
//     a producer warpgroup whose one thread issues the TMA loads
//     (setmaxnreg: 40 registers for it, 232 for the consumers);
//   - Q [128 x hd] is loaded once; K and V tiles of 128 keys come through a
//     ring of 2 stages each (full/empty mbarriers per stage, K and V apart,
//     so S = Q K^T starts before V lands). Every tile is 128-byte swizzled
//     in boxes of 64 columns; hd 96 takes two boxes whose upper 32 columns
//     TMA fills with zeros, so it runs as hd 128 (a third more work).
//     Tensor maps are rank 3 ([BH, S, hd]), so a tile at a ragged S reads
//     zeros, never the next head's rows. 171 KB at hd 128 with the
//     epilogue's staging, so one block an SM;
//   - S = Q K^T: wgmma m64n128k16 with both operands in shared memory, K
//     read K-major (tnspB = 0), fp32 accumulators (64 a thread);
//   - the online softmax on that fragment: a row lives in 4 lanes of a
//     warp (two rows a thread), so its max and sum take two __shfl_xor
//     each; exp2 with log2(e) folded into the scale; masked scores (keys
//     past S, and above the diagonal in the diagonal tile only) are -1e30,
//     whose exp2 is exactly 0; l sums the fp32 probabilities per lane and
//     is reduced once at the end;
//   - O += P V: wgmma with A from registers, P rounded to bf16 in the A
//     fragment of each 16-key slice (the accumulator's layout, thread for
//     thread: hopper::a_fragment), V read MN-major (tnspB = 1); O stays in
//     registers over every key tile, rescaled by exp2(m_old - m_new);
//   - the epilogue divides by max(l, 1e-30), rounds to bf16 once and
//     stores through shared memory in 16-byte pieces (hopper::store_tile).
// What bounds it now, and what comes next: each product is waited on
// before the softmax that reads it, so the tensor cores idle while the
// exponentials run (tests/check_torch_flash_parts.py times the body
// without its softmax: on an H100 at jamba's shape the products alone take
// three fifths of the kernel's time). Next: overlap one warpgroup's
// softmax with the other's products (ping-pong, ordered by named
// barriers), or a tile's softmax with the next tile's Q K^T inside a
// warpgroup; then walk tiles persistently, and skip the fully masked half
// of the diagonal tile for the first warpgroup.
//
// tf32x3 body (fp32, hd 64, 96 or 128, 16-byte aligned bases). What bounds
// it: operations. At jamba's shape the forward is 34.4 GFLOP: 0.513 ms at
// the CUDA cores' 67 TFLOP/s, 0.209 ms at a third of the TF32 tensor
// cores' 494.7, which three TF32 mma.sync a product reach while keeping
// fp32's accuracy (tf32x3.cuh's split, the small-by-small product dropped).
// The design:
//   - one block of 8 warps per 128 query rows, each warp 16 rows; Q is
//     loaded once, raw, and split as its fragments are read;
//   - K and V tiles of 64 keys come through cp.async double buffers, K and
//     V apart, so S = Q K^T starts before V lands and each tile's loads
//     run under the previous tile's products (two barriers a key tile).
//     Rows are padded (Q and K to hd + 8 words, read in 64-bit pairs
//     along hd; V to hd + 4, read at key rows 2t and 2t + 1) so that
//     fragment loads fall in distinct banks. 202 KB at hd 128; with 146
//     to 208 registers a thread, one block (8 warps) an SM at every hd;
//   - S = Q K^T and O += P V by tf32x3::mma3 on m16n8k8 fragments, the
//     accumulators in registers (32 scores and hd / 2 outputs a thread);
//   - the online softmax on the accumulator fragment: a row lives in the 4
//     lanes of a quad, so its max and sum take two __shfl_xor each; exp2
//     with log2(e) folded into the scale; masked scores -1e30, whose exp2
//     is exactly 0; out = acc / max(l, 1e-30);
//   - P feeds O += P V from the accumulator with no shuffle: inside each
//     8-key slice the product's k order is permuted (A column t is key 2t,
//     t + 4 is key 2t + 1) and V's rows are read in that order;
//   - causal: a warp skips a key tile wholly above its 16 rows.
//   hd 96 runs as it is (12 k8 steps).
// simt body (fp32 and bf16 the other bodies do not take, e.g. unaligned
// bases): fp32 FMAs on the CUDA cores, 64 x 64 tiles. Per key tile, K is staged transposed in shared
// memory; each thread forms a 4 x 4 patch of scores, masks it and stores it
// transposed; V replaces K while four threads a query row take the row's
// max and sum; each thread rescales its 4 x hd/16 patch of the accumulator
// in registers and adds P @ V. hd is a template argument: 64, 96 or 128.
#include "../../csrc/hopper_gemm.cuh"
#include "../../csrc/tf32x3.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

// ------------------------------------------------------------ simt body
constexpr int kBQ = 64;        // query rows of a block
constexpr int kBK = 64;        // key rows of a step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int kPad = kBQ + 4;  // row stride of the transposed tiles

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

// Shared-memory layout, in floats: q^T [hd][kPad]; one buffer for K^T
// [hd][kPad] and then V [kBK][hd]; scores^T [kBK][kPad]; two [4][kBQ]
// buffers of the row reductions' partials; m, l, corr [kBQ].
struct Smem {
  int q, kv, s, red_max, red_sum, m, l, corr, total;
};

__host__ __device__ inline Smem layout(int hd) {
  Smem m;
  m.q = 0;
  m.kv = m.q + hd * kPad;
  m.s = m.kv + hd * kPad;
  m.red_max = m.s + kBK * kPad;
  m.red_sum = m.red_max + 4 * kBQ;
  m.m = m.red_sum + 4 * kBQ;
  m.l = m.m + kBQ;
  m.corr = m.l + kBQ;
  m.total = m.corr + kBQ;
  return m;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int group, int causal, float scale) {
  constexpr int W = HD / 16;   // accumulator columns a thread owns
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Smem L = layout(HD);
  float* qt = smem + L.q;
  float* kv = smem + L.kv;
  float* st = smem + L.s;
  float* red_max = smem + L.red_max;
  float* red_sum = smem + L.red_sum;
  float* m = smem + L.m;
  float* l = smem + L.l;
  float* corr = smem + L.corr;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;   // longest first
  const size_t base = (size_t)blockIdx.y * S * HD;
  const size_t kv_base = (size_t)(blockIdx.y / group) * S * HD;
  const T* qh = q + base;
  const T* kh = k + kv_base;
  const T* vh = v + kv_base;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e - r * HD;
    qt[d * kPad + r] = q0 + r < S ? to_f(qh[(size_t)(q0 + r) * HD + d]) : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  float acc[4][W];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j) acc[i][j] = 0.f;

  const int last = causal ? min(S - 1, q0 + kBQ - 1) : S - 1;
  for (int k0 = 0; k0 <= last; k0 += kBK) {
    __syncthreads();   // the last step's V and probabilities are read
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int c = e / HD, d = e - c * HD;
      kv[d * kPad + c] = k0 + c < S ? to_f(kh[(size_t)(k0 + c) * HD + d]) : 0.f;
    }
    __syncthreads();
    // ---- scores: rows ty*4.., key columns tx*4..
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&qt[d * kPad + ty * 4]);
      const float4 kc = *reinterpret_cast<const float4*>(&kv[d * kPad + tx * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qa[i] * ka[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool ok = kpos < S && (!causal || qpos >= kpos);
        st[(tx * 4 + j) * kPad + ty * 4 + i] = ok ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();
    // ---- V replaces K; row maxima, four threads a row, 16 columns each
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int c = e / HD, d = e - c * HD;
      kv[c * HD + d] = k0 + c < S ? to_f(vh[(size_t)(k0 + c) * HD + d]) : 0.f;
    }
    const int r = tid % kBQ, part = tid / kBQ;
    float mx = kNegInf;
    for (int c = part * 16; c < part * 16 + 16; ++c)
      mx = fmaxf(mx, st[c * kPad + r]);
    red_max[part * kBQ + r] = mx;
    __syncthreads();
    const float m_prev = m[r];
    const float m_new =
        fmaxf(fmaxf(m_prev, fmaxf(red_max[r], red_max[kBQ + r])),
              fmaxf(red_max[2 * kBQ + r], red_max[3 * kBQ + r]));
    float sum = 0.f;
    for (int c = part * 16; c < part * 16 + 16; ++c) {
      const float e = expf(st[c * kPad + r] - m_new);
      st[c * kPad + r] = e;
      sum += e;
    }
    red_sum[part * kBQ + r] = sum;
    __syncthreads();
    if (part == 0) {
      const float cr = expf(m_prev - m_new);
      l[r] = l[r] * cr + ((red_sum[r] + red_sum[kBQ + r]) +
                          (red_sum[2 * kBQ + r] + red_sum[3 * kBQ + r]));
      m[r] = m_new;
      corr[r] = cr;
    }
    __syncthreads();
    // ---- acc = acc * corr + P @ V: rows ty*4.., columns tx*W..
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cr = corr[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < W; ++j) acc[i][j] *= cr;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(&st[c * kPad + ty * 4]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      float va[W];
#pragma unroll
      for (int j = 0; j < W; ++j) va[j] = kv[c * HD + tx * W + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < W; ++j) acc[i][j] += pa[i] * va[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    if (q0 + row >= S) continue;
    const float inv = 1.f / fmaxf(l[row], 1e-30f);
    T* o = out + base + (size_t)(q0 + row) * HD + tx * W;
#pragma unroll
    for (int j = 0; j < W; ++j) from_f(acc[i][j] * inv, &o[j]);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int S, int group, int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, HD>;
  const size_t smem = (size_t)layout(HD).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, group, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh,
             int S, int hd, int group, int causal, float scale,
             cudaStream_t st) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, out, bh, S, group, causal, scale, st);
    case 96: return launch<T, 96>(q, k, v, out, bh, S, group, causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, out, bh, S, group, causal, scale, st);
    default: return -1;
  }
}

// ----------------------------------------------------------- wgmma body
constexpr int kWBQ = 128;   // query rows of a block (two warpgroups of 64)
constexpr int kWBK = 128;   // keys of a ring stage
constexpr int kWStages = 2;
constexpr int kWConsumers = 2;
constexpr int kWThreads = (kWConsumers + 1) * hopper::kWarpgroup;
constexpr int kTileBox = kWBK * 128;   // one [128 rows][64 bf16] box, 16 KB
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block at padded head dim HDP (64 or 128), in bytes
// from the 1024-aligned base: Q, the K ring, the V ring, the epilogue's
// staging (hopper::store_tile, 8 consumer warps), then the barriers:
// full_q, and per stage full_k, empty_k, full_v, empty_v.
template <int HDP>
struct FlashSmem {
  static constexpr int kBoxes = HDP / 64;
  static constexpr int kTile = kBoxes * kTileBox;   // Q, or one K or V stage
  static constexpr int kK = kTile;
  static constexpr int kV = kK + kWStages * kTile;
  static constexpr int kStaging = kV + kWStages * kTile;
  static constexpr int kBars =
      kStaging + 4 * kWConsumers * hopper::kStageWarpBytes;
  static constexpr int kBytes =
      hopper::kSmemAlign + kBars + 8 * (1 + 4 * kWStages);
};

enum StageBar { kFullK = 0, kEmptyK = 1, kFullV = 2, kEmptyV = 3 };

__device__ __forceinline__ uint32_t stage_bar(uint32_t bars, StageBar kind,
                                              int s) {
  return bars + 8 + 32 * s + 8 * kind;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD, int HDP>
__global__ void __launch_bounds__(kWThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   __nv_bfloat16* __restrict__ out, int S, int group,
                   int causal, float scale_log2) {
  using namespace hopper;
  using L = FlashSmem<HDP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (smem_u32(smem_raw) + kSmemAlign - 1) & ~(uint32_t)(kSmemAlign - 1);
  const uint32_t q_s = base, k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t bars = base + L::kBars, full_q = bars;
  const int wg = threadIdx.x / kWarpgroup, t = threadIdx.x % kWarpgroup;
  const int nq = (S + kWBQ - 1) / kWBQ;
  const int qt = nq - 1 - (int)blockIdx.y;   // longest first
  const int q0 = qt * kWBQ;
  const int bh = blockIdx.x;
  const int nk = causal ? qt + 1 : (S + kWBK - 1) / kWBK;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(stage_bar(bars, kFullK, s), 1);
      mbar_init(stage_bar(bars, kEmptyK, s), 4 * kWConsumers);
      mbar_init(stage_bar(bars, kFullV, s), 1);
      mbar_init(stage_bar(bars, kEmptyV, s), 4 * kWConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kWConsumers) {   // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t != 0) return;
    const int kvh = bh / group;
    mbar_expect_tx(full_q, L::kTile);
#pragma unroll
    for (int j = 0; j < L::kBoxes; ++j)
      tma_load_3d(q_s + j * kTileBox, &map_q, full_q, 64 * j, q0, bh);
    int s = 0, phase = 0;
    for (int kt = 0; kt < nk; ++kt) {
      const uint32_t fk = stage_bar(bars, kFullK, s);
      const uint32_t fv = stage_bar(bars, kFullV, s);
      mbar_wait(stage_bar(bars, kEmptyK, s), phase ^ 1);
      mbar_expect_tx(fk, L::kTile);
#pragma unroll
      for (int j = 0; j < L::kBoxes; ++j)
        tma_load_3d(k_s + s * L::kTile + j * kTileBox, &map_k, fk, 64 * j,
                    kt * kWBK, kvh);
      mbar_wait(stage_bar(bars, kEmptyV, s), phase ^ 1);
      mbar_expect_tx(fv, L::kTile);
#pragma unroll
      for (int j = 0; j < L::kBoxes; ++j)
        tma_load_3d(v_s + s * L::kTile + j * kTileBox, &map_v, fv, 64 * j,
                    kt * kWBK, kvh);
      if (++s == kWStages) { s = 0; phase ^= 1; }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg ..; thread t holds
  // rows r0 and r0 + 8 and, in every 8 columns, columns c0 and c0 + 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = t % 32;
  const int r0 = q0 + wg * 64 + (t / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint32_t qa = q_s + wg * 64 * 128;   // this warpgroup's rows of Q
  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(full_q, 0);
  int s = 0, phase = 0;
  for (int kt = 0; kt < nk; ++kt) {
    // ---- S = Q K^T (64 x 128 keys), overwriting sc
    float sc[64];
    mbar_wait(stage_bar(bars, kFullK, s), phase);
    const uint32_t kb = k_s + s * L::kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t off = (kk / 4) * kTileBox + (kk % 4) * 32;
      wgmma_m64n128k16<0>(sc, desc_a(qa + off), desc_a(kb + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    release(stage_bar(bars, kEmptyK, s), t);

    // ---- the online softmax, in log2 units, on the fragment
    const int k0 = kt * kWBK;
    const bool edge = k0 + kWBK > S || (causal && kt == qt);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float x = sc[i] * scale_log2;
      if (edge) {
        const int col = k0 + 8 * (i / 4) + c0 + (i % 2);
        const int row = r0 + 8 * ((i / 2) % 2);
        if (col >= S || (causal && col > row)) x = kNegInf;
      }
      sc[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = ex2(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      sc[i] = ex2(sc[i] - m[(i / 2) % 2]);
      sum[(i / 2) % 2] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] *= corr[(i / 2) % 2];
    uint32_t pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) a_fragment(sc, kk, pa[kk]);

    // ---- O += P V
    mbar_wait(stage_bar(bars, kFullV, s), phase);
    const uint32_t vb = v_s + s * L::kTile;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t dv = desc_b(vb + kk * 16 * 128, kTileBox);
      if constexpr (HDP == 128)
        wgmma_m64n128k16_rs(o, pa[kk], dv);
      else
        wgmma_m64n64k16_rs(o, pa[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    release(stage_bar(bars, kEmptyV, s), t);
    if (++s == kWStages) { s = 0; phase ^= 1; }
  }

  // ---- epilogue: l over the row's 4 lanes, O / max(l, 1e-30), bf16 once
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] *= inv[(i / 2) % 2];
  store_tile<HDP>(o,
                  smem_raw + (base - smem_u32(smem_raw)) + L::kStaging +
                      (threadIdx.x / 32) * kStageWarpBytes,
                  out + (size_t)bh * S * HD, S, HD, q0 + wg * 64, 0, t);
}

template <int HD, int HDP>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int bh, int S, int group, int causal, float scale,
                 cudaStream_t stream) {
  using L = FlashSmem<HDP>;
  CUtensorMap map_q, map_k, map_v;
  const cuuint64_t strides[2] = {(cuuint64_t)HD * 2, (cuuint64_t)S * HD * 2};
  const cuuint64_t dims_q[3] = {(cuuint64_t)HD, (cuuint64_t)S, (cuuint64_t)bh};
  const cuuint64_t dims_kv[3] = {(cuuint64_t)HD, (cuuint64_t)S,
                                 (cuuint64_t)(bh / group)};
  int err = hopper::make_map(&map_q, q, 3, dims_q, strides, kWBQ);
  if (!err) err = hopper::make_map(&map_k, k, 3, dims_kv, strides, kWBK);
  if (!err) err = hopper::make_map(&map_v, v, 3, dims_kv, strides, kWBK);
  if (err) return err;
  auto kernel = flash_wgmma_kernel<HD, HDP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(bh, (S + kWBQ - 1) / kWBQ);   // every head's longest tile first
  kernel<<<grid, kWThreads, L::kBytes, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(out), S, group,
      causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- tf32x3 body
// Query tiles of 128 rows, 8 warps of 16; key tiles of 64.
constexpr int kTBQ = 128;
constexpr int kTBK = 64;
constexpr int kTThreads = 256;

// Shared memory, in floats: Q [128][HD + 8] (raw) and two K stages
// [64][HD + 8], read in 64-bit pairs along hd (pitch = 8 mod 32 words),
// then two V stages [64][HD + 4], read at rows 2t and 2t + 1 (pitch = 4
// mod 32). 202 KB at hd 128, 154 KB at 96, 106 KB at 64.
template <int HD>
struct TfSmem {
  static constexpr int kPitch = HD + 8;    // Q and K
  static constexpr int kPitchV = HD + 4;
  static constexpr int kQ = kTBQ * kPitch;
  static constexpr int kK = kTBK * kPitch;
  static constexpr int kV = kTBK * kPitchV;
  static constexpr int kBytes = (kQ + 2 * kK + 2 * kV) * 4;
};

template <int HD>
__global__ void __launch_bounds__(kTThreads, 1)
flash_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    int S, int group, int causal, float scale_log2) {
  using namespace tf32x3;
  using L = TfSmem<HD>;
  constexpr int P = L::kPitch, PV = L::kPitchV, NT = HD / 8;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + L::kQ;        // stage s at ks + s * kK
  float* vs = ks + 2 * L::kK;    // stage s at vs + s * kV
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int nq = (S + kTBQ - 1) / kTBQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kTBQ;   // longest first
  const int bh = blockIdx.x;
  const float* qh = q + (size_t)bh * S * HD;
  const float* kh = k + (size_t)(bh / group) * S * HD;
  const float* vh = v + (size_t)(bh / group) * S * HD;
  const int nk = ((causal ? min(S, q0 + kTBQ) : S) + kTBK - 1) / kTBK;
  const int r_lo = q0 + 16 * warp;   // the warp's first query row

  // groups in flight, oldest first: [Q, K0], [V0], then per key tile kt
  // [K kt+1] and [V kt+1] (empty past the last tile)
  load_tile<kTBQ, HD, kTThreads>(qs, P, qh, HD, q0, 0, S, HD, tid);
  load_tile<kTBK, HD, kTThreads>(ks, P, kh, HD, 0, 0, S, HD, tid);
  async_cluster::commit_async();
  load_tile<kTBK, HD, kTThreads>(vs, PV, vh, HD, 0, 0, S, HD, tid);
  async_cluster::commit_async();

  float o[1][NT][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTBK, s = kt & 1;
    // K kt+1 takes the stage of K kt-1, which every warp has read (the
    // second barrier of the last step)
    if (kt + 1 < nk)
      load_tile<kTBK, HD, kTThreads>(ks + (s ^ 1) * L::kK, P, kh, HD,
                                     k0 + kTBK, 0, S, HD, tid);
    async_cluster::commit_async();
    async_cluster::wait_async<2>();   // K kt has landed
    __syncthreads();
    // causal: a key tile wholly above the warp's rows adds exp(-1e30 - m)
    // = 0 to each of them, so the warp skips it
    const bool active = !causal || k0 <= r_lo + 15;
    float sc[1][8][4] = {};
    if (active) {
      // ---- S = Q K^T (16 rows x 64 keys a warp)
      const float* kb = ks + s * L::kK;
#pragma unroll
      for (int d = 0; d < NT; ++d) {
        const FragA fq[1] = {load_a(qs + 16 * warp * P + 8 * d, P, lane)};
        FragB fk[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          fk[j] = load_b_nk(kb + 8 * j * P + 8 * d, P, lane);
        mma3(sc, fq, fk);
      }
      // ---- the online softmax on the fragment, in log2 units: c0, c1 are
      // row g at keys 2t, 2t + 1 of each 8; c2, c3 row g + 8
      const bool edge = k0 + kTBK > S || (causal && k0 + kTBK - 1 > r_lo);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = sc[0][j][i] * scale_log2;
          if (edge) {
            const int col = k0 + 8 * j + 2 * t + (i & 1);
            const int row = r_lo + g + 8 * (i >> 1);
            if (col >= S || (causal && col > row)) x = kNegInf;
          }
          sc[0][j][i] = x;
          mx[i >> 1] = fmaxf(mx[i >> 1], x);
        }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = ex2(m[h] - mx[h]);
        m[h] = mx[h];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[0][j][i] = ex2(sc[0][j][i] - m[i >> 1]);
          sum[i >> 1] += sc[0][j][i];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[0][n][i] *= corr[i >> 1];
    }
    // V kt+1 takes the stage of V kt-1, which every warp has read (the
    // first barrier of this step)
    if (kt + 1 < nk)
      load_tile<kTBK, HD, kTThreads>(vs + (s ^ 1) * L::kV, PV, vh, HD,
                                     k0 + kTBK, 0, S, HD, tid);
    async_cluster::commit_async();
    async_cluster::wait_async<2>();   // V kt has landed
    __syncthreads();
    if (active) {
      // ---- O += P V: P's 8-key slice j as the A operand straight from the
      // accumulator (keys 2t, 2t + 1 as columns t, t + 4), V's rows read in
      // that order
      const float* vb = vs + s * L::kV;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const FragA fp[1] = {a_from_c(sc[0][j])};
        FragB fv[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n)
          fv[n] = load_b(vb + 8 * j * PV + 8 * n, PV, lane);
        mma3(o, fp, fv);
      }
    }
  }

  // ---- epilogue: l over the row's 4 lanes, O / max(l, 1e-30)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    const int row = r_lo + g + 8 * h;
    if (row >= S) continue;
    float* dst = out + ((size_t)bh * S + row) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[0][n][2 * h] * inv, o[0][n][2 * h + 1] * inv);
  }
}

template <int HD>
int launch_tf32x3(const void* q, const void* k, const void* v, void* out,
                  int bh, int S, int group, int causal, float scale,
                  cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return -1;
  auto kernel = flash_tf32x3_kernel<HD>;
  int err = async_cluster::allow_smem(kernel, TfSmem<HD>::kBytes);
  if (err) return err;
  dim3 grid(bh, (S + kTBQ - 1) / kTBQ);   // every head's longest tile first
  kernel<<<grid, kTThreads, TfSmem<HD>::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, group,
      causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

// Every body takes head dims 64, 96 and 128 (kernel.py's HEAD_DIMS).
bool takes_head_dim(int hd) { return hd == 64 || hd == 96 || hd == 128; }

// The C entry's body codes (kernel.py's _BODY_CODE).
enum Body { kSimt = 0, kWgmma = 1, kTf32x3 = 2 };

}  // namespace

// One launch on `stream`: q [BH, S, hd], k and v [BH / group, S, hd], all
// bf16 if bf16 else f32 -> out [BH, S, hd] in the same type; scores are
// q . k * scale, and q's row bh reads k/v row bh / group. body 1 takes the
// wgmma body (bf16 only; 16-byte aligned bases), 2 the tf32x3 body (fp32
// only; 16-byte aligned bases), 0 the simt body. Returns the CUDA error of
// the launch (0 on success), hopper::kNoEncoder or kMapError + the CUresult
// of a tensor map, or -1 for arguments the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int S, int hd, int causal, float scale,
                                      int bf16, int body, int group,
                                      void* stream) {
  if (bh < 1 || bh > 65535 || S < 1 || group < 1 || bh % group ||
      !takes_head_dim(hd))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (body) {
    case kWgmma:
      if (!bf16) return -1;
      switch (hd) {
        case 64: return launch_wgmma<64, 64>(q, k, v, out, bh, S, group, causal, scale, st);
        case 96: return launch_wgmma<96, 128>(q, k, v, out, bh, S, group, causal, scale, st);
        default: return launch_wgmma<128, 128>(q, k, v, out, bh, S, group, causal, scale, st);
      }
    case kTf32x3:
      if (bf16) return -1;
      switch (hd) {
        case 64: return launch_tf32x3<64>(q, k, v, out, bh, S, group, causal, scale, st);
        case 96: return launch_tf32x3<96>(q, k, v, out, bh, S, group, causal, scale, st);
        default: return launch_tf32x3<128>(q, k, v, out, bh, S, group, causal, scale, st);
      }
    case kSimt:
      if (bf16)
        return dispatch<__nv_bfloat16>(q, k, v, out, bh, S, hd, group,
                                       causal, scale, st);
      return dispatch<float>(q, k, v, out, bh, S, hd, group, causal, scale,
                             st);
    default:
      return -1;
  }
}
