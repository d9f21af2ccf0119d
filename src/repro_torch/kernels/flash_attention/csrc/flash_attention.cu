// Fused attention forward (flash schedule) for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_kernel (src/repro/kernels/
// flash_attention/kernel.py, body _body): q, k, v [BH, S, hd], both f32 or
// both bf16 -> out [BH, S, hd] in q's type, with scores q . k * scale
// (scale = hd ** -0.5, passed by the wrapper), an optional causal mask at
// -1e30 per element, and the fp32 online softmax (m, l, acc) over key
// tiles; out = acc / max(l, 1e-30). The S x S score matrix never reaches
// device memory.
//
// One block per (query tile of kBQ rows, batch*head) walks the key tiles
// of kBK rows in order. The TPU kernel's sequential key axis becomes that
// loop; nothing carries between blocks. Per key tile:
//   1. K is staged, transposed, in shared memory;
//   2. each thread forms a 4 x 4 patch of the scores (q from shared memory,
//      transposed too), masks it and stores it, transposed, in shared
//      memory;
//   3. V replaces K in shared memory while four threads per query row take
//      the row's max and sum of exponentials, and the row's m, l and the
//      correction exp(m_old - m_new) are updated;
//   4. each thread rescales its 4 x hd/16 patch of the accumulator, kept in
//      registers, and adds P @ V.
// Causal key tiles entirely above the diagonal are skipped (their terms are
// exp(-1e30 - m) = 0), and the query tiles with the most key tiles are
// launched first. hd is a template argument: 64, 96 or 128.
//
// What bounds it: operations. At jamba's attention shape (S 2048, 32 heads
// of 128, causal) the forward is 34 GFLOP against 42 MB of traffic in
// bf16; the bf16 tensor cores would need 35 us. This first form runs fp32
// FMAs on the CUDA cores with both operands from shared memory, so it stays
// far above that; mma/wgmma, TMA and a ring of key tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows of a block
constexpr int kBK = 64;        // key rows of a step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int kPad = kBQ + 4;  // row stride of the transposed tiles
constexpr float kNegInf = -1e30f;

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
                       int causal, float scale) {
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
  const T* qh = q + base;
  const T* kh = k + base;
  const T* vh = v + base;

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
           int S, int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, HD>;
  const size_t smem = (size_t)layout(HD).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh,
             int S, int hd, int causal, float scale, cudaStream_t st) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, out, bh, S, causal, scale, st);
    case 96: return launch<T, 96>(q, k, v, out, bh, S, causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, out, bh, S, causal, scale, st);
    default: return -1;
  }
}

}  // namespace

// 1 if the kernel takes head dim hd, else 0.
extern "C" int flash_attention_takes_head_dim(int hd) {
  return hd == 64 || hd == 96 || hd == 128;
}

// One launch on `stream`: q, k, v [BH, S, hd], all bf16 if bf16 else f32
// -> out [BH, S, hd] in the same type; scores are q . k * scale. Returns
// the CUDA error of the launch (0 on success), or -1 for arguments the
// kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int S, int hd, int causal, float scale,
                                      int bf16, void* stream) {
  if (bh < 1 || bh > 65535 || S < 1 || !flash_attention_takes_head_dim(hd))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, bh, S, hd, causal, scale,
                                   st);
  return dispatch<float>(q, k, v, out, bh, S, hd, causal, scale, st);
}
