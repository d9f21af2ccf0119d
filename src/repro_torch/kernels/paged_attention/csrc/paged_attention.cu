// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paged_attention_kernel (src/repro/kernels/
// paged_attention/kernel.py, body _body). One query token per sequence
// attends over a paged KV cache through a block table:
//
//   q [B, KVH, G, hd]   k, v pages [P, page, KVH, hd]   block_table [B, n]
//   seq_lens [B]   ->   out [B, KVH, G, hd]
//
// q and the pages both f32 or both bf16; scores, the online softmax and the
// accumulator in fp32; out written once in q's type. One block per (kv
// head, sequence) walks the sequence's n * page slots in order, kRows at a
// time (a step may span pages: each row looks its page up in the table),
// and keeps the G query rows' running max m, sum l and accumulator in
// shared memory. Slots at or beyond seq_lens[b] score -1e30 before the max,
// as on the TPU, so a sequence of length 0 averages the V rows of every
// slot its (clamped) table names. The wrapper clamps the table; the kernel
// trusts it.
//
// What bounds it: bytes. A decode step reads every K and V row of its
// pages once (268 MB in bf16 at batch 32 x 2048 tokens, 8 kv heads of
// 128) for about 4 * G * hd operations a row, far below the card's
// operations-per-byte balance. This first form loads each step's rows
// synchronously into shared memory (no TMA, no double buffering), so the
// loads' latency is exposed between steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;   // K and V rows staged per step
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

// Shared-memory layout, in floats. K and V rows are padded to hd + 1 so
// that threads reading one column of neighbouring rows hit distinct banks.
struct Smem {
  int q, k, v, s, acc, m, l, corr, total;
};

__host__ __device__ inline Smem layout(int g, int hd) {
  Smem m;
  m.q = 0;
  m.k = m.q + g * hd;
  m.v = m.k + kRows * (hd + 1);
  m.s = m.v + kRows * (hd + 1);
  m.acc = m.s + g * kRows;
  m.m = m.acc + g * hd;
  m.l = m.m + g;
  m.corr = m.l + g;
  m.total = m.corr + g;
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ block_table,
                       const int* __restrict__ seq_lens, T* __restrict__ out,
                       int kvh, int g, int hd, int page, int n_pages,
                       float scale) {
  extern __shared__ float smem[];
  const Smem L = layout(g, hd);
  float* qs = smem + L.q;
  float* ks = smem + L.k;
  float* vs = smem + L.v;
  float* ss = smem + L.s;
  float* acc = smem + L.acc;
  float* m = smem + L.m;
  float* l = smem + L.l;
  float* corr = smem + L.corr;
  const int hdp = hd + 1;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int len = seq_lens[b];
  const int* table = block_table + (size_t)b * n_pages;
  const size_t qo = ((size_t)b * kvh + h) * g * hd;

  for (int e = tid; e < g * hd; e += kThreads) {
    qs[e] = to_f(q[qo + e]);
    acc[e] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  const int slots = n_pages * page;
  for (int s0 = 0; s0 < slots; s0 += kRows) {
    const int rows = min(kRows, slots - s0);
    __syncthreads();   // the last step's rows and scores are read
    for (int e = tid; e < rows * hd; e += kThreads) {
      const int r = e / hd, d = e - r * hd;
      const int pos = s0 + r, p = pos / page;
      const size_t src =
          (((size_t)table[p] * page + (pos - p * page)) * kvh + h) * hd + d;
      ks[r * hdp + d] = to_f(kp[src]);
      vs[r * hdp + d] = to_f(vp[src]);
    }
    __syncthreads();
    for (int e = tid; e < g * rows; e += kThreads) {
      const int gi = e / rows, r = e - gi * rows;
      const float* qg = qs + gi * hd;
      const float* kr = ks + r * hdp;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot += qg[d] * kr[d];
      ss[gi * kRows + r] = s0 + r < len ? dot * scale : kNegInf;
    }
    __syncthreads();
    for (int gi = tid; gi < g; gi += kThreads) {
      float* sg = ss + gi * kRows;
      const float m_prev = m[gi];
      float m_new = m_prev;
      for (int r = 0; r < rows; ++r) m_new = fmaxf(m_new, sg[r]);
      float sum = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float e = expf(sg[r] - m_new);
        sg[r] = e;
        sum += e;
      }
      const float c = expf(m_prev - m_new);
      l[gi] = l[gi] * c + sum;
      m[gi] = m_new;
      corr[gi] = c;
    }
    __syncthreads();
    for (int e = tid; e < g * hd; e += kThreads) {
      const int gi = e / hd, d = e - gi * hd;
      const float* sg = ss + gi * kRows;
      float a = acc[e] * corr[gi];
      for (int r = 0; r < rows; ++r) a += sg[r] * vs[r * hdp + d];
      acc[e] = a;
    }
  }
  __syncthreads();
  for (int e = tid; e < g * hd; e += kThreads)
    from_f(acc[e] / fmaxf(l[e / hd], 1e-30f), &out[qo + e]);
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* sl, void* out, int bsz, int kvh, int g, int hd,
           int page, int n_pages, float scale, size_t smem,
           cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kvh, bsz);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, sl, static_cast<T*>(out), kvh, g, hd,
      page, n_pages, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one launch at (G, hd), in bytes.
extern "C" long long paged_attention_smem_bytes(int g, int hd) {
  if (g < 1 || hd < 1) return -1;
  return (long long)layout(g, hd).total * sizeof(float);
}

// One launch on `stream`: q [B, KVH, G, hd], k_pages and v_pages [P, page,
// KVH, hd], all bf16 if bf16 else f32, block_table [B, n_pages] int32 in
// [0, P), seq_lens [B] int32 -> out [B, KVH, G, hd] in q's type; scores
// are q . k * scale (the wrapper passes hd ** -0.5). Returns
// the CUDA error of the launch (0 on success), or -1 for arguments the
// kernel does not take.
extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const void* bt,
                                      const void* sl, void* out, int bsz,
                                      int kvh, int g, int hd, int page,
                                      int n_pages, float scale, int bf16,
                                      void* stream) {
  const long long smem = paged_attention_smem_bytes(g, hd);
  if (smem < 0 || bsz < 1 || kvh < 1 || page < 1 || n_pages < 1 ||
      bsz > 65535)
    return -1;
  const int* bt_ = static_cast<const int*>(bt);
  const int* sl_ = static_cast<const int*>(sl);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, kp, vp, bt_, sl_, out, bsz, kvh, g, hd,
                                 page, n_pages, scale, (size_t)smem, st);
  return launch<float>(q, kp, vp, bt_, sl_, out, bsz, kvh, g, hd, page,
                       n_pages, scale, (size_t)smem, st);
}
