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
// accumulator in fp32; out written once in q's type. Slots at or beyond
// seq_lens[b] score -1e30 before the max, as on the TPU, so a sequence of
// length 0 averages the V rows of every slot its (clamped) table names; l
// is clamped at 1e-30. The wrapper clamps the table; the kernel trusts it.
//
// What bounds it: bytes. A decode step reads every K and V row of its
// pages once (268 MB in bf16 at batch 32 x 2048 tokens, 8 kv heads of
// 128) for about 4 * G * hd operations a row, far below the card's
// operations-per-byte balance. Two bodies, chosen by shape before the
// launch (kernel.body):
//
// * split (G 1 to 8; rows of 1 to 32 whole 16-byte units; 16-byte aligned
//   bases). Each (sequence, kv head) is cut into S contiguous
//   ranges of its live slots (all slots for length 0, else the first
//   seq_lens[b]: later slots would weigh exp(-1e30 - m) = 0), one block of
//   four warps a range, the S blocks one thread-block cluster. A warp owns
//   tiles of 8 row groups: a row is hd * size bytes, read by LPR lanes at
//   16 bytes each, so a warp instruction covers 32 / LPR rows (2 in bf16 at
//   hd 128). Each lane copies its own 16-byte pieces of K and V by cp.async
//   into a ring of three tiles, two ahead of the one it computes, and reads
//   back only what it copied, so no barrier stands between the warps while
//   they stream. The block table is read once a page. q's G rows live in
//   registers, G rounded up to 1, 2, 4 or 8 (the spare rows zero, carried
//   and never written); a row's G dot products reduce by LPR-lane shuffles;
//   each warp keeps its own online softmax in registers (one max a tile
//   across its rows), and P V accumulates in registers. At the end the row
//   groups merge by shuffles, the warps through shared memory, and the
//   cluster's S partial (m, l, acc) through distributed shared memory, each
//   block writing 1 / S of out: one launch, no scratch buffer.
// * serial (any other shape): one block per (kv head, sequence) walks the
//   sequence's slots kRows at a time, loading each step's rows into shared
//   memory and keeping the G rows' running max, sum and accumulator there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../csrc/async_cluster.cuh"

namespace {

namespace ac = async_cluster;

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr unsigned kMinusInfBits = 0xff800000u;   // -inf, for rows past hi

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

// ------------------------------------------------------------- split body
constexpr int kWarps = kThreads / 32;
constexpr int kIt = 8;        // row groups a tile
constexpr int kStages = 3;    // ring: two tiles ahead
constexpr int kMaxSplits = 8;

// The 16 bytes of `u` as floats: 8 bf16 or 4 f32.
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       const __nv_bfloat16*) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
    f[2 * k] = v.x;
    f[2 * k + 1] = v.y;
  }
}

// Bytes of the split body's shared memory: the warps' rings, then the
// warps' (m, l) [kWarps][G] and acc [kWarps][G][hd], then the block's
// (m, l) [G] and acc [G][hd], which the cluster's peers read.
struct SplitSmem {
  int wm, wl, wa, bm, bl, ba, total;
};

__host__ __device__ inline SplitSmem split_layout(int g, int hd) {
  SplitSmem m;
  m.wm = kWarps * kStages * 2 * kIt * 32 * 16;
  m.wl = m.wm + kWarps * g * 4;
  m.wa = m.wl + kWarps * g * 4;
  m.bm = m.wa + kWarps * g * hd * 4;
  m.bl = m.bm + g * 4;
  m.ba = m.bl + g * 4;
  m.total = m.ba + g * hd * 4;
  return m;
}

// G query rows in registers, of which the first gq are q's.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ table,
                   const int* __restrict__ seq_lens, T* __restrict__ out,
                   int kvh, int gq, int hd, int page, int n_pages,
                   float scale, int lpr_log) {
  constexpr int kEpl = 16 / (int)sizeof(T);   // elements a lane a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  const SplitSmem L = split_layout(G, hd);
  const int n_split = gridDim.x;
  const unsigned rank = ac::cluster_rank();   // == blockIdx.x
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lpr = 1 << lpr_log, rpi = 32 >> lpr_log;
  const int rg = lane >> lpr_log, seg = lane & (lpr - 1);
  const int R = kIt * rpi;   // rows a tile

  // this block's range [lo, hi) of the live slots
  const int len = seq_lens[b];
  const int slots = n_pages * page;
  const int end = (len > 0 && len < slots) ? len : slots;
  const int chunk = ((end + n_split - 1) / n_split + R - 1) / R * R;
  const int lo = (int)rank * chunk;
  const int hi = min(end, lo + chunk);
  const int n_tiles = hi > lo ? (hi - lo + R - 1) / R : 0;
  const int mine = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps
                                  : 0;

  const int* tb = table + (size_t)b * n_pages;
  const size_t row_stride = (size_t)kvh * hd;
  const T* kh = kp + (size_t)h * hd + seg * kEpl;
  const T* vh = vp + (size_t)h * hd + seg * kEpl;
  uint4* ring = reinterpret_cast<uint4*>(smem) + warp * kStages * 2 * kIt * 32;

  // Issue the copies of this warp's i-th tile (rows lo + t * R + ...),
  // committed as one group (empty past the warp's last tile).
  auto issue = [&](int i) {
    if (i < mine) {
      const int r0 = lo + (warp + kWarps * i) * R + rg;
      int p = r0 / page, off = r0 - p * page, cached = -1, phys = 0;
      uint4* st = ring + (i % kStages) * 2 * kIt * 32;
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        if (r0 + it * rpi < hi) {
          if (p != cached) {
            phys = tb[p];
            cached = p;
          }
          const size_t o = ((size_t)phys * page + off) * row_stride;
          ac::copy_async(st + it * 32 + lane, kh + o, 16);
          ac::copy_async(st + (kIt + it) * 32 + lane, vh + o, 16);
        }
        off += rpi;
        while (off >= page) {
          off -= page;
          ++p;
        }
      }
    }
    ac::commit_async();
  };
  issue(0);
  issue(1);

  float qf[G][kEpl], acc[G][kEpl], m[G], l[G];
  const T* qh = q + ((size_t)b * kvh + h) * gq * hd + seg * kEpl;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < gq)
      unpack(*reinterpret_cast<const uint4*>(qh + (size_t)g * hd), qf[g], qh);
    else
#pragma unroll
      for (int e = 0; e < kEpl; ++e) qf[g][e] = 0.f;
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kEpl; ++e) acc[g][e] = 0.f;
  }

  for (int i = 0; i < mine; ++i) {
    ac::wait_async<1>();   // this lane's copies of tile i landed
    issue(i + 2);
    const uint4* st = ring + (i % kStages) * 2 * kIt * 32;
    const int r0 = lo + (warp + kWarps * i) * R + rg;
    float sc[kIt][G];
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      float kf[kEpl];
      unpack(st[it * 32 + lane], kf, kh);
      float d[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        d[g] = 0.f;
#pragma unroll
        for (int e = 0; e < kEpl; ++e) d[g] = fmaf(qf[g][e], kf[e], d[g]);
      }
      for (int o = lpr >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          d[g] += __shfl_xor_sync(0xffffffffu, d[g], o);
      const bool live = r0 + it * rpi < hi;
#pragma unroll
      for (int g = 0; g < G; ++g)
        sc[it][g] = live ? (len > 0 ? d[g] * scale : kNegInf)
                         : __uint_as_float(kMinusInfBits);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float tm = sc[0][g];
#pragma unroll
      for (int it = 1; it < kIt; ++it) tm = fmaxf(tm, sc[it][g]);
      for (int o = lpr; o < 32; o <<= 1)
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, o));
      const float mn = fmaxf(m[g], tm);
      const float corr = expf(m[g] - mn);
      m[g] = mn;
      float sum = 0.f;
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        sc[it][g] = expf(sc[it][g] - mn);
        sum += sc[it][g];
      }
      l[g] = l[g] * corr + sum;
#pragma unroll
      for (int e = 0; e < kEpl; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      float vf[kEpl];
      unpack(st[(kIt + it) * 32 + lane], vf, vh);
      const bool live = r0 + it * rpi < hi;
#pragma unroll
      for (int e = 0; e < kEpl; ++e) vf[e] = live ? vf[e] : 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < kEpl; ++e)
          acc[g][e] = fmaf(sc[it][g], vf[e], acc[g][e]);
    }
  }

  // row groups -> the warp (all on one max), then the warps -> the block
  for (int o = lpr; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int e = 0; e < kEpl; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
  float* wm = reinterpret_cast<float*>(smem + L.wm);
  float* wl = reinterpret_cast<float*>(smem + L.wl);
  float* wa = reinterpret_cast<float*>(smem + L.wa);
  float* bm = reinterpret_cast<float*>(smem + L.bm);
  float* bl = reinterpret_cast<float*>(smem + L.bl);
  float* ba = reinterpret_cast<float*>(smem + L.ba);
  if (rg == 0)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < kEpl; ++e)
        wa[(warp * G + g) * hd + seg * kEpl + e] = acc[g][e];
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = l[g];
    }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = wm[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float f[kWarps], sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      f[w] = expf(wm[w * G + g] - mx);
      sum += wl[w * G + g] * f[w];
    }
    for (int e = tid; e < hd; e += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += wa[(w * G + g) * hd + e] * f[w];
      ba[g * hd + e] = a;
    }
    if (tid == 0) {
      bm[g] = mx;
      bl[g] = sum;
    }
  }
  ac::cluster_sync();   // every block's (m, l, acc) of its range

  // the cluster's blocks -> out: this block writes entries rank, rank + S,
  // ... of [gq, hd]
  const int hd_log = __ffs(hd) - 1;
  T* o = out + ((size_t)b * kvh + h) * gq * hd;
  for (int x = (int)rank + n_split * tid; x < gq * hd;
       x += n_split * kThreads) {
    const int g = x >> hd_log;
    float pm[kMaxSplits], mx = kNegInf;
    for (int s = 0; s < n_split; ++s) {
      pm[s] = ac::load_peer(ac::peer_addr(bm + g, s));
      mx = fmaxf(mx, pm[s]);
    }
    float sum = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float f = expf(pm[s] - mx);
      sum += ac::load_peer(ac::peer_addr(bl + g, s)) * f;
      a += ac::load_peer(ac::peer_addr(ba + x, s)) * f;
    }
    from_f(a / fmaxf(sum, 1e-30f), &o[x]);
  }
  ac::cluster_sync();   // no block leaves while its peers read it
}

// ------------------------------------------------------------ serial body
constexpr int kRows = 32;   // K and V rows staged per step

// Shared-memory layout, in floats. K and V rows are padded to hd + 1 so
// that threads reading one column of neighbouring rows hit distinct banks.
struct SerialSmem {
  int q, k, v, s, acc, m, l, corr, total;
};

__host__ __device__ inline SerialSmem serial_layout(int g, int hd) {
  SerialSmem m;
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
paged_serial_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp,
                    const int* __restrict__ block_table,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    int kvh, int g, int hd, int page, int n_pages,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const SerialSmem L = serial_layout(g, hd);
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

// ------------------------------------------------------------- launchers
template <typename T>
int launch_serial(const void* q, const void* kp, const void* vp,
                  const int* bt, const int* sl, void* out, int bsz, int kvh,
                  int g, int hd, int page, int n_pages, float scale,
                  size_t smem, cudaStream_t stream) {
  auto kernel = paged_serial_kernel<T>;
  int err = ac::allow_smem(kernel, smem);
  if (err) return err;
  dim3 grid(kvh, bsz);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, sl, static_cast<T*>(out), kvh, g, hd,
      page, n_pages, scale);
  return (int)cudaGetLastError();
}

template <typename T, int G>
int launch_split(const void* q, const void* kp, const void* vp,
                 const int* bt, const int* sl, void* out, int bsz, int kvh,
                 int g, int hd, int page, int n_pages, float scale,
                 int splits, int lpr_log, size_t smem, cudaStream_t stream) {
  auto kernel = paged_split_kernel<T, G>;
  int err = ac::allow_smem(kernel, smem);
  if (err) return err;
  return ac::launch_cluster(
      kernel, dim3(splits, kvh, bsz), dim3(kThreads), smem,
      dim3(splits, 1, 1), stream, static_cast<const T*>(q),
      static_cast<const T*>(kp), static_cast<const T*>(vp), bt, sl,
      static_cast<T*>(out), kvh, g, hd, page, n_pages, scale, lpr_log);
}

// The query rows the split body holds for g: g rounded up to 1, 2, 4, 8.
int split_group(int g) { return g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8; }

template <typename T>
int by_g(int g, const void* q, const void* kp, const void* vp, const int* bt,
         const int* sl, void* out, int bsz, int kvh, int hd, int page,
         int n_pages, float scale, int splits, int lpr_log, size_t smem,
         cudaStream_t st) {
  switch (split_group(g)) {
    case 1:
      return launch_split<T, 1>(q, kp, vp, bt, sl, out, bsz, kvh, g, hd,
                                page, n_pages, scale, splits, lpr_log, smem,
                                st);
    case 2:
      return launch_split<T, 2>(q, kp, vp, bt, sl, out, bsz, kvh, g, hd,
                                page, n_pages, scale, splits, lpr_log, smem,
                                st);
    case 4:
      return launch_split<T, 4>(q, kp, vp, bt, sl, out, bsz, kvh, g, hd,
                                page, n_pages, scale, splits, lpr_log, smem,
                                st);
    default:
      return launch_split<T, 8>(q, kp, vp, bt, sl, out, bsz, kvh, g, hd,
                                page, n_pages, scale, splits, lpr_log, smem,
                                st);
  }
}

// log2 of the lanes a row of hd elements of `es` bytes takes at 16 bytes
// each, or -1 where the split body does not take the row: 1 to 32 whole
// 16-byte units, a power of two.
int lanes_log(int hd, int es) {
  const int bytes = hd * es;
  if (bytes % 16 != 0) return -1;
  const int lanes = bytes / 16;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0) return -1;
  return __builtin_ctz(lanes);
}

bool split_takes(int g, int hd, int es) {
  return g >= 1 && g <= 8 && lanes_log(hd, es) >= 0;
}

}  // namespace

// Dynamic shared memory of one launch at (G, hd) on the split body if
// `split` else the serial body, in bytes, or -1 for a shape that body does
// not take.
extern "C" long long paged_attention_smem_bytes(int g, int hd, int bf16,
                                                int split) {
  if (g < 1 || hd < 1) return -1;
  if (split)
    return split_takes(g, hd, bf16 ? 2 : 4)
               ? split_layout(split_group(g), hd).total
               : -1;
  return (long long)serial_layout(g, hd).total * sizeof(float);
}

// One launch on `stream`: q [B, KVH, G, hd], k_pages and v_pages [P, page,
// KVH, hd], all bf16 if bf16 else f32, block_table [B, n_pages] int32 in
// [0, P), seq_lens [B] int32 -> out [B, KVH, G, hd] in q's type; scores
// are q . k * scale (the wrapper passes hd ** -0.5). On the split body
// (`split`; q, k_pages and v_pages 16-byte aligned) each (sequence, kv
// head) is cut over a cluster of `splits` blocks (1, 2, 4 or 8). Returns
// the CUDA error of the launch (0 on success), or -1 for arguments the
// kernel does not take.
extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const void* bt,
                                      const void* sl, void* out, int bsz,
                                      int kvh, int g, int hd, int page,
                                      int n_pages, float scale, int bf16,
                                      int split, int splits, void* stream) {
  const long long smem = paged_attention_smem_bytes(g, hd, bf16, split);
  if (smem < 0 || bsz < 1 || kvh < 1 || page < 1 || n_pages < 1 ||
      bsz > 65535)
    return -1;
  const int* bt_ = static_cast<const int*>(bt);
  const int* sl_ = static_cast<const int*>(sl);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split) {
    if ((splits != 1 && splits != 2 && splits != 4 && splits != kMaxSplits) ||
        kvh > 65535 ||
        ac::copy_unit({(unsigned long long)q, (unsigned long long)kp,
                       (unsigned long long)vp}) != 16)
      return -1;
    const int lg = lanes_log(hd, bf16 ? 2 : 4);
    if (bf16)
      return by_g<__nv_bfloat16>(g, q, kp, vp, bt_, sl_, out, bsz, kvh, hd,
                                 page, n_pages, scale, splits, lg,
                                 (size_t)smem, st);
    return by_g<float>(g, q, kp, vp, bt_, sl_, out, bsz, kvh, hd, page,
                       n_pages, scale, splits, lg, (size_t)smem, st);
  }
  if (bf16)
    return launch_serial<__nv_bfloat16>(q, kp, vp, bt_, sl_, out, bsz, kvh,
                                        g, hd, page, n_pages, scale,
                                        (size_t)smem, st);
  return launch_serial<float>(q, kp, vp, bt_, sl_, out, bsz, kvh, g, hd, page,
                              n_pages, scale, (size_t)smem, st);
}
