// Asynchronous copies and thread-block-cluster helpers for Hopper (sm_90a),
// shared by the SSD-scan and paged-attention kernels and the grouped
// GEMM's stream body.
//
// copy_async moves one unit of 16, 8 or 4 bytes from global to shared
// memory by cp.async (2 bytes, for a bf16 tensor whose base is not 4-byte
// aligned, by a plain load and store); a thread commits its copies as one
// group and waits with wait_async<n>() until at most n of its groups are in
// flight. The cluster helpers read and write a peer block's shared memory
// (mapa + ld/st.shared::cluster) and synchronise every thread of the
// cluster, with release/acquire ordering of shared-memory writes at
// cluster scope.
#pragma once
#include <cuda_runtime.h>

#include <initializer_list>

namespace async_cluster {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One unit of `unit` bytes (16, 8, 4 or 2) from `src` to `dst`; both
// aligned to the unit.
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int unit) {
  const unsigned d = smem_addr(dst);
  if (unit == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else if (unit == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else if (unit == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    *static_cast<unsigned short*>(dst) =
        *static_cast<const unsigned short*>(src);
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int n>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// The largest unit of 16, 8, 4 or 2 bytes that divides every value in
// `v` (addresses and byte counts).
inline int copy_unit(std::initializer_list<unsigned long long> v) {
  int unit = 16;
  for (unsigned long long x : v)
    while (unit > 2 && x % unit != 0) unit /= 2;
  return unit;
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address of `p` (in this block's shared memory) in block `rank`'s.
__device__ __forceinline__ unsigned peer_addr(const void* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_addr(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ float load_peer(unsigned addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_peer(unsigned addr, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(v.x), "f"(v.y)
               : "memory");
}

// Every thread of every block of the cluster arrives, then waits.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// Launch `kernel` on `grid` x `block` with `smem` bytes of dynamic shared
// memory and clusters of `cluster` blocks. Returns a CUDA error code.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), dim3 grid, dim3 block,
                   size_t smem, dim3 cluster, cudaStream_t stream,
                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Raise `kernel`'s dynamic shared-memory limit to `bytes` (needed above
// 48 KB). Returns a CUDA error code.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace async_cluster
