// Device primitives of csrc/dp.cu that have no plain C++ spelling: the
// block's dynamic shared memory, the thread block cluster (rank, size,
// barrier, a pointer into another block's shared memory) and the
// cluster-scope release store / acquire load that signal a ring slot
// between two warps, which may sit in two blocks of one cluster.
//
// dp.cu uses nothing else that is specific to the device compiler apart
// from the warp intrinsics of cuda_runtime.h, so a rehearsal of the kernels
// as host C++ (a std::thread a CUDA thread) replaces this header and that
// one and compiles dp.cu unchanged.
#pragma once

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace dpdev {

namespace cg = cooperative_groups;

__device__ __forceinline__ uint8_t* dyn_smem() {
  extern __shared__ __align__(16) uint8_t dp_dyn_smem[];
  return dp_dyn_smem;
}

__device__ __forceinline__ int cluster_rank() {
  return static_cast<int>(cg::this_cluster().block_rank());
}

__device__ __forceinline__ int cluster_size() {
  return static_cast<int>(cg::this_cluster().num_blocks());
}

// Barrier over every thread of the cluster; orders shared, distributed
// shared and global memory (arrive.release / wait.acquire).
__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

// p, an address in this block's shared memory, as the same address in the
// shared memory of block `rank` of the cluster (a generic pointer).
template <class T>
__device__ __forceinline__ T* map_rank(T* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}

__device__ __forceinline__ void st_release_cluster(int* p, int v) {
  asm volatile("st.release.cluster.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_acquire_cluster(const int* p) {
  int v;
  asm volatile("ld.acquire.cluster.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

}  // namespace dpdev
