// Host stand-in for gsalign_tpu_torch/csrc/dp_dev.cuh (see cuda_runtime.h
// of this directory): the same functions over the stand-in's blocks.
#pragma once
#include <type_traits>

#include <cuda_runtime.h>

namespace dpdev {
inline uint8_t* dyn_smem() { return shim_block->smem; }
inline int cluster_size() { return (int)shim_cluster->blocks.size(); }
inline int cluster_rank() { return blockIdx.x % cluster_size(); }
inline void cluster_sync() { shim_cluster->bar->arrive_and_wait(); }
template <class T>
inline T* map_rank(T* p, int rank) {
  auto* mine = reinterpret_cast<const uint8_t*>(p);
  return reinterpret_cast<T*>(shim_cluster->blocks[rank]->smem +
                              (mine - shim_block->smem));
}
inline void st_release_cluster(int* p, int v) {
  __atomic_store_n(p, v, __ATOMIC_RELEASE);
}
inline int ld_acquire_cluster(const int* p) {
  return __atomic_load_n(p, __ATOMIC_ACQUIRE);
}
}  // namespace dpdev
