// Host stand-in for gsalign_tpu_torch/csrc/seed_dev.cuh (see
// tests/dp_host_rehearsal/cuda_runtime.h, which it is built over): the same
// functions over the stand-in's blocks, the grid barrier by the same
// protocol (a counter that every block adds one to, polled up to a target).
#pragma once

#include <cuda_runtime.h>

namespace seeddev {
inline unsigned long long* dyn_smem64() {
  return reinterpret_cast<unsigned long long*>(shim_block->smem);
}
inline void grid_sync(unsigned long long* word, unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __atomic_fetch_add(word, 1ull, __ATOMIC_RELEASE);
    while (__atomic_load_n(word, __ATOMIC_ACQUIRE) < target)
      std::this_thread::yield();
  }
  __syncthreads();
}
}  // namespace seeddev
