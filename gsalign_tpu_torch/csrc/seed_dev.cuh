// Device primitives of csrc/seed.cu that have no plain C++ spelling: the
// block's dynamic shared memory and the release and acquire of the barrier
// over every block of a cooperatively launched grid. seed.cu uses nothing
// else that is specific to the device compiler apart from the warp
// intrinsics of cuda_runtime.h, so a rehearsal of the kernels as host C++
// (a std::thread a CUDA thread) replaces this header and that one and
// compiles seed.cu unchanged.
#pragma once

#include <cuda_runtime.h>

namespace seeddev {

__device__ __forceinline__ unsigned long long* dyn_smem64() {
  extern __shared__ unsigned long long seed_dyn_smem[];
  return seed_dyn_smem;
}

// Barrier over every thread of the grid, which must have been launched
// cooperatively (all blocks resident at once, or the wait never ends).
// `word` is a counter in global memory, zero at launch, to which every
// block adds one at each barrier: the k-th barrier (k = 1, 2, ...) is
// passed when the counter reads target = k * gridDim.x, so it is never
// reset. Thread 0 of a block arrives with a release and polls with an
// acquire, between two block barriers: what any thread of the grid wrote
// to global memory before the barrier is visible to every thread after it
// (to reads that do not go through the L1 cache: __ldcg).
__device__ __forceinline__ void grid_sync(unsigned long long* word,
                                          unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u64 [%0], %1;" ::"l"(word),
                 "l"(1ull)
                 : "memory");
    unsigned long long seen;
    do {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                   : "=l"(seen)
                   : "l"(word)
                   : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

}  // namespace seeddev
