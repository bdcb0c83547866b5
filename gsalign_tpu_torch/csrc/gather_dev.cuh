// The masked gather's one read, shared by the stand-alone masked_gather
// kernel (csrc/gather.cu) and by the fused lock-step seed scan
// (csrc/seed.cu, seed_lockstep), where the lane that owns a compaction slot
// performs that slot's read itself. Plain C++ apart from the qualifiers, so
// a host rehearsal compiles it as it is.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace gatherdev {

// out = table[ix] where ix >= 0, else 0 (a masked-off slot reads nothing)
__device__ __forceinline__ int32_t masked_word(
    const int32_t* __restrict__ table, int32_t ix) {
  return ix >= 0 ? table[ix] : 0;
}

}  // namespace gatherdev
