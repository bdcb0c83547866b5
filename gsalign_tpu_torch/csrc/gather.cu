// Masked gather of int32 words, hand-written for Hopper (sm_90a). Bound to
// Python through ops/gather.py (ctypes).
//
// Replaces the JAX package's Pallas kernel gsalign_tpu/ops/gather_pallas.py
// (_kernel, called by masked_row_gather): out[i] = table[idx[i]] where
// idx[i] >= 0, else 0. The seed scan's `pallas` SA mode uses it to read the
// suffix-array words of the lanes that enter direct extension in one
// iteration, compacted into K slots. Since the lock-step scan became one
// kernel (csrc/seed.cu, seed_lockstep) that read happens inside it, through
// the same masked_word of gather_dev.cuh; this stand-alone kernel remains
// the port of the Pallas kernel for a caller that has its indices in a
// tensor.
//
// The TPU kernel DMAs the whole aligned 1024-word block around each wanted
// word into VMEM and picks the word with a one-hot select, because Mosaic
// slices 1-D HBM refs only at that granularity. None of that carries over:
// here one thread reads its one 4-byte word, and a masked-off thread reads
// nothing. So neither K % 8 == 0 nor a 1024-padded table is required (the
// 1024-padded sa_rows is taken as it is). What bounds it on this card is
// latency, not bandwidth: K <= 512 independent random 4-byte reads from
// device memory, a few microseconds in all, less than the launch itself.

#include <cstdint>

#include <cuda_runtime.h>

#include "gather_dev.cuh"

namespace {

__global__ void masked_gather_kernel(const int32_t* __restrict__ table,
                                     const int32_t* __restrict__ idx, int K,
                                     int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K) return;
  out[i] = gatherdev::masked_word(table, idx[i]);
}

}  // namespace

// C entry point. Pointers are device pointers; stream is a cudaStream_t.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int gsalign_masked_gather(const void* table, const void* idx, int K,
                                     void* out, void* stream) {
  if (K <= 0) return 0;
  const int threads = 128;
  masked_gather_kernel<<<(K + threads - 1) / threads, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(idx), K,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
