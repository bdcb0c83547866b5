// Host stand-in for cuda_runtime.h, for rehearsing gsalign_tpu_torch/csrc/
// dp.cu, seed.cu, probe.cu and layout.cu without a CUDA compiler or card:
// the source is compiled unchanged as C++20 by g++ with this directory
// first on the include path.
// A launch (cudaLaunchKernelEx) runs every CUDA thread of the grid as a
// std::thread; warp shuffles, votes, reductions and __syncwarp are
// exchanges through a per-warp array between two std::barrier waits,
// __syncthreads a per-block barrier, the cluster barrier one over the
// cluster's blocks, dynamic shared memory a buffer a block; all blocks of a
// grid run at once, as a cooperative launch's do. An exchange whose mask is
// not the whole warp waits only for the threads the mask names (a barrier
// a mask, made at its first use), so a group of a warp that has left its
// loop does not hold the others, as on the card. It checks arithmetic,
// indexing and the protocols between warps and blocks; it says nothing of
// what nvcc accepts or of speed. Keep problems small: a thread a CUDA
// thread. The stand-in device holds 10 blocks at once (5 SMs of 2).
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __align__(n)
#define __launch_bounds__(n)
#define __grid_constant__
using std::max;
using std::min;
struct dim3 { unsigned x = 1, y = 1, z = 1; dim3() {} dim3(unsigned a) : x(a) {} };
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return uint4{a, b, c, d}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorPeerAccessAlreadyEnabled = 704;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
enum { cudaLaunchAttributeCooperative = 2, cudaLaunchAttributeClusterDimension = 4 };
enum { cudaDevAttrMultiProcessorCount = 16 };
struct cudaLaunchAttribute { int id; struct { struct { unsigned x, y, z; } clusterDim; int cooperative; } val; };
struct cudaLaunchConfig_t { dim3 gridDim, blockDim; size_t dynamicSmemBytes; cudaStream_t stream; cudaLaunchAttribute* attrs; unsigned numAttrs; };
template <class K> cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) { std::memset(p, v, n); return 0; }
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return 0; }
inline cudaError_t cudaDeviceEnablePeerAccess(int, unsigned) { return cudaErrorPeerAccessAlreadyEnabled; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 5; return 0; }
struct cudaFuncAttributes { int numRegs; };
template <class K> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) { a->numRegs = 32; return 0; }
template <class K> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) { *n = 2; return 0; }

struct ShimWarp {
  std::barrier<> bar{32}; long long slot[32];
  std::mutex mu; std::map<unsigned, std::unique_ptr<std::barrier<>>> part;
};
struct ShimBlock { std::unique_ptr<std::barrier<>> bar; uint8_t* smem; std::vector<ShimWarp> warps; };
struct ShimCluster { std::unique_ptr<std::barrier<>> bar; std::vector<ShimBlock*> blocks; };
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local ShimWarp* shim_warp;
inline thread_local ShimBlock* shim_block;
inline thread_local ShimCluster* shim_cluster;

// the barrier of the threads that `mask` names in this thread's warp
inline std::barrier<>& shim_bar(unsigned mask) {
  if (mask == 0xFFFFFFFFu) return shim_warp->bar;
  std::lock_guard<std::mutex> lock(shim_warp->mu);
  auto& b = shim_warp->part[mask];
  if (!b) b = std::make_unique<std::barrier<>>(__builtin_popcount(mask));
  return *b;
}
// publish v in this lane's slot, wait for the mask's threads, read lane
// `src`'s value, wait again (the slot may be written by the next exchange)
template <class T> inline T shim_exchange(unsigned mask, T v, int src) {
  static_assert(sizeof(T) <= sizeof(long long));
  long long w = 0; std::memcpy(&w, &v, sizeof(T));
  std::barrier<>& b = shim_bar(mask);
  shim_warp->slot[threadIdx.x & 31] = w; b.arrive_and_wait();
  w = shim_warp->slot[src & 31]; b.arrive_and_wait();
  T r; std::memcpy(&r, &w, sizeof(T)); return r; }

inline void __syncwarp(unsigned mask = 0xFFFFFFFFu) { shim_bar(mask).arrive_and_wait(); }
inline void __syncthreads() { shim_block->bar->arrive_and_wait(); }
template <class T> inline T __shfl_sync(unsigned mask, T v, int src) { return shim_exchange(mask, v, src); }
template <class T> inline T __shfl_xor_sync(unsigned mask, T v, int lane_mask) {
  return shim_exchange(mask, v, (threadIdx.x & 31) ^ lane_mask); }
inline int __shfl_up_sync(unsigned mask, int v, int d) {
  int lane = threadIdx.x & 31;
  return shim_exchange(mask, v, lane >= d ? lane - d : lane); }
inline int __vibmax_s32(int a, int b, bool* p) { *p = a >= b; return a >= b ? a : b; }
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) { uint64_t w = ((uint64_t)y << 32) | x; uint32_t r = 0; for (int i = 0; i < 4; ++i) { uint32_t sel = (s >> (4 * i)) & 0xf; uint32_t b = (w >> (8 * (sel & 7))) & 0xff; if (sel & 8) b = (b & 0x80) ? 0xff : 0; r |= b << (8 * i); } return r; }
template <class T> inline T __ldcg(const T* p) { return *p; }
template <class T> inline void __stcg(T* p, T v) { *p = v; }
inline int __shfl_down_sync(unsigned mask, int v, int d) {
  int lane = threadIdx.x & 31;
  return shim_exchange(mask, v, lane + d < 32 ? lane + d : lane); }
inline unsigned __ballot_sync(unsigned mask, bool p) {
  std::barrier<>& b = shim_bar(mask);
  shim_warp->slot[threadIdx.x & 31] = p; b.arrive_and_wait();
  unsigned r = 0; for (int i = 0; i < 32; ++i) if (mask >> i & 1) r |= (unsigned)(shim_warp->slot[i] != 0) << i;
  b.arrive_and_wait(); return r; }
inline unsigned __reduce_add_sync(unsigned mask, unsigned v) {
  std::barrier<>& b = shim_bar(mask);
  shim_warp->slot[threadIdx.x & 31] = v; b.arrive_and_wait();
  unsigned r = 0; for (int i = 0; i < 32; ++i) if (mask >> i & 1) r += (unsigned)shim_warp->slot[i];
  b.arrive_and_wait(); return r; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) { return __atomic_fetch_add(p, v, __ATOMIC_RELAXED); }
inline unsigned atomicAdd(unsigned* p, unsigned v) { return __atomic_fetch_add(p, v, __ATOMIC_RELAXED); }
inline void __nanosleep(unsigned) { std::this_thread::yield(); }

template <class... Exp, class... Act>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(Exp...), Act&&... args) {
  unsigned cs = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) cs = cfg->attrs[i].val.clusterDim.x;
  const unsigned nb = cfg->gridDim.x, nt = cfg->blockDim.x;
  std::vector<ShimBlock> blocks(nb);
  std::vector<ShimCluster> clusters(nb / cs);
  for (unsigned b = 0; b < nb; ++b) {
    blocks[b].bar = std::make_unique<std::barrier<>>(nt);
    blocks[b].smem = static_cast<uint8_t*>(std::aligned_alloc(128, (cfg->dynamicSmemBytes + 127) / 128 * 128 + 128));
    std::memset(blocks[b].smem, 0xAB, cfg->dynamicSmemBytes);
    blocks[b].warps = std::vector<ShimWarp>(nt / 32);
  }
  for (unsigned c = 0; c < nb / cs; ++c) {
    clusters[c].bar = std::make_unique<std::barrier<>>(cs * nt);
    for (unsigned r = 0; r < cs; ++r) clusters[c].blocks.push_back(&blocks[c * cs + r]);
  }
  std::vector<std::thread> th;
  for (unsigned b = 0; b < nb; ++b)
    for (unsigned t = 0; t < nt; ++t)
      th.emplace_back([&, b, t] {
        threadIdx.x = t; blockIdx.x = b; blockDim.x = nt; gridDim.x = nb;
        shim_block = &blocks[b]; shim_warp = &blocks[b].warps[t / 32]; shim_cluster = &clusters[b / cs];
        kernel(static_cast<Exp>(args)...);
      });
  for (auto& x : th) x.join();
  for (auto& b : blocks) std::free(b.smem);
  return 0;
}
