// A host emulation of the CUDA features that the lane-group kernels of
// kissabc_tpu_torch/csrc/generic.cuh and the flagship AIS sweeps of
// csrc/ais.cu use, for tests/test_torch_lane_groups.py and
// tests/test_torch_ais_compaction.py: one std::thread per CUDA thread,
// blocks one after another, static __shared__ variables shared by the
// block's threads, __syncthreads a block barrier, and each warp collective
// (__syncwarp, __ballot_sync, __shfl_sync, __shfl_xor_sync) a rendezvous of
// the lanes of its mask that aborts on a lane outside the mask or a wait
// of 20 s (a deadlock). A cooperative launch (cudaLaunchCooperativeKernel)
// starts every block's threads at once, but runs one block at a time: the
// grid barrier (cooperative_groups.h, grid_group::sync) hands the turn to
// the next block, and past the last block back to the first, so every
// block has passed the barrier's earlier side before any block runs on.
// The static __shared__ variables are then reused from block to block, so
// nothing in shared memory may stay live across the grid barrier (what the
// card would keep). The float intrinsics round as plain float arithmetic
// (but __fmaf_rn rounds once, as the card's FFMA, where KT_EMU_FUSED_FMA
// is defined): the emulation checks the kernels' control flow and index
// arithmetic, not the card's arithmetic.
#pragma once
#include <algorithm>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <type_traits>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__

struct float2 {
  float x, y;
};
struct kt_uint3 {
  unsigned x = 0, y = 0, z = 0;
};
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
inline thread_local kt_uint3 threadIdx, blockIdx;
inline kt_uint3 blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidConfiguration = 9,
  cudaErrorCooperativeLaunchTooLarge = 82,
  cudaErrorNotSupported = 801
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount,
  cudaDevAttrCooperativeLaunch
};
// the SMs the emulated card reports (a cooperative grid is this many
// blocks: the emulated occupancy is one block an SM)
inline int kt_emu_sms = 1;
using std::max;
using std::min;

inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline int __float_as_int(float f) { return (int)__float_as_uint(f); }
inline float __int_as_float(int i) { return __uint_as_float((uint32_t)i); }
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
inline float __fadd_rz(float a, float b) { return a + b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
#ifdef KT_EMU_FUSED_FMA
// a fused multiply-add, one rounding, as the card's FFMA
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
#else
inline float __fmaf_rn(float a, float b, float c) { return a * b + c; }
#endif
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __int2float_rn(int i) { return (float)i; }
// lgammaf of the generic kernels' prior table without glibc's global
// signgam, which every emulated thread would write
inline float kt_host_lgammaf(float x) {
  int sign;
  return ::lgammaf_r(x, &sign);
}
#define lgammaf kt_host_lgammaf
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline float __ldcg(const float* p) { return *p; }
inline float __ldg(const float* p) { return *p; }

struct KtWarp {
  std::mutex m;
  std::condition_variable cv;
};
struct KtBlock {
  std::mutex m;
  std::condition_variable cv;
  int nthreads = 0, arrived = 0;
  long gen = 0;
  std::vector<KtWarp> warps;
  std::vector<std::vector<uint32_t>> sent;  // per thread, per collective
  std::vector<char> smem;
  int at_grid = 0;  // threads at the grid barrier or done (cooperative)
};
inline thread_local KtBlock* kt_block;

inline void __syncthreads() {
  std::unique_lock<std::mutex> lk(kt_block->m);
  long g = kt_block->gen;
  if (++kt_block->arrived == kt_block->nthreads) {
    kt_block->arrived = 0;
    ++kt_block->gen;
    kt_block->cv.notify_all();
  } else {
    kt_block->cv.wait(lk, [&] { return kt_block->gen != g; });
  }
}

[[noreturn]] inline void kt_fail(const char* what, int t, unsigned mask) {
  std::fprintf(stderr, "emulated CUDA: %s (thread %d, mask %08x)\n", what, t,
               mask);
  std::abort();
}

// One warp collective: send v and return what every lane of the mask sent
// to its collective of the same index.
inline std::vector<uint32_t> kt_collective(unsigned mask, uint32_t v) {
  int t = threadIdx.x, lane = t & 31, w0 = t - lane;
  if (!(mask >> lane & 1u)) kt_fail("lane outside its mask", t, mask);
  KtWarp& warp = kt_block->warps[t / 32];
  std::unique_lock<std::mutex> lk(warp.m);
  size_t k = kt_block->sent[t].size();
  kt_block->sent[t].push_back(v);
  warp.cv.notify_all();
  bool ok = warp.cv.wait_for(lk, std::chrono::seconds(20), [&] {
    for (int l = 0; l < 32; ++l)
      if ((mask >> l & 1u) && kt_block->sent[w0 + l].size() <= k)
        return false;
    return true;
  });
  if (!ok) kt_fail("a warp collective waits for ever", t, mask);
  std::vector<uint32_t> out(32, 0u);
  for (int l = 0; l < 32; ++l)
    if (mask >> l & 1u) out[l] = kt_block->sent[w0 + l][k];
  return out;
}
inline void __syncwarp(unsigned mask) { kt_collective(mask, 0u); }
inline unsigned __ballot_sync(unsigned mask, bool p) {
  std::vector<uint32_t> v = kt_collective(mask, p ? 1u : 0u);
  unsigned b = 0;
  for (int l = 0; l < 32; ++l)
    if (v[l]) b |= 1u << l;
  return b;
}
inline float __shfl_sync(unsigned mask, float x, int src) {
  std::vector<uint32_t> v = kt_collective(mask, __float_as_uint(x));
  if (!(mask >> (src & 31) & 1u))
    kt_fail("a shuffle from outside its mask", threadIdx.x, mask);
  return __uint_as_float(v[src & 31]);
}
inline int __shfl_sync(unsigned mask, int x, int src) {
  std::vector<uint32_t> v = kt_collective(mask, (uint32_t)x);
  if (!(mask >> (src & 31) & 1u))
    kt_fail("a shuffle from outside its mask", threadIdx.x, mask);
  return (int)v[src & 31];
}
inline float __shfl_xor_sync(unsigned mask, float x, int lane_mask) {
  return __shfl_sync(mask, x, (int)(threadIdx.x & 31u) ^ lane_mask);
}

template <class T>
cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) {
  return 0;
}
template <class T>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, T*, int,
                                                          size_t) {
  *b = 1;
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return 0;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? kt_emu_sms : 1;
  return 0;
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

// the block's dynamic shared memory (extern __shared__), filled with a
// pattern so that a read before a write shows
template <class T>
T* kt_dyn_smem() {
  return reinterpret_cast<T*>(kt_block->smem.data());
}

// kernel<<<blocks, threads, smem>>>(args...)
template <class K, class... A>
void kt_launch(K kernel, int blocks, int threads, size_t smem, A... args) {
  for (int b = 0; b < blocks; ++b) {
    KtBlock block;
    block.nthreads = threads;
    block.sent.assign(threads, {});
    block.warps = std::vector<KtWarp>((threads + 31) / 32);
    block.smem.assign(smem + 64, (char)0x7f);
    blockDim.x = threads;
    gridDim.x = blocks;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([=, &block] {
        kt_block = &block;
        blockIdx.x = b;
        threadIdx.x = t;
        kernel(args...);
      });
    for (auto& th : ts) th.join();
  }
}

// The cooperative launch's turn: step = round * blocks + the block that
// runs. A block's last thread to reach the grid barrier, or to finish,
// hands the turn on.
struct KtGrid {
  std::mutex m;
  std::condition_variable cv;
  long step = 0;
  int blocks = 0;
};
inline KtGrid* kt_grid;
inline thread_local long kt_round;

inline void kt_wait_turn() {
  std::unique_lock<std::mutex> lk(kt_grid->m);
  long want = kt_round * kt_grid->blocks + blockIdx.x;
  if (!kt_grid->cv.wait_for(lk, std::chrono::seconds(60),
                            [&] { return kt_grid->step == want; }))
    kt_fail("a block waits for its turn for ever", threadIdx.x, 0u);
}

inline void kt_pass_turn() {
  bool last;
  {
    std::lock_guard<std::mutex> lk(kt_block->m);
    last = ++kt_block->at_grid == kt_block->nthreads;
    if (last) kt_block->at_grid = 0;
  }
  if (last) {
    std::lock_guard<std::mutex> lk(kt_grid->m);
    ++kt_grid->step;
    kt_grid->cv.notify_all();
  }
}

inline void kt_grid_sync() {
  kt_pass_turn();
  ++kt_round;
  kt_wait_turn();
}

template <class... A, size_t... I>
void kt_call(void (*kernel)(A...), void** args, std::index_sequence<I...>) {
  kernel(*static_cast<std::remove_reference_t<A>*>(args[I])...);
}

template <class... A>
cudaError_t cudaLaunchCooperativeKernel(void (*kernel)(A...), dim3 grid,
                                        dim3 threads, void** args, size_t,
                                        cudaStream_t) {
  int blocks = grid.x, nthreads = threads.x;
  KtGrid g;
  g.blocks = blocks;
  kt_grid = &g;
  blockDim.x = nthreads;
  gridDim.x = blocks;
  std::vector<KtBlock> bs(blocks);
  std::vector<std::thread> ts;
  for (int b = 0; b < blocks; ++b) {
    bs[b].nthreads = nthreads;
    bs[b].sent.assign(nthreads, {});
    bs[b].warps = std::vector<KtWarp>((nthreads + 31) / 32);
    for (int t = 0; t < nthreads; ++t)
      ts.emplace_back([=, &bs] {
        kt_block = &bs[b];
        blockIdx.x = b;
        threadIdx.x = t;
        kt_round = 0;
        kt_wait_turn();
        kt_call(kernel, args, std::index_sequence_for<A...>());
        kt_pass_turn();
      });
  }
  for (auto& th : ts) th.join();
  kt_grid = nullptr;
  return 0;
}
