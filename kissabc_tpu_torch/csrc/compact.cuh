// Block-local compaction of the walkers that need the simulator, shared by
// the lane-group kernels of generic.cuh (#6, #10) and the flagship AIS
// sweeps of ais.cu (#7, #8): phase 1 runs one thread per walker, and a
// ballot per warp and a prefix over the block's warps give each walker
// that needs the simulator a slot in shared memory, in walker order, for
// phase 2 to take.

#pragma once

#include <cuda_runtime.h>

namespace {

// Phase 1 over the block's walkers [first, first + walkers), in passes of
// blockDim.x threads (at most kMaxThreads): needs(w) runs once for each
// walker w < n (and writes the outputs of a walker that does not need the
// simulator); the walkers for which it returns true get slots
// s_walker[0 .. p) in walker order. Every thread reaches every barrier.
// Returns p. A caller that compacts again in the same block puts a
// barrier between this call's return and the next call.
template <int kMaxThreads, typename Needs>
__device__ int compact_walkers(int first, int walkers, int n, int* s_walker,
                               Needs needs) {
  __shared__ int s_base[kMaxThreads / 32];
  __shared__ int s_pass;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_pass = 0;
  for (int pass = 0; pass < walkers; pass += blockDim.x) {
    int i = pass + (int)threadIdx.x, w = first + i;
    bool sim = (i < walkers && w < n) ? needs(w) : false;
    unsigned ballot = __ballot_sync(0xffffffffu, sim);
    if (lane == 0) s_base[warp] = __popc(ballot);
    __syncthreads();
    if (threadIdx.x == 0) {  // exclusive prefix over the warps, from s_pass
      int sum = s_pass;
      for (int q = 0; q < (int)(blockDim.x >> 5); ++q) {
        int count = s_base[q];
        s_base[q] = sum;
        sum += count;
      }
      s_pass = sum;
    }
    __syncthreads();
    if (sim)
      s_walker[s_base[warp] + __popc(ballot & ((1u << lane) - 1u))] = w;
    __syncthreads();
  }
  return s_pass;
}

}  // namespace
