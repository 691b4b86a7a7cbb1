// Hand-written CUDA kernel for sequential (Markovian) user simulators on
// Hopper (sm_90a): the streaming scan cost.
//
// It replaces the Pallas TPU kernel of kissabc_tpu/ops/pallas_kernels.py
//   kt_streaming_scan_cost <- make_streaming_scan_cost (pallas_call :3010)
//
// This file is a template. kissabc_tpu_torch/ops/codegen.py traces the
// user's PyTorch callables and writes a translation unit that defines
//   KT_NPARAMS (theta leaves K), KT_NSTATE (state leaves), KT_NSTATS
//   (observations), KT_NSERIES (series leaves), KT_NOISE_NORMAL
//   void scan_init(const float* th, float* x)
//   void scan_step(const float* th, const float* x, float e, int t,
//                  float* xn)
//   void scan_observe(const float* th, const float* x, int t,
//                     const float* obs, float* o)
// and then includes this file; ops/_build.py compiles it with nvcc.
//
// Design. x_{t+1} = step(theta, x_t, eps_t, t) is sequential in t, so the
// only parallelism is over walkers: one thread per walker runs its whole
// path with theta, the state and the KT_NSTATS running sums in registers;
// the path never touches memory. A walker moves (K + KT_NSTATS) * 4 bytes
// against ~50 operations per step over nsteps steps, so the kernel is
// bound by arithmetic (and, at small n, by the latency of the dependent
// chain: each thread has no independent work, so only other warps hide
// it). The series, when there is one, is read at t by every thread of a
// warp at once: a uniform load through the read-only path, served from
// L1 after the first warp.
//
// Steps go in pairs j = 0 .. ceil(nsteps/2)-1: two uniform words give
// the noise of steps 2j and 2j + 1 (Box-Muller's two halves for normal
// noise, the two uniforms as they are for uniform noise); an odd nsteps
// ends on the first half of one more pair, as the TPU kernel does. Each
// step runs step, then observe on the new state, then adds the
// observations to the sums; the means are the sums times 1/nsteps.
//
// Random bits. The stub flag is a template argument, so the step loop
// tests nothing at run time. stub = 1 replays the JAX package's
// _stub_bits at the TPU kernel's coordinates: program w / sb_rows, the
// program's row (w % sb_rows) / 128 split into slab ws = row / sr and row
// in slab row % sr (the sublane), lane w % 128, counters 2*(ws*npairs +
// j) and +1. stub = 0 is Philox4x32-10 keyed by (seed, 0), counter
// (j/2, walker, 6, 0): one call gives the words of pairs j and j + 1,
// i.e. four steps, so the loop runs whole groups of four steps on one
// call each, with no select and no guard, and the ragged last group
// (nsteps % 4 steps) after it, as moments_philox peels its last group.
// Either loop runs every step's step, observe and adds in the order
// above, so the outputs are those of one pair at a time, bit for bit.
//
// Geometry: blocks of `threads` threads (ops/scan.py SCAN_THREADS, by
// measurement on the H100).
//
// Walkers w >= n are masked: nothing is padded and nothing past n is
// written. The seed is read from device memory, so nothing waits for
// the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Philox stream (third counter word) of the scan kernel; the flagship
// kernels use 0..2 and the generic kernels 3..5.
constexpr uint32_t kStreamScan = 6u;

struct ScanLeaves {
  const float* p[KT_NPARAMS];
};

struct Walker {
  float th[KT_NPARAMS];
  float x[KT_NSTATE];
  float s[KT_NSTATS];
};

__device__ __forceinline__ void scan_one_step(Walker& wk, float e, int t,
                                              const float* series,
                                              int nsteps) {
  float xn[KT_NSTATE];
  scan_step(wk.th, wk.x, e, t, xn);
#pragma unroll
  for (int k = 0; k < KT_NSTATE; ++k) wk.x[k] = xn[k];
#if KT_NSERIES > 0
  float obs[KT_NSERIES];
#pragma unroll
  for (int k = 0; k < KT_NSERIES; ++k)
    obs[k] = __ldg(series + (size_t)k * nsteps + t);
#else
  const float* obs = nullptr;
  (void)series;
  (void)nsteps;
#endif
  float o[KT_NSTATS];
  scan_observe(wk.th, wk.x, t, obs, o);
#pragma unroll
  for (int p = 0; p < KT_NSTATS; ++p) wk.s[p] += o[p];
}

// The noise of one pair of steps from two uniform words.
__device__ __forceinline__ void pair_noise(uint32_t b1, uint32_t b2,
                                           float* ea, float* eb) {
#if KT_NOISE_NORMAL
  box_muller(b1, b2, ea, eb);
#else
  *ea = to_unit(b1);
  *eb = to_unit(b2);
#endif
}

template <bool kStub>
__global__ void streaming_scan_cost_kernel(
    ScanLeaves th, const long long* __restrict__ seed_ptr,
    const float* __restrict__ series, float* __restrict__ out, int ld, int n,
    int nsteps, float inv_n, int sb_rows, int sr) {
  int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n) return;
  uint32_t seed = (uint32_t)(unsigned long long)seed_ptr[0];
  Walker wk;
#pragma unroll
  for (int k = 0; k < KT_NPARAMS; ++k) wk.th[k] = th.p[k][w];
  scan_init(wk.th, wk.x);
#pragma unroll
  for (int p = 0; p < KT_NSTATS; ++p) wk.s[p] = 0.0f;

  float e0, e1, e2, e3;
  if (kStub) {
    // stub coordinates of the TPU kernel's (program, slab, sublane, lane)
    uint32_t pid = (uint32_t)(w / sb_rows);
    int prow = (w % sb_rows) / 128;
    uint32_t ws = (uint32_t)(prow / sr), sub = (uint32_t)(prow % sr);
    uint32_t lane = (uint32_t)(w % 128);
    int npairs = (nsteps + 1) / 2, whole = nsteps / 2;
    for (int j = 0; j < npairs; ++j) {
      uint32_t ctr = 2u * (ws * (uint32_t)npairs + (uint32_t)j);
      pair_noise(stub_bits(pid, seed, ctr, sub, lane),
                 stub_bits(pid, seed, ctr + 1u, sub, lane), &e0, &e1);
      scan_one_step(wk, e0, 2 * j, series, nsteps);
      if (j < whole) scan_one_step(wk, e1, 2 * j + 1, series, nsteps);
    }
  } else {
    PhiloxKey key = philox_key(seed);
    int groups = nsteps / 4, left = nsteps % 4;
    for (int g = 0; g < groups; ++g) {
      Words4 q = philox4x32_10((uint32_t)g, (uint32_t)w, kStreamScan, 0u,
                               key);
      pair_noise(q.x0, q.x1, &e0, &e1);
      pair_noise(q.x2, q.x3, &e2, &e3);
      int t = 4 * g;
      scan_one_step(wk, e0, t, series, nsteps);
      scan_one_step(wk, e1, t + 1, series, nsteps);
      scan_one_step(wk, e2, t + 2, series, nsteps);
      scan_one_step(wk, e3, t + 3, series, nsteps);
    }
    if (left) {
      Words4 q = philox4x32_10((uint32_t)groups, (uint32_t)w, kStreamScan,
                               0u, key);
      int t = 4 * groups;
      pair_noise(q.x0, q.x1, &e0, &e1);
      scan_one_step(wk, e0, t, series, nsteps);
      if (left > 1) scan_one_step(wk, e1, t + 1, series, nsteps);
      if (left > 2) {
        pair_noise(q.x2, q.x3, &e2, &e3);
        scan_one_step(wk, e2, t + 2, series, nsteps);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < KT_NSTATS; ++p) out[(size_t)p * ld + w] = wk.s[p] * inv_n;
}

}  // namespace

// threads: the block size, a multiple of 32 up to 1024.
extern "C" int kt_streaming_scan_cost(const float* const* th,
                                      const long long* seed,
                                      const float* series, float* out,
                                      int ld, int n, int nsteps, float inv_n,
                                      int stub, int sb_rows, int sr,
                                      int threads, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidConfiguration;
  ScanLeaves leaves;
  for (int k = 0; k < KT_NPARAMS; ++k) leaves.p[k] = th[k];
  if (n > 0) {
    auto kernel = stub ? streaming_scan_cost_kernel<true>
                       : streaming_scan_cost_kernel<false>;
    kernel<<<(n + threads - 1) / threads, threads, 0,
             (cudaStream_t)stream>>>(leaves, seed, series, out, ld, n,
                                     nsteps, inv_n, sb_rows, sr);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
