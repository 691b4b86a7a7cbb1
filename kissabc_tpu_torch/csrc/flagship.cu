// Hand-written CUDA kernels for the flagship README model on Hopper
// (sm_90a): the batched simulator cost and the one-kernel smc sweep.
//
// They replace two Pallas TPU kernels of kissabc_tpu/ops/pallas_kernels.py:
//   kt_normal_summary_cost <- normal_summary_cost (pallas_call at :275)
//   kt_fused_sweep         <- _fused_sweep_call  (pallas_call at :427)
//
// Design. Both are one thread per walker. The TPU kernels tile walkers on
// sublanes and draws on lanes because the VPU is a 2-D vector unit; on the
// GPU the per-walker loop over draws is the natural shape: each thread
// generates its own bits, runs Box-Muller and keeps the two z-moments in
// registers, so a walker's 1000 draws never touch memory. A walker moves 12
// bytes (kernel 1) or 41 bytes (kernel 2) against ~50 arithmetic operations
// per draw, so both kernels are bound by arithmetic, not by memory: the
// design keeps every draw in registers and uses no shared memory. Kernel 2
// simulates only the walkers that pass its gate 1 (no other walker's
// outputs depend on the simulation).
//
// What bounds kernel 1 on the H100 is instruction issue: one warp
// instruction per scheduler per cycle, 132 x 128 lane instructions per
// cycle. Its draw loop (moments_philox in moments.cuh) issues 43 SASS
// instructions a draw (tools/sass_draw_loop.py; 53.5 before the loop was
// cut), so 1000 draws of 2^20 walkers take at least 1.34 ms at 1980 MHz;
// the bound of chip_smoke.py counts 47 operations a draw at the float32
// rate, 0.74 ms, which only an FMA on every lane every cycle would reach.
// The loop issues only the arithmetic of the result: round keys made once
// per walker, the last ragged group of four draws peeled out of the loop,
// and the Box-Muller radius without the branches of log1pf and sqrtf
// (common.cuh), bit for bit.
//
// Random bits. bits = 0 ("hw") uses Philox4x32-10 keyed by (seed, 0) with
// counter (draw group, walker, stream, 0): one call gives four words, i.e.
// two Box-Muller pairs. It is the counterpart of the TPU's hardware PRNG.
// bits = 1 ("stub") reproduces the JAX package's multiply-xorshift test
// stream (_stub_bits, pallas_kernels.py:76-110) at the exact (program,
// counter, sublane, lane) coordinates the TPU kernels use, so the kernels
// can be held against the JAX golden models bit for bit on the inputs.
//
// The device helpers (sincos, stub bits, Philox, Box-Muller) are in
// common.cuh, shared with the generic kernels of generic.cuh; the moment
// sums and the summary cost in moments.cuh, shared with ais.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC, together with ais.cu into one library. No
// --use_fast_math: log1pf and sqrtf must stay the IEEE/libdevice versions
// the plain PyTorch versions use. Each entry point launches on the
// caller's stream and returns cudaGetLastError().

#include "common.cuh"
#include "moments.cuh"

namespace {

constexpr int kThreads = 128;

// Philox streams (third counter word): one per independent use.
constexpr uint32_t kStreamCost = 0u;
constexpr uint32_t kStreamSweepWalker = 1u;
constexpr uint32_t kStreamSweepSim = 2u;

__global__ void normal_summary_cost_kernel(
    const float* __restrict__ mu, const float* __restrict__ sg,
    const long long* __restrict__ seed_ptr, float* __restrict__ out, int n,
    int ndraws, float inv_n, float tmu, float tsd, float sdw, int stub,
    int block, int chunk, int wt) {
  int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n) return;
  uint32_t seed = (uint32_t)(unsigned long long)seed_ptr[0];
  float s1, s2;
  if (stub) {
    // normal_summary_cost's grid: program = superblock of wt*block walkers,
    // walker tile sb inside it, walker = sublane of the tile
    int nchunks = (ndraws + 2 * chunk - 1) / (2 * chunk);
    uint32_t pid = (uint32_t)(w / (wt * block));
    uint32_t sb = (uint32_t)((w / block) % wt);
    uint32_t sub = (uint32_t)(w % block);
    moments_stub(pid, seed, 2u * sb * (uint32_t)nchunks, sub, ndraws, chunk,
                 &s1, &s2);
  } else {
    moments_philox(seed, kStreamCost, (uint32_t)w, ndraws, &s1, &s2);
  }
  out[w] = summary_cost(mu[w], sg[w], s1, s2, inv_n, tmu, tsd, sdw);
}

__global__ void fused_sweep_kernel(
    const float* __restrict__ mu_in, const float* __restrict__ sg_in,
    const float* __restrict__ dmu, const float* __restrict__ dsg,
    const float* __restrict__ xs, const float* __restrict__ lps,
    const float* __restrict__ eps_ptr, const long long* __restrict__ seed_ptr,
    float* __restrict__ omu, float* __restrict__ osg,
    float* __restrict__ oxs, float* __restrict__ olps,
    unsigned char* __restrict__ ocm, int n, int ndraws, float inv_n,
    float tmu, float tsd, float sdw, float inv_sqrt_d, float mu_lo,
    float mu_hi, float sg_lo, float sg_hi, float lp_const,
    float half_inv_var, int stub, int block, int chunk) {
  int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n) return;  // no padding walkers: nothing past n is written
  uint32_t seed = (uint32_t)(unsigned long long)seed_ptr[0];
  uint32_t pid = (uint32_t)(w / block);

  // per-walker randomness: proposal scale w ~ N(0,1), MH log-u
  uint32_t bu1, bu2, bu3;
  if (stub) {
    // the TPU kernel's (block/128, 128) column view of the walker block
    uint32_t csub = (uint32_t)((w % block) / 128), clane = (uint32_t)(w % 128);
    bu1 = stub_bits(pid, seed, 10000u, csub, clane);
    bu2 = stub_bits(pid, seed, 10001u, csub, clane);
    bu3 = stub_bits(pid, seed, 10002u, csub, clane);
  } else {
    Words4 b = philox4x32_10(0u, (uint32_t)w, kStreamSweepWalker, 0u, seed);
    bu1 = b.x0;
    bu2 = b.x1;
    bu3 = b.x2;
  }
  float c, s;
  sincos_2pi(to_unit(bu2), &c, &s);
  float z = sqrtf(-2.0f * log1pf(-to_unit(bu1))) * c;
  float wv = z * inv_sqrt_d;
  float lprob = log1pf(-to_unit(bu3));  // log U(0,1]

  float mu = mu_in[w], sg = sg_in[w];
  float pmu = mu + dmu[w] * wv;
  float psg = sg + dsg[w] * wv;
  bool inside = (pmu >= mu_lo) && (pmu <= mu_hi) && (psg >= sg_lo) &&
                (psg <= sg_hi);
  float lpp = inside ? lp_const - psg * psg * half_inv_var
                     : __int_as_float(0xff800000);  // -inf
  float lp = lps[w];
  float dl = lpp - lp;
  float lm = (dl > 0.0f) ? 0.0f : dl;  // min(dl, 0), NaN propagates
  bool gate1 = inside && (lprob < lm);

  // the outputs depend on the simulation only where gate 1 passes
  bool commit = false;
  float xp = 0.0f;
  if (gate1) {
    float s1, s2;
    if (stub) {
      moments_stub(pid, seed, 0u, (uint32_t)(w % block), ndraws, chunk, &s1,
                   &s2);
    } else {
      moments_philox(seed, kStreamSweepSim, (uint32_t)w, ndraws, &s1, &s2);
    }
    xp = summary_cost(pmu, psg, s1, s2, inv_n, tmu, tsd, sdw);
    commit = xp < eps_ptr[0];
  }
  omu[w] = commit ? pmu : mu;
  osg[w] = commit ? psg : sg;
  oxs[w] = commit ? xp : xs[w];
  olps[w] = commit ? lpp : lp;
  ocm[w] = commit ? 1 : 0;
}

inline int grid_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int kt_normal_summary_cost(const float* mu, const float* sg,
                                      const long long* seed, float* out,
                                      int n, int ndraws, float inv_n,
                                      float tmu, float tsd, float sdw,
                                      int stub, int block, int chunk, int wt,
                                      void* stream) {
  if (n > 0) {
    normal_summary_cost_kernel<<<grid_for(n), kThreads, 0,
                                 (cudaStream_t)stream>>>(
        mu, sg, seed, out, n, ndraws, inv_n, tmu, tsd, sdw, stub, block,
        chunk, wt);
  }
  return (int)cudaGetLastError();
}

extern "C" int kt_fused_sweep(const float* mu, const float* sg,
                              const float* dmu, const float* dsg,
                              const float* xs, const float* lps,
                              const float* eps, const long long* seed,
                              float* omu, float* osg, float* oxs, float* olps,
                              unsigned char* ocm, int n, int ndraws,
                              float inv_n, float tmu, float tsd, float sdw,
                              float inv_sqrt_d, float mu_lo, float mu_hi,
                              float sg_lo, float sg_hi, float lp_const,
                              float half_inv_var, int stub, int block,
                              int chunk, void* stream) {
  if (n > 0) {
    fused_sweep_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        mu, sg, dmu, dsg, xs, lps, eps, seed, omu, osg, oxs, olps, ocm, n,
        ndraws, inv_n, tmu, tsd, sdw, inv_sqrt_d, mu_lo, mu_hi, sg_lo, sg_hi,
        lp_const, half_inv_var, stub, block, chunk);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
