// Hand-written CUDA kernels for the flagship README model on Hopper
// (sm_90a): the batched simulator cost and the one-kernel smc sweep.
//
// They replace two Pallas TPU kernels of kissabc_tpu/ops/pallas_kernels.py:
//   kt_normal_summary_cost <- normal_summary_cost (pallas_call at :275)
//   kt_fused_sweep         <- _fused_sweep_call  (pallas_call at :427)
//
// Kernel 1 is one thread per walker. The TPU kernels tile walkers on
// sublanes and draws on lanes because the VPU is a 2-D vector unit; on the
// GPU the per-walker loop over draws is the natural shape: each thread
// generates its own bits, runs Box-Muller and keeps the two z-moments in
// registers, so a walker's 1000 draws never touch memory. A walker moves 12
// bytes against ~50 arithmetic operations per draw, so the kernel is bound
// by arithmetic, not by memory.
//
// What bounds it on the H100 is instruction issue: one warp instruction
// per scheduler per cycle, 132 x 128 lane instructions per cycle. Its draw
// loop (moments_philox in moments.cuh) issues ~43 SASS instructions a draw
// (tools/sass_draw_loop.py), so 1000 draws of 2^20 walkers take at least
// ~1.35 ms at 1980 MHz; the bound of chip_smoke.py counts 47 operations a
// draw at the float32 rate, 0.74 ms, which only an FMA on every lane every
// cycle would reach. The loop issues only the arithmetic of the result:
// round keys made once per walker, the last ragged group of four draws
// peeled out of the loop, and the Box-Muller radius without the branches
// of log1pf and sqrtf (common.cuh), bit for bit.
//
// Kernel 2, the smc sweep, simulates only the walkers that pass its gate
// 1 (no other walker's outputs depend on the simulation): ~44% of them on
// the prior. One thread per walker masked the rest, so a warp ran the draw
// loop with about half its lanes idle. So a block covers `walkers` walkers
// with blockDim.x threads in two phases, as the AIS sweeps of ais.cu do:
// - phase 1, one thread per walker (in passes of blockDim.x): the words,
//   the two partners, the proposal, the prior and gate 1. A walker that
//   fails gate 1 writes its inputs as its outputs at once, with commit 0;
//   the others get slots in walker order (compact_walkers, compact.cuh)
//   and stash their proposal (12 bytes) in shared memory;
// - phase 2, one thread per compacted walker: the simulator, the cost,
//   the commit and the writes.
// The geometry (walkers a block, threads) comes from ops/kernels.py
// sweep_geometry: at n = 131072 a block of 1024 walkers on 1024 threads
// an SM, so each compacted walker has its thread in one pass. The stub
// flag is a template argument, so neither phase tests it at run time.
//
// The partners: the kernel takes the step's three raw uint32 words (two
// shift words and the seed) and derives the two rotation shifts by
// roll_shifts' rule (ops/moves.py; pallas_kernels.py:480-482): r1 = w0 %
// (n - 1) + 1, r2 = w1 % (n - 2) + 1, bumped past r1. The partner
// differences of walker w are mu[(w - r2) mod n] - mu[(w - r1) mod n],
// the elements torch.roll(mu, r2) - torch.roll(mu, r1) subtracts, so they
// are the same floats. A step is one draw of words and one launch.
//
// Random bits. Every walker's bits are keyed by its index, never by its
// thread, so any geometry gives the outputs of one thread per walker bit
// for bit. bits = 0 ("hw") uses Philox4x32-10 keyed by (seed, 0) with
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
#include "compact.cuh"
#include "moments.cuh"
#include "shifts.cuh"

namespace {

constexpr int kThreads = 128;          // kernel 1's blocks
constexpr int kSweepMaxThreads = 1024;  // kernel 2: threads a block
constexpr int kSweepMaxWalkers = 1024;  // walkers a block covers at most
constexpr int kSweepNumF = 11;
constexpr int kSweepNumI = 4;

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
    out[w] = summary_cost(mu[w], sg[w], s1, s2, inv_n, tmu, tsd, sdw);
  } else {
    moments_philox(seed, kStreamCost, (uint32_t)w, ndraws, &s1, &s2);
    out[w] = centred_cost(mu[w], sg[w], s1, s2, ndraws, tmu, tsd, sdw);
  }
}

struct SweepConsts {
  float inv_n, tmu, tsd, sdw;                          // simulator, cost
  float inv_sqrt_d;                                    // proposal scale
  float mu_lo, mu_hi, sg_lo, sg_hi, lp_const, half_inv_var;  // prior
  int ndraws, block, chunk, stub;
};

struct SweepArgs {
  const float *mu, *sg, *xs, *lps;
  const float* eps_ptr;  // the tolerance in device memory, or null: eps
  float eps;
  const long long* words;  // two shift words, the seed (uint32 in int64)
  float *omu, *osg, *oxs, *olps;
  unsigned char* ocm;
  int n;
};

// A gate-1 walker's proposal, stashed across the barrier.
struct SweepProposal {
  float mu, sg, lpp;
};

// Phase 1 for walker w: the proposal, the prior and gate 1. Returns gate
// 1; a walker that fails it has written its outputs.
template <bool kStub>
__device__ __forceinline__ bool sweep_propose(int w, int r1, int r2,
                                              uint32_t seed,
                                              const SweepArgs& a,
                                              const SweepConsts& c,
                                              SweepProposal* q) {
  // per-walker randomness: proposal scale w ~ N(0,1), MH log-u
  uint32_t bu1, bu2, bu3;
  if (kStub) {
    // the TPU kernel's (block/128, 128) column view of the walker block
    uint32_t pid = (uint32_t)(w / c.block);
    uint32_t csub = (uint32_t)((w % c.block) / 128);
    uint32_t clane = (uint32_t)(w % 128);
    bu1 = stub_bits(pid, seed, 10000u, csub, clane);
    bu2 = stub_bits(pid, seed, 10001u, csub, clane);
    bu3 = stub_bits(pid, seed, 10002u, csub, clane);
  } else {
    Words4 b = philox4x32_10(0u, (uint32_t)w, kStreamSweepWalker, 0u, seed);
    bu1 = b.x0;
    bu2 = b.x1;
    bu3 = b.x2;
  }
  float cs, sn;
  sincos_2pi(to_unit(bu2), &cs, &sn);
  float z = sqrtf(-2.0f * log1pf(-to_unit(bu1))) * cs;
  float wv = z * c.inv_sqrt_d;
  float lprob = log1pf(-to_unit(bu3));  // log U(0,1]

  // partners (w + r) mod n of the rolls: roll(x, r)[w] = x[(w - r) mod n]
  int k1 = w - r1, k2 = w - r2;
  if (k1 < 0) k1 += a.n;
  if (k2 < 0) k2 += a.n;
  float mu = a.mu[w], sg = a.sg[w];
  float dmu = a.mu[k2] - a.mu[k1];
  float dsg = a.sg[k2] - a.sg[k1];
  float pmu = mu + dmu * wv;
  float psg = sg + dsg * wv;
  bool inside = (pmu >= c.mu_lo) && (pmu <= c.mu_hi) && (psg >= c.sg_lo) &&
                (psg <= c.sg_hi);
  float lpp = inside ? c.lp_const - psg * psg * c.half_inv_var
                     : __int_as_float(0xff800000);  // -inf
  float lp = a.lps[w];
  float dl = lpp - lp;
  float lm = (dl > 0.0f) ? 0.0f : dl;  // min(dl, 0), NaN propagates
  bool gate1 = inside && (lprob < lm);
  if (!gate1) {  // never commits: the inputs go through
    a.omu[w] = mu;
    a.osg[w] = sg;
    a.oxs[w] = a.xs[w];
    a.olps[w] = lp;
    a.ocm[w] = 0;
  } else {
    q->mu = pmu;
    q->sg = psg;
    q->lpp = lpp;
  }
  return gate1;
}

// Phase 2 for a gate-1 walker w: the simulator, the cost, the commit.
template <bool kStub>
__device__ __forceinline__ void sweep_accept(int w, const SweepProposal& q,
                                             uint32_t seed, float eps,
                                             const SweepArgs& a,
                                             const SweepConsts& c) {
  float s1, s2, xp;
  if (kStub) {
    moments_stub((uint32_t)(w / c.block), seed, 0u, (uint32_t)(w % c.block),
                 c.ndraws, c.chunk, &s1, &s2);
    xp = summary_cost(q.mu, q.sg, s1, s2, c.inv_n, c.tmu, c.tsd, c.sdw);
  } else {
    moments_philox(seed, kStreamSweepSim, (uint32_t)w, c.ndraws, &s1, &s2);
    xp = centred_cost(q.mu, q.sg, s1, s2, c.ndraws, c.tmu, c.tsd, c.sdw);
  }
  bool commit = xp < eps;
  a.omu[w] = commit ? q.mu : a.mu[w];
  a.osg[w] = commit ? q.sg : a.sg[w];
  a.oxs[w] = commit ? xp : a.xs[w];
  a.olps[w] = commit ? q.lpp : a.lps[w];
  a.ocm[w] = commit ? 1 : 0;
}

template <bool kStub>
__global__ void __launch_bounds__(kSweepMaxThreads)
    fused_sweep_kernel(SweepArgs a, SweepConsts c, int walkers) {
  __shared__ int s_r[2];
  __shared__ int s_walker[kSweepMaxWalkers];
  __shared__ SweepProposal s_prop[kSweepMaxWalkers];
  if (threadIdx.x == 0) derive_rolls(a.words, a.n, s_r);
  __syncthreads();
  int r1 = s_r[0], r2 = s_r[1];
  uint32_t seed = word32(a.words[2]);
  int first = blockIdx.x * walkers;
  int p = compact_walkers<kSweepMaxThreads>(
      first, walkers, a.n, s_walker, [&](int w) {
        return sweep_propose<kStub>(w, r1, r2, seed, a, c,
                                    &s_prop[w - first]);
      });
  if ((int)threadIdx.x >= p) return;
  float eps = a.eps_ptr ? a.eps_ptr[0] : a.eps;
  for (int slot = threadIdx.x; slot < p; slot += blockDim.x) {
    int w = s_walker[slot];
    sweep_accept<kStub>(w, s_prop[w - first], seed, eps, a, c);
  }
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

// One fused smc sweep over n >= 3 walkers. eps: the tolerance in device
// memory (one float), or null to take eps_value. words: int64[3], the two
// shift words and the seed. fconsts: inv_n, target mu, target sd, sd
// weight, max_stretch / sqrt(2), mu_lo, mu_hi, sg_lo, sg_hi, the prior's
// log-constant, 1 / (2 sg_sigma^2); iconsts: ndraws, block, chunk, stub.
// walkers, threads: the geometry (threads a multiple of 32 up to 1024,
// 1 to 1024 walkers a block).
extern "C" int kt_fused_sweep(const float* mu, const float* sg,
                              const float* xs, const float* lps,
                              const float* eps, float eps_value,
                              const long long* words, float* omu, float* osg,
                              float* oxs, float* olps, unsigned char* ocm,
                              int n, const float* fconsts,
                              const int* iconsts, int walkers, int threads,
                              void* stream) {
  if (threads < 32 || threads > kSweepMaxThreads || threads % 32 ||
      walkers < 1 || walkers > kSweepMaxWalkers || n < 3)
    return (int)cudaErrorInvalidConfiguration;
  SweepConsts c;
  float* fdst[kSweepNumF] = {&c.inv_n,  &c.tmu,        &c.tsd,   &c.sdw,
                             &c.inv_sqrt_d, &c.mu_lo,  &c.mu_hi, &c.sg_lo,
                             &c.sg_hi,  &c.lp_const,   &c.half_inv_var};
  for (int k = 0; k < kSweepNumF; ++k) *fdst[k] = fconsts[k];
  int* idst[kSweepNumI] = {&c.ndraws, &c.block, &c.chunk, &c.stub};
  for (int k = 0; k < kSweepNumI; ++k) *idst[k] = iconsts[k];
  SweepArgs a{mu, sg, xs, lps, eps, eps_value, words, omu, osg, oxs, olps,
              ocm, n};
  int blocks = (n + walkers - 1) / walkers;
  auto kernel = c.stub ? fused_sweep_kernel<true> : fused_sweep_kernel<false>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a, c, walkers);
  return (int)cudaGetLastError();
}

extern "C" const char* kt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
