// Hand-written CUDA kernels for the flagship model's fused AIS sweeps on
// Hopper (sm_90a).
//
// They replace two Pallas TPU kernels of kissabc_tpu/ops/pallas_kernels.py:
//   kt_fused_ais_half <- _fused_ais_half_call (pallas_call at :692), one
//                        red/black half-update (make_fused_flagship_ais_sweep
//                        launches it twice per sweep)
//   kt_fused_ais_full <- _fused_ais_full_call (pallas_call at :1022), both
//                        halves of a sweep in one launch
//                        (make_fused_flagship_ais_sweep_onekernel)
//
// What one walker of an updated half does: the 4:2:1 stretch / DE / walk
// mixture proposal against six partners of the complementary half, the
// flagship prior (Uniform(mu_lo, mu_hi) x TruncatedNormal(0, sg_sigma,
// sg_lo, sg_hi)), and, inside the prior, the ndraws-normal simulator and
// its summary cost; then the kernelized MH accept on lp + ll and the
// commit of the raw proposal.
//
// What bounds them on the H100: the draw loop's issue (moments.cuh,
// ~43 SASS instructions a draw; a walker moves ~48 bytes). One thread per
// walker masked the ~41% of the walkers that propose outside the prior at
// the init of a run, so a warp ran the loop with ~59% of its lanes busy.
// Design: a block covers `walkers` walkers of the half with blockDim.x
// threads in two phases, as the lane-group kernels of generic.cuh do:
// - phase 1, one thread per walker (in passes of blockDim.x): the words,
//   the six partners, the proposal and the prior. A walker outside the
//   prior never commits, so it writes its inputs as its outputs at once
//   (the TPU kernel's outputs after simulating it anyway). The walkers
//   inside get slots in walker order (compact_walkers, compact.cuh);
// - phase 2, one thread per compacted walker (the draws of this model are
//   light: one lane a walker, ops/lane_groups.py pick): the simulator,
//   the cost and the accept. The proposal crosses the barrier in shared
//   memory (20 bytes a walker): recomputing it in phase 2 instead gave
//   the same bits and was 5-8% slower on the H100 (PERF.md section 6).
// About one block of 512 threads an SM at the production width
// (ops/fused_ais.py flagship_geometry). On a run's converged ensemble
// every walker lies inside the prior; there the gain is the geometry's.
//
// The six partner shifts of a half are derived in the kernel from the six
// raw uint32 words the wrapper draws, by _rot_shifts6's rule
// (pallas_kernels.py:1116-1135): word k modulo h, h - 1 or h - 2, each
// bumped past the earlier draws of its move (derive_shifts); thread 0 of
// each block writes them to shared memory before phase 1. So a sweep
// costs the host one draw of words and one launch a half (or a sweep),
// and nothing in between. Walkers read their partners by index,
// comp[(i + r_j) % h], so nothing is copied.
//
// Half B of a sweep proposes against the UPDATED half A.
// kt_fused_ais_half is launched twice on one stream; kt_fused_ais_full
// does both halves in one cooperative launch: each block runs the two
// phases over its ranges of half A (a grid-stride loop over ranges), a
// grid-wide barrier (cooperative_groups::this_grid().sync()), then half B,
// which reads half A's outputs with ld.global.cg (through L2, past any
// stale L1 line). The grid is the co-resident maximum from the occupancy
// API, at most the ranges a half has; a refused cooperative launch is
// returned as an error, never replaced by two launches.
//
// Random bits. Every walker's bits are keyed by its index, never by its
// thread, so the geometry leaves every output's bits as one thread per
// walker gives them. stub = 1 replays the JAX package's _stub_bits at the
// TPU kernels' coordinates:
//   half kernel: words k = 0..8 at counter 20000 + k, program w / block,
//     (block/128, 128) column view; the simulator at counters 2j, 2j + 1,
//     sublane w % block, lane = draw index (kernel #2's layout);
//   full kernel: program 0, words at cbase + k on the (h/128, 128) view of
//     the half (cbase 100000 for half A, 200000 for half B); the simulator
//     at cbase + 16 + 2 (wb * nchunks + j), wb = i / block.
// Word k: 0 move, 1 stretch z, (2, 3) -> (gamma normal, mu jitter),
// (4, 5) -> (sigma jitter, walk r1), (6, 7) -> (r2, r3), 8 accept.
// stub = 0 is Philox4x32-10 keyed by (seed, 0): words k from counter
// (k / 4, walker, kStreamAisWalker, 0), the simulator as moments_philox on
// kStreamAisSim. The full kernel numbers half B's walkers h..2h-1, so the
// two halves draw from distinct counters.
//
// Built into one library with flagship.cu, with its flags (FMA
// contraction kept); kt_error_string is flagship.cu's.

#include <cooperative_groups.h>

#include "common.cuh"
#include "compact.cuh"
#include "moments.cuh"
#include "shifts.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;   // threads a block
constexpr int kMaxWalkers = 1024;  // walkers a block covers at most
constexpr uint32_t kStreamAisWalker = 6u;
constexpr uint32_t kStreamAisSim = 7u;
constexpr int kNumF = 18;
constexpr int kNumI = 4;

struct AisConsts {
  float inv_n, tmu, tsd, sdw;                 // simulator and cost
  float g_lo, g_span, de_scale, inv300, third, p_s_hi, p_d_hi;  // moves
  float inv_scale;                            // kernelized density
  float mu_lo, mu_hi, sg_lo, sg_hi, lp_const, half_inv_var;     // prior
  int ndraws, chunk, block, stub;
};

template <bool kFresh>
__device__ __forceinline__ float load(const float* p, int i) {
  // kFresh: written earlier in this launch by other blocks
  return kFresh ? __ldcg(p + i) : p[i];
}

// Where a walker's bits come from.
struct Bits {
  uint32_t seed, pid, cbase, sub, lane;  // stub words
  uint32_t sim_pid, sim_ctr0, sim_sub;   // stub simulator
  uint32_t walker;                       // Philox counter word 1
};

// The bits of walker i of the half kernel.
struct HalfBits {
  uint32_t seed;
  int block;
  __device__ Bits operator()(int i) const {
    Bits b;
    b.seed = seed;
    b.pid = (uint32_t)(i / block);
    b.cbase = 20000u;
    b.sub = (uint32_t)((i % block) / 128);
    b.lane = (uint32_t)(i % 128);
    b.sim_pid = b.pid;
    b.sim_ctr0 = 0u;
    b.sim_sub = (uint32_t)(i % block);
    b.walker = (uint32_t)i;
    return b;
  }
};

// The bits of walker i of half `half` (of h walkers) of the full kernel.
struct FullBits {
  uint32_t seed, cbase;
  int block, nchunks, base;
  __device__ Bits operator()(int i) const {
    Bits b;
    b.seed = seed;
    b.pid = 0u;
    b.cbase = cbase;
    b.sub = (uint32_t)(i / 128);
    b.lane = (uint32_t)(i % 128);
    b.sim_pid = 0u;
    b.sim_ctr0 = cbase + 16u + 2u * (uint32_t)(i / block) * (uint32_t)nchunks;
    b.sim_sub = (uint32_t)(i % block);
    b.walker = (uint32_t)(base + i);
    return b;
  }
};

__device__ __forceinline__ void walker_words(const Bits& b, int stub,
                                             uint32_t* wd) {
  if (stub) {
#pragma unroll
    for (int k = 0; k < 9; ++k)
      wd[k] = stub_bits(b.pid, b.seed, b.cbase + (uint32_t)k, b.sub, b.lane);
  } else {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      Words4 q = philox4x32_10((uint32_t)g, b.walker, kStreamAisWalker, 0u,
                               b.seed);
      wd[4 * g] = q.x0;
      if (4 * g + 1 < 9) wd[4 * g + 1] = q.x1;
      if (4 * g + 2 < 9) wd[4 * g + 2] = q.x2;
      if (4 * g + 3 < 9) wd[4 * g + 3] = q.x3;
    }
  }
}

__device__ __forceinline__ float propose(bool is_s, bool is_d, float z,
                                         float gamma, float r1, float r2,
                                         float r3, float nz, float xi,
                                         const float* p, const AisConsts& c) {
  // p: stretch partner, DE pair, walk triple
  float p_s = p[0] + z * (xi - p[0]);
  float tri = (fabsf(p[1] - p[2]) + fabsf(xi - p[2])) + fabsf(p[1] - xi);
  float p_d = (xi + gamma * (p[1] - p[2])) + ((gamma * tri) * c.inv300) * nz;
  float cen = ((p[3] + p[4]) + p[5]) * c.third;
  float p_w = xi + ((r1 * (p[3] - cen) + r2 * (p[4] - cen)) +
                    r3 * (p[5] - cen));
  return is_s ? p_s : (is_d ? p_d : p_w);
}

// A walker's proposal and what its accept needs besides the simulator.
struct Proposal {
  float mu, sg, lpp, corr, u_acc;
};

// The steps before the simulator for walker i of a half-update: upd[i]
// against comp[(i + r_j) % h]. Returns whether the proposal lies inside
// the prior.
template <bool kFresh>
__device__ __forceinline__ bool ais_propose(int i, int h,
                                            const float* __restrict__ mu,
                                            const float* __restrict__ sg,
                                            const float* cmu,
                                            const float* csg, const int* r,
                                            const Bits& b,
                                            const AisConsts& c,
                                            Proposal* q) {
  uint32_t wd[9];
  walker_words(b, c.stub, wd);
  float u_mid = to_unit(wd[0]), u_z = to_unit(wd[1]);
  float gam_n, nz_mu, nz_sg, r1, r2, r3;
  box_muller(wd[2], wd[3], &gam_n, &nz_mu);
  box_muller(wd[4], wd[5], &nz_sg, &r1);
  box_muller(wd[6], wd[7], &r2, &r3);
  q->u_acc = to_unit(wd[8]);

  bool is_s = u_mid < c.p_s_hi;
  bool is_d = (u_mid >= c.p_s_hi) && (u_mid < c.p_d_hi);
  float zroot = u_z * c.g_span + c.g_lo;
  float z = zroot * zroot;                           // cdf_g_inv(u, a)
  q->corr = is_s ? 2.0f * logf(zroot) : 0.0f;        // (d - 1) log z, d = 2
  float gamma = c.de_scale * expf(0.1f * gam_n);

  float pm[6], ps[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    int k = i + r[j];
    if (k >= h) k -= h;
    pm[j] = load<kFresh>(cmu, k);
    ps[j] = load<kFresh>(csg, k);
  }
  float pmu = propose(is_s, is_d, z, gamma, r1, r2, r3, nz_mu, mu[i], pm, c);
  float psg = propose(is_s, is_d, z, gamma, r1, r2, r3, nz_sg, sg[i], ps, c);
  q->mu = pmu;
  q->sg = psg;
  bool inside = (pmu >= c.mu_lo) && (pmu <= c.mu_hi) && (psg >= c.sg_lo) &&
                (psg <= c.sg_hi);
  q->lpp = inside ? c.lp_const - (psg * psg) * c.half_inv_var
                  : __int_as_float(0xff800000);
  return inside;
}

// The simulator, the cost and the MH accept of a walker inside the prior,
// and its outputs.
__device__ __forceinline__ void ais_accept(
    int i, const Proposal& q, const Bits& b, const AisConsts& c,
    const float* __restrict__ mu, const float* __restrict__ sg,
    const float* __restrict__ lp, const float* __restrict__ ll, float* omu,
    float* osg, float* olp, float* oll) {
  float s1, s2, cost;
  if (c.stub) {
    moments_stub(b.sim_pid, b.seed, b.sim_ctr0, b.sim_sub, c.ndraws, c.chunk,
                 &s1, &s2);
    cost = summary_cost(q.mu, q.sg, s1, s2, c.inv_n, c.tmu, c.tsd, c.sdw);
  } else {
    moments_philox(b.seed, kStreamAisSim, b.walker, c.ndraws, &s1, &s2);
    cost = centred_cost(q.mu, q.sg, s1, s2, c.ndraws, c.tmu, c.tsd, c.sdw);
  }
  float t = cost * c.inv_scale;
  float llp = -0.5f * (t * t);
  float lp0 = lp[i], ll0 = ll[i];
  float lw = (q.corr + (q.lpp + llp)) - (lp0 + ll0);
  bool acc = log1pf(-q.u_acc) <= lw;
  omu[i] = acc ? q.mu : mu[i];
  osg[i] = acc ? q.sg : sg[i];
  olp[i] = acc ? q.lpp : lp0;
  oll[i] = acc ? llp : ll0;
}

// The block's shared memory: the half's shifts, the slots and the
// proposals of the walkers inside the prior (by walker index in the
// range).
struct Shared {
  int r[6];
  int walker[kMaxWalkers];
  Proposal prop[kMaxWalkers];
};

// One block's half-update over the walkers [first, first + walkers) of a
// half of h: upd against comp[(i + r_j) % h], the outputs to out[i];
// sh.r holds the half's shifts. Every thread reaches every barrier.
template <bool kFresh, typename BitsOf>
__device__ void half_range(int first, int walkers, int h,
                           const float* __restrict__ mu,
                           const float* __restrict__ sg,
                           const float* __restrict__ lp,
                           const float* __restrict__ ll, const float* cmu,
                           const float* csg, Shared& sh,
                           BitsOf bits_of, const AisConsts& c, float* omu,
                           float* osg, float* olp, float* oll) {
  const int* r = sh.r;
  int* s_walker = sh.walker;
  Proposal* s_prop = sh.prop;
  int p = compact_walkers<kMaxThreads>(
      first, walkers, h, s_walker, [&](int i) {
        Proposal q;
        bool inside = ais_propose<kFresh>(i, h, mu, sg, cmu, csg, r,
                                          bits_of(i), c, &q);
        if (!inside) {  // never commits: the inputs go through
          omu[i] = mu[i];
          osg[i] = sg[i];
          olp[i] = lp[i];
          oll[i] = ll[i];
        } else {
          s_prop[i - first] = q;
        }
        return inside;
      });
  for (int slot = threadIdx.x; slot < p; slot += blockDim.x) {
    int i = s_walker[slot];
    ais_accept(i, s_prop[i - first], bits_of(i), c, mu, sg, lp, ll, omu,
               osg, olp, oll);
  }
}

__global__ void __launch_bounds__(kMaxThreads) fused_ais_half_kernel(
    const float* __restrict__ mu, const float* __restrict__ sg,
    const float* __restrict__ lp, const float* __restrict__ ll,
    const float* __restrict__ cmu, const float* __restrict__ csg,
    const long long* __restrict__ words, float* __restrict__ omu,
    float* __restrict__ osg, float* __restrict__ olp,
    float* __restrict__ oll, int h, int walkers, AisConsts c) {
  __shared__ Shared sh;
  if (threadIdx.x == 0) derive_shifts(words, h, sh.r);
  __syncthreads();
  HalfBits bits{word32(words[6]), c.block};
  half_range<false>(blockIdx.x * walkers, walkers, h, mu, sg, lp, ll, cmu,
                    csg, sh, bits, c, omu, osg, olp, oll);
}

__global__ void __launch_bounds__(kMaxThreads) fused_ais_full_kernel(
    const float* __restrict__ mu, const float* __restrict__ sg,
    const float* __restrict__ lp, const float* __restrict__ ll,
    const long long* __restrict__ words, float* omu, float* osg, float* olp,
    float* oll, int h, int walkers, AisConsts c) {
  __shared__ Shared sh;
  cg::grid_group grid = cg::this_grid();
  int ranges = (h + walkers - 1) / walkers;
  int nchunks = (c.ndraws + 2 * c.chunk - 1) / (2 * c.chunk);
  uint32_t seed = word32(words[12]);
  for (int half = 0; half < 2; ++half) {
    if (threadIdx.x == 0) derive_shifts(words + 6 * half, h, sh.r);
    __syncthreads();
    FullBits bits{seed, half ? 200000u : 100000u, c.block, nchunks,
                  half * h};
    for (int g = blockIdx.x; g < ranges; g += gridDim.x) {
      if (half == 0) {  // half A against the old half B
        half_range<false>(g * walkers, walkers, h, mu, sg, lp, ll, mu + h,
                          sg + h, sh, bits, c, omu, osg, olp, oll);
      } else {          // half B against the updated half A
        half_range<true>(g * walkers, walkers, h, mu + h, sg + h, lp + h,
                         ll + h, omu, osg, sh, bits, c, omu + h, osg + h,
                         olp + h, oll + h);
      }
      __syncthreads();  // the slots are free again
    }
    if (half == 0) grid.sync();
  }
}

AisConsts make_consts(const float* f, const int* n) {
  AisConsts c;
  float* dst[kNumF] = {&c.inv_n,  &c.tmu,    &c.tsd,      &c.sdw,
                       &c.g_lo,   &c.g_span, &c.de_scale, &c.inv300,
                       &c.third,  &c.p_s_hi, &c.p_d_hi,   &c.inv_scale,
                       &c.mu_lo,  &c.mu_hi,  &c.sg_lo,    &c.sg_hi,
                       &c.lp_const, &c.half_inv_var};
  for (int k = 0; k < kNumF; ++k) *dst[k] = f[k];
  int* idst[kNumI] = {&c.ndraws, &c.chunk, &c.block, &c.stub};
  for (int k = 0; k < kNumI; ++k) *idst[k] = n[k];
  return c;
}

// A geometry the kernels take: threads a multiple of 32 up to
// kMaxThreads, 1 to kMaxWalkers walkers a block.
bool geometry_ok(int walkers, int threads) {
  return threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
         walkers >= 1 && walkers <= kMaxWalkers;
}

// The cooperative grid of the full kernel: blocks per SM times SMs, no
// more than the ranges of `walkers` a half of h has.
int full_grid(int h, int walkers, int threads, int* blocks_per_sm,
              int* sms) {
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fused_ais_full_kernel, threads, 0);
  int need = (h + walkers - 1) / walkers;
  int grid = (*blocks_per_sm) * (*sms);
  return grid < need ? grid : need;
}

}  // namespace

// words: the half's six shift words and the seed (int64 holding uint32).
// walkers, threads: the geometry.
extern "C" int kt_fused_ais_half(const float* mu, const float* sg,
                                 const float* lp, const float* ll,
                                 const float* cmu, const float* csg,
                                 const long long* words, float* omu,
                                 float* osg, float* olp, float* oll, int h,
                                 const float* fconsts, const int* iconsts,
                                 int walkers, int threads, void* stream) {
  if (!geometry_ok(walkers, threads) || h < 3)
    return (int)cudaErrorInvalidConfiguration;
  AisConsts c = make_consts(fconsts, iconsts);
  int blocks = (h + walkers - 1) / walkers;
  fused_ais_half_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      mu, sg, lp, ll, cmu, csg, words, omu, osg, olp, oll, h, walkers, c);
  return (int)cudaGetLastError();
}

// words: half A's six shift words, half B's six, then the seed.
extern "C" int kt_fused_ais_full(const float* mu, const float* sg,
                                 const float* lp, const float* ll,
                                 const long long* words, float* omu,
                                 float* osg, float* olp, float* oll, int h,
                                 const float* fconsts, const int* iconsts,
                                 int walkers, int threads, void* stream) {
  if (!geometry_ok(walkers, threads) || h < 3)
    return (int)cudaErrorInvalidConfiguration;
  AisConsts c = make_consts(fconsts, iconsts);
  int dev = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  int per_sm = 0, sms = 0;
  int grid = full_grid(h, walkers, threads, &per_sm, &sms);
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&mu,  (void*)&sg,  (void*)&lp,      (void*)&ll,
                  (void*)&words, (void*)&omu, (void*)&osg,   (void*)&olp,
                  (void*)&oll, (void*)&h,   (void*)&walkers, (void*)&c};
  cudaError_t err = cudaLaunchCooperativeKernel(
      fused_ais_full_kernel, dim3(grid), dim3(threads), args, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// (blocks per SM, SMs, grid) of the full kernel's cooperative launch for a
// half of h walkers at a geometry.
extern "C" int kt_fused_ais_full_grid(int h, int walkers, int threads,
                                      int* out) {
  if (!geometry_ok(walkers, threads))
    return (int)cudaErrorInvalidConfiguration;
  out[2] = full_grid(h, walkers, threads, &out[0], &out[1]);
  return (int)cudaGetLastError();
}
