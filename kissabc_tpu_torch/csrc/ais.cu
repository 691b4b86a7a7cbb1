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
// Design. One thread per walker of the updated half, as the flagship smc
// kernels: the draws stay in registers and a walker moves ~48 bytes
// against ~47 operations per draw, so both kernels are bound by
// arithmetic. The TPU kernels take six rolled copies of the complementary
// half; here a walker reads its partners by index, comp[(i + r_j) % h],
// so nothing is copied. A walker outside the prior skips the simulator:
// its llp is its lpp (-inf) and it never commits, the outputs the TPU
// kernel gives after simulating it anyway.
//
// Half B of a sweep proposes against the UPDATED half A. kt_fused_ais_half
// is launched twice on one stream; kt_fused_ais_full does both halves in
// one cooperative launch: a grid-stride loop over half A, a grid-wide
// barrier (cooperative_groups::this_grid().sync()), then half B, which
// reads half A's outputs with ld.global.cg (through L2, past any stale L1
// line). The grid is the co-resident maximum from the occupancy API; a
// refused cooperative launch is returned as an error, never replaced by
// two launches.
//
// Random bits. stub = 1 replays the JAX package's _stub_bits at the TPU
// kernels' coordinates:
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
#include "moments.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
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

// One walker of a half-update: upd[i] against comp[(i + r_j) % h]; the
// outputs go to out[i].
template <bool kFresh>
__device__ void ais_walker(int i, int h, const float* __restrict__ mu,
                           const float* __restrict__ sg,
                           const float* __restrict__ lp,
                           const float* __restrict__ ll, const float* cmu,
                           const float* csg, const int* r, const Bits& b,
                           const AisConsts& c, float* omu, float* osg,
                           float* olp, float* oll) {
  uint32_t wd[9];
  walker_words(b, c.stub, wd);
  float u_mid = to_unit(wd[0]), u_z = to_unit(wd[1]);
  float gam_n, nz_mu, nz_sg, r1, r2, r3;
  box_muller(wd[2], wd[3], &gam_n, &nz_mu);
  box_muller(wd[4], wd[5], &nz_sg, &r1);
  box_muller(wd[6], wd[7], &r2, &r3);
  float u_acc = to_unit(wd[8]);

  bool is_s = u_mid < c.p_s_hi;
  bool is_d = (u_mid >= c.p_s_hi) && (u_mid < c.p_d_hi);
  float zroot = u_z * c.g_span + c.g_lo;
  float z = zroot * zroot;                        // cdf_g_inv(u, a)
  float corr = is_s ? 2.0f * logf(zroot) : 0.0f;  // (d - 1) log z, d = 2
  float gamma = c.de_scale * expf(0.1f * gam_n);

  float pm[6], ps[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    int k = i + r[j];
    if (k >= h) k -= h;
    pm[j] = load<kFresh>(cmu, k);
    ps[j] = load<kFresh>(csg, k);
  }
  float mu0 = mu[i], sg0 = sg[i];
  float pmu = propose(is_s, is_d, z, gamma, r1, r2, r3, nz_mu, mu0, pm, c);
  float psg = propose(is_s, is_d, z, gamma, r1, r2, r3, nz_sg, sg0, ps, c);
  bool inside = (pmu >= c.mu_lo) && (pmu <= c.mu_hi) && (psg >= c.sg_lo) &&
                (psg <= c.sg_hi);
  float neg_inf = __int_as_float(0xff800000);
  float lpp = inside ? c.lp_const - (psg * psg) * c.half_inv_var : neg_inf;
  float llp = lpp;
  if (inside) {  // no output of a walker outside the prior depends on it
    float s1, s2;
    if (c.stub) {
      moments_stub(b.sim_pid, b.seed, b.sim_ctr0, b.sim_sub, c.ndraws,
                   c.chunk, &s1, &s2);
    } else {
      moments_philox(b.seed, kStreamAisSim, b.walker, c.ndraws, &s1, &s2);
    }
    float cost = summary_cost(pmu, psg, s1, s2, c.inv_n, c.tmu, c.tsd, c.sdw);
    float t = cost * c.inv_scale;
    llp = -0.5f * (t * t);
  }
  float lp0 = lp[i], ll0 = ll[i];
  float lw = (corr + (lpp + llp)) - (lp0 + ll0);
  bool acc = inside && (log1pf(-u_acc) <= lw);
  omu[i] = acc ? pmu : mu0;
  osg[i] = acc ? psg : sg0;
  olp[i] = acc ? lpp : lp0;
  oll[i] = acc ? llp : ll0;
}

__global__ void fused_ais_half_kernel(
    const float* __restrict__ mu, const float* __restrict__ sg,
    const float* __restrict__ lp, const float* __restrict__ ll,
    const float* __restrict__ cmu, const float* __restrict__ csg,
    const long long* __restrict__ shifts, const long long* __restrict__ seed,
    float* __restrict__ omu, float* __restrict__ osg,
    float* __restrict__ olp, float* __restrict__ oll, int h, AisConsts c) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h) return;  // no padding walkers: nothing past h is written
  int r[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) r[j] = (int)shifts[j];
  Bits b;
  b.seed = (uint32_t)(unsigned long long)seed[0];
  b.pid = (uint32_t)(i / c.block);
  b.cbase = 20000u;
  b.sub = (uint32_t)((i % c.block) / 128);
  b.lane = (uint32_t)(i % 128);
  b.sim_pid = b.pid;
  b.sim_ctr0 = 0u;
  b.sim_sub = (uint32_t)(i % c.block);
  b.walker = (uint32_t)i;
  ais_walker<false>(i, h, mu, sg, lp, ll, cmu, csg, r, b, c, omu, osg, olp,
                    oll);
}

__global__ void fused_ais_full_kernel(
    const float* __restrict__ mu, const float* __restrict__ sg,
    const float* __restrict__ lp, const float* __restrict__ ll,
    const long long* __restrict__ shifts, const long long* __restrict__ seed,
    float* omu, float* osg, float* olp, float* oll, int h, AisConsts c) {
  cg::grid_group grid = cg::this_grid();
  int stride = gridDim.x * blockDim.x;
  int nchunks = (c.ndraws + 2 * c.chunk - 1) / (2 * c.chunk);
  uint32_t s = (uint32_t)(unsigned long long)seed[0];
  for (int half = 0; half < 2; ++half) {
    int base = half * h;
    int r[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) r[j] = (int)shifts[6 * half + j];
    uint32_t cbase = half ? 200000u : 100000u;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < h; i += stride) {
      Bits b;
      b.seed = s;
      b.pid = 0u;
      b.cbase = cbase;
      b.sub = (uint32_t)(i / 128);
      b.lane = (uint32_t)(i % 128);
      b.sim_pid = 0u;
      b.sim_ctr0 = cbase + 16u + 2u * (uint32_t)(i / c.block) *
                                     (uint32_t)nchunks;
      b.sim_sub = (uint32_t)(i % c.block);
      b.walker = (uint32_t)(base + i);
      if (half == 0) {  // half A against the old half B
        ais_walker<false>(i, h, mu, sg, lp, ll, mu + h, sg + h, r, b, c, omu,
                          osg, olp, oll);
      } else {          // half B against the updated half A
        ais_walker<true>(i, h, mu + h, sg + h, lp + h, ll + h, omu, osg, r,
                         b, c, omu + h, osg + h, olp + h, oll + h);
      }
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
  c.ndraws = n[0];
  c.chunk = n[1];
  c.block = n[2];
  c.stub = n[3];
  return c;
}

// The cooperative grid of the full kernel: blocks per SM times SMs, no
// more than h needs.
int full_grid(int h, int* blocks_per_sm, int* sms) {
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fused_ais_full_kernel, kThreads, 0);
  int need = (h + kThreads - 1) / kThreads;
  int grid = (*blocks_per_sm) * (*sms);
  return grid < need ? grid : need;
}

}  // namespace

extern "C" int kt_fused_ais_half(const float* mu, const float* sg,
                                 const float* lp, const float* ll,
                                 const float* cmu, const float* csg,
                                 const long long* shifts,
                                 const long long* seed, float* omu,
                                 float* osg, float* olp, float* oll, int h,
                                 const float* fconsts, const int* iconsts,
                                 void* stream) {
  AisConsts c = make_consts(fconsts, iconsts);
  if (h > 0) {
    fused_ais_half_kernel<<<(h + kThreads - 1) / kThreads, kThreads, 0,
                            (cudaStream_t)stream>>>(
        mu, sg, lp, ll, cmu, csg, shifts, seed, omu, osg, olp, oll, h, c);
  }
  return (int)cudaGetLastError();
}

extern "C" int kt_fused_ais_full(const float* mu, const float* sg,
                                 const float* lp, const float* ll,
                                 const long long* shifts,
                                 const long long* seed, float* omu,
                                 float* osg, float* olp, float* oll, int h,
                                 const float* fconsts, const int* iconsts,
                                 void* stream) {
  AisConsts c = make_consts(fconsts, iconsts);
  int dev = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  int per_sm = 0, sms = 0;
  int grid = full_grid(h, &per_sm, &sms);
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&mu,  (void*)&sg,     (void*)&lp,  (void*)&ll,
                  (void*)&shifts, (void*)&seed, (void*)&omu, (void*)&osg,
                  (void*)&olp, (void*)&oll,    (void*)&h,   (void*)&c};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)fused_ais_full_kernel, dim3(grid), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// (blocks per SM, SMs, grid) of the full kernel's cooperative launch for a
// half of h walkers.
extern "C" int kt_fused_ais_full_grid(int h, int* out) {
  out[2] = full_grid(h, &out[0], &out[1]);
  return (int)cudaGetLastError();
}
