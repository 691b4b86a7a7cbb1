// Hand-written CUDA kernels for user models on Hopper (sm_90a): the
// generic streaming simulator cost and the generic fused smc sweep.
//
// They replace three Pallas TPU kernels of kissabc_tpu/ops/pallas_kernels.py:
//   kt_streaming_moment_cost <- make_streaming_moment_cost (pallas_call :2742)
//   kt_fused_smc_sweep       <- make_fused_smc_sweep       (pallas_call :2391)
//   kt_fused_ais_sweep       <- make_fused_ais_sweep half_call (pallas_call
//                               :1440), in units with KT_HAS_AIS
//   kt_fused_abcde_generation <- make_fused_abcde_generation full_call
//                               (pallas_call :2071), in units with
//                               KT_HAS_ABCDE
//
// This file is a template. kissabc_tpu_torch/ops/codegen.py traces the
// user's PyTorch callables and writes a translation unit that defines
//   KT_NPARAMS (theta leaves K), KT_NSTATS, KT_NOISE_NORMAL, KT_HAS_SWEEP
//   float draw(const float* th, float e)        one simulated value
//   void  stats_of(float x, float* g)           the KT_NSTATS summaries
//   float reduce_cost(const float* th, const float* m)   (sweeps only)
//   float prior_logpdf(const float* th)                  (sweeps only)
//   void  prior_push(const float* th, float* out)        (AIS, ABC-DE)
// and then includes this file; ops/_build.py compiles it with nvcc.
//
// Design. One thread per walker loops over its draws, as the flagship
// kernels do: the summaries stay in registers, a walker's draws never
// touch memory, and a walker moves (K + KT_NSTATS) * 4 bytes (cost) or
// about (2K + 6) * 4 bytes (sweep) against ~50 operations per draw. So
// the kernels are bound by instruction issue: an SM issues one warp
// instruction per scheduler per cycle, 132 x 128 lane instructions per
// cycle on the H100. On the flagship model the draw loop is 49 SASS
// instructions a draw (tools/sass_draw_loop.py; 80 before, with the stub
// test, the tail guards and the branches of log1pf and sqrtf in it), so
// 1000 draws of 2^20 walkers cannot take less than 1.53 ms at 1980 MHz.
// What the design does about it:
// - simulate() is a template on the bit source, so the loop holds no
//   stub test; the draws that both halves of a chunk pair hold run in
//   pairs without a guard, the ragged rest after them; the Philox round
//   keys are made once per walker and the Box-Muller radius runs without
//   libdevice's branches (common.cuh);
// - the sweep simulates only the walkers that pass gate 1 (no other
//   walker's outputs depend on it), and a warp runs the draw loop while
//   any of its lanes needs it: one thread per walker left 56% of the
//   lanes idle. Each block of 512 threads compacts its gate-1 walkers
//   onto its first threads before the simulator, so ~93% of the lanes in
//   the loop do useful work (fused_smc_sweep_kernel below). The AIS
//   sweep and the ABC-DE generation still mask.
// Draws keep the TPU kernels' chunk structure: chunk pair j holds draws
// [2j*chunk, (2j+1)*chunk) (half a, first noise of each pair) and
// [(2j+1)*chunk, (2j+2)*chunk) (half b); each half is summed on its own
// and added to the running totals, a first and then b. Partial sums of
// <= chunk draws keep the raw moments accurate enough for reduce_cost's
// m2 - m1^2.
//
// Random bits. stub = 1 replays the JAX package's _stub_bits at the TPU
// kernels' coordinates (walkers on lanes: program w / (wt*block), row
// (w % (wt*block)) / 128, lane w % 128, counters 2*(row*nchunks + j) and
// +1, sublane = draw index in the chunk; the sweep's per-walker words at
// counters 40000..40002 on the (rows, 128) tile). stub = 0 is
// Philox4x32-10 keyed by (seed, 0), counter (j, walker, stream, l/2):
// one call gives the two noise pairs of draws l and l + 1.
//
// Scalars that change every sweep (eps, the boundary flag, the two
// partner shifts and the seed) are read from device memory, so the smc
// loop never waits for the host to learn them. Walkers w >= n are masked:
// nothing is padded and nothing past n is written.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walkers.cuh"

namespace {

constexpr int kThreads = 128;

// Philox streams (third counter word) of the generic kernels; the
// flagship kernels use 0..2.
constexpr uint32_t kStreamGenCost = 3u;
constexpr uint32_t kStreamGenSweepWalker = 4u;
constexpr uint32_t kStreamGenSweepSim = 5u;

__device__ __forceinline__ void noise_pair(uint32_t b1, uint32_t b2,
                                           float* ea, float* eb) {
#if KT_NOISE_NORMAL
  box_muller(b1, b2, ea, eb);
#else
  *ea = to_unit(b1);
  *eb = to_unit(b2);
#endif
}

__device__ __forceinline__ void add_draw(const float* th, float e,
                                         float* acc) {
  float g[KT_NSTATS];
  stats_of(draw(th, e), g);
#pragma unroll
  for (int p = 0; p < KT_NSTATS; ++p) acc[p] += g[p];
}

// The four words of draws l and l + 1 of chunk pair j: for each draw the
// bits of its half-a and half-b noises.
template <bool kStub>
__device__ __forceinline__ void pair_words(uint32_t pid, uint32_t row_ctr,
                                           uint32_t lane, uint32_t seed,
                                           const PhiloxKey& key, uint32_t j,
                                           uint32_t walker, uint32_t stream,
                                           int l, uint32_t* w) {
  if constexpr (kStub) {
    w[0] = stub_bits(pid, seed, row_ctr, (uint32_t)l, lane);
    w[1] = stub_bits(pid, seed, row_ctr + 1u, (uint32_t)l, lane);
    w[2] = stub_bits(pid, seed, row_ctr, (uint32_t)l + 1u, lane);
    w[3] = stub_bits(pid, seed, row_ctr + 1u, (uint32_t)l + 1u, lane);
  } else {
    Words4 q = philox4x32_10(j, walker, stream, (uint32_t)(l >> 1), key);
    w[0] = q.x0;
    w[1] = q.x1;
    w[2] = q.x2;
    w[3] = q.x3;
  }
}

// The KT_NSTATS moments (summary sums times inv_n) of ndraws draws for
// one walker with parameters th, on the stub stream (kStub) or Philox.
// In chunk pair j, half a holds na draws and half b nb <= na: the draws
// that both halves hold run in pairs without a guard, the ragged rest of
// half a (and the last odd draw of half b) after them, so the sums keep
// the order of one guarded loop.
template <bool kStub>
__device__ void simulate(const float* th, int ndraws, int chunk, float inv_n,
                         uint32_t pid, uint32_t row, uint32_t lane,
                         uint32_t seed, uint32_t stream, uint32_t walker,
                         float* m) {
  PhiloxKey key = philox_key(seed);
  int nchunks = (ndraws + 2 * chunk - 1) / (2 * chunk);
  float s[KT_NSTATS];
#pragma unroll
  for (int p = 0; p < KT_NSTATS; ++p) s[p] = 0.0f;
  for (int j = 0; j < nchunks; ++j) {
    int start_a = 2 * j * chunk;
    int na = min(chunk, ndraws - start_a);
    int nb = max(0, min(chunk, ndraws - start_a - chunk));
    uint32_t ctr = 2u * (row * (uint32_t)nchunks + (uint32_t)j);
    float a[KT_NSTATS], b[KT_NSTATS];
#pragma unroll
    for (int p = 0; p < KT_NSTATS; ++p) a[p] = b[p] = 0.0f;
    uint32_t w[4];
    float ea, eb;
    int l = 0;
    for (; l + 1 < nb; l += 2) {
      pair_words<kStub>(pid, ctr, lane, seed, key, (uint32_t)j, walker,
                        stream, l, w);
      noise_pair(w[0], w[1], &ea, &eb);
      add_draw(th, ea, a);
      add_draw(th, eb, b);
      noise_pair(w[2], w[3], &ea, &eb);
      add_draw(th, ea, a);
      add_draw(th, eb, b);
    }
    for (; l < na; l += 2) {
      pair_words<kStub>(pid, ctr, lane, seed, key, (uint32_t)j, walker,
                        stream, l, w);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (l + h >= na) break;
        noise_pair(w[2 * h], w[2 * h + 1], &ea, &eb);
        add_draw(th, ea, a);
        if (l + h < nb) add_draw(th, eb, b);
      }
    }
#pragma unroll
    for (int p = 0; p < KT_NSTATS; ++p) s[p] += a[p];
#pragma unroll
    for (int p = 0; p < KT_NSTATS; ++p) s[p] += b[p];
  }
#pragma unroll
  for (int p = 0; p < KT_NSTATS; ++p) m[p] = s[p] * inv_n;
}

template <bool kStub>
__global__ void streaming_moment_cost_kernel(
    Leaves th, const long long* __restrict__ seed_ptr,
    float* __restrict__ out, int ld, int n, int ndraws, float inv_n,
    int sb_rows, int chunk) {
  int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n) return;
  uint32_t seed = (uint32_t)(unsigned long long)seed_ptr[0];
  float t[KT_NPARAMS];
#pragma unroll
  for (int k = 0; k < KT_NPARAMS; ++k) t[k] = th.p[k][w];
  Coords c = coords(w, sb_rows);
  float m[KT_NSTATS];
  simulate<kStub>(t, ndraws, chunk, inv_n, c.pid, c.row, c.lane, seed,
                  kStreamGenCost, (uint32_t)w, m);
#pragma unroll
  for (int p = 0; p < KT_NSTATS; ++p) out[(size_t)p * ld + w] = m[p];
}

#if KT_HAS_SWEEP
// Threads per block of the sweep at most (the wrapper picks the block
// size, a multiple of 32): the block's gate-1 walkers are compacted in
// shared slots of this many.
constexpr int kSweepMaxThreads = 1024;

// The sweep's steps before the simulator for walker w: the per-walker
// words (proposal scale N(0,1) * w_scale, MH log-u), the Gaussian-
// difference proposal against the partners (w - r) mod n, i.e.
// jnp.roll(x, r)[w], and the prior's logpdf lpp. Returns gate 1: alive,
// inside the prior's support, and log u < min(lpp - lps, 0).
template <bool kStub>
__device__ __forceinline__ bool sweep_propose(
    Leaves th, const float* __restrict__ lps,
    const unsigned char* __restrict__ alive, int w, int n, int r1, int r2,
    uint32_t seed, float w_scale, int sb_rows, float* prop, float* lpp) {
  Coords c = coords(w, sb_rows);
  uint32_t bu1, bu2, bu3;
  if constexpr (kStub) {
    bu1 = stub_bits(c.pid, seed, 40000u, c.row, c.lane);
    bu2 = stub_bits(c.pid, seed, 40001u, c.row, c.lane);
    bu3 = stub_bits(c.pid, seed, 40002u, c.row, c.lane);
  } else {
    Words4 b = philox4x32_10(0u, (uint32_t)w, kStreamGenSweepWalker, 0u,
                             seed);
    bu1 = b.x0;
    bu2 = b.x1;
    bu3 = b.x2;
  }
  float cv, sv;
  sincos_2pi(to_unit(bu2), &cv, &sv);
  float z = sqrtf(-2.0f * log1pf(-to_unit(bu1))) * cv;
  float wv = z * w_scale;
  float lprob = log1pf(-to_unit(bu3));  // log U(0,1]
  int i2 = w - r2, i1 = w - r1;
  if (i2 < 0) i2 += n;
  if (i1 < 0) i1 += n;
#pragma unroll
  for (int k = 0; k < KT_NPARAMS; ++k) {
    float d = th.p[k][i2] - th.p[k][i1];
    prop[k] = th.p[k][w] + d * wv;
  }
  // push is the identity for the continuous marginals of the table
  *lpp = prior_logpdf(prop);
  float dl = *lpp - lps[w];
  float lm = (dl > 0.0f) ? 0.0f : dl;  // min(dl, 0), NaN propagates
  return (alive[w] != 0) && (*lpp > __uint_as_float(0xff800000u)) &&
         (lprob < lm);
}

// One block of T threads sweeps T walkers in two phases. Phase 1: every
// thread proposes for its walker and tests gate 1; a walker that fails it
// keeps its inputs. Compaction: a ballot per warp and a prefix over the
// block's warps give each gate-1 walker a slot, in walker order. Phase 2:
// threads 0 .. p-1 take the p gate-1 walkers, recompute their proposals
// (the same bits, ~150 operations against the draws' ~60000), simulate,
// test gate 2 (< eps, or <= eps by the flag) and write. So a warp runs
// the draw loop with all its lanes busy but in the block's last partial
// warp. Threads past n fail gate 1 and write nothing; every thread
// reaches the barriers.
template <bool kStub>
__global__ void __launch_bounds__(kSweepMaxThreads) fused_smc_sweep_kernel(
    Leaves th, const float* __restrict__ xs, const float* __restrict__ lps,
    const unsigned char* __restrict__ alive,
    const float* __restrict__ eps_ptr,
    const unsigned char* __restrict__ flag_ptr,
    const long long* __restrict__ rs, OutLeaves oth,
    float* __restrict__ oxs, float* __restrict__ olps,
    unsigned char* __restrict__ ocm, int n, int ndraws, float inv_n,
    float w_scale, int sb_rows, int chunk) {
  __shared__ int s_walker[kSweepMaxThreads];
  __shared__ int s_base[kSweepMaxThreads / 32];
  __shared__ int s_pass;
  // rs = (r1, r2, seed): the partner shifts and the kernel seed
  int r1 = (int)rs[0], r2 = (int)rs[1];
  uint32_t seed = (uint32_t)(unsigned long long)rs[2];
  int w = blockIdx.x * blockDim.x + threadIdx.x;
  float prop[KT_NPARAMS], lpp;

  bool gate1 = false;
  if (w < n) {
    gate1 = sweep_propose<kStub>(th, lps, alive, w, n, r1, r2, seed,
                                 w_scale, sb_rows, prop, &lpp);
    if (!gate1) {
#pragma unroll
      for (int k = 0; k < KT_NPARAMS; ++k) oth.p[k][w] = th.p[k][w];
      oxs[w] = xs[w];
      olps[w] = lps[w];
      ocm[w] = 0;
    }
  }

  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned pass = __ballot_sync(0xffffffffu, gate1);
  if (lane == 0) s_base[warp] = __popc(pass);
  __syncthreads();
  if (threadIdx.x == 0) {  // exclusive prefix over the block's warps
    int sum = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
      int count = s_base[i];
      s_base[i] = sum;
      sum += count;
    }
    s_pass = sum;
  }
  __syncthreads();
  if (gate1) s_walker[s_base[warp] + __popc(pass & ((1u << lane) - 1u))] = w;
  __syncthreads();

  if ((int)threadIdx.x >= s_pass) return;
  int v = s_walker[threadIdx.x];
  sweep_propose<kStub>(th, lps, alive, v, n, r1, r2, seed, w_scale, sb_rows,
                       prop, &lpp);
  Coords c = coords(v, sb_rows);
  float m[KT_NSTATS];
  simulate<kStub>(prop, ndraws, chunk, inv_n, c.pid, c.row, c.lane, seed,
                  kStreamGenSweepSim, (uint32_t)v, m);
  float xp = reduce_cost(prop, m);
  float eps = eps_ptr[0];
  bool commit = (xp < eps) || ((flag_ptr[0] != 0) && (xp == eps));
#pragma unroll
  for (int k = 0; k < KT_NPARAMS; ++k)
    oth.p[k][v] = commit ? prop[k] : th.p[k][v];
  oxs[v] = commit ? xp : xs[v];
  olps[v] = commit ? lpp : lps[v];
  ocm[v] = commit ? 1 : 0;
}
#endif

#if defined(KT_HAS_AIS) && KT_HAS_AIS
// The generic AIS half-update (make_fused_ais_sweep): per walker i of the
// updated half, the 4:2:1 stretch / DE / walk proposal against the six
// partners comp[(i + r_j) % h], the push (discrete marginals rounded) and
// the prior's logpdf, then, inside the prior, the streamed simulator on
// the pushed proposal, reduce_cost in the kernel, and the kernelized MH
// accept on lp + ll; the raw float proposal is committed. A walker
// outside the prior skips the simulator: its llp is its lpp (-inf) and it
// never commits, the outputs the TPU kernel gives after simulating it.
//
// The words and the proposal are mixture_propose (walkers.cuh), shared
// with the tempered sweep; the simulator is simulate() at the same
// (program, row, lane).
constexpr uint32_t kStreamGenAisWalker = 8u;
constexpr uint32_t kStreamGenAisSim = 9u;

struct AisGenConsts {
  float inv_n, g_lo, g_span, de_scale, inv300, third, p_s_hi, p_d_hi,
      inv_scale, corr2;  // corr2 = 2 (d - 1)
};

template <bool kStub>
__global__ void fused_ais_sweep_kernel(
    Leaves th, const float* __restrict__ lp, const float* __restrict__ ll,
    Leaves comp, const long long* __restrict__ shifts,
    const long long* __restrict__ seed_ptr, OutLeaves oth,
    float* __restrict__ olp, float* __restrict__ oll, int h, int ndraws,
    AisGenConsts c, int sb_rows, int chunk) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h) return;  // no padding walkers: nothing past h is written
  uint32_t seed = (uint32_t)(unsigned long long)seed_ptr[0];
  Coords cc = coords(i, sb_rows);
  MixConsts mc = {c.g_lo,  c.g_span, c.de_scale, c.inv300,
                  c.third, c.p_s_hi, c.p_d_hi,   c.corr2};
  float prop[KT_NPARAMS], corr, u_acc;
  mixture_propose(th, comp, shifts, i, h, seed, cc, kStub,
                  kStreamGenAisWalker, mc, prop, &corr, &u_acc);
  float pushed[KT_NPARAMS];
  prior_push(prop, pushed);
  float lpp = prior_logpdf(pushed);
  bool valid = lpp > __uint_as_float(0xff800000u);
  float llp = lpp;
  if (valid) {  // no output of a walker outside the prior depends on it
    float m[KT_NSTATS];
    simulate<kStub>(pushed, ndraws, chunk, c.inv_n, cc.pid, cc.row, cc.lane,
                    seed, kStreamGenAisSim, (uint32_t)i, m);
    float t = reduce_cost(pushed, m) * c.inv_scale;
    llp = -0.5f * (t * t);
  }
  float lp0 = lp[i], ll0 = ll[i];
  float lw = (corr + (lpp + llp)) - (lp0 + ll0);
  bool acc = valid && (log1pf(-u_acc) <= lw);
#pragma unroll
  for (int k = 0; k < KT_NPARAMS; ++k)
    oth.p[k][i] = acc ? prop[k] : th.p[k][i];
  olp[i] = acc ? lpp : lp0;
  oll[i] = acc ? llp : ll0;
}
#endif

#if defined(KT_HAS_ABCDE) && KT_HAS_ABCDE
// The ABC-DE generation (make_fused_abcde_generation): per walker w, the
// DE proposal ts + gamma (ta - tb) from the bases and partners gathered
// before the launch, the push and the prior's logpdf, the prior-MH gate
// (active, and log U <= min(lpp - lps, 0)), then, for the walkers that
// pass the gate only, the streamed simulator on the raw or the pushed
// proposal (push_cost), reduce_cost in the kernel, and the commit
// dp <= max(eps_i, ds). The raw proposal is committed; gate is 0 or 1.
// A walker that fails the gate skips the simulator: no output of it
// depends on the simulation, as in the TPU kernel, which simulates every
// walker and masks.
//
// Gate uniform: stub counter 40000 on the (TR, 128) super-tile, or word 0
// of Philox counter (0, w, kStreamAbcdeWalker, 0); the simulator is
// simulate() at the same (program, row, lane), on kStreamAbcdeSim.
constexpr uint32_t kStreamAbcdeWalker = 11u;
constexpr uint32_t kStreamAbcdeSim = 12u;

template <bool kStub>
__global__ void fused_abcde_generation_kernel(
    Leaves th, Leaves ts, Leaves ta, Leaves tb, const float* __restrict__ lps,
    const float* __restrict__ ds, const float* __restrict__ active,
    const float* __restrict__ eps_i, const long long* __restrict__ seed_ptr,
    OutLeaves oth, float* __restrict__ olps, float* __restrict__ ods,
    float* __restrict__ ogate, int n, int ndraws, float inv_n, float gamma,
    int push_cost, int sb_rows, int chunk) {
  int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n) return;  // no padding walkers: nothing past n is written
  uint32_t seed = (uint32_t)(unsigned long long)seed_ptr[0];
  Coords c = coords(w, sb_rows);
  uint32_t bu;
  if constexpr (kStub) {
    bu = stub_bits(c.pid, seed, 40000u, c.row, c.lane);
  } else {
    bu = philox4x32_10(0u, (uint32_t)w, kStreamAbcdeWalker, 0u, seed).x0;
  }
  float lprob = log1pf(-to_unit(bu));  // log U(0,1]

  float prop[KT_NPARAMS];
#pragma unroll
  for (int k = 0; k < KT_NPARAMS; ++k)
    prop[k] = ts.p[k][w] + gamma * (ta.p[k][w] - tb.p[k][w]);
  float pushed[KT_NPARAMS];
  prior_push(prop, pushed);
  float lpp = prior_logpdf(pushed);
  float lp = lps[w];
  float dl = lpp - lp;
  // min(dl, 0) with NaN kept (fminf would drop it): -inf - -inf never
  // passes, as jnp.minimum
  float lm = (dl > 0.0f) ? 0.0f : dl;
  bool gate = (active[w] > 0.5f) && (lprob <= lm);

  bool commit = false;
  float dp = 0.0f;
  if (gate) {  // the outputs depend on the simulation only here
    // selected leaf by leaf (a pointer to one array or the other would
    // put both on the stack)
    float sim[KT_NPARAMS];
#pragma unroll
    for (int k = 0; k < KT_NPARAMS; ++k)
      sim[k] = push_cost ? pushed[k] : prop[k];
    float m[KT_NSTATS];
    simulate<kStub>(sim, ndraws, chunk, inv_n, c.pid, c.row, c.lane, seed,
                    kStreamAbcdeSim, (uint32_t)w, m);
    dp = reduce_cost(sim, m);
    float e = eps_i[w], d = ds[w];
    // max(eps_i, ds) with NaN kept, as jnp.maximum
    float hi = (e != e || d != d) ? (e + d) : fmaxf(e, d);
    commit = dp <= hi;
  }
#pragma unroll
  for (int k = 0; k < KT_NPARAMS; ++k)
    oth.p[k][w] = commit ? prop[k] : th.p[k][w];
  olps[w] = commit ? lpp : lp;
  ods[w] = commit ? dp : ds[w];
  ogate[w] = gate ? 1.0f : 0.0f;
}
#endif

inline int grid_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int kt_streaming_moment_cost(const float* const* th,
                                        const long long* seed, float* out,
                                        int ld, int n, int ndraws,
                                        float inv_n, int stub, int sb_rows,
                                        int chunk, void* stream) {
  Leaves leaves;
  for (int k = 0; k < KT_NPARAMS; ++k) leaves.p[k] = th[k];
  if (n > 0) {
    auto kernel = stub ? &streaming_moment_cost_kernel<true>
                       : &streaming_moment_cost_kernel<false>;
    kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        leaves, seed, out, ld, n, ndraws, inv_n, sb_rows, chunk);
  }
  return (int)cudaGetLastError();
}

#if KT_HAS_SWEEP
// blocks x threads from the wrapper (ops/fused_smc.py sweep_geometry):
// threads a multiple of 32 up to kSweepMaxThreads, blocks * threads >= n.
extern "C" int kt_fused_smc_sweep(
    const float* const* th, const float* xs, const float* lps,
    const unsigned char* alive, const float* eps, const unsigned char* flag,
    const long long* rs, float* const* oth, float* oxs, float* olps,
    unsigned char* ocm, int n, int ndraws, float inv_n, float w_scale,
    int stub, int sb_rows, int chunk, int blocks, int threads,
    void* stream) {
  if (threads < 32 || threads > kSweepMaxThreads || threads % 32 ||
      (long long)blocks * threads < n)
    return (int)cudaErrorInvalidConfiguration;
  Leaves leaves;
  OutLeaves outs;
  for (int k = 0; k < KT_NPARAMS; ++k) {
    leaves.p[k] = th[k];
    outs.p[k] = oth[k];
  }
  if (n > 0) {
    auto kernel = stub ? &fused_smc_sweep_kernel<true>
                       : &fused_smc_sweep_kernel<false>;
    kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        leaves, xs, lps, alive, eps, flag, rs, outs, oxs, olps, ocm, n,
        ndraws, inv_n, w_scale, sb_rows, chunk);
  }
  return (int)cudaGetLastError();
}

// Blocks of `threads` threads of the Philox sweep resident on one SM.
extern "C" int kt_fused_smc_sweep_occupancy(int threads, int* blocks_per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fused_smc_sweep_kernel<false>, threads, 0);
}
#endif

#if defined(KT_HAS_AIS) && KT_HAS_AIS
extern "C" int kt_fused_ais_sweep(
    const float* const* th, const float* lp, const float* ll,
    const float* const* comp, const long long* shifts, const long long* seed,
    float* const* oth, float* olp, float* oll, int h, int ndraws,
    const float* fconsts, int stub, int sb_rows, int chunk, void* stream) {
  Leaves leaves, partners;
  OutLeaves outs;
  for (int k = 0; k < KT_NPARAMS; ++k) {
    leaves.p[k] = th[k];
    partners.p[k] = comp[k];
    outs.p[k] = oth[k];
  }
  const float* f = fconsts;
  AisGenConsts c = {f[0], f[1], f[2], f[3], f[4],
                    f[5], f[6], f[7], f[8], f[9]};
  if (h > 0) {
    auto kernel = stub ? &fused_ais_sweep_kernel<true>
                       : &fused_ais_sweep_kernel<false>;
    kernel<<<grid_for(h), kThreads, 0, (cudaStream_t)stream>>>(
        leaves, lp, ll, partners, shifts, seed, outs, olp, oll, h, ndraws, c,
        sb_rows, chunk);
  }
  return (int)cudaGetLastError();
}
#endif

#if defined(KT_HAS_ABCDE) && KT_HAS_ABCDE
extern "C" int kt_fused_abcde_generation(
    const float* const* th, const float* const* bases, const float* lps,
    const float* ds, const float* active, const float* eps_i,
    const long long* seed, float* const* oth, float* olps, float* ods,
    float* ogate, int n, int ndraws, float inv_n, float gamma, int push_cost,
    int stub, int sb_rows, int chunk, void* stream) {
  // bases: the K leaves of ts, then of ta, then of tb
  Leaves leaves, s, a, b;
  OutLeaves outs;
  for (int k = 0; k < KT_NPARAMS; ++k) {
    leaves.p[k] = th[k];
    s.p[k] = bases[k];
    a.p[k] = bases[KT_NPARAMS + k];
    b.p[k] = bases[2 * KT_NPARAMS + k];
    outs.p[k] = oth[k];
  }
  if (n > 0) {
    auto kernel = stub ? &fused_abcde_generation_kernel<true>
                       : &fused_abcde_generation_kernel<false>;
    kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        leaves, s, a, b, lps, ds, active, eps_i, seed, outs, olps, ods,
        ogate, n, ndraws, inv_n, gamma, push_cost, sb_rows, chunk);
  }
  return (int)cudaGetLastError();
}
#endif

extern "C" const char* kt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
