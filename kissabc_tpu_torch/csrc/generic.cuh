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
//   void  prior_push(const float* th, float* out)        (sweeps only)
// and then includes this file; ops/_build.py compiles it with nvcc.
//
// Design. A walker's draws form one loop that keeps its summaries in
// registers and never touches memory; a walker moves (K + KT_NSTATS) * 4
// bytes (cost) or about (2K + 6) * 4 bytes (sweeps) against ~50
// operations per draw. So the kernels are bound by instruction issue (an
// SM issues one warp instruction per scheduler per cycle, 132 x 128 lane
// instructions per cycle on the H100) or, where few walkers need the
// simulator, by the latency of one walker's loop. On the flagship model
// the draw loop is 48.75 SASS instructions a draw (tools/sass_draw_loop.py),
// so 1000 draws of 2^20 walkers cannot take less than 1.5 ms at 1980 MHz,
// and one walker's 1000 draws are a chain of ~48750 instructions, 0.025 ms
// at one instruction a cycle. What the design does about it:
// - simulate() is a template on the bit source, so the loop holds no
//   stub test; the draws that both halves of a chunk pair hold run in
//   pairs without a guard, the ragged rest after them; the Philox round
//   keys are made once per walker and the Box-Muller radius runs without
//   libdevice's branches (common.cuh);
// - the sweeps and the ABC-DE generation simulate only the walkers whose
//   outputs depend on it (gate 1, inside the prior, the prior gate), and
//   a warp runs the draw loop while any of its lanes needs it. So each
//   block compacts those walkers onto its first threads or lane groups
//   before the simulator (compact_walkers), and ~90% of the lanes in the
//   loop do useful work against 32-59% when one thread per walker masks;
// - kernel #3 (fused_smc_sweep_kernel) runs one thread per compacted
//   walker: at 2^20 walkers it is issue-bound;
// - kernels #6 and #10 (the lane-group kernels) give each compacted
//   walker a group of L lanes that share its draws (simulate_group). At
//   #10's production width, 16384 walkers x 1000 draws, ~5300 walkers
//   pass the gate: one thread each would leave ~40 threads an SM and the
//   kernel bound by the latency of one walker's chain, which L lanes cut
//   L-fold. At 131072 walkers (#6 per half, #10) the card is issue-bound
//   and the groups keep the lanes busy. The walkers a block covers, its
//   threads and L are parameters (the wrappers pick them by measurement:
//   ops/lane_groups.py), so a block's walkers and the
//   grid's spread over the SMs are chosen apart from the lanes;
// - kernel #4 (the cost) simulates every walker, so it compacts nothing:
//   at 2^20 walkers it runs one thread per walker, issue-bound; at
//   ABCDE's split generations (16384 walkers, ~124 an SM) and below it
//   runs the same lane groups, which cut the chain of one walker L-fold.
//
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
// one call gives the two noise pairs of draws l and l + 1. Every
// walker's bits are keyed by its own index, never by its thread, so
// compaction and lane groups leave every output's bits as one thread per
// walker gives them (simulate_group says why the sums keep theirs).
//
// Scalars that change every sweep (eps, the boundary flag, the two
// partner shifts and the seed) are read from device memory, so the smc
// loop never waits for the host to learn them. Walkers w >= n are masked:
// nothing is padded and nothing past n is written.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compact.cuh"
#include "walkers.cuh"

namespace {

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

#if KT_HAS_SWEEP
// Threads per block of the sweep at most (the wrapper picks the block
// size, a multiple of 32): the block's gate-1 walkers are compacted in
// shared slots of this many.
constexpr int kSweepMaxThreads = 1024;

// The sweep's steps before the simulator for walker w: the per-walker
// words (proposal scale N(0,1) * w_scale, MH log-u), the Gaussian-
// difference proposal against the partners (w - r) mod n, i.e.
// jnp.roll(x, r)[w], read from p2 (shift r2) and p1 (shift r1), its push
// and the prior's logpdf lpp of the pushed values. p2 and p1 are the
// snapshot th itself, or, for a shard of a mesh, copies of the whole
// population already rolled by r2 and r1 (then r1 = r2 = 0). Returns
// gate 1: alive, inside the prior's support, and log u < min(lpp - lps,
// 0).
template <bool kStub>
__device__ __forceinline__ bool sweep_propose(
    Leaves th, Leaves p2, Leaves p1, const float* __restrict__ lps,
    const unsigned char* __restrict__ alive, int w, int n, int r1, int r2,
    uint32_t seed, float w_scale, int sb_rows, float* prop, float* pushed,
    float* lpp) {
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
    float d = p2.p[k][i2] - p1.p[k][i1];
    prop[k] = th.p[k][w] + d * wv;
  }
  // the push rounds the discrete marginals (a copy of a continuous one);
  // the prior and the simulator see the pushed values, the commit the raw
  prior_push(prop, pushed);
  *lpp = prior_logpdf(pushed);
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
// and pushes (the same bits, ~150 operations against the draws' ~60000),
// simulate on the pushed values, test gate 2 (< eps, or <= eps by the
// flag) and commit the raw proposal, as the JAX kernel. So a warp runs
// the draw loop with all its lanes busy but in the block's last partial
// warp. Threads past n fail gate 1 and write nothing; every thread
// reaches the barriers.
template <bool kStub>
__global__ void __launch_bounds__(kSweepMaxThreads) fused_smc_sweep_kernel(
    Leaves th, Leaves p2, Leaves p1, const float* __restrict__ xs,
    const float* __restrict__ lps,
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
  float prop[KT_NPARAMS], pushed[KT_NPARAMS], lpp;

  bool gate1 = false;
  if (w < n) {
    gate1 = sweep_propose<kStub>(th, p2, p1, lps, alive, w, n, r1, r2,
                                 seed, w_scale, sb_rows, prop, pushed, &lpp);
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
  sweep_propose<kStub>(th, p2, p1, lps, alive, v, n, r1, r2, seed, w_scale,
                       sb_rows, prop, pushed, &lpp);
  Coords c = coords(v, sb_rows);
  float m[KT_NSTATS];
  simulate<kStub>(pushed, ndraws, chunk, inv_n, c.pid, c.row, c.lane, seed,
                  kStreamGenSweepSim, (uint32_t)v, m);
  float xp = reduce_cost(pushed, m);
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

// The lane-group kernels, #6 (fused_ais_sweep_kernel) and #10
// (fused_abcde_generation_kernel), and the cost kernel #4
// (streaming_moment_cost_kernel: phase 2 alone, one turn, since every
// walker needs the simulator). A block covers `walkers` walkers with
// blockDim.x threads in two phases:
// - phase 1, one thread per walker (in passes of blockDim.x): the steps
//   before the simulator; a walker that does not need it writes its
//   outputs at once. A ballot per warp and a prefix over the block's warps
//   give each walker that needs it a slot, in walker order
//   (compact_walkers, compact.cuh);
// - phase 2, groups of L lanes (L divides 32, so a group lies inside one
//   warp): the block's groups take its compacted walkers in turn. Each
//   group recomputes its walker's proposal from the walker index (the
//   same bits: one to three Philox calls and ~150-400 operations against
//   ~49000 for the draws, so only the index crosses the barrier), runs the
//   simulator on its L lanes (simulate_group) and, on the group's first
//   lane, reduce_cost, the commit or accept and the writes. A warp runs
//   while its first group has a walker (phase2_turn).
// L = 1 runs simulate(), the loop of one thread per walker. Threads past
// n take no walker and reach every barrier; nothing past n is written.
constexpr int kGroupMaxThreads = 512;
constexpr int kGroupMaxWalkers = 4096;  // walkers a block covers at most
constexpr int kGroupMaxSmem = 232448;   // dynamic shared memory of a block
// one accumulator per (half, statistic): q = 2p + half
constexpr int kAccums = 2 * KT_NSTATS;
// float2 cells of one staging buffer: kAccums rows of 33 (32 lanes and
// one cell of padding, so a row starts one bank pair after the last)
constexpr int kStageCells = kAccums * 33;
// floats of one warp's staging: two buffers
constexpr int kStageFloats = 2 * 2 * kStageCells;

// a compile-time int as a type: the lanes of an instantiation, a flag
template <int N>
struct Int {
  static constexpr int value = N;
};

// The moments of simulate() for one walker on a group of L lanes (L even,
// dividing 32), called by all 32 lanes of the warp at once: lane r of
// the group is its rank, gw the group's index in its warp, stage the
// warp's staging. In chunk pair j the group takes the walker's Philox calls
// (stub: draw pairs) in rounds of L, lane r call c0 + r, i.e. draws
// l = 2(c0 + r) and l + 1 of both halves. Each lane makes its noise pairs
// and runs draw and stats_of on its four draws (pairs), and per
// accumulator q stores the pair (l, l + 1) in one float2 cell; after a
// __syncwarp the lane that owns q (q % L == r) loads the round's L cells of
// q and, after making its next round's pairs, adds them in draw order
// (source lane, then l before l + 1). A draw past the half's na or nb
// draws, which only the chunk pair's last rounds hold, is stored as +0: a
// running sum that starts at +0 is never -0, and x + +0 is x for every
// other x, so the padded adds change no bit. At the chunk pair's end the
// lane of (a, p) takes b from its neighbour (q + 1) and adds a, then b, to
// the total, as simulate() does; the moments reach every lane of the group
// by shuffles. So every float addition is the one simulate() makes, in
// its order. Rounds alternate between two buffers, so one __syncwarp a
// round orders a round's stores after the loads of the round before last.
// Cell (q, c) lies at q * 33 + c, c the storing lane's index in its warp:
// a group's cells are its own, the stores of a row are consecutive, and
// the loads of a half-warp (its lanes own rows r + iL, source column
// gw * L + src) fall on the bank pairs (lane + iL + src) mod 16, all
// distinct; every offset but the lane's and the buffer's is a constant.
template <bool kStub, int L>
__device__ void simulate_group(const float* th, int ndraws, int chunk,
                               float inv_n, uint32_t pid, uint32_t row,
                               uint32_t lane, uint32_t seed, uint32_t stream,
                               uint32_t walker, int r, int gw, float* stage,
                               float* m) {
  static_assert(L >= 2 && 32 % L == 0, "lane groups of 2 to 32");
  constexpr unsigned kWarp = 0xffffffffu;
  constexpr int kOwn = (kAccums + L - 1) / L;    // accumulators per lane
  // this lane's store cell in row 0, and its first load cell (row r,
  // column of source lane 0)
  float2* put = reinterpret_cast<float2*>(stage) + gw * L + r;
  const float2* get = reinterpret_cast<const float2*>(stage) + r * 33 +
                      gw * L;
  PhiloxKey key = philox_key(seed);
  int nchunks = (ndraws + 2 * chunk - 1) / (2 * chunk);
  int buf = 0;  // cells of the buffer this round uses: 0 or kStageCells
  float s[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) s[i] = 0.0f;
  for (int j = 0; j < nchunks; ++j) {
    int start_a = 2 * j * chunk;
    int na = min(chunk, ndraws - start_a);
    int nb = max(0, min(chunk, ndraws - start_a - chunk));
    uint32_t ctr = 2u * (row * (uint32_t)nchunks + (uint32_t)j);
    float2 v[kAccums];  // this lane's pairs of its call
    // the pairs of call c0 + r; pad: the round may hold draws past na or
    // nb, to be stored as +0
    auto make = [&](int c0, auto pad) {
      int l = 2 * (c0 + r);
      uint32_t w[4];
      pair_words<kStub>(pid, ctr, lane, seed, key, (uint32_t)j, walker,
                        stream, l, w);
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        float ea, eb, ga[KT_NSTATS], gb[KT_NSTATS];
        noise_pair(w[2 * d], w[2 * d + 1], &ea, &eb);
        stats_of(draw(th, ea), ga);
        stats_of(draw(th, eb), gb);
        if constexpr (decltype(pad)::value) {
          bool va = l + d < na, vb = l + d < nb;
#pragma unroll
          for (int p = 0; p < KT_NSTATS; ++p) {
            ga[p] = va ? ga[p] : 0.0f;
            gb[p] = vb ? gb[p] : 0.0f;
          }
        }
#pragma unroll
        for (int p = 0; p < KT_NSTATS; ++p) {
          (d == 0 ? v[2 * p].x : v[2 * p].y) = ga[p];
          (d == 0 ? v[2 * p + 1].x : v[2 * p + 1].y) = gb[p];
        }
      }
    };
    float acc[kOwn];
#pragma unroll
    for (int i = 0; i < kOwn; ++i) acc[i] = 0.0f;
    // one round: store this lane's pairs, load the cells of the
    // accumulators it owns, make the next round's pairs (last is the
    // round's last call), then add the loaded cells in draw order
    auto round = [&](int c0, int last, auto pad) {
#pragma unroll
      for (int q = 0; q < kAccums; ++q) put[buf + q * 33] = v[q];
      __syncwarp(kWarp);
      float2 x[kOwn][L];
#pragma unroll
      for (int i = 0; i < kOwn; ++i)
        if (r + i * L < kAccums) {
#pragma unroll
          for (int src = 0; src < L; ++src)
            x[i][src] = get[buf + i * L * 33 + src];
        }
      if (c0 + L < last) make(c0 + L, pad);
#pragma unroll
      for (int i = 0; i < kOwn; ++i)
        if (r + i * L < kAccums) {
#pragma unroll
          for (int src = 0; src < L; ++src) {
            acc[i] += x[i][src].x;
            acc[i] += x[i][src].y;
          }
        }
      buf ^= kStageCells;
    };
    // the calls c < nb / 2 hold four draws of the chunk pair: their rounds
    // run without the padding, the rounds after them with it
    int full = (nb >> 1) / L * L, ncalls = (na + 1) >> 1;
    int c0 = 0;
    if (full > 0) {
      make(0, Int<0>());
      for (; c0 < full; c0 += L) round(c0, full, Int<0>());
    }
    if (c0 < ncalls) {
      make(c0, Int<1>());
      for (; c0 < ncalls; c0 += L) round(c0, ncalls, Int<1>());
    }
    // even lanes own the (a, p) accumulators, their odd neighbours (b, p)
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      float b = __shfl_xor_sync(kWarp, acc[i], 1);
      if (!(r & 1)) {
        s[i] += acc[i];
        s[i] += b;
      }
    }
  }
  int first = (int)(threadIdx.x & 31u) - r;
#pragma unroll
  for (int p = 0; p < KT_NSTATS; ++p)
    m[p] = __shfl_sync(kWarp, s[(2 * p) / L], first + (2 * p) % L) * inv_n;
}

// The simulator of phase 2 on L lanes: simulate() itself for L = 1.
template <bool kStub, int L>
__device__ __forceinline__ void simulate_lanes(
    const float* th, int ndraws, int chunk, float inv_n, Coords c,
    uint32_t seed, uint32_t stream, uint32_t walker, int r, int gw,
    float* stage, float* m) {
  if constexpr (L == 1) {
    simulate<kStub>(th, ndraws, chunk, inv_n, c.pid, c.row, c.lane, seed,
                    stream, walker, m);
  } else {
    simulate_group<kStub, L>(th, ndraws, chunk, inv_n, c.pid, c.row,
                             c.lane, seed, stream, walker, r, gw, stage,
                             m);
  }
}

// Phase 2's turn `base` for the group g (the warp's first group g0) of a
// block with p compacted walkers: whether the group has a walker, and the
// walker it simulates. With L = 1 a thread runs while it has one; with
// L > 1 the whole warp runs while its first group has one (the warp's
// collectives take all 32 lanes), and a group without one simulates the
// first group's walker again, to write nothing: its lanes would idle in
// the running warp all the same.
template <int L>
__device__ __forceinline__ bool phase2_turn(int base, int g, int g0, int p) {
  return base + (L == 1 ? g : g0) < p;
}

// Kernel #4: the moments of every walker w < n, moment p to
// out[p * ld + w]. A block covers the walkers [blockIdx.x * walkers, +
// walkers) with one group of L lanes each (threads == walkers * L): L = 1
// is one thread a walker, the loop of simulate(). Nothing is compacted:
// every walker needs the simulator. For L > 1 a warp runs while its first
// group has a walker (phase2_turn's rule, in one turn); a group of that
// warp past the last walker simulates the first group's walker again, to
// write nothing.
//
// What bounds it on the H100: at 2^20 walkers x 1000 draws the draw
// loop's issue (one thread per walker in blocks of 128: the flagship
// model's ~49 SASS instructions a draw run at ~75% of the issue floor).
// Where few walkers share an SM, at ABCDE's split generations (16384: 124
// an SM) and below, one thread a walker left each scheduler about one
// warp, and the kernel ran at the latency of one walker's chain of ~48500
// instructions; L lanes a walker cut that chain L-fold for ~6 staging
// instructions a draw (see simulate_group). The geometry comes from
// ops/lane_groups.py cost_pick, by measurement. The groups take one walker
// each, not the block's walkers in turns: on the H100 a turn loop around
// the simulator took more registers and ran slower at every width tried.
// L = 1 is a kernel of its own, one thread a walker without launch
// bounds: under __launch_bounds__(kGroupMaxThreads) ptxas scheduled the
// same loop so that one walker's chain ran slower, which cost 3-20% at
// 33792-131072 walkers of the flagship model (PERF.md section 6).
template <bool kStub>
__global__ void streaming_moment_cost_kernel(
    Leaves th, const long long* __restrict__ seed_ptr,
    float* __restrict__ out, int ld, int n, int ndraws, float inv_n,
    int sb_rows, int chunk, int walkers) {
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

template <bool kStub, int L>
__global__ void __launch_bounds__(kGroupMaxThreads)
    streaming_moment_cost_kernel_lanes(Leaves th,
                                       const long long* __restrict__ seed_ptr,
                                       float* __restrict__ out, int ld, int n,
                                       int ndraws, float inv_n, int sb_rows,
                                       int chunk, int walkers) {
  extern __shared__ float s_dyn[];  // each warp's staging
  uint32_t seed = (uint32_t)(unsigned long long)seed_ptr[0];
  int first = blockIdx.x * walkers;
  int p = min(walkers, n - first);
  int g = threadIdx.x / L, r = threadIdx.x % L;
  int g0 = (threadIdx.x >> 5) * (32 / L);  // the warp's first group
  if (!phase2_turn<L>(0, g, g0, p)) return;
  bool own = g < p;
  int w = first + (own ? g : g0);
  float t[KT_NPARAMS];
#pragma unroll
  for (int k = 0; k < KT_NPARAMS; ++k) t[k] = th.p[k][w];
  float m[KT_NSTATS];
  simulate_lanes<kStub, L>(t, ndraws, chunk, inv_n, coords(w, sb_rows),
                           seed, kStreamGenCost, (uint32_t)w, r, g - g0,
                           s_dyn + (threadIdx.x >> 5) * kStageFloats, m);
  if (r == 0 && own) {
#pragma unroll
    for (int q = 0; q < KT_NSTATS; ++q) out[(size_t)q * ld + w] = m[q];
  }
}

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
// What bounds it on the H100: at the production width (two launches of
// h = 65536 walkers x 1000 draws a sweep) the draw loop's issue; one
// thread per walker masked the ~41% of walkers outside the prior, so each
// warp ran the loop with ~59% of its lanes busy. Now phase 1 proposes and
// writes the walkers outside the prior, and phase 2 runs the compacted
// walkers on lane groups (see the lane-group kernels above): 4 lanes for
// a model whose draw needs the latency hidden, 1 lane (one thread per
// compacted walker, in about one block of 512 an SM) for a light one,
// where the groups' staging would cost more than it hides
// (ops/lane_groups.py pick, by measurement). On a run's converged
// ensemble nearly every walker lies inside the prior: there the gain is
// the geometry's.
//
// The words and the proposal are mixture_propose (walkers.cuh), shared
// with the tempered sweep: the kernel takes the half's seven raw words
// and thread 0 of each block derives the six partner shifts from the
// first six (derive_shifts, shifts.cuh), so a half-update is one word
// draw and one launch; word 6 is the seed. The simulator is simulate() at
// the same (program, row, lane).
constexpr uint32_t kStreamGenAisWalker = 8u;
constexpr uint32_t kStreamGenAisSim = 9u;

struct AisGenConsts {
  float inv_n, g_lo, g_span, de_scale, inv300, third, p_s_hi, p_d_hi,
      inv_scale, corr2;  // corr2 = 2 (d - 1)
};

// The steps before the simulator for walker i: the proposal, its push and
// logpdf, the stretch's log-Jacobian and the accept uniform. Returns
// whether the push lies inside the prior. kParts: the partners-given form
// (walkers.cuh).
template <bool kStub, bool kParts>
__device__ __forceinline__ bool ais_propose(
    Leaves th, Leaves comp, const PartLeaves& parts, const int* r, int i,
    int h, uint32_t seed, const AisGenConsts& c, int sb_rows, float* prop,
    float* pushed, float* lpp, float* corr, float* u_acc) {
  MixConsts mc = {c.g_lo,  c.g_span, c.de_scale, c.inv300,
                  c.third, c.p_s_hi, c.p_d_hi,   c.corr2};
  mixture_propose<kParts>(th, comp, parts, r, i, h, seed, coords(i, sb_rows),
                          kStub, kStreamGenAisWalker, mc, prop, corr, u_acc);
  prior_push(prop, pushed);
  *lpp = prior_logpdf(pushed);
  return *lpp > __uint_as_float(0xff800000u);
}

template <bool kStub, int L, bool kParts>
__global__ void __launch_bounds__(kGroupMaxThreads) fused_ais_sweep_kernel(
    Leaves th, const float* __restrict__ lp, const float* __restrict__ ll,
    Leaves comp, const long long* __restrict__ words, OutLeaves oth,
    float* __restrict__ olp, float* __restrict__ oll, int h, int ndraws,
    AisGenConsts c, int sb_rows, int chunk, int walkers, PartLeaves parts) {
  extern __shared__ float s_dyn[];  // each warp's staging, then the slots
  __shared__ int shifts[6];
  int* s_walker = reinterpret_cast<int*>(
      s_dyn + (L > 1 ? (blockDim.x >> 5) * kStageFloats : 0));
  if (!kParts && threadIdx.x == 0) derive_shifts(words, h, shifts);
  __syncthreads();
  uint32_t seed = word32(words[6]);
  int p = compact_walkers<kGroupMaxThreads>(
      blockIdx.x * walkers, walkers, h, s_walker, [&](int i) {
        float prop[KT_NPARAMS], pushed[KT_NPARAMS], lpp, corr, u_acc;
        bool valid = ais_propose<kStub, kParts>(
            th, comp, parts, shifts, i, h, seed, c, sb_rows, prop, pushed,
            &lpp, &corr, &u_acc);
        if (!valid) {  // never commits: the inputs go through
#pragma unroll
          for (int k = 0; k < KT_NPARAMS; ++k) oth.p[k][i] = th.p[k][i];
          olp[i] = lp[i];
          oll[i] = ll[i];
        }
        return valid;
      });
  float* stage = s_dyn + (threadIdx.x >> 5) * kStageFloats;
  int g = threadIdx.x / L, r = threadIdx.x % L, groups = blockDim.x / L;
  int g0 = (threadIdx.x >> 5) * (32 / L);  // the warp's first group
  for (int base = 0; phase2_turn<L>(base, g, g0, p); base += groups) {
    bool own = base + g < p;
    int i = s_walker[own ? base + g : base + g0];
    float prop[KT_NPARAMS], pushed[KT_NPARAMS], lpp, corr, u_acc;
    ais_propose<kStub, kParts>(th, comp, parts, shifts, i, h, seed, c,
                               sb_rows, prop, pushed, &lpp, &corr, &u_acc);
    float m[KT_NSTATS];
    simulate_lanes<kStub, L>(pushed, ndraws, chunk, c.inv_n,
                             coords(i, sb_rows), seed, kStreamGenAisSim,
                             (uint32_t)i, r, g - g0, stage, m);
    if (r == 0 && own) {
      float t = reduce_cost(pushed, m) * c.inv_scale;
      float llp = -0.5f * (t * t);
      float lp0 = lp[i], ll0 = ll[i];
      float lw = (corr + (lpp + llp)) - (lp0 + ll0);
      bool acc = log1pf(-u_acc) <= lw;
#pragma unroll
      for (int k = 0; k < KT_NPARAMS; ++k)
        oth.p[k][i] = acc ? prop[k] : th.p[k][i];
      olp[i] = acc ? lpp : lp0;
      oll[i] = acc ? llp : ll0;
    }
  }
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
// What bounds it on the H100: ~32% of the walkers pass the gate. At
// ABCDE's production width, 16384 walkers x 1000 draws, that is ~5300
// simulated walkers, ~40 an SM: one thread each left the kernel bound by
// the latency of one walker's chain of ~48750 instructions (0.054-0.084
// ms, the chain alone 0.025 ms), on 128 blocks for 132 SMs, with a warp's
// lanes ~32% busy. At 131072 walkers the masked lanes were the cost. Now
// phase 1 gates and writes the walkers that fail, blocks of 64 walkers
// spread the grid over every SM, and each compacted walker's draws are
// split over a group of 4 lanes, which cuts the chain ~4-fold (0.0245 ms
// on the H100); at 131072 the compacted walkers keep ~96% of the loop's
// lanes busy, on 1 lane each for a light model (see the lane-group
// kernels above, ops/lane_groups.py pick).
//
// Gate uniform: stub counter 40000 on the (TR, 128) super-tile, or word 0
// of Philox counter (0, w, kStreamAbcdeWalker, 0); the simulator is
// simulate() at the same (program, row, lane), on kStreamAbcdeSim.
constexpr uint32_t kStreamAbcdeWalker = 11u;
constexpr uint32_t kStreamAbcdeSim = 12u;

// The steps before the simulator for walker w: the proposal, its push and
// logpdf. Returns the gate.
template <bool kStub>
__device__ __forceinline__ bool abcde_gate(
    Leaves ts, Leaves ta, Leaves tb, const float* __restrict__ lps,
    const float* __restrict__ active, int w, uint32_t seed, float gamma,
    int sb_rows, float* prop, float* pushed, float* lpp) {
  uint32_t bu;
  if constexpr (kStub) {
    Coords c = coords(w, sb_rows);
    bu = stub_bits(c.pid, seed, 40000u, c.row, c.lane);
  } else {
    bu = philox4x32_10(0u, (uint32_t)w, kStreamAbcdeWalker, 0u, seed).x0;
  }
  float lprob = log1pf(-to_unit(bu));  // log U(0,1]
#pragma unroll
  for (int k = 0; k < KT_NPARAMS; ++k)
    prop[k] = ts.p[k][w] + gamma * (ta.p[k][w] - tb.p[k][w]);
  prior_push(prop, pushed);
  *lpp = prior_logpdf(pushed);
  float dl = *lpp - lps[w];
  // min(dl, 0) with NaN kept (fminf would drop it): -inf - -inf never
  // passes, as jnp.minimum
  float lm = (dl > 0.0f) ? 0.0f : dl;
  return (active[w] > 0.5f) && (lprob <= lm);
}

template <bool kStub, int L>
__global__ void __launch_bounds__(kGroupMaxThreads)
    fused_abcde_generation_kernel(
        Leaves th, Leaves ts, Leaves ta, Leaves tb,
        const float* __restrict__ lps, const float* __restrict__ ds,
        const float* __restrict__ active, const float* __restrict__ eps_i,
        const long long* __restrict__ seed_ptr, OutLeaves oth,
        float* __restrict__ olps, float* __restrict__ ods,
        float* __restrict__ ogate, int n, int ndraws, float inv_n,
        float gamma, int push_cost, int sb_rows, int chunk, int walkers) {
  extern __shared__ float s_dyn[];  // each warp's staging, then the slots
  int* s_walker = reinterpret_cast<int*>(
      s_dyn + (L > 1 ? (blockDim.x >> 5) * kStageFloats : 0));
  uint32_t seed = (uint32_t)(unsigned long long)seed_ptr[0];
  int p = compact_walkers<kGroupMaxThreads>(
      blockIdx.x * walkers, walkers, n, s_walker, [&](int w) {
        float prop[KT_NPARAMS], pushed[KT_NPARAMS], lpp;
        bool gate = abcde_gate<kStub>(ts, ta, tb, lps, active, w, seed,
                                      gamma, sb_rows, prop, pushed, &lpp);
        if (!gate) {  // no output depends on the simulation
#pragma unroll
          for (int k = 0; k < KT_NPARAMS; ++k) oth.p[k][w] = th.p[k][w];
          olps[w] = lps[w];
          ods[w] = ds[w];
          ogate[w] = 0.0f;
        }
        return gate;
      });
  float* stage = s_dyn + (threadIdx.x >> 5) * kStageFloats;
  int g = threadIdx.x / L, r = threadIdx.x % L, groups = blockDim.x / L;
  int g0 = (threadIdx.x >> 5) * (32 / L);  // the warp's first group
  for (int base = 0; phase2_turn<L>(base, g, g0, p); base += groups) {
    bool own = base + g < p;
    int w = s_walker[own ? base + g : base + g0];
    float prop[KT_NPARAMS], pushed[KT_NPARAMS], lpp;
    abcde_gate<kStub>(ts, ta, tb, lps, active, w, seed, gamma, sb_rows, prop,
                      pushed, &lpp);
    // selected leaf by leaf (a pointer to one array or the other would
    // put both on the stack)
    float sim[KT_NPARAMS];
#pragma unroll
    for (int k = 0; k < KT_NPARAMS; ++k)
      sim[k] = push_cost ? pushed[k] : prop[k];
    float m[KT_NSTATS];
    simulate_lanes<kStub, L>(sim, ndraws, chunk, inv_n, coords(w, sb_rows),
                             seed, kStreamAbcdeSim, (uint32_t)w, r, g - g0,
                             stage, m);
    if (r == 0 && own) {
      float dp = reduce_cost(sim, m);
      float e = eps_i[w], d = ds[w];
      // max(eps_i, ds) with NaN kept, as jnp.maximum
      float hi = (e != e || d != d) ? (e + d) : fmaxf(e, d);
      bool commit = dp <= hi;
#pragma unroll
      for (int k = 0; k < KT_NPARAMS; ++k)
        oth.p[k][w] = commit ? prop[k] : th.p[k][w];
      olps[w] = commit ? lpp : lps[w];
      ods[w] = commit ? dp : d;
      ogate[w] = 1.0f;
    }
  }
}
#endif

// Dynamic shared memory of a lane-group block: for L > 1 each warp's
// staging, then (slots) the walkers' slots of the compacting kernels.
inline size_t group_smem(int walkers, int threads, int lanes,
                         bool slots = true) {
  size_t bytes = slots ? (size_t)walkers * sizeof(int) : 0;
  if (lanes > 1)
    bytes += (size_t)(threads / 32) * kStageFloats * sizeof(float);
  return bytes;
}

// The lanes a unit instantiates: 1 and 4, the two that
// ops/lane_groups.py pick chooses. A unit that defines KT_GROUP_ALL_LANES
// (the geometry grid of tools/time_geometry.py, the host tests) also has
// 2, 8 and 16; each instantiation is two kernels (Philox, stub bits) of
// the unrolled draw loop, compiled into every user model's library.
#if defined(KT_GROUP_ALL_LANES) && KT_GROUP_ALL_LANES
inline bool group_lanes(int lanes) {
  return lanes == 1 || lanes == 2 || lanes == 4 || lanes == 8 || lanes == 16;
}
#else
inline bool group_lanes(int lanes) { return lanes == 1 || lanes == 4; }
#endif

// 0 for a geometry the lane-group kernels take, else
// cudaErrorInvalidConfiguration: threads a multiple of 32 up to
// kGroupMaxThreads, 1 to kGroupMaxWalkers walkers a block, L one of the
// unit's (group_lanes) and the shared memory (with the walkers' slots,
// or without for #4) within a block's.
inline int group_check(int walkers, int threads, int lanes,
                       bool slots = true) {
  bool ok = threads >= 32 && threads <= kGroupMaxThreads &&
            threads % 32 == 0 && walkers >= 1 &&
            walkers <= kGroupMaxWalkers && group_lanes(lanes) &&
            group_smem(walkers, threads, lanes, slots) <=
                (size_t)kGroupMaxSmem;
  return ok ? 0 : (int)cudaErrorInvalidConfiguration;
}

// The instantiation of a lane-group kernel for `lanes` (checked by
// group_check): pick(Int<L>()).
template <typename Pick>
auto by_lanes(int lanes, Pick pick) -> decltype(pick(Int<1>())) {
  switch (lanes) {
    case 4:
      return pick(Int<4>());
#if defined(KT_GROUP_ALL_LANES) && KT_GROUP_ALL_LANES
    case 2:
      return pick(Int<2>());
    case 8:
      return pick(Int<8>());
    case 16:
      return pick(Int<16>());
#endif
    default:
      return pick(Int<1>());
  }
}

// Lets `kernel` take `smem` bytes of dynamic shared memory (above 48 KB a
// block must ask for it).
template <typename Kernel>
int group_smem_opt_in(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Blocks of the Philox instantiation `kernel` resident on one SM.
template <typename Kernel>
int group_occupancy(Kernel kernel, int walkers, int threads, int lanes,
                    int* blocks_per_sm) {
  size_t smem = group_smem(walkers, threads, lanes);
  int err = group_smem_opt_in(kernel, smem);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, threads, smem);
}

}  // namespace

// walkers, threads and lanes from the wrapper (ops/lane_groups.py
// cost_geometry): group_check's without the walkers' slots, and a group of
// lanes a walker (threads == walkers * lanes); the grid is
// ceil(n / walkers) blocks.
extern "C" int kt_streaming_moment_cost(const float* const* th,
                                        const long long* seed, float* out,
                                        int ld, int n, int ndraws,
                                        float inv_n, int stub, int sb_rows,
                                        int chunk, int walkers, int threads,
                                        int lanes, void* stream) {
  int err = group_check(walkers, threads, lanes, false);
  if (err) return err;
  if ((long long)walkers * lanes != threads)
    return (int)cudaErrorInvalidConfiguration;
  Leaves leaves;
  for (int k = 0; k < KT_NPARAMS; ++k) leaves.p[k] = th[k];
  if (n > 0) {
    auto kernel = by_lanes(lanes, [&](auto l) {
      constexpr int L = decltype(l)::value;
      if constexpr (L == 1)
        return stub ? &streaming_moment_cost_kernel<true>
                    : &streaming_moment_cost_kernel<false>;
      else
        return stub ? &streaming_moment_cost_kernel_lanes<true, L>
                    : &streaming_moment_cost_kernel_lanes<false, L>;
    });
    size_t smem = group_smem(walkers, threads, lanes, false);
    err = group_smem_opt_in(kernel, smem);
    if (err) return err;
    int blocks = (int)(((long long)n + walkers - 1) / walkers);
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        leaves, seed, out, ld, n, ndraws, inv_n, sb_rows, chunk, walkers);
  }
  return (int)cudaGetLastError();
}

#if KT_HAS_SWEEP
// blocks x threads from the wrapper (ops/fused_smc.py sweep_geometry):
// threads a multiple of 32 up to kSweepMaxThreads, blocks * threads >= n.
// part2/part1: null (the partners are read from th at (w - r) mod n), or
// the leaves of a shard's rolled copies (with rs = (0, 0, seed)).
extern "C" int kt_fused_smc_sweep(
    const float* const* th, const float* xs, const float* lps,
    const unsigned char* alive, const float* eps, const unsigned char* flag,
    const long long* rs, float* const* oth, float* oxs, float* olps,
    unsigned char* ocm, int n, int ndraws, float inv_n, float w_scale,
    int stub, int sb_rows, int chunk, int blocks, int threads,
    void* stream, const float* const* part2, const float* const* part1) {
  if (threads < 32 || threads > kSweepMaxThreads || threads % 32 ||
      (long long)blocks * threads < n)
    return (int)cudaErrorInvalidConfiguration;
  Leaves leaves, p2, p1;
  OutLeaves outs;
  for (int k = 0; k < KT_NPARAMS; ++k) {
    leaves.p[k] = th[k];
    p2.p[k] = part2 ? part2[k] : th[k];
    p1.p[k] = part1 ? part1[k] : th[k];
    outs.p[k] = oth[k];
  }
  if (n > 0) {
    auto kernel = stub ? &fused_smc_sweep_kernel<true>
                       : &fused_smc_sweep_kernel<false>;
    kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        leaves, p2, p1, xs, lps, alive, eps, flag, rs, outs, oxs, olps, ocm,
        n, ndraws, inv_n, w_scale, sb_rows, chunk);
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
// words: the half's six shift words and the seed (int64 holding uint32).
// walkers, threads and lanes from the wrapper (ops/lane_groups.py
// geometry); the grid is ceil(h / walkers) blocks. parts: null (the
// partners comp[(i + r_j) % h] of the derived shifts), or the 6 K
// partner leaves of a shard of a mesh, leaf-major (leaf k's six at
// 6k .. 6k + 5), each read at the walker's own index; then only words[6],
// the seed, is read, and comp is not.
extern "C" int kt_fused_ais_sweep_parts(
    const float* const* th, const float* lp, const float* ll,
    const float* const* comp, const long long* words, float* const* oth,
    float* olp, float* oll, int h, int ndraws, const float* fconsts,
    int stub, int sb_rows, int chunk, int walkers, int threads, int lanes,
    void* stream, const float* const* parts) {
  int err = group_check(walkers, threads, lanes);
  if (err) return err;
  if (h > 0 && h < 3 && !parts) return (int)cudaErrorInvalidConfiguration;
  Leaves leaves, partners;
  OutLeaves outs;
  PartLeaves given = {};
  for (int k = 0; k < KT_NPARAMS; ++k) {
    leaves.p[k] = th[k];
    partners.p[k] = comp[k];
    outs.p[k] = oth[k];
    for (int j = 0; j < 6; ++j) given.p[k][j] = parts ? parts[6 * k + j] : 0;
  }
  const float* f = fconsts;
  AisGenConsts c = {f[0], f[1], f[2], f[3], f[4],
                    f[5], f[6], f[7], f[8], f[9]};
  if (h > 0) {
    auto kernel = by_lanes(lanes, [&](auto l) {
      constexpr int L = decltype(l)::value;
      if (parts)
        return stub ? &fused_ais_sweep_kernel<true, L, true>
                    : &fused_ais_sweep_kernel<false, L, true>;
      return stub ? &fused_ais_sweep_kernel<true, L, false>
                  : &fused_ais_sweep_kernel<false, L, false>;
    });
    size_t smem = group_smem(walkers, threads, lanes);
    err = group_smem_opt_in(kernel, smem);
    if (err) return err;
    int blocks = (int)(((long long)h + walkers - 1) / walkers);
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        leaves, lp, ll, partners, words, outs, olp, oll, h, ndraws, c,
        sb_rows, chunk, walkers, given);
  }
  return (int)cudaGetLastError();
}

// The snapshot form: kt_fused_ais_sweep_parts without partners.
extern "C" int kt_fused_ais_sweep(
    const float* const* th, const float* lp, const float* ll,
    const float* const* comp, const long long* words, float* const* oth,
    float* olp, float* oll, int h, int ndraws, const float* fconsts,
    int stub, int sb_rows, int chunk, int walkers, int threads, int lanes,
    void* stream) {
  return kt_fused_ais_sweep_parts(th, lp, ll, comp, words, oth, olp, oll, h,
                                  ndraws, fconsts, stub, sb_rows, chunk,
                                  walkers, threads, lanes, stream, nullptr);
}

extern "C" int kt_fused_ais_sweep_occupancy(int walkers, int threads,
                                            int lanes, int* blocks_per_sm) {
  int err = group_check(walkers, threads, lanes);
  if (err) return err;
  return group_occupancy(by_lanes(lanes, [](auto l) {
                           return &fused_ais_sweep_kernel<
                               false, decltype(l)::value, false>;
                         }),
                         walkers, threads, lanes, blocks_per_sm);
}
#endif

#if defined(KT_HAS_ABCDE) && KT_HAS_ABCDE
// walkers, threads and lanes from the wrapper (ops/lane_groups.py
// geometry); the grid is ceil(n / walkers) blocks.
extern "C" int kt_fused_abcde_generation(
    const float* const* th, const float* const* bases, const float* lps,
    const float* ds, const float* active, const float* eps_i,
    const long long* seed, float* const* oth, float* olps, float* ods,
    float* ogate, int n, int ndraws, float inv_n, float gamma, int push_cost,
    int stub, int sb_rows, int chunk, int walkers, int threads, int lanes,
    void* stream) {
  int err = group_check(walkers, threads, lanes);
  if (err) return err;
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
    auto kernel = by_lanes(lanes, [&](auto l) {
      constexpr int L = decltype(l)::value;
      return stub ? &fused_abcde_generation_kernel<true, L>
                  : &fused_abcde_generation_kernel<false, L>;
    });
    size_t smem = group_smem(walkers, threads, lanes);
    err = group_smem_opt_in(kernel, smem);
    if (err) return err;
    int blocks = (int)(((long long)n + walkers - 1) / walkers);
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        leaves, s, a, b, lps, ds, active, eps_i, seed, outs, olps, ods,
        ogate, n, ndraws, inv_n, gamma, push_cost, sb_rows, chunk, walkers);
  }
  return (int)cudaGetLastError();
}

extern "C" int kt_fused_abcde_generation_occupancy(int walkers, int threads,
                                                   int lanes,
                                                   int* blocks_per_sm) {
  int err = group_check(walkers, threads, lanes);
  if (err) return err;
  return group_occupancy(by_lanes(lanes, [](auto l) {
                           return &fused_abcde_generation_kernel<
                               false, decltype(l)::value>;
                         }),
                         walkers, threads, lanes, blocks_per_sm);
}
#endif

extern "C" const char* kt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
