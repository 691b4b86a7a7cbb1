// Hand-written CUDA radix select for Hopper (sm_90a): the masked type-7
// quantile of one population, in one cooperative launch.
//
// It replaces no TPU kernel. The JAX package's quantile
// (kissabc_tpu/ops/quantile.py masked_quantile_bisect) is plain jnp, and
// its PyTorch counterpart (kissabc_tpu_torch/ops/quantile.py
// masked_quantile_bisect_plain, this kernel's plain version) issues about
// 480 small operations a quantile: 33 bisection passes over the vector,
// each a compare, an and and an int64 sum, and the scalar arithmetic
// between them, plus two blocking host-to-device copies of an inf. The
// smc loop takes one quantile an iteration, and at 2^20 walkers the host
// issuing them was the loop's largest block of time.
//
// What it computes: the same bits as the bisection. An alive entry's key
// is the monotone uint32 of its float (negatives bit-complemented,
// non-negatives with the sign bit set, so -inf < finite < +inf and
// -0.0 < +0.0); a NaN counts as +inf. With m the alive count, h =
// float(m - 1) * q, k = max(floor(h), 0) and frac = h - k, each rounded
// to float32 as PyTorch rounds them, xlo is the key of rank k (+inf when
// k >= m, so m = 0 gives +inf). xhi is xlo when rank k + 1 holds the same
// key, else the least alive non-NaN value above xlo, else xlo. The result
// is xlo + frac * (xhi - xlo), three roundings written out (__fsub_rn,
// __fmul_rn, __fadd_rn: this unit builds without -fmad=false, and a
// contracted FMA would round once where PyTorch's three kernels round
// three times), or xlo itself when it is not finite.
//
// What bounds it on the H100: one read of x and the mask, 5 bytes an
// entry (2^20 entries: 5.2 MB at 3.35 TB/s, about 1.6 us). Design: an
// MSD radix select of 11, 11 and 10 bits. Every block takes a grid-stride
// share of the entries (16-byte loads where x is 16-byte aligned and the
// mask 4-byte aligned), counts its digits in a shared-memory histogram
// and adds the nonzero bins into a global one with atomicAdd; after a
// grid barrier every block reads the global histogram (8 KB, from L2)
// and finds, by a block-wide prefix scan, the bin that holds the rank.
// The next pass counts only the keys of that prefix. The second and
// third passes re-read x and the mask from L2 (5 MB of its 50 MB). The
// third pass also takes the least key above the 22-bit prefix (an
// atomicMin), so the neighbour xhi comes from the last histogram or from
// that minimum with no fourth pass. The kernel zeroes its scratch itself
// before the first barrier: four grid barriers in place of ~480 launches
// and two copies. The grid is the blocks co-resident on the card (the
// wrapper's choice, at most the occupancy API's), as a grid barrier
// needs.
//
// Built as its own library (ops/_build.py), with the flagship's flags.

#include <cooperative_groups.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kBins1 = 2048;  // key bits 31..21
constexpr int kBins2 = 2048;  // key bits 20..10
constexpr int kBins3 = 1024;  // key bits 9..0
// scratch: the three global histograms, then the least key above the
// prefix of the third pass
constexpr int kH1 = 0;
constexpr int kH2 = kH1 + kBins1;
constexpr int kH3 = kH2 + kBins2;
constexpr int kMinAbove = kH3 + kBins3;
constexpr int kScratchWords = kMinAbove + 1;
constexpr unsigned kNone = 0xffffffffu;      // no key (above every key)
constexpr unsigned kPosInfKey = 0xff800000u;  // the key of +inf
// slots of the block's scan memory after the 32 warp sums
constexpr int kSlotBin = 32, kSlotBelow = 33, kSlotMin = 34, kScanWords = 35;

__device__ __forceinline__ bool is_nan(unsigned b) {
  return (b & 0x7fffffffu) > 0x7f800000u;
}

// The monotone key of a float's bits; a NaN is keyed as +inf.
__device__ __forceinline__ unsigned key_of(unsigned b) {
  if (is_nan(b)) return kPosInfKey;
  return (b >> 31) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unkey(unsigned u) {
  return __uint_as_float((u >> 31) ? (u ^ 0x80000000u) : ~u);
}

// f(bits) for every alive entry of this block's grid-stride share.
template <class F>
__device__ __forceinline__ void for_alive(const float* x,
                                          const unsigned char* alive, int n,
                                          F f) {
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  int nv = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15u) == 0 &&
      (reinterpret_cast<uintptr_t>(alive) & 3u) == 0) {
    nv = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const unsigned* a4 = reinterpret_cast<const unsigned*>(alive);
    for (int v = first; v < nv; v += stride) {
      const unsigned a = a4[v];  // four bools, entry j in byte j
      if (!a) continue;
      const float4 xv = x4[v];
      if (a & 0xffu) f(__float_as_uint(xv.x));
      if (a & 0xff00u) f(__float_as_uint(xv.y));
      if (a & 0xff0000u) f(__float_as_uint(xv.z));
      if (a & 0xff000000u) f(__float_as_uint(xv.w));
    }
  }
  for (int i = 4 * nv + first; i < n; i += stride)
    if (alive[i]) f(__float_as_uint(x[i]));
}

// One counting pass: the block's histogram of digit(bits) over its alive
// entries (a negative digit is not counted) in shared memory, its nonzero
// bins then added into the global histogram `hist` of nb bins.
template <class Digit>
__device__ void count_pass(const float* x, const unsigned char* alive,
                           int n, int nb, Digit digit, unsigned* sh,
                           unsigned* hist) {
  for (int b = threadIdx.x; b < nb; b += blockDim.x) sh[b] = 0u;
  __syncthreads();
  for_alive(x, alive, n, [&](unsigned bits) {
    const int d = digit(bits);
    if (d >= 0) atomicAdd(&sh[d], 1u);
  });
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    if (sh[b]) atomicAdd(&hist[b], sh[b]);
}

__device__ __forceinline__ unsigned warp_inclusive_sum(unsigned v) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned u = (unsigned)__shfl_sync(0xffffffffu, (int)v,
                                             lane >= d ? lane - d : lane);
    if (lane >= d) v += u;
  }
  return v;
}

struct Rank {
  unsigned bin;    // the bin that holds the rank (nb when none does)
  unsigned below;  // the count in the bins below it
  unsigned rank;   // the rank asked for
};

// The bin of the global histogram `hist` (nb bins, a multiple of
// blockDim.x) that holds rank rank_of(total), 0-based over the counts in
// bin order, to every thread of the block. Each thread sums its nb /
// blockDim.x consecutive bins; a block-wide exclusive scan of the sums
// finds the thread whose bins hold the rank, and that thread the bin.
template <class RankOf>
__device__ Rank find_rank(const unsigned* hist, int nb, RankOf rank_of,
                          unsigned* sh) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int nw = blockDim.x >> 5, per = nb / blockDim.x;
  const unsigned* mine = hist + t * per;
  unsigned s = 0;
  for (int j = 0; j < per; ++j) s += __ldcg(mine + j);
  const unsigned inc = warp_inclusive_sum(s);
  if (lane == 31) sh[w] = inc;
  if (t == 0) sh[kSlotBin] = nb;
  __syncthreads();
  if (w == 0) {
    const unsigned v = warp_inclusive_sum(lane < nw ? sh[lane] : 0u);
    if (lane < nw) sh[lane] = v;
  }
  __syncthreads();
  const unsigned r = rank_of(sh[nw - 1]);
  unsigned c = (w ? sh[w - 1] : 0u) + inc - s;
  if (r >= c && r - c < s) {
    for (int j = 0; j < per; ++j) {
      const unsigned h = __ldcg(mine + j);
      if (r - c < h) {
        sh[kSlotBin] = t * per + j;
        sh[kSlotBelow] = c;
        break;
      }
      c += h;
    }
  }
  __syncthreads();
  const Rank out{sh[kSlotBin], sh[kSlotBelow], r};
  __syncthreads();  // sh is written again by the next scan
  return out;
}

__global__ void __launch_bounds__(kMaxThreads) masked_quantile_kernel(
    const float* __restrict__ x, const unsigned char* __restrict__ alive,
    int n, float q, float* out, unsigned* scratch) {
  __shared__ unsigned sh_hist[kBins1];
  __shared__ unsigned sh_scan[kScanWords];
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x;
  unsigned* h1 = scratch + kH1;
  unsigned* h2 = scratch + kH2;
  unsigned* h3 = scratch + kH3;

  for (int i = blockIdx.x * blockDim.x + t; i < kScratchWords;
       i += gridDim.x * blockDim.x)
    scratch[i] = i == kMinAbove ? kNone : 0u;
  grid.sync();

  // pass 1: the top 11 bits; the alive count m is its histogram's total
  count_pass(x, alive, n, kBins1,
             [](unsigned b) { return (int)(key_of(b) >> 21); }, sh_hist, h1);
  grid.sync();
  long long k = 0;
  float frac = 0.0f;
  const Rank r1 = find_rank(h1, kBins1, [&](unsigned m) {
    // the rounding of masked_quantile_bisect_plain: h = float32(m - 1) * q
    const float h = __fmul_rn((float)((long long)m - 1), q);
    k = (long long)floorf(h);
    if (k < 0) k = 0;
    frac = __fsub_rn(h, (float)k);
    return k < (long long)m ? (unsigned)k : m;  // m: no bin, +inf
  }, sh_scan);
  if (r1.bin == (unsigned)kBins1) {  // k >= m (every block alike)
    if (blockIdx.x == 0 && t == 0) *out = __uint_as_float(0x7f800000u);
    return;
  }

  // pass 2: bits 20..10 of the keys in bin r1.bin
  const unsigned p1 = r1.bin;
  count_pass(x, alive, n, kBins2, [&](unsigned b) {
    const unsigned c = key_of(b);
    return (c >> 21) == p1 ? (int)((c >> 10) & 0x7ffu) : -1;
  }, sh_hist, h2);
  grid.sync();
  const Rank r2 = find_rank(
      h2, kBins2, [&](unsigned) { return r1.rank - r1.below; }, sh_scan);

  // pass 3: bits 9..0 of the keys of the 22-bit prefix, and the least
  // non-NaN key above the prefix
  const unsigned p2 = (p1 << 11) | r2.bin;
  unsigned least = kNone;
  if (t == 0) sh_scan[kSlotMin] = kNone;
  count_pass(x, alive, n, kBins3, [&](unsigned b) {
    const unsigned c = key_of(b);
    if ((c >> 10) == p2) return (int)(c & 0x3ffu);
    if ((c >> 10) > p2 && !is_nan(b)) least = min(least, c);
    return -1;
  }, sh_hist, h3);
  for (int d = 16; d; d >>= 1)
    least = min(least, (unsigned)__shfl_sync(0xffffffffu, (int)least,
                                             (t & 31) ^ d));
  if ((t & 31) == 0 && least != kNone) atomicMin(&sh_scan[kSlotMin], least);
  __syncthreads();
  if (t == 0 && sh_scan[kSlotMin] != kNone)
    atomicMin(&scratch[kMinAbove], sh_scan[kSlotMin]);
  grid.sync();
  if (blockIdx.x != 0) return;

  // block 0: xlo from the last histogram, then its neighbour
  const Rank r3 = find_rank(
      h3, kBins3, [&](unsigned) { return r2.rank - r2.below; }, sh_scan);
  const unsigned lo_key = (p2 << 10) | r3.bin;
  const unsigned long long count_le =
      (unsigned long long)r1.below + r2.below + r3.below +
      __ldcg(h3 + r3.bin);
  unsigned hi_key = lo_key;
  if (count_le < (unsigned long long)(k + 2)) {
    // no tie at rank k + 1: the next nonzero bin of the prefix (its
    // keys are finite), else the least key above the prefix
    if (t == 0) sh_scan[kSlotMin] = kNone;
    __syncthreads();
    const int per = kBins3 / blockDim.x;
    for (int j = t * per; j < (t + 1) * per; ++j)
      if ((unsigned)j > r3.bin && __ldcg(h3 + j)) {
        atomicMin(&sh_scan[kSlotMin], (unsigned)j);
        break;
      }
    __syncthreads();
    const unsigned next = sh_scan[kSlotMin];
    const unsigned above = __ldcg(scratch + kMinAbove);
    if (next != kNone)
      hi_key = (p2 << 10) | next;
    else if (above != kNone)
      hi_key = above;
  }
  if (t == 0) {
    const float xlo = unkey(lo_key), xhi = unkey(hi_key);
    const bool finite = (__float_as_uint(xlo) & 0x7f800000u) != 0x7f800000u;
    *out = finite ? __fadd_rn(xlo, __fmul_rn(frac, __fsub_rn(xhi, xlo)))
                  : xlo;
  }
}

}  // namespace

// The masked type-7 quantile of x[alive] (n entries; alive as bytes 0/1)
// into out[0], in one cooperative launch of `blocks` blocks of `threads`
// threads (a power of two, 32 to 1024; blocks at most the co-resident
// maximum, kt_masked_quantile_grid). scratch:
// kt_masked_quantile_scratch_words() uint32, any contents.
extern "C" int kt_masked_quantile(const float* x, const unsigned char* alive,
                                  int n, float q, float* out,
                                  unsigned* scratch, int blocks, int threads,
                                  void* stream) {
  if (n < 0 || n > (1 << 30) || blocks < 1 || threads < 32 ||
      threads > kMaxThreads || (threads & (threads - 1)))
    return (int)cudaErrorInvalidConfiguration;
  void* args[] = {(void*)&x,   (void*)&alive, (void*)&n,
                  (void*)&q,   (void*)&out,   (void*)&scratch};
  cudaError_t err = cudaLaunchCooperativeKernel(
      masked_quantile_kernel, dim3(blocks), dim3(threads), args, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The scratch that kt_masked_quantile takes, in uint32 words.
extern "C" int kt_masked_quantile_scratch_words() { return kScratchWords; }

// (blocks an SM, SMs) of the kernel's cooperative launch at `threads`
// threads a block.
extern "C" int kt_masked_quantile_grid(int threads, int* out) {
  int dev = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], masked_quantile_kernel, threads, 0);
  return (int)cudaGetLastError();
}

extern "C" const char* kt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
