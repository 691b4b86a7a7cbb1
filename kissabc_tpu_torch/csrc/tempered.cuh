// Hand-written CUDA kernel for Hopper (sm_90a): the fused tempered sweep
// of tsmc. It replaces the Pallas TPU kernel
//   kt_fused_tempered_sweep <- make_fused_tempered_sweep half_call
//                              (pallas_call :1748, kissabc_tpu/ops/
//                              pallas_kernels.py)
//
// This file is a template. kissabc_tpu_torch/ops/codegen.py traces the
// user's log-likelihood and writes a translation unit that defines
//   KT_NPARAMS (theta leaves K)
//   float loglike(const float* th)               deterministic, pushed theta
//   float prior_logpdf(const float* th)
//   void  prior_push(const float* th, float* out)
// and then includes this file; ops/_build.py compiles it with nvcc.
//
// Design. One thread per walker of the updated half: the words and the
// 4:2:1 mixture proposal of the generic AIS sweep (mixture_propose,
// walkers.cuh; the same stub counters 50000 + k), the push, the prior's
// logpdf and the user's log-likelihood of the pushed value, then the
// tempered MH accept at the temperature lam,
//   lw = (corr + (valid ? lpp + lam * llp : -inf)) - (lp + lam * ll),
// in the order of the TPU kernel (pallas_kernels.py:1726-1737). The raw
// float proposal is committed with the raw (unscaled) lpp and llp, so
// lam can change between sweeps; lam is read from device memory, so one
// compiled kernel serves the whole temperature ladder without a host
// read. A walker moves about (2K + 4) * 4 bytes (its partners are
// re-reads of the other half) against a few hundred operations. Walkers
// i >= h are masked: nothing is padded and nothing past h is written.
//
// What bounds it on the H100: nothing in the kernel. A half-update of
// 65536 walkers takes ~0.003 ms, near the launch floor, against 0.0006 ms
// for its bytes; what a sweep cost was the host's glue around it. The
// kernel takes the half's seven raw words (the wrapper's one draw): six
// from which each warp derives the six partner shifts by _rot_shifts6's
// rule, one modulo a lane (derive_shifts_warp, shifts.cuh; faster on the
// H100 than thread 0 and a block barrier or six modulos a thread), and the
// seed. So a half-update is one word draw and one launch, where the shifts
// made on the host's stream cost ~35 small device operations. A sweep is
// two launches: both halves in one cooperative launch with a grid barrier
// was slower on the card at 131072 walkers (PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "walkers.cuh"

namespace {

constexpr int kThreads = 128;
constexpr uint32_t kStreamTemperedWalker = 10u;

// kParts: the partners-given form of a shard of a mesh (walkers.cuh).
template <bool kParts>
__global__ void __launch_bounds__(kThreads) fused_tempered_sweep_kernel(
    Leaves th, const float* __restrict__ lp, const float* __restrict__ ll,
    Leaves comp, const long long* __restrict__ words,
    const float* __restrict__ lam_ptr, OutLeaves oth,
    float* __restrict__ olp, float* __restrict__ oll, int h, MixConsts c,
    int stub, int sb_rows, PartLeaves parts) {
  int r[6];
  if (!kParts) derive_shifts_warp(words, h, r);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h) return;
  uint32_t seed = word32(words[6]);
  Coords cc = coords(i, sb_rows);
  float prop[KT_NPARAMS], corr, u_acc;
  mixture_propose<kParts>(th, comp, parts, r, i, h, seed, cc, stub,
                          kStreamTemperedWalker, c, prop, &corr, &u_acc);
  float pushed[KT_NPARAMS];
  prior_push(prop, pushed);
  float lpp = prior_logpdf(pushed);
  float llp = loglike(pushed);
  const float neg_inf = __uint_as_float(0xff800000u);
  bool valid = lpp > neg_inf;
  float lam = lam_ptr[0];
  float lp0 = lp[i], ll0 = ll[i];
  // lam * llp is NaN at lam = 0 and llp = -inf: such a walker never
  // commits, as in the TPU kernel
  float nw = valid ? lpp + lam * llp : neg_inf;
  float lw = (corr + nw) - (lp0 + lam * ll0);
  bool acc = valid && (log1pf(-u_acc) <= lw);
#pragma unroll
  for (int k = 0; k < KT_NPARAMS; ++k)
    oth.p[k][i] = acc ? prop[k] : th.p[k][i];
  olp[i] = acc ? lpp : lp0;
  oll[i] = acc ? llp : ll0;
}

inline int grid_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// One half-update. words: the half's six shift words and the seed (int64
// holding uint32); fconsts: g_lo, g_span, de_scale, inv300, third,
// p_s_hi, p_d_hi, corr2. parts: null, or the 6 K partner leaves of a
// shard of a mesh, leaf-major, each read at the walker's own index (then
// only words[6] is read, and comp is not).
extern "C" int kt_fused_tempered_sweep_parts(
    const float* const* th, const float* lp, const float* ll,
    const float* const* comp, const long long* words, const float* lam,
    float* const* oth, float* olp, float* oll, int h, const float* fconsts,
    int stub, int sb_rows, void* stream, const float* const* parts) {
  if (h > 0 && h < 3 && !parts) return (int)cudaErrorInvalidConfiguration;
  Leaves lt, lc;
  OutLeaves lo;
  PartLeaves given = {};
  for (int k = 0; k < KT_NPARAMS; ++k) {
    lt.p[k] = th[k];
    lc.p[k] = comp[k];
    lo.p[k] = oth[k];
    for (int j = 0; j < 6; ++j) given.p[k][j] = parts ? parts[6 * k + j] : 0;
  }
  MixConsts c = {fconsts[0], fconsts[1], fconsts[2], fconsts[3],
                 fconsts[4], fconsts[5], fconsts[6], fconsts[7]};
  if (h > 0) {
    auto kernel = parts ? &fused_tempered_sweep_kernel<true>
                        : &fused_tempered_sweep_kernel<false>;
    kernel<<<grid_for(h), kThreads, 0, (cudaStream_t)stream>>>(
        lt, lp, ll, lc, words, lam, lo, olp, oll, h, c, stub, sb_rows, given);
  }
  return (int)cudaGetLastError();
}

// The snapshot form: kt_fused_tempered_sweep_parts without partners.
extern "C" int kt_fused_tempered_sweep(
    const float* const* th, const float* lp, const float* ll,
    const float* const* comp, const long long* words, const float* lam,
    float* const* oth, float* olp, float* oll, int h, const float* fconsts,
    int stub, int sb_rows, void* stream) {
  return kt_fused_tempered_sweep_parts(th, lp, ll, comp, words, lam, oth, olp,
                                       oll, h, fconsts, stub, sb_rows, stream,
                                       nullptr);
}

extern "C" const char* kt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
