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
// lam can change between sweeps; lam, the six shifts and the seed are
// read from device memory, so one compiled kernel serves the whole
// temperature ladder without a host read. A walker moves about
// (2K + 4) * 4 bytes (its partners are re-reads of the other half)
// against a few hundred operations. Walkers i >= h are masked: nothing is
// padded and nothing past h is written.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walkers.cuh"

namespace {

constexpr int kThreads = 128;
constexpr uint32_t kStreamTemperedWalker = 10u;

__global__ void fused_tempered_sweep_kernel(
    Leaves th, const float* __restrict__ lp, const float* __restrict__ ll,
    Leaves comp, const long long* __restrict__ shifts,
    const long long* __restrict__ seed_ptr, const float* __restrict__ lam_ptr,
    OutLeaves oth, float* __restrict__ olp, float* __restrict__ oll, int h,
    MixConsts c, int stub, int sb_rows) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h) return;
  uint32_t seed = (uint32_t)(unsigned long long)seed_ptr[0];
  Coords cc = coords(i, sb_rows);
  float prop[KT_NPARAMS], corr, u_acc;
  mixture_propose(th, comp, shifts, i, h, seed, cc, stub,
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

// fconsts: g_lo, g_span, de_scale, inv300, third, p_s_hi, p_d_hi, corr2
extern "C" int kt_fused_tempered_sweep(
    const float* const* th, const float* lp, const float* ll,
    const float* const* comp, const long long* shifts, const long long* seed,
    const float* lam, float* const* oth, float* olp, float* oll, int h,
    const float* fconsts, int stub, int sb_rows, void* stream) {
  Leaves leaves, partners;
  OutLeaves outs;
  for (int k = 0; k < KT_NPARAMS; ++k) {
    leaves.p[k] = th[k];
    partners.p[k] = comp[k];
    outs.p[k] = oth[k];
  }
  const float* f = fconsts;
  MixConsts c = {f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7]};
  if (h > 0) {
    fused_tempered_sweep_kernel<<<grid_for(h), kThreads, 0,
                                  (cudaStream_t)stream>>>(
        leaves, lp, ll, partners, shifts, seed, lam, outs, olp, oll, h, c,
        stub, sb_rows);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
