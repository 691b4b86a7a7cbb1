// Per-walker layout shared by the generic kernels (generic.cuh) and the
// tempered sweep (tempered.cuh): the theta leaves of a population, the
// TPU kernels' stub coordinates of a walker, and the words and 4:2:1
// stretch / DE / walk mixture proposal of the ensemble half-updates, which
// the generic AIS sweep (make_fused_ais_sweep) and the tempered sweep
// (make_fused_tempered_sweep) make alike: the same words, the same stub
// counters (50000 + k) and the same partners comp[(i + r_j) % h]. Both
// take the half's seven raw words: six from which the kernel derives the
// shifts r_j (shifts.cuh) and the seed.
//
// The partners-given form (kParts): a shard of a walker mesh holds only
// its block of the other half, so its partners come as six arrays per
// leaf, the shard's blocks of the other half rolled by each shift
// (parallel/mesh.py partner_rolls), each read at the walker's own index
// i; the seed is still words[6] and the shifts are not derived. Without
// kParts the code is the snapshot form's, unchanged.
//
// Needs KT_NPARAMS (theta leaves K) defined before it is included.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "shifts.cuh"

namespace {

struct Leaves {
  const float* p[KT_NPARAMS];
};
struct OutLeaves {
  float* p[KT_NPARAMS];
};
// Leaf k's six partners (stretch, DE pair, walk triple) of the
// partners-given form.
struct PartLeaves {
  const float* p[KT_NPARAMS][6];
};

// Per-walker stub coordinates of the TPU kernels' walker-on-lane grid:
// program w / sb_rows, row (w % sb_rows) / 128, lane w % 128.
struct Coords {
  uint32_t pid, row, lane;
};

__device__ __forceinline__ Coords coords(int w, int sb_rows) {
  return {(uint32_t)(w / sb_rows), (uint32_t)((w % sb_rows) / 128),
          (uint32_t)(w % 128)};
}

// Words k of a walker (stub counter 50000 + k on the TPU kernel's
// (TR, 128) super-tile; Philox word k of counter (k / 4, i, stream, 0)):
// 0 move, 1 stretch z, 2 accept, then normal pair q from words 3 + 2q,
// 4 + 2q. The normals in order: the DE gamma, one jitter per leaf, the
// three walk weights.
constexpr int kMixPairs = (KT_NPARAMS + 4 + 1) / 2;
constexpr int kMixWords = 3 + 2 * kMixPairs;

struct MixConsts {
  float g_lo, g_span, de_scale, inv300, third, p_s_hi, p_d_hi,
      corr2;  // corr2 = 2 (d - 1)
};

// The mixture proposal of walker i of the updated half (leaves th) against
// the six partners comp[(i + r[j]) % h], or with kParts parts.p[k][j][i]:
// writes the raw proposal to prop, the stretch's log-Jacobian (0 for DE
// and walk) to corr and the accept uniform to u_acc. Every operation in
// the order of the TPU kernels (pallas_kernels.py:1677-1714).
template <bool kParts>
__device__ __forceinline__ void mixture_propose(
    Leaves th, Leaves comp, const PartLeaves& parts, const int* r, int i,
    int h, uint32_t seed, Coords cc, int stub, uint32_t stream,
    const MixConsts& c, float* prop, float* corr, float* u_acc) {
  uint32_t wd[kMixWords];
  if (stub) {
#pragma unroll
    for (int k = 0; k < kMixWords; ++k)
      wd[k] = stub_bits(cc.pid, seed, 50000u + (uint32_t)k, cc.row, cc.lane);
  } else {
#pragma unroll
    for (int g = 0; 4 * g < kMixWords; ++g) {
      Words4 q = philox4x32_10((uint32_t)g, (uint32_t)i, stream, 0u, seed);
      uint32_t v[4] = {q.x0, q.x1, q.x2, q.x3};
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (4 * g + t < kMixWords) wd[4 * g + t] = v[t];
    }
  }
  float nrm[2 * kMixPairs];
#pragma unroll
  for (int q = 0; q < kMixPairs; ++q)
    box_muller(wd[3 + 2 * q], wd[4 + 2 * q], &nrm[2 * q], &nrm[2 * q + 1]);
  float u_mid = to_unit(wd[0]), u_z = to_unit(wd[1]);
  *u_acc = to_unit(wd[2]);
  bool is_s = u_mid < c.p_s_hi;
  bool is_d = (u_mid >= c.p_s_hi) && (u_mid < c.p_d_hi);
  float zroot = u_z * c.g_span + c.g_lo;
  float z = zroot * zroot;
  *corr = is_s ? c.corr2 * logf(zroot) : 0.0f;
  float gamma = c.de_scale * expf(0.1f * nrm[0]);
  float r1 = nrm[1 + KT_NPARAMS], r2 = nrm[2 + KT_NPARAMS],
        r3 = nrm[3 + KT_NPARAMS];

  int idx[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    int k = i + (kParts ? 0 : r[j]);
    idx[j] = k >= h ? k - h : k;
  }
#pragma unroll
  for (int k = 0; k < KT_NPARAMS; ++k) {
    float xi = th.p[k][i];
    float pa, da, db, wa, wb, wc;
    if constexpr (kParts) {
      pa = parts.p[k][0][i], da = parts.p[k][1][i], db = parts.p[k][2][i];
      wa = parts.p[k][3][i], wb = parts.p[k][4][i], wc = parts.p[k][5][i];
    } else {
      const float* cp = comp.p[k];
      pa = cp[idx[0]], da = cp[idx[1]], db = cp[idx[2]];
      wa = cp[idx[3]], wb = cp[idx[4]], wc = cp[idx[5]];
    }
    float p_s = pa + z * (xi - pa);
    float tri = (fabsf(da - db) + fabsf(xi - db)) + fabsf(da - xi);
    float p_d = (xi + gamma * (da - db)) + ((gamma * tri) * c.inv300) *
                                               nrm[1 + k];
    float cen = ((wa + wb) + wc) * c.third;
    float p_w = xi + ((r1 * (wa - cen) + r2 * (wb - cen)) + r3 * (wc - cen));
    prop[k] = is_s ? p_s : (is_d ? p_d : p_w);
  }
}

}  // namespace
