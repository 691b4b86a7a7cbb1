// The flagship simulator's moment sums and summary cost, shared by the
// flagship kernels (flagship.cu) and the flagship AIS sweeps (ais.cu):
// ndraws N(0,1) draws per walker on the stub stream at the TPU kernels'
// (program, counter, sublane, lane) coordinates or on Philox, their sums
// and sums of squares, and the README model's cost from them. Each has a
// plain PyTorch twin in kissabc_tpu_torch/ops/kernels.py.

#pragma once

#include "common.cuh"

namespace {

// z-moment sums of ndraws N(0,1) draws from the stub stream, in the TPU
// kernels' order: draw chunk j holds draws [2j*chunk, (2j+1)*chunk) (cos
// half) and [(2j+1)*chunk, (2j+2)*chunk) (sin half) from the bit counters
// ctr0 + 2j and ctr0 + 2j + 1; each half's chunk sum is added to the
// running sums separately, as the TPU kernels do.
__device__ void moments_stub(uint32_t pid, uint32_t seed, uint32_t ctr0,
                             uint32_t sub, int ndraws, int chunk, float* s1,
                             float* s2) {
  int nchunks = (ndraws + 2 * chunk - 1) / (2 * chunk);
  float m1 = 0.0f, m2 = 0.0f;
  for (int j = 0; j < nchunks; ++j) {
    uint32_t ctr = ctr0 + 2u * (uint32_t)j;
    int start_a = 2 * j * chunk, start_b = (2 * j + 1) * chunk;
    float a1 = 0.0f, a2 = 0.0f, b1 = 0.0f, b2 = 0.0f;
    for (int l = 0; l < chunk && start_a + l < ndraws; ++l) {
      float za, zb;
      box_muller(stub_bits(pid, seed, ctr, sub, (uint32_t)l),
                 stub_bits(pid, seed, ctr + 1u, sub, (uint32_t)l), &za, &zb);
      a1 += za;
      a2 += za * za;
      if (start_b + l < ndraws) {
        b1 += zb;
        b2 += zb * zb;
      }
    }
    m1 += a1;
    m1 += b1;
    m2 += a2;
    m2 += b2;
  }
  *s1 = m1;
  *s2 = m2;
}

// The four draws of one Philox call (two Box-Muller pairs) added to the
// moment sums in order; with kGuard only the first `left` of them.
template <bool kGuard>
__device__ __forceinline__ void add_group(Words4 b, int left, float* m1,
                                          float* m2) {
  float z[4];
  box_muller(b.x0, b.x1, &z[0], &z[1]);
  box_muller(b.x2, b.x3, &z[2], &z[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!kGuard || k < left) {
      *m1 += z[k];
      *m2 += z[k] * z[k];
    }
  }
}

// z-moment sums of ndraws N(0,1) draws from Philox: group q gives draws
// 4q .. 4q+3 (two Box-Muller pairs from one Philox call). The round keys
// are made once; the whole groups run without a guard, the ragged last
// group (ndraws % 4 draws) after them.
__device__ void moments_philox(uint32_t seed, uint32_t stream,
                               uint32_t walker, int ndraws, float* s1,
                               float* s2) {
  PhiloxKey key = philox_key(seed);
  float m1 = 0.0f, m2 = 0.0f;
  int whole = ndraws / 4;
  for (int q = 0; q < whole; ++q)
    add_group<false>(philox4x32_10((uint32_t)q, walker, stream, 0u, key), 4,
                     &m1, &m2);
  if (ndraws % 4)
    add_group<true>(philox4x32_10((uint32_t)whole, walker, stream, 0u, key),
                    ndraws % 4, &m1, &m2);
  *s1 = m1;
  *s2 = m2;
}

// hypot(mu + sigma*mean_z - target_mu, (sigma*sd_z - target_sd) * w).
__device__ __forceinline__ float summary_cost(float mu, float sg, float s1,
                                              float s2, float inv_n,
                                              float tmu, float tsd,
                                              float sdw) {
  float mz = s1 * inv_n;
  float vz = s2 * inv_n - mz * mz;
  float d1 = (mu + sg * mz) - tmu;
  float d2 = (sg * sqrtf(fmaxf(vz, 0.0f)) - tsd) * sdw;
  return sqrtf(d1 * d1 + d2 * d2);
}

}  // namespace
