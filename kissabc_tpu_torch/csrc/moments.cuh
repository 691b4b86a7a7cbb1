// The flagship simulator's moment sums and summary cost, shared by the
// flagship kernels (flagship.cu) and the flagship AIS sweeps (ais.cu):
// ndraws N(0,1) draws per walker on the stub stream at the TPU kernels'
// (program, counter, sublane, lane) coordinates or on Philox, their sums
// and sums of squares (centred on Philox), and the README model's cost
// from them. Each has a plain PyTorch twin in
// kissabc_tpu_torch/ops/kernels.py; on Philox the kernels are the more
// accurate side (tests/test_torch_moments.py).

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
// centred moment sums: m1 += (z0 + z1) + (z2 + z3) and m2c += the sum of
// (z_k^2 - 1), each square added by a fused multiply-add inside the group
// (from -4) and the group's sum added once; with kGuard only the first
// `left` draws (from -left). Every rounding is written out, so no
// contraction choice of the compiler changes the bits.
template <bool kGuard>
__device__ __forceinline__ void add_group(Words4 b, int left, float* m1,
                                          float* m2c) {
  float z[4];
  box_muller(b.x0, b.x1, &z[0], &z[1]);
  box_muller(b.x2, b.x3, &z[2], &z[3]);
  if (!kGuard) {
    float t = __fmaf_rn(z[0], z[0], -4.0f);
    t = __fmaf_rn(z[1], z[1], t);
    t = __fmaf_rn(z[2], z[2], t);
    t = __fmaf_rn(z[3], z[3], t);
    *m1 = __fadd_rn(*m1, __fadd_rn(__fadd_rn(z[0], z[1]),
                                   __fadd_rn(z[2], z[3])));
    *m2c = __fadd_rn(*m2c, t);
    return;
  }
  float t = -(float)left, u = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k < left) {
      t = __fmaf_rn(z[k], z[k], t);
      u = __fadd_rn(u, z[k]);
    }
  }
  *m1 = __fadd_rn(*m1, u);
  *m2c = __fadd_rn(*m2c, t);
}

// Centred z-moment sums of ndraws N(0,1) draws from Philox: *s1 = sum z,
// *s2c = sum (z^2 - 1). Group q gives draws 4q .. 4q+3 (two Box-Muller
// pairs from one Philox call). The round keys are made once; the whole
// groups run without a guard, the ragged last group (ndraws % 4 draws)
// after them.
//
// Why centred: the README cost's d2 = sg * sd - target_sd cancels near
// the target (to ~1e-3 of target_sd at the end of every smc or AIS run),
// so an error in sum z^2 is magnified ~1000 times in the cost. A float32
// sum of 1000 squares one after another (~1000 at the end) was 6.4e-7
// off, 4.0e-4 of a walker's ll (ROADMAP C2). Centred, the running sum
// stays near sqrt(2 ndraws) and takes one add a group: 5 instructions a
// group for s2c where the plain sum took 4.
__device__ void moments_philox(uint32_t seed, uint32_t stream,
                               uint32_t walker, int ndraws, float* s1,
                               float* s2c) {
  PhiloxKey key = philox_key(seed);
  float m1 = 0.0f, m2c = 0.0f;
  int whole = ndraws / 4;
  for (int q = 0; q < whole; ++q)
    add_group<false>(philox4x32_10((uint32_t)q, walker, stream, 0u, key), 4,
                     &m1, &m2c);
  if (ndraws % 4)
    add_group<true>(philox4x32_10((uint32_t)whole, walker, stream, 0u, key),
                    ndraws % 4, &m1, &m2c);
  *s1 = m1;
  *s2c = m2c;
}

// hypot(mu + sigma*mean_z - target_mu, (sigma*sd_z - target_sd) * w)
// from the stub stream's sums (moments_stub), inv_n = float32(1/n).
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

// The same cost from the centred Philox sums (moments_philox), without
// the cancellations: var_z - 1 = s2c/n - mean_z^2 and sd_z - 1 =
// (var_z - 1) / (1 + sd_z) carry the bits that rounding var_z and sd_z
// near 1 would drop, d2 is ((sigma - target_sd) + sigma (sd_z - 1)) w
// with the product unrounded before the add (sigma - target_sd is exact
// for sigma within a factor 2 of the target), and d1 is (mu - target_mu)
// + sigma mean_z with one rounding. The means are divisions by n, not
// products with a rounded 1/n.
__device__ __forceinline__ float centred_cost(float mu, float sg, float s1,
                                              float s2c, int ndraws,
                                              float tmu, float tsd,
                                              float sdw) {
  float nd = (float)ndraws;
  float mz = s1 / nd;
  float vm1 = __fmaf_rn(-mz, mz, s2c / nd);
  float sdm1 = fmaxf(vm1 / (1.0f + sqrtf(fmaxf(1.0f + vm1, 0.0f))), -1.0f);
  float d1 = __fmaf_rn(sg, mz, mu - tmu);
  float d2 = __fmul_rn(__fmaf_rn(sg, sdm1, sg - tsd), sdw);
  return sqrtf(__fmaf_rn(d1, d1, __fmul_rn(d2, d2)));
}

}  // namespace
