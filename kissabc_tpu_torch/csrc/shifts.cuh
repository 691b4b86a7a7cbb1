// The partner shifts that the kernels derive from raw uint32 words (each
// carried in an int64), one copy for every kernel that takes words:
//   derive_shifts: the six shifts of an ensemble half-update, the rule of
//     _rot_shifts6 (pallas_kernels.py:1116-1135; ops/moves.py
//     _distinct_shifts), for #6 (generic.cuh), #7 and #8 (ais.cu) and #9
//     (tempered.cuh);
//   derive_rolls: the two rolls of the flagship smc sweep #2, the rule of
//     ops/moves.py roll_shifts (flagship.cu).
// A block derives them once, on thread 0 into shared memory (#2, #6, #7,
// #8), or each warp does, one modulo a lane (#9, derive_shifts_warp), so
// a sweep costs the host one draw of words and one launch, and nothing in
// between.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t word32(long long w) {
  return (uint32_t)(unsigned long long)w;
}

// The six rotation shifts of a half of h >= 3 walkers from six raw uint32
// words, distinct within each move: stretch r0; DE r1 != r2; walk r3, r4,
// r5 distinct. Draw j of a move is word % (h - j), bumped past each
// earlier draw of the move in ascending order (ops/moves.py
// _distinct_shifts).
__device__ void derive_shifts(const long long* words, int h, int* r) {
  uint32_t u = (uint32_t)h;
  r[0] = (int)(word32(words[0]) % u);
  int d1 = (int)(word32(words[1]) % u);
  int d2 = (int)(word32(words[2]) % (u - 1u));
  d2 += d2 >= d1;
  r[1] = d1;
  r[2] = d2;
  int a = (int)(word32(words[3]) % u);
  int b = (int)(word32(words[4]) % (u - 1u));
  b += b >= a;
  int c = (int)(word32(words[5]) % (u - 2u));
  c += c >= min(a, b);
  c += c >= max(a, b);
  r[3] = a;
  r[4] = b;
  r[5] = c;
}

// derive_shifts made by a whole warp, which every lane of it calls (none
// has exited): lane j < 6 takes draw j, word j modulo h, h - 1 or h - 2,
// and every lane gathers the six draws by shuffles and bumps them. One
// modulo a lane where derive_shifts makes six, and no block barrier: the
// kernels that take words one thread a walker (#9) pay for their shifts
// with ~30 instructions a thread, which overlap the walker's own words.
__device__ __forceinline__ void derive_shifts_warp(const long long* words,
                                                   int h, int* r) {
  int j = (int)(threadIdx.x & 31u);
  j = j < 6 ? j : 0;
  // the modulus of draw j: h for each move's first, then h - 1, h - 2
  uint32_t d = (uint32_t)h - (uint32_t)(j == 2 || j == 4) -
               2u * (uint32_t)(j == 5);
  int raw = (int)(word32(words[j]) % d);
  int v[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = __shfl_sync(0xffffffffu, raw, k);
  r[0] = v[0];
  int d1 = v[1], d2 = v[2];
  d2 += d2 >= d1;
  r[1] = d1;
  r[2] = d2;
  int a = v[3], b = v[4];
  b += b >= a;
  int c = v[5];
  c += c >= min(a, b);
  c += c >= max(a, b);
  r[3] = a;
  r[4] = b;
  r[5] = c;
}

// roll_shifts' two distinct rotation shifts in [1, n) for n >= 3.
__device__ __forceinline__ void derive_rolls(const long long* words, int n,
                                             int* r) {
  int r1 = (int)(word32(words[0]) % (uint32_t)(n - 1)) + 1;
  int r2 = (int)(word32(words[1]) % (uint32_t)(n - 2)) + 1;
  r[0] = r1;
  r[1] = r2 + (r2 >= r1);
}

}  // namespace
