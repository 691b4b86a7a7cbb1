// Runs the fused tempered sweep (#9) of kissabc_tpu_torch/csrc/
// tempered.cuh on the host emulation, for
// tests/test_torch_tempered_words.py. Included after a generated tempered
// unit (which includes tempered.cuh).
//
//   program shifts h w0 .. w5 [h w0 .. w5]...
//     prints per set the six shifts derive_shifts (shifts.cuh) gives, then
//     the six that derive_shifts_warp gives on lane 0 of a warp of 32,
//     then 1 if every lane got lane 0's;
//   program sweep IN OUT
//     reads IN (int32 h; float the 2K leaves of h walkers, half A's then
//     half B's, then lp A, ll A, lp B, ll B; int64 words[14], half A's
//     seven then half B's; float lam; float fconsts[8]; int32 stub,
//     sb_rows), runs one sweep as two launches of kt_fused_tempered_sweep
//     (half B against the updated half A) into OUT: the 2K leaves, then
//     lp A, ll A, lp B, ll B. Prints the error code.
#include <cstdlib>
#include <fstream>
#include <string>
#include <vector>

// every lane's derive_shifts_warp, six ints a lane
__global__ void warp_shifts_kernel(const long long* words, int h, int* out) {
  int r[6];
  derive_shifts_warp(words, h, r);
  for (int k = 0; k < 6; ++k) out[threadIdx.x * 6 + k] = r[k];
}

int main(int argc, char** argv) {
  std::string kind = argv[1];
  if (kind == "shifts") {
    for (int a = 2; a + 6 < argc; a += 7) {
      int h = std::atoi(argv[a]);
      long long w[6];
      for (int k = 0; k < 6; ++k) w[k] = std::atoll(argv[a + 1 + k]);
      int r[6], lanes[32 * 6];
      derive_shifts(w, h, r);
      kt_launch(warp_shifts_kernel, 1, 32, 0, (const long long*)w, h,
                (int*)lanes);
      int same = 1;
      for (int t = 1; t < 32; ++t)
        for (int k = 0; k < 6; ++k) same &= lanes[t * 6 + k] == lanes[k];
      std::printf("%d %d %d %d %d %d %d %d %d %d %d %d %d\n", r[0], r[1],
                  r[2], r[3], r[4], r[5], lanes[0], lanes[1], lanes[2],
                  lanes[3], lanes[4], lanes[5], same);
    }
    return 0;
  }
  const int K = KT_NPARAMS;
  std::ifstream f(argv[2], std::ios::binary);
  int h = 0;
  f.read(reinterpret_cast<char*>(&h), 4);
  std::vector<std::vector<float>> in(2 * K + 4, std::vector<float>(h));
  for (auto& v : in) f.read(reinterpret_cast<char*>(v.data()), 4 * h);
  long long words[14];
  float lam, fconsts[8];
  int stub, sb_rows;
  f.read(reinterpret_cast<char*>(words), sizeof words);
  f.read(reinterpret_cast<char*>(&lam), 4);
  f.read(reinterpret_cast<char*>(fconsts), sizeof fconsts);
  f.read(reinterpret_cast<char*>(&stub), 4);
  f.read(reinterpret_cast<char*>(&sb_rows), 4);
  if (!f) {
    std::fprintf(stderr, "short input file %s\n", argv[2]);
    return 2;
  }
  std::vector<std::vector<float>> two(2 * K + 4,
                                      std::vector<float>(h, -7.0f));
  auto ptrs = [&](std::vector<std::vector<float>>& v, int first, int count) {
    std::vector<float*> p(count);
    for (int k = 0; k < count; ++k) p[k] = v[first + k].data();
    return p;
  };
  auto cptrs = [&](std::vector<std::vector<float>>& v, int first,
                   int count) {
    std::vector<const float*> p(count);
    for (int k = 0; k < count; ++k) p[k] = v[first + k].data();
    return p;
  };
  // two launches: half A against half B, then half B against A's outputs
  auto ta = cptrs(in, 0, K), tb = cptrs(in, K, K);
  auto oa = ptrs(two, 0, K), ob = ptrs(two, K, K);
  std::vector<const float*> oa_in(oa.begin(), oa.end());
  int err_two = kt_fused_tempered_sweep(
      ta.data(), in[2 * K].data(), in[2 * K + 1].data(), tb.data(), words,
      &lam, oa.data(), two[2 * K].data(), two[2 * K + 1].data(), h, fconsts,
      stub, sb_rows, nullptr);
  if (!err_two)
    err_two = kt_fused_tempered_sweep(
        tb.data(), in[2 * K + 2].data(), in[2 * K + 3].data(), oa_in.data(),
        words + 7, &lam, ob.data(), two[2 * K + 2].data(),
        two[2 * K + 3].data(), h, fconsts, stub, sb_rows, nullptr);
  std::ofstream o(argv[3], std::ios::binary);
  for (auto& x : two) o.write(reinterpret_cast<const char*>(x.data()), 4 * h);
  std::printf("%d\n", err_two);
  return 0;
}
