// Runs the ABC-DE generation (units with KT_HAS_ABCDE), one AIS
// half-update (KT_HAS_AIS) or the streaming moment cost (a unit with
// neither) of generic.cuh on the host emulation, on inputs from a fixed
// LCG, once per geometry given on the command line:
//   program n ndraws chunk stub [walkers threads lanes]...
// and prints per geometry one line: walkers threads lanes, the error
// code, an FNV-1a hash of every output's bits, and the walkers that
// committed (the cost: the output values written, past n too). With
// KT_DUMP set, the AIS half-update also writes to that path its inputs
// (theta leaves, lp, ll of all n walkers, float32) and the first
// geometry's outputs (theta leaves, lp, ll of the first half).
#include <cstdlib>
#include <fstream>
#include <string>

static uint32_t kt_lcg = 12345u;
static float urand(float lo, float hi) {
  kt_lcg = kt_lcg * 1664525u + 1013904223u;
  return lo + (hi - lo) * ((kt_lcg >> 8) * (1.0f / 16777216.0f));
}

int main(int argc, char** argv) {
  int n = std::atoi(argv[1]), ndraws = std::atoi(argv[2]);
  int chunk = std::atoi(argv[3]), stub = std::atoi(argv[4]);
  const int K = KT_NPARAMS;
  std::vector<std::vector<float>> th(K, std::vector<float>(n));
  std::vector<std::vector<float>> bases(3 * K, std::vector<float>(n));
  for (int k = 0; k < K; ++k)
    for (int w = 0; w < n; ++w)
      th[k][w] = k == 0 ? urand(1.5f, 2.5f) : urand(0.01f, 0.1f);
  for (int b = 0; b < 3 * K; ++b)
    for (int w = 0; w < n; ++w) bases[b][w] = th[b % K][(w * 7 + b * 13) % n];
  std::vector<float> lps(n), ds(n), active(n), eps_i(n), ll(n);
  for (int w = 0; w < n; ++w) {
    lps[w] = w % 13 == 0 ? -INFINITY : urand(-3.0f, 0.0f);
    ds[w] = urand(0.0f, 3.0f);
    active[w] = urand(0.0f, 1.0f) < 0.6f ? 1.0f : 0.0f;
    eps_i[w] = ds[w] <= 0.3f ? 0.3f : 0.8f;
    ll[w] = urand(-20.0f, -1.0f);
  }
  long long seed = 2024;
  std::vector<const float*> thp(K), bp(3 * K);
  for (int k = 0; k < K; ++k) thp[k] = th[k].data();
  for (int b = 0; b < 3 * K; ++b) bp[b] = bases[b].data();
  float inv_n = 1.0f / ndraws;
  for (int i = 5; i + 2 < argc; i += 3) {
    int walkers = std::atoi(argv[i]), threads = std::atoi(argv[i + 1]);
    int lanes = std::atoi(argv[i + 2]);
#if defined(KT_HAS_ABCDE) && KT_HAS_ABCDE
    int m = n;
    std::vector<std::vector<float>> outs(K + 3, std::vector<float>(m, -7.0f));
    std::vector<float*> op(K);
    for (int k = 0; k < K; ++k) op[k] = outs[k].data();
    int err = kt_fused_abcde_generation(
        thp.data(), bp.data(), lps.data(), ds.data(), active.data(),
        eps_i.data(), &seed, op.data(), outs[K].data(), outs[K + 1].data(),
        outs[K + 2].data(), n, ndraws, inv_n, 1.19f, 0, stub, 1024, chunk,
        walkers, threads, lanes, nullptr);
    std::vector<float>& ref = ds;   // a walker commits where its ds moves
    std::vector<float>& got = outs[K + 1];
#elif defined(KT_HAS_AIS) && KT_HAS_AIS
    int m = n / 2;
    std::vector<std::vector<float>> outs(K + 2, std::vector<float>(m, -7.0f));
    std::vector<float*> op(K);
    std::vector<const float*> comp(K);
    for (int k = 0; k < K; ++k) {
      op[k] = outs[k].data();
      comp[k] = th[k].data() + m;
    }
    // six shift words, then the seed
    long long words[7] = {5, 77, 100, 3, 40, 65, seed};
    float fc[10] = {inv_n,     0.57735026f, 1.1547005f, 1.19f,
                    1.0f / 300, 1.0f / 3,   4.0f / 7,   6.0f / 7,
                    2.0f,      2.0f * (K - 1)};
    std::vector<float> lp0(lps);
    for (float& x : lp0)
      if (x == -INFINITY) x = -1.0f;
    int err = kt_fused_ais_sweep(thp.data(), lp0.data(), ll.data(),
                                 comp.data(), words, op.data(),
                                 outs[K].data(), outs[K + 1].data(), m,
                                 ndraws, fc, stub, 1024, chunk, walkers,
                                 threads, lanes, nullptr);
    std::vector<float>& ref = ll;
    std::vector<float>& got = outs[K + 1];
    const char* dump = std::getenv("KT_DUMP");
    if (dump && i == 5) {
      std::ofstream f(dump, std::ios::binary);
      for (int k = 0; k < K; ++k)
        f.write(reinterpret_cast<const char*>(th[k].data()), 4 * n);
      f.write(reinterpret_cast<const char*>(lp0.data()), 4 * n);
      f.write(reinterpret_cast<const char*>(ll.data()), 4 * n);
      for (auto& v : outs)
        f.write(reinterpret_cast<const char*>(v.data()), 4 * m);
    }
#else
    // the moments of every walker into rows of n + 5 (ld), the tail a
    // sentinel that must stay
    int m = n, ld = n + 5;
    std::vector<std::vector<float>> outs(1, std::vector<float>(
                                                KT_NSTATS * ld, -7.0f));
    int err = kt_streaming_moment_cost(thp.data(), &seed, outs[0].data(),
                                       ld, n, ndraws, inv_n, stub, 1024,
                                       chunk, walkers, threads, lanes,
                                       nullptr);
    std::vector<float> ref(outs[0].size(), -7.0f);
    std::vector<float>& got = outs[0];
    m = (int)got.size();
#endif
    unsigned long long h = 1469598103934665603ull;
    for (auto& v : outs)
      for (float f : v) {
        h ^= __float_as_uint(f);
        h *= 1099511628211ull;
      }
    int moved = 0;
    for (int w = 0; w < m; ++w) moved += got[w] != ref[w];
    std::printf("%d %d %d %d %016llx %d\n", walkers, threads, lanes, err, h,
                moved);
  }
  return 0;
}
