// Runs the flagship kernels' device code of kissabc_tpu_torch/csrc/
// flagship.cu (with moments.cuh) on the host emulation, for
// tests/test_torch_fused_sweep_compaction.py and tests/test_torch_moments.py.
// Built with KT_EMU_FUSED_FMA, so __fmaf_rn rounds once, as on the card.
//
//   program rolls n w0 w1 [n w0 w1]...
//     prints per set the two shifts derive_rolls gives;
//   program sweep IN OUT [walkers threads]...
//     reads IN (int32 n; float mu[n], sg[n], xs[n], lps[n]; float eps;
//     int64 words[3]; float fconsts[11]; int32 iconsts[4]), runs one
//     thread per walker (the device functions called walker by walker)
//     into OUT.ref, then kt_fused_sweep once per geometry into OUT.<k>,
//     and prints per geometry one line: walkers threads, the error code.
//     Each output file holds omu, osg, oxs, olps (float[n] each) and the
//     commit mask (uint8[n]);
//   program moments IN OUT
//     reads IN (uint32 seed, stream; int32 ndraws, m; then m records of
//     uint32 walker, float mu, sg, tmu, tsd, sdw) and writes OUT, per
//     walker: float s1, s2c (moments_philox), cost (centred_cost), and
//     double s1, s2 and cost over the same float32 draws.
#include <fstream>
#include <string>

#include "flagship.cu"

namespace {

struct SweepInputs {
  int n = 0;
  std::vector<float> mu, sg, xs, lps;
  float eps = 0.0f;
  long long words[3];
  float fconsts[kSweepNumF];
  int iconsts[kSweepNumI];
};

SweepInputs read_sweep(const char* path) {
  std::ifstream f(path, std::ios::binary);
  SweepInputs in;
  f.read(reinterpret_cast<char*>(&in.n), 4);
  for (auto* v : {&in.mu, &in.sg, &in.xs, &in.lps}) {
    v->resize(in.n);
    f.read(reinterpret_cast<char*>(v->data()), 4 * in.n);
  }
  f.read(reinterpret_cast<char*>(&in.eps), 4);
  f.read(reinterpret_cast<char*>(in.words), sizeof in.words);
  f.read(reinterpret_cast<char*>(in.fconsts), sizeof in.fconsts);
  f.read(reinterpret_cast<char*>(in.iconsts), sizeof in.iconsts);
  if (!f) {
    std::fprintf(stderr, "short input file %s\n", path);
    std::exit(2);
  }
  return in;
}

struct SweepOutputs {
  std::vector<float> f[4];
  std::vector<unsigned char> commit;
  explicit SweepOutputs(int n) : commit(n, 7) {
    for (auto& v : f) v.assign(n, -7.0f);
  }
  void write(const std::string& path) const {
    std::ofstream o(path, std::ios::binary);
    for (auto& v : f)
      o.write(reinterpret_cast<const char*>(v.data()), 4 * v.size());
    o.write(reinterpret_cast<const char*>(commit.data()), commit.size());
  }
};

SweepConsts consts_of(const SweepInputs& in) {
  const float* f = in.fconsts;
  const int* i = in.iconsts;
  return SweepConsts{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7],
                     f[8], f[9], f[10], i[0], i[1], i[2], i[3]};
}

// One thread per walker: phase 1 and, for a gate-1 walker, phase 2.
template <bool kStub>
void reference_sweep(const SweepArgs& a, const SweepConsts& c) {
  int r[2];
  derive_rolls(a.words, a.n, r);
  uint32_t seed = word32(a.words[2]);
  for (int w = 0; w < a.n; ++w) {
    SweepProposal q;
    if (sweep_propose<kStub>(w, r[0], r[1], seed, a, c, &q))
      sweep_accept<kStub>(w, q, seed, a.eps, a, c);
  }
}

int run_sweep(int argc, char** argv) {
  SweepInputs in = read_sweep(argv[2]);
  std::string out = argv[3];
  SweepConsts c = consts_of(in);
  SweepOutputs ref(in.n);
  SweepArgs a{in.mu.data(),  in.sg.data(),  in.xs.data(),     in.lps.data(),
              nullptr,       in.eps,        in.words,         ref.f[0].data(),
              ref.f[1].data(), ref.f[2].data(), ref.f[3].data(),
              ref.commit.data(), in.n};
  if (in.n >= 3 && c.stub)  // the rolls need n >= 3
    reference_sweep<true>(a, c);
  else if (in.n >= 3)
    reference_sweep<false>(a, c);
  ref.write(out + ".ref");
  for (int k = 4, g = 0; k + 1 < argc; k += 2, ++g) {
    int walkers = std::atoi(argv[k]), threads = std::atoi(argv[k + 1]);
    SweepOutputs o(in.n);
    // the even geometries read eps from memory, the odd ones take it as
    // an argument
    const float* eps_ptr = (g % 2 == 0) ? &in.eps : nullptr;
    int err = kt_fused_sweep(in.mu.data(), in.sg.data(), in.xs.data(),
                             in.lps.data(), eps_ptr, in.eps, in.words,
                             o.f[0].data(), o.f[1].data(), o.f[2].data(),
                             o.f[3].data(), o.commit.data(), in.n, in.fconsts,
                             in.iconsts, walkers, threads, nullptr);
    o.write(out + "." + std::to_string(g));
    std::printf("%d %d %d\n", walkers, threads, err);
  }
  return 0;
}

int run_moments(char** argv) {
  std::ifstream f(argv[2], std::ios::binary);
  uint32_t seed, stream;
  int ndraws, m;
  f.read(reinterpret_cast<char*>(&seed), 4);
  f.read(reinterpret_cast<char*>(&stream), 4);
  f.read(reinterpret_cast<char*>(&ndraws), 4);
  f.read(reinterpret_cast<char*>(&m), 4);
  std::ofstream o(argv[3], std::ios::binary);
  for (int r = 0; r < m; ++r) {
    uint32_t walker;
    float mu, sg, tmu, tsd, sdw;
    f.read(reinterpret_cast<char*>(&walker), 4);
    for (float* v : {&mu, &sg, &tmu, &tsd, &sdw})
      f.read(reinterpret_cast<char*>(v), 4);
    if (!f) {
      std::fprintf(stderr, "short input file %s\n", argv[2]);
      return 2;
    }
    float s1, s2c;
    moments_philox(seed, stream, walker, ndraws, &s1, &s2c);
    float cost = centred_cost(mu, sg, s1, s2c, ndraws, tmu, tsd, sdw);
    // the same float32 draws, summed in double
    PhiloxKey key = philox_key(seed);
    double d1 = 0.0, d2 = 0.0;
    for (int q = 0; 4 * q < ndraws; ++q) {
      Words4 b = philox4x32_10((uint32_t)q, walker, stream, 0u, key);
      float z[4];
      box_muller(b.x0, b.x1, &z[0], &z[1]);
      box_muller(b.x2, b.x3, &z[2], &z[3]);
      for (int k = 0; k < 4 && 4 * q + k < ndraws; ++k) {
        d1 += z[k];
        d2 += (double)z[k] * (double)z[k];
      }
    }
    double mz = d1 / ndraws, vz = std::max(d2 / ndraws - mz * mz, 0.0);
    double cost64 = std::hypot((double)mu + (double)sg * mz - (double)tmu,
                               ((double)sg * std::sqrt(vz) - (double)tsd) *
                                   (double)sdw);
    float fo[3] = {s1, s2c, cost};
    double dout[3] = {d1, d2, cost64};
    o.write(reinterpret_cast<const char*>(fo), sizeof fo);
    o.write(reinterpret_cast<const char*>(dout), sizeof dout);
  }
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  std::string kind = argv[1];
  if (kind == "rolls") {
    for (int a = 2; a + 2 < argc; a += 3) {
      int n = std::atoi(argv[a]);
      long long w[2] = {std::atoll(argv[a + 1]), std::atoll(argv[a + 2])};
      int r[2];
      derive_rolls(w, n, r);
      std::printf("%d %d\n", r[0], r[1]);
    }
    return 0;
  }
  if (kind == "moments") return run_moments(argv);
  return run_sweep(argc, argv);
}
