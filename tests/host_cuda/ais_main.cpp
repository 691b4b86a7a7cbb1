// Runs the flagship AIS sweeps of kissabc_tpu_torch/csrc/ais.cu (#7
// kt_fused_ais_half, #8 kt_fused_ais_full) on the host emulation, for
// tests/test_torch_ais_compaction.py.
//
//   program shifts h w0 .. w5 [h w0 .. w5]...
//     prints per set the six shifts derive_shifts gives;
//   program half|full IN OUT SMS [walkers threads]...
//     reads IN (int32 n; float mu[n], sg[n], lp[n], ll[n]; int64
//     words[13]; float fconsts[18]; int32 iconsts[4]), runs one thread per
//     walker (the device functions called walker by walker, on the shifts
//     derive_shifts gives) into OUT.ref, then the kernel once per geometry
//     on an emulated card of SMS SMs into OUT.<k>, and prints per geometry
//     one line: walkers threads, the error code. Each output file
//     holds the four outputs (mu, sg, lp, ll) of the updated walkers: the
//     first half for half, all n for full (half B against the updated
//     half A).
#include <fstream>
#include <string>

#include "ais.cu"

namespace {

struct Inputs {
  int n = 0;
  std::vector<float> mu, sg, lp, ll;
  long long words[13];
  float fconsts[kNumF];
  int iconsts[kNumI];
};

Inputs read_inputs(const char* path) {
  std::ifstream f(path, std::ios::binary);
  Inputs in;
  f.read(reinterpret_cast<char*>(&in.n), 4);
  for (auto* v : {&in.mu, &in.sg, &in.lp, &in.ll}) {
    v->resize(in.n);
    f.read(reinterpret_cast<char*>(v->data()), 4 * in.n);
  }
  f.read(reinterpret_cast<char*>(in.words), sizeof in.words);
  f.read(reinterpret_cast<char*>(in.fconsts), sizeof in.fconsts);
  f.read(reinterpret_cast<char*>(in.iconsts), sizeof in.iconsts);
  if (!f) {
    std::fprintf(stderr, "short input file %s\n", path);
    std::exit(2);
  }
  return in;
}

void write_outputs(const std::string& path,
                   const std::vector<std::vector<float>>& outs) {
  std::ofstream f(path, std::ios::binary);
  for (auto& v : outs)
    f.write(reinterpret_cast<const char*>(v.data()), 4 * v.size());
}

// One half-update, one walker after another: the outputs of one thread
// per walker.
template <bool kFresh, typename BitsOf>
void reference_half(int h, const float* mu, const float* sg, const float* lp,
                    const float* ll, const float* cmu, const float* csg,
                    const long long* words, BitsOf bits_of,
                    const AisConsts& c, float* omu, float* osg, float* olp,
                    float* oll) {
  int r[6];
  derive_shifts(words, h, r);
  for (int i = 0; i < h; ++i) {
    Proposal q;
    Bits b = bits_of(i);
    if (ais_propose<kFresh>(i, h, mu, sg, cmu, csg, r, b, c, &q)) {
      ais_accept(i, q, b, c, mu, sg, lp, ll, omu, osg, olp, oll);
    } else {
      omu[i] = mu[i];
      osg[i] = sg[i];
      olp[i] = lp[i];
      oll[i] = ll[i];
    }
  }
}

}  // namespace

int main(int argc, char** argv) {
  std::string kind = argv[1];
  if (kind == "shifts") {
    for (int a = 2; a + 6 < argc; a += 7) {
      int h = std::atoi(argv[a]);
      long long w[6];
      for (int k = 0; k < 6; ++k) w[k] = std::atoll(argv[a + 1 + k]);
      int r[6];
      derive_shifts(w, h, r);
      std::printf("%d %d %d %d %d %d\n", r[0], r[1], r[2], r[3], r[4], r[5]);
    }
    return 0;
  }
  Inputs in = read_inputs(argv[2]);
  std::string out = argv[3];
  kt_emu_sms = std::atoi(argv[4]);
  bool full = kind == "full";
  int h = in.n / 2, m = full ? in.n : h;
  AisConsts c = make_consts(in.fconsts, in.iconsts);
  auto fresh = [&] {
    return std::vector<std::vector<float>>(4, std::vector<float>(m, -7.0f));
  };
  const float *mu = in.mu.data(), *sg = in.sg.data(), *lp = in.lp.data(),
              *ll = in.ll.data();

  std::vector<std::vector<float>> ref = fresh();
  if (full) {
    int nchunks = (c.ndraws + 2 * c.chunk - 1) / (2 * c.chunk);
    uint32_t seed = word32(in.words[12]);
    reference_half<false>(h, mu, sg, lp, ll, mu + h, sg + h, in.words,
                          FullBits{seed, 100000u, c.block, nchunks, 0}, c,
                          ref[0].data(), ref[1].data(), ref[2].data(),
                          ref[3].data());
    reference_half<true>(h, mu + h, sg + h, lp + h, ll + h, ref[0].data(),
                         ref[1].data(), in.words + 6,
                         FullBits{seed, 200000u, c.block, nchunks, h}, c,
                         ref[0].data() + h, ref[1].data() + h,
                         ref[2].data() + h, ref[3].data() + h);
  } else {
    reference_half<false>(h, mu, sg, lp, ll, mu + h, sg + h, in.words,
                          HalfBits{word32(in.words[6]), c.block}, c,
                          ref[0].data(), ref[1].data(), ref[2].data(),
                          ref[3].data());
  }
  write_outputs(out + ".ref", ref);

  for (int a = 5, k = 0; a + 1 < argc; a += 2, ++k) {
    int walkers = std::atoi(argv[a]), threads = std::atoi(argv[a + 1]);
    std::vector<std::vector<float>> o = fresh();
    int err;
    if (full) {
      err = kt_fused_ais_full(mu, sg, lp, ll, in.words, o[0].data(),
                              o[1].data(), o[2].data(), o[3].data(), h,
                              in.fconsts, in.iconsts, walkers, threads,
                              nullptr);
    } else {
      err = kt_fused_ais_half(mu, sg, lp, ll, mu + h, sg + h, in.words,
                              o[0].data(), o[1].data(), o[2].data(),
                              o[3].data(), h, in.fconsts, in.iconsts,
                              walkers, threads, nullptr);
    }
    write_outputs(out + "." + std::to_string(k), o);
    std::printf("%d %d %d\n", walkers, threads, err);
  }
  return 0;
}
