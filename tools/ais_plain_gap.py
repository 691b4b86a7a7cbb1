#!/usr/bin/env python3
"""The gap between the flagship AIS half-update #7 (``kt_fused_ais_half``)
and its plain version on Philox bits, and which side of it is off.

    python3 tools/ais_plain_gap.py [--seeds N]
    python3 chip_smoke.py --save-ais-inputs P && \\
        python3 tools/ais_plain_gap.py --population P
    python3 tools/ais_plain_gap.py --candidates

With ``--candidates``: the float32 moment sums tried for the repair of
ROADMAP C2 (``CANDIDATES``; the last is what ``csrc/moments.cuh``
ships), each against float64 over its own draws beside the plain
version against float64 over its own, at 65536 walkers whose proposals
lie near the target, with each candidate's SASS instructions a draw
(``ops/sass.py``; needs ``cuobjdump``).

Without ``--population``: for each seed, a population of 131072 walkers
from the flagship prior with its kernelized log-likelihoods (scale
0.005), and two word sets (the words of ``chip_smoke.py``'s
``ais-kernel-times``, which give the shifts it had before #7 took words,
and 12 random words); one half-update by the kernel and by
``FlagshipAIS.half_plain`` on the shifts ``rot_shifts6`` makes of the
same words.

With ``--population P``: the population and the two word sets that
``chip_smoke.py`` saved from its ``ais-kernel-times`` phase
(``words13``: the random words of ``ais-stub``; ``words_h65536``: the
words that give PR 10's shifts), through that phase's whole sweep of two
half-updates, half B against the updated half A on each side. Half B is
also run by the plain version against the kernel's updated half A, so a
gap that half A hands on shows apart from the walker's own.

Prints one JSON line per (population, words, half): the walkers both
sides commit, the commit masks' difference, the relative gap of the
committed ``ll`` (99th percentile and maximum) and the values outside the
golden tolerance (rtol 2e-4, atol 2e-5). Then, for each walker outside
(at most 5 a line), its inputs, its six partners on each side, both
sides' outputs, and its moment sums and cost three ways from the same
float32 draws: summed in the plain version's order, summed one draw after
another in float32 with the square's multiply-add fused (the kernel's
order, ``moments.cuh``), and summed in float64 with the cost in float64;
with the ``ll`` each gives. The last line names the card and its power
limit. Needs one card and nvcc; imports nothing of JAX.
"""

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RTOL, ATOL = 2e-4, 2e-5
TARGET = (2.0, 0.04, 50.0)   # target mean, target sd, sd weight
SCALE = 0.005                # the kernelized density's scale


def walker_sums(torch, K, FA, seed, walker, ndraws):
    """One walker's simulator draws (float32, as the plain version makes
    them) summed three ways: (s1, s2) in the plain version's order, in
    the kernel's (one draw after another, s2 by a fused multiply-add),
    and in float64."""
    dev = seed.device
    q = torch.arange(-(-ndraws // 4), device=dev)
    x0, x1, x2, x3 = K.philox4x32_10(q, torch.full_like(q, walker),
                                     FA.STREAM_AIS_SIM, 0, seed)
    za, zb = K._box_muller(x0, x1)
    zc, zd = K._box_muller(x2, x3)
    z = torch.stack((za, zb, zc, zd), 1).flatten()[:ndraws]
    plain = K._moments_philox(seed, FA.STREAM_AIS_SIM, 1, ndraws, dev,
                              walker0=walker)
    m1 = m2 = np.float32(0.0)
    for v in z.cpu().numpy():
        m1 = np.float32(m1 + v)
        m2 = np.float32(np.float64(v) * np.float64(v) + np.float64(m2))
    zd64 = z.double()
    return dict(plain=(float(plain[0]), float(plain[1])),
                kernel_order=(float(m1), float(m2)),
                float64=(float(zd64.sum()), float((zd64 * zd64).sum())))


def cost_and_ll(torch, K, mu, sg, sums, ndraws, f64):
    """The summary cost and kernelized ``ll`` of a proposal (mu, sg) from
    moment sums, in float32 as the plain version computes them or in
    float64."""
    if f64:
        mz = sums[0] / ndraws
        vz = max(sums[1] / ndraws - mz * mz, 0.0)
        cost = float(np.hypot(mu + sg * mz - TARGET[0],
                              (sg * np.sqrt(vz) - TARGET[1]) * TARGET[2]))
        return cost, -0.5 * (cost / SCALE) ** 2
    t = [torch.tensor([v], dtype=torch.float32) for v in (mu, sg, *sums)]
    cost = K._summary_cost(*t, ndraws, *TARGET)
    inv = float(np.float32(1.0 / SCALE))
    tt = cost * inv
    return float(cost), float(-0.5 * (tt * tt))


def compare(torch, label, ins, outs, want, margin):
    """One JSON line for a half: kernel ``outs`` against plain ``want``
    on inputs ``ins``; returns the walkers outside the tolerance."""
    h = ins[0].shape[0]
    gc = torch.zeros(h, dtype=torch.bool, device=ins[0].device)
    wc = gc.clone()
    for o, w, x in zip(outs, want, ins):
        gc |= o != x
        wc |= w != x
    both = gc & wc
    bad = torch.zeros_like(both)
    for o, w in zip(outs, want):
        bad |= both & ~torch.isclose(o, w, rtol=RTOL, atol=ATOL)
    rel = ((outs[3] - want[3]).abs() / want[3].abs().clamp(min=1e-30))[both]
    band = 1e-4 + 1e-5 * (ins[3].abs() + want[3].abs())
    print(json.dumps(dict(
        **label, commits=int(both.sum()), masks_differ=int((gc != wc).sum()),
        masks_differ_off_border=int(((gc != wc) & (margin.abs() >= band))
                                    .sum()),
        ll_rel_gap_p99=float(rel.quantile(0.99)) if len(rel) else None,
        ll_rel_gap_max=float(rel.max()) if len(rel) else None,
        outside_tolerance=int(bad.sum()))), flush=True)
    return torch.nonzero(bad).flatten().tolist()


def report(torch, K, FA, m, label, walkers, ins, comps, shifts, outs, sides,
           seed):
    """Each outlying walker of a half: inputs, partners and outputs per
    side (``comps``, ``sides``: name -> partner leaves, outputs), and its
    sums and ``ll`` three ways."""
    h = ins[0].shape[0]
    for i in walkers[:5]:
        part = [(i + int(r)) % h for r in shifts]
        sums = walker_sums(torch, K, FA, seed, i, m.ndraws)
        mu, sg = (float(x[i]) for x in sides["plain"][:2])
        ways = {k: cost_and_ll(torch, K, mu, sg, v, m.ndraws, k == "float64")
                for k, v in sums.items()}
        print(json.dumps(dict(
            **label, walker=i, inputs=[float(x[i]) for x in ins],
            partners={k: [[float(c[0][j]), float(c[1][j])] for j in part]
                      for k, c in comps.items()},
            kernel=[float(x[i]) for x in outs],
            **{k: [float(x[i]) for x in v[:4]] for k, v in sides.items()},
            margin=float(sides["plain"][5][i]), sums=sums,
            cost_ll=ways)), flush=True)


def sweep_halves(torch, K, FA, m, ins, words, seed, label):
    """``chip_smoke.py``'s #7 sweep: half A, then half B against the
    updated half A, each by the kernel and by the plain version; half B
    also by the plain version against the kernel's half A."""
    h = ins[0].shape[0] // 2
    A = [x[:h] for x in ins]
    B = [x[h:] for x in ins]
    sh = [FA.rot_shifts6(words[k:k + 6], h) for k in (0, 6)]
    ka = [torch.empty_like(x) for x in A]
    m.launch_half(A, B[:2], torch.cat([words[:6], seed]), ka)
    pa = m.half_plain(*A, *B[:2], sh[0], seed)
    bad = compare(torch, dict(**label, half="A"), A, ka, pa[:4], pa[5])
    report(torch, K, FA, m, dict(**label, half="A"), bad, A,
           {"both": B[:2]}, sh[0], ka, {"plain": pa}, seed)
    kb = [torch.empty_like(x) for x in B]
    m.launch_half(B, ka[:2], torch.cat([words[6:12], seed]), kb)
    pb = m.half_plain(*B, *pa[:2], sh[1], seed)
    pk = m.half_plain(*B, *ka[:2], sh[1], seed)
    bad = compare(torch, dict(**label, half="B"), B, kb, pb[:4], pb[5])
    compare(torch, dict(**label, half="B on the kernel's half A"), B, kb,
            pk[:4], pk[5])
    report(torch, K, FA, m, dict(**label, half="B"), bad, B,
           {"plain": pa[:2], "kernel": ka[:2]}, sh[1], kb,
           {"plain": pb, "plain on the kernel's half A": pk}, seed)


# The float32 moment sums and costs tried for the repair of C2, each as
# a kernel over walkers of one Philox stream; candidate 4 is what
# csrc/moments.cuh ships. kRef adds float64 sums of the same draws (a
# separate instance, so the float instance's SASS is the candidate's).
CANDIDATES = {0: "parent: one sum of squares, draw after draw",
              1: "four partial sums, one per draw slot of a group",
              2: "centred sum, fmaf(z, z, -1) a draw, vz = s2c/n + 1 - mz^2",
              3: "compensated (Kahan) sum of squares",
              4: "centred sum a group, cost on sd - 1 (shipped)"}
CANDIDATE_SOURCE = r"""
#include "common.cuh"
#include "moments.cuh"
namespace {
template <int kCand, bool kRef>
__global__ void candidate_kernel(const float* mu, const float* sg, int m,
                                 uint32_t seed, uint32_t stream, int ndraws,
                                 float* out, double* out64) {
  int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= m) return;
  const float tmu = 2.0f, tsd = 0.04f, sdw = 50.0f;
  float inv_n = 1.0f / (float)ndraws;
  float s1 = 0.0f, s2 = 0.0f, cost;
  if (kCand == 4) {
    moments_philox(seed, stream, (uint32_t)w, ndraws, &s1, &s2);
    cost = centred_cost(mu[w], sg[w], s1, s2, ndraws, tmu, tsd, sdw);
    out[3 * w + 1] = s2;
  } else {
    PhiloxKey key = philox_key(seed);
    float p[4] = {0.0f, 0.0f, 0.0f, 0.0f}, comp = 0.0f;
    for (int q = 0; q < ndraws / 4; ++q) {
      Words4 b = philox4x32_10((uint32_t)q, (uint32_t)w, stream, 0u, key);
      float z[4];
      box_muller(b.x0, b.x1, &z[0], &z[1]);
      box_muller(b.x2, b.x3, &z[2], &z[3]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s1 += z[k];
        if (kCand == 0) s2 = __fmaf_rn(z[k], z[k], s2);
        if (kCand == 1) p[k] = __fmaf_rn(z[k], z[k], p[k]);
        if (kCand == 2) s2 = __fadd_rn(s2, __fmaf_rn(z[k], z[k], -1.0f));
        if (kCand == 3) {
          float y = __fmaf_rn(z[k], z[k], -comp);
          float t = __fadd_rn(s2, y);
          comp = __fsub_rn(__fsub_rn(t, s2), y);
          s2 = t;
        }
      }
    }
    if (kCand == 1) s2 = (p[0] + p[1]) + (p[2] + p[3]);
    float mz = s1 * inv_n;
    float vz = kCand == 2 ? __fmaf_rn(-mz, mz, __fmaf_rn(s2, inv_n, 1.0f))
                          : __fmaf_rn(-mz, mz, s2 * inv_n);
    float sd = sqrtf(fmaxf(vz, 0.0f));
    float d1 = __fmaf_rn(sg[w], mz, mu[w]) - tmu;
    float d2 = __fmul_rn(__fmaf_rn(sg[w], sd, -tsd), sdw);
    cost = kCand == 0  // the parent's cost, as its kernels compiled it
               ? summary_cost(mu[w], sg[w], s1, s2, inv_n, tmu, tsd, sdw)
               : sqrtf(__fmaf_rn(d1, d1, __fmul_rn(d2, d2)));
    out[3 * w + 1] = s2;
  }
  out[3 * w] = s1;
  out[3 * w + 2] = cost;
  if (kRef) {  // float64 over the same draws
    PhiloxKey key = philox_key(seed);
    double d1 = 0.0, d2 = 0.0;
    for (int q = 0; q < ndraws / 4; ++q) {
      Words4 b = philox4x32_10((uint32_t)q, (uint32_t)w, stream, 0u, key);
      float z[4];
      box_muller(b.x0, b.x1, &z[0], &z[1]);
      box_muller(b.x2, b.x3, &z[2], &z[3]);
      for (int k = 0; k < 4; ++k) {
        d1 += z[k];
        d2 += (double)z[k] * (double)z[k];
      }
    }
    double mz = d1 / ndraws, vz = fmax(d2 / ndraws - mz * mz, 0.0);
    out64[3 * w] = d1;
    out64[3 * w + 1] = d2;
    out64[3 * w + 2] = hypot((double)mu[w] + (double)sg[w] * mz - 2.0,
                             ((double)sg[w] * sqrt(vz) - 0.04) * 50.0);
  }
}
template <int kCand, bool kRef>
int launch(const float* mu, const float* sg, int m, unsigned seed,
           unsigned philox_stream, int ndraws, float* out, double* out64,
           void* stream) {
  auto kernel = candidate_kernel<kCand, kRef>;
  kernel<<<(m + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      mu, sg, m, seed, philox_stream, ndraws, out, out64);
  return (int)cudaGetLastError();
}
}  // namespace
extern "C" int kt_candidate(int cand, int ref, const float* mu,
                            const float* sg, int m, unsigned seed,
                            unsigned stream, int ndraws, float* out,
                            double* out64, void* st) {
  typedef int (*Fn)(const float*, const float*, int, unsigned, unsigned, int,
                    float*, double*, void*);
  Fn fns[5][2] = {{launch<0, false>, launch<0, true>},
                  {launch<1, false>, launch<1, true>},
                  {launch<2, false>, launch<2, true>},
                  {launch<3, false>, launch<3, true>},
                  {launch<4, false>, launch<4, true>}};
  return fns[cand][ref](mu, sg, m, seed, stream, ndraws, out, out64, st);
}
extern "C" const char* kt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
"""


def candidates(torch, K, FA, m=65536, ndraws=1000):
    """Each candidate's gap to float64 over its own draws against the
    plain version's over its own, for walkers 0..m-1 of the AIS
    simulator's stream (seed 2024; walker 33906 is C2's) at proposals
    whose costs lie near the target (sigma within 1e-4 / sd_z of
    target_sd / sd_z, mu within 3e-3 of the target mean): the 99th
    percentile and the maximum of the sum of squares' absolute error and
    of the cost's and ll's relative error; whether the candidate meets
    the requirement (no farther off than the plain version at both); and
    its SASS instructions a draw."""
    import ctypes

    from kissabc_tpu_torch.ops import _build, sass

    dev = torch.device("cuda")
    seed = torch.tensor([2024], dtype=torch.int64, device=dev)
    # the plain version's draws and sums, and float64 over its draws
    q = torch.arange(ndraws // 4, device=dev)
    zs64, p1, p2 = [], [], []
    for w0 in range(0, m, 8192):
        w = torch.arange(w0, w0 + 8192, device=dev)
        x0, x1, x2, x3 = K.philox4x32_10(q[None, :], w[:, None],
                                         FA.STREAM_AIS_SIM, 0, seed)
        za, zb = K._box_muller(x0, x1)
        zc, zd = K._box_muller(x2, x3)
        z = torch.stack((za, zb, zc, zd), 2).flatten(1).double()
        zs64.append(torch.stack((z.sum(1), (z * z).sum(1)), 1))
    z64 = torch.cat(zs64)
    ps1, ps2 = K._moments_philox(seed, FA.STREAM_AIS_SIM, m, ndraws, dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    mz = z64[:, 0] / ndraws
    sd = torch.sqrt(z64[:, 1] / ndraws - mz * mz)
    u = torch.rand((2, m), generator=gen, device=dev, dtype=torch.float64)
    sg = ((0.04 + (2 * u[0] - 1) * 1e-4) / sd).float()
    mu = (2.0 - sg.double() * mz + (2 * u[1] - 1) * 3e-3).float()

    def f64_cost(s1, s2):
        mzz = s1 / ndraws
        vz = torch.clamp(s2 / ndraws - mzz * mzz, min=0.0)
        return torch.hypot(mu.double() + sg.double() * mzz - 2.0,
                           (sg.double() * torch.sqrt(vz) - 0.04) * 50.0)

    def gaps(s2, s2_64, cost, cost64):
        ll = lambda c: -0.5 * (c / SCALE) ** 2   # noqa: E731
        e = {"s2_abs": (s2 - s2_64).abs(),
             "cost_rel": (cost - cost64).abs() / cost64,
             "ll_rel": (ll(cost) - ll(cost64)).abs() / ll(cost64).abs()}
        return {k: [float(v.quantile(0.99)), float(v.max())]
                for k, v in e.items()}

    plain = gaps(ps2.double(), z64[:, 1],
                 K._summary_cost(mu, sg, ps1, ps2, ndraws, *TARGET).double(),
                 f64_cost(z64[:, 0], z64[:, 1]))
    print(json.dumps(dict(candidate="plain version", walkers=m,
                          **plain)), flush=True)
    # built with the hand-written library's flags (FMA contraction on),
    # so the draws and the loops are those of the shipped kernels
    digest = _build._digest(*(h.read_bytes() for h in _build.HEADERS),
                            CANDIDATE_SOURCE.encode(),
                            " ".join(_build.NVCC_FLAGS).encode())
    lib_path = _build.BUILD_DIR / f"libc2-candidates-{digest}.so"
    src = lib_path.with_suffix(".cu")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(CANDIDATE_SOURCE)
    _build._Job(lib_path, (src,), _build.NVCC_FLAGS).wait()
    lib = _build._bind(lib_path, {})
    fn = lib.kt_candidate
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_int] + [
        ctypes.c_void_p] * 3
    per_draw = {}
    for name, instrs in sass.functions(sass.disassemble(lib_path)).items():
        t = re.search(r"candidate_kernelILi(\d)ELb0E", name)
        loops = sass.draw_loops(instrs) if t else []
        if loops:
            per_draw[int(t.group(1))] = loops[0]["per_draw"]
    for cand, what in CANDIDATES.items():
        out = torch.empty((m, 3), device=dev)
        out64 = torch.empty((m, 3), dtype=torch.float64, device=dev)
        _build.check(lib, fn(cand, 1, mu.data_ptr(), sg.data_ptr(), m, 2024,
                             FA.STREAM_AIS_SIM, ndraws, out.data_ptr(),
                             out64.data_ptr(),
                             torch.cuda.current_stream().cuda_stream),
                     "candidate")
        s2 = out[:, 1].double() + (ndraws if cand in (2, 4) else 0)
        g = gaps(s2, out64[:, 1], out[:, 2].double(), out64[:, 2])
        meets = all(g[k][i] <= plain[k][i] for k in ("s2_abs", "cost_rel")
                    for i in (0, 1))
        print(json.dumps(dict(candidate=cand, what=what, walkers=m,
                              sass_per_draw=per_draw.get(cand),
                              meets_requirement=meets, **g)), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--population", metavar="PATH")
    ap.add_argument("--candidates", action="store_true",
                    help="only the float32 sums tried for C2, against the "
                    "plain version")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ais_plain_gap: no CUDA device", file=sys.stderr)
        return 1
    import kissabc_tpu_torch as kt
    from kissabc_tpu_torch import models
    from kissabc_tpu_torch.ops import fused_ais as FA
    from kissabc_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    n, h = 131072, 65536
    seed = torch.tensor([2024], dtype=torch.int64, device=dev)
    m = kt.make_fused_flagship_ais_sweep(n, scale=SCALE).model
    if args.candidates:
        candidates(torch, K, FA)
    elif args.population:
        saved = torch.load(args.population)
        ins = [x.to(dev) for x in saved["ins"]]
        for name, words in saved["words"].items():
            sweep_halves(torch, K, FA, m, ins, words.to(dev)[:12], seed,
                         dict(population=args.population, words=name))
    else:
        word_sets = {
            "ais-kernel-times": torch.tensor([5, 77, 999, 3, 39999, 64999],
                                             dtype=torch.int64, device=dev),
            "random": FA.uint32_words(
                torch.Generator(device=dev).manual_seed(5), 6)}
        prior = models.flagship()[0]
        model_k = kt.ApproxKernelizedPosterior(
            prior, kt.make_flagship_cost_batched(), SCALE,
            cost_vectorized=True)
        for s in range(args.seeds):
            gen = torch.Generator(device=dev).manual_seed(s)
            th = prior.sample_tree(gen, n)
            ld = model_k.loglike_batch(th, gen)
            ins = [th[0][:h].contiguous(), th[1][:h].contiguous(), ld[0][:h],
                   ld[1][:h]]
            comp = [th[0][h:].contiguous(), th[1][h:].contiguous()]
            for label, words in word_sets.items():
                outs = [torch.empty_like(x) for x in ins]
                m.launch_half(ins, comp, torch.cat([words, seed]), outs)
                sh = FA.rot_shifts6(words, h)
                want = m.half_plain(*ins, *comp, sh, seed)
                lab = dict(seed=s, words=label)
                bad = compare(torch, lab, ins, outs, want[:4], want[5])
                report(torch, K, FA, m, lab, bad, ins, {"both": comp}, sh,
                       outs, {"plain": want}, seed)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
