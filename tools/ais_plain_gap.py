#!/usr/bin/env python3
"""The gap between the flagship AIS half-update #7 (``kt_fused_ais_half``)
and its plain version on Philox bits, and which side of it is off.

    python3 tools/ais_plain_gap.py [--seeds N]
    python3 chip_smoke.py --save-ais-inputs P && \\
        python3 tools/ais_plain_gap.py --population P

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--population", metavar="PATH")
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
    if args.population:
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
