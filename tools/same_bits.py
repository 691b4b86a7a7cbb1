#!/usr/bin/env python3
"""Whether the CUDA kernels of this checkout give, bit for bit, the
outputs of the kernels of another checkout on the same inputs.

    python3 tools/same_bits.py --parent DIR [--n N] [--only TEXT ...]

Loads the package of this checkout and the one under DIR side by side
(the second under another module name, so each builds its own libraries
into its own ``build/``), makes every input once from a seed on the card,
and runs each kernel through both: #1 ``normal_summary_cost`` (Philox and
stub bits), #2 ``fused_sweep`` (Philox and stub, and on Philox at each
geometry ``chip_smoke.GEOMETRIES_2`` times; a tree whose kernel takes the
step's words gets ``fused_sweep_words``, a tree whose kernel takes
partner differences gets the rolls ``roll_shifts`` makes of the same
words), #3 ``fused_smc_sweep`` (the flagship
model on Philox at 2**20, g-and-k with ECDF statistics on stub bits),
#3 also on the prior table's P1-P4 (``chip_smoke.prior_table_priors``,
stub bits, 65536 walkers), each tree on its own draws (so a change in a
family's draws shows: P4 holds ``DiscreteUniform(1, 6)``), #6 (a sweep)
and #10 on P4 likewise,
``smc-1m-generic-discrete`` (``chip_smoke.py``'s phase, smc at 2^20 on
the mixed discrete prior through #4 and #3, end to end),
#4 ``streaming_moment_cost`` (flagship and g-and-k, Philox and stub; the
flagship model also at 1000, 16384 and 16384 + 37 walkers, each tree at
its default geometry),
#5 ``streaming_scan_cost`` (AR(1) at nsteps % 4 of 0, 1 and 3, SIR with a
series and a two-leaf state, Philox and stub; AR(1) in each block size of
``chip_smoke.SCAN_THREADS``), #6 ``fused_ais_sweep`` (flagship and
g-and-k, Philox and stub; flagship on an odd half of 32771; and one
whole sweep of the flagship model from a generator state; a tree whose
kernel takes the half's words gets ``half_words``, a tree whose kernel
takes shifts gets ``rot_shifts6`` of the same words), #9
``fused_tempered_sweep`` (one whole sweep of the conjugate model at
131072 and 4096 walkers from a generator state, Philox and stub), #7
``fused_ais_half`` and #8 ``fused_ais_full`` (Philox and stub, and on
Philox at each geometry ``chip_smoke.GEOMETRIES_78`` times; a tree whose
launches take raw words gets the words, a tree whose launches take
shifts gets ``rot_shifts6`` of the same words) and #10
``fused_abcde_generation`` (flagship, Philox and stub at n, and at 16384
and 16384 + 37, a width that is no multiple of a block). Prints
one JSON line per case (``--only TEXT``: only the cases whose name holds
TEXT) with the count of output values that differ (0:
the same bits), then the card and its power limit; exits 1 if any case
differs. Against a parent from before the repair of the flagship Philox
moment sums (ROADMAP C2; its ``moments_philox`` differs), the cases that
run them (the Philox cases of #1, #2, #7 and #8) differ on purpose: their
lines say so and they do not count. Needs one card and nvcc; imports
nothing of JAX.
"""

import argparse
import importlib.util
import inspect
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from chip_smoke import (GEOMETRIES_2, GEOMETRIES_78, SCAN_THREADS,  # noqa
                        prior_table_priors)


def load_package(root, name):
    """The kissabc_tpu_torch package under ``root``, imported as
    ``name``."""
    pkg = os.path.join(os.path.abspath(root), "kissabc_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    importlib.import_module(f"{name}.models")
    return mod


def flat(out):
    """Every tensor of a nested output, in order."""
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in flat(o)]
    return [out]


def ais_args(m, fa, torch, words, h, full):
    """What #7 (``full`` False) or #8 of ``m``'s tree takes besides its
    buffers, for halves of ``h`` walkers: the raw words, or the shifts
    ``rot_shifts6`` makes of them and the seed (made here once, so a
    timed launch makes none)."""
    fn = m.launch_full if full else m.launch_half
    if "words" in inspect.signature(fn).parameters:
        return (words,)
    return (torch.cat([fa.rot_shifts6(words[k:k + 6], h)
                       for k in range(0, len(words) - 1, 6)]), words[-1:])


def launch_ais(m, fa, ins, comp, args, outs, geometry):
    """#7 (``comp`` given) or #8 on ``ais_args``'s ``args``, at
    ``geometry`` (``(walkers, threads)`` or None for the default; a tree
    that takes shifts has one geometry)."""
    h = ins[0].shape[0] if comp is not None else ins[0].shape[0] // 2
    fn = m.launch_half if comp is not None else m.launch_full
    head = [ins] + ([comp] if comp is not None else [])
    if len(args) == 1:
        fn(*head, *args, outs, geometry and fa.check_geometry(h, *geometry))
    else:
        fn(*head, *args, outs)
    return outs


def cases(torch, n, big):
    """(name, fn(pkg) -> outputs) for every kernel, on inputs made once."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def uniform(m, lo, hi):
        return torch.rand(m, generator=gen, device=dev) * (hi - lo) + lo

    seed = torch.tensor([11], dtype=torch.int64, device=dev)
    mu, sg = uniform(big, 1.0, 3.0), uniform(big, 0.01, 0.1)
    dmu, dsg = uniform(n, -0.5, 0.5), uniform(n, -0.02, 0.02)
    xs = uniform(big, 0.0, 1.0)
    alive = torch.rand(big, generator=gen, device=dev) < 0.95
    gk = [uniform(n, 0, 6), uniform(n, 0.1, 3), uniform(n, -1, 5),
          uniform(n, 0.0, 0.9)]
    ar = [uniform(n, 0.0, 2.0), uniform(n, 0.3, 2.0)]
    lp_ll = (uniform(big, -5.0, 0.0), uniform(big, -50.0, -1.0))
    h = n // 2
    idx = [torch.randint(0, n, (n,), generator=gen, device=dev)
           for _ in range(3)]
    active = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
    ds = uniform(n, 0.0, 3.0)
    fl_kw = dict(ndraws=1000, target_mu=2.0, target_sd=0.04, sd_weight=50.0,
                 a_stretch=3.0, mu_lo=1.0, mu_hi=3.0, sg_sigma=0.05,
                 sg_lo=0.0, sg_hi=100.0, chunk=512)

    def ecdf(pkg, probes):
        return [lambda x, t=t: (x < t).to(torch.float32) for t in probes]

    def ecdf_reduce(th, m):
        return (torch.square(m[0] - 0.25) + torch.square(m[1] - 0.5)
                + torch.square(m[2] - 0.75))

    def k1(bits):
        return lambda p: p.ops.kernels.normal_summary_cost(
            mu, sg, seed, bits=bits)

    words2 = torch.cat([torch.randint(0, 1 << 32, (2,), generator=gen,
                                      device=dev), seed])

    def k2(bits, geometry=None):
        def run(p):
            K = p.ops.kernels
            args = (mu[:n], sg[:n], xs[:n], lp_ll[0][:n], 0.5)
            kw = dict(bits=bits, block=2048, chunk=512)
            if hasattr(K, "fused_sweep_words"):   # the kernel takes words
                geo = geometry and K.check_sweep_geometry(n, *geometry)
                return K.fused_sweep_words(*args, words2, geometry=geo, **kw)
            # a tree whose kernel takes the partner differences
            r1, r2 = p.ops.moves.roll_shifts(words2[:2].tolist(), n)
            dmu = torch.roll(mu[:n], r2) - torch.roll(mu[:n], r1)
            dsg = torch.roll(sg[:n], r2) - torch.roll(sg[:n], r1)
            return K.fused_sweep(*args[:2], dmu, dsg, *args[2:], words2[2:],
                                 **kw)
        return run

    def k3(model, bits, m):
        def run(p):
            if model == "flagship":
                prior, draw, reduce_cost = p.models.flagship()
                sw = p.make_fused_smc_sweep(prior, draw, reduce_cost,
                                            bits=bits)
                th = [mu[:m], sg[:m]]
            else:
                prior, draw, _ = p.models.g_and_k()
                sw = p.make_fused_smc_sweep(
                    prior, draw, ecdf_reduce, stats=ecdf(p, (2.0, 3.0, 4.0)),
                    ndraws=700, bits=bits)
                th = gk
            lps = sw.prior.logpdf_tree(tuple(th)).to(torch.float32)
            rs = torch.tensor([5, 77, 11], dtype=torch.int64, device=dev)
            return sw.run(th, xs[:m], lps, alive[:m],
                          torch.tensor(0.5, device=dev),
                          torch.tensor(False, device=dev), rs)
        return run

    def table_draws(p, pname, m=65536):
        """A population of a prior-table prior drawn by the tree ``p``
        itself, from a generator seeded 31, as float32 leaves: a tree
        whose draws differ (values or stream) shows in the outputs."""
        prior = prior_table_priors(p)[pname]
        g = torch.Generator(device=dev).manual_seed(31)
        return prior, [x.to(torch.float32).contiguous()
                       for x in prior.sample_tree(g, m)]

    def table_models(p):
        _, draw, reduce_cost = p.models.flagship()
        return (lambda th, e: draw(th[:2], e),
                lambda th, mo: reduce_cost(th[:2], mo))

    def k3_table(pname, m=65536):
        """#3 on a prior-table prior, each tree on its own draws."""
        def run(p):
            prior, th = table_draws(p, pname, m)
            sw = p.make_fused_smc_sweep(prior, *table_models(p),
                                        bits="stub")
            lps = prior.logpdf_tree(prior.push_tree(tuple(th))).to(
                torch.float32)
            rs = torch.tensor([5, m // 2 + 3, 12345], dtype=torch.int64,
                              device=dev)
            return th, sw.run(th, xs[:m], lps, alive[:m],
                              torch.tensor(30.0, device=dev),
                              torch.tensor(False, device=dev), rs)
        return run

    def k6_drawn(pname, m=65536):
        """One whole #6 sweep from a generator on a prior-table prior,
        each tree on its own draws."""
        def run(p):
            prior, th = table_draws(p, pname, m)
            sw = p.make_fused_ais_sweep(prior, *table_models(p), scale=0.5,
                                        bits="stub")
            lp = prior.logpdf_tree(prior.push_tree(tuple(th))).to(
                torch.float32)
            g = torch.Generator(device=dev).manual_seed(21)
            return th, sw(g, tuple(th), (lp, lp_ll[1][:m]))
        return run

    def k10_drawn(pname, m=65536):
        """One #10 generation on a prior-table prior, each tree on its
        own draws."""
        def run(p):
            prior, leaves = table_draws(p, pname, m)
            g = p.make_fused_abcde_generation(
                prior, *table_models(p), gamma=2.38 / math.sqrt(32.0),
                bits="stub")
            bases = [[x[i[:m] % m] for x in leaves] for i in idx]
            lps = g.prior.logpdf_tree(g.prior.push_tree(tuple(leaves))) \
                .float().contiguous()
            eps_i = torch.where(ds[:m] <= 0.3, 0.3, 0.8)
            return leaves, g.run(leaves, bases, lps, ds[:m], active[:m],
                                 eps_i, seed)
        return run

    def smc_discrete(p):
        """chip_smoke.py's smc-1m-generic-discrete end to end: the mixed
        discrete prior at 2^20 through #4 at the init and #3 every sweep;
        the posterior, its costs, eps and the iterations."""
        prior, draw, reduce_cost = p.models.mixed_discrete()
        res = p.smc(prior, p.make_streaming_moment_cost(draw, reduce_cost,
                                                        ndraws=500),
                    cost_vectorized=True, nparticles=big, epstol=0.08,
                    sweep_fused=p.make_fused_smc_sweep(
                        prior, draw, reduce_cost, ndraws=500), key=5,
                    device=dev)
        return ([torch.as_tensor(q.particles) for q in res.P]
                + [torch.as_tensor(res.C), torch.tensor(res.eps),
                   torch.tensor(res.iterations)])

    def k4(model, bits, m=n):
        def run(p):
            if model == "flagship":
                _, draw, reduce_cost = p.models.flagship()
                th = (mu[:m], sg[:m])
            else:
                _, draw, reduce_cost = p.models.g_and_k()
                th = tuple(gk)
            return p.make_streaming_moment_cost(
                draw, reduce_cost, bits=bits).moments(th, seed)
        return run

    sir_series = uniform(1001, 0.0, 200.0).cpu().numpy()

    def two_leaf(p):
        def step(th, xt, eps, t):
            x, acc = xt
            x = x + th[0] * 0.1 + eps
            return (x, 0.9 * acc + 0.1 * torch.abs(x))
        return dict(step=step, init=lambda th: (th[0], torch.abs(th[0])),
                    reduce_cost=lambda th, m: m[0],
                    observe=lambda th, xt, t, obs: (xt[1], xt[0] * t.float()))

    def k5(model, nsteps, bits, threads=None):
        def run(p):
            if model == "ar1":
                _, step, init, reduce_cost = p.models.ar1()
                kw = dict(step=step, init=init, reduce_cost=reduce_cost)
                th = tuple(ar)
            elif model == "sir":
                _, step, init, observe, reduce_cost, _ = p.models.sir()
                kw = dict(step=step, init=init, reduce_cost=reduce_cost,
                          observe=observe, series=sir_series[:nsteps])
                th = (ar[0] * 0.35 + 0.05, ar[1] * 0.2)
            else:
                kw = two_leaf(p)
                th = tuple(ar[:1])
            c = p.make_streaming_scan_cost(nsteps=nsteps, bits=bits, **kw)
            if threads is None or "threads" not in inspect.signature(
                    c.launch).parameters:   # a tree of one block size
                return c.means(th, seed)
            leaves = [x.contiguous() for x in th]
            out = torch.empty((c.unit(len(th)).nstats, n), device=dev)
            c.launch(n, leaves, seed, out, n, structure=len(th),
                     threads=threads)
            return tuple(out)
        return run

    words7 = torch.cat([torch.randint(0, 1 << 32, (6,), generator=gen,
                                      device=dev), seed])

    def mixture_half(p, sw, half, *args, lam=()):
        """One half-update of #6 or #9 on ``words7``: the words, or the
        shifts ``rot_shifts6`` makes of them and the seed."""
        if hasattr(sw, "half_words"):
            return sw.half_words(*args, words7, *lam)
        return sw.half(*args, p.ops.fused_ais.rot_shifts6(words7[:6], half),
                       words7[6:], *lam)

    def k6(model, bits, half=h):
        def run(p):
            if model == "flagship":
                prior, draw, reduce_cost = p.models.flagship()
                leaves = [mu[:n], sg[:n]]
            else:
                prior, draw, reduce_cost = p.models.g_and_k()
                leaves = gk
            sw = p.make_fused_ais_sweep(prior, draw, reduce_cost, scale=0.5,
                                        bits=bits)
            return mixture_half(
                p, sw, half, [x[:half] for x in leaves], lp_ll[0][:half],
                lp_ll[1][:half], [x[half:2 * half] for x in leaves])
        return run

    def k6_sweep(bits):   # a whole sweep: each tree draws its own words
        def run(p):
            prior, draw, reduce_cost = p.models.flagship()
            sw = p.make_fused_ais_sweep(prior, draw, reduce_cost, scale=0.5,
                                        bits=bits)
            g = torch.Generator(device=dev).manual_seed(21)
            return sw(g, (mu[:n], sg[:n]), (lp_ll[0][:n], lp_ll[1][:n]))
        return run

    def k9_sweep(bits, m=n):
        def run(p):
            prior, ll_conj, _, _ = p.models.conjugate_normal()
            sw = p.make_fused_tempered_sweep(prior, ll_conj, bits=bits)
            th = mu[:m] - 2.0
            lp, ll = prior.logpdf(th).float(), ll_conj(th).float()
            g = torch.Generator(device=dev).manual_seed(22)
            half = m // 2
            return sw(g, (th[:half], th[half:]),
                      ((lp[:half], ll[:half]), (lp[half:], ll[half:])),
                      torch.tensor(0.3, device=dev))
        return run

    words13 = torch.cat([torch.randint(0, 1 << 32, (12,), generator=gen,
                                       device=dev), seed])

    def k7(bits, full, geometry=None):
        def run(p):
            fa = p.ops.fused_ais
            m = fa.FlagshipAIS(scale=0.1, block=2048, bits=bits, **fl_kw)
            if full:
                ins = [mu[:n], sg[:n], lp_ll[0][:n], lp_ll[1][:n]]
                comp, words = None, words13
            else:
                ins = [mu[:h], sg[:h], lp_ll[0][:h], lp_ll[1][:h]]
                comp = [mu[h:n], sg[h:n]]
                words = torch.cat([words13[:6], seed])
            return launch_ais(m, fa, ins, comp,
                              ais_args(m, fa, torch, words, h, full),
                              [torch.empty_like(x) for x in ins], geometry)
        return run

    def k10(bits, m=n):
        def run(p):
            prior, draw, reduce_cost = p.models.flagship()
            g = p.make_fused_abcde_generation(
                prior, draw, reduce_cost, gamma=2.38 / math.sqrt(4.0),
                bits=bits)
            leaves = [mu[:m], sg[:m]]
            bases = [[x[i[:m] % m] for x in leaves] for i in idx]
            lps = g.prior.logpdf_tree(tuple(leaves)).float().contiguous()
            eps_i = torch.where(ds[:m] <= 0.3, 0.3, 0.8)
            return g.run(leaves, bases, lps, ds[:m], active[:m], eps_i, seed)
        return run

    return [("#1 hw", k1("hw")), ("#1 stub", k1("stub")),
            ("#2 hw", k2("hw")), ("#2 stub", k2("stub")),
            ("#3 flagship hw 2^20", k3("flagship", "hw", big)),
            ("#3 g-and-k-ecdf stub", k3("gk", "stub", n)),
            ("#3 prior-table P1 stub 65536, own draws", k3_table("P1")),
            ("#3 prior-table P2 stub 65536, own draws", k3_table("P2")),
            ("#3 prior-table P3 stub 65536, own draws", k3_table("P3")),
            ("#3 prior-table P4 stub 65536, own draws", k3_table("P4")),
            ("#6 prior-table P4 stub 65536, own draws, a sweep",
             k6_drawn("P4")),
            ("#10 prior-table P4 stub 65536, own draws", k10_drawn("P4")),
            ("smc-1m-generic-discrete", smc_discrete),
            ("#4 flagship hw", k4("flagship", "hw")),
            ("#4 flagship stub", k4("flagship", "stub")),
            ("#4 g-and-k hw", k4("gk", "hw")),
            ("#4 flagship hw 1000", k4("flagship", "hw", 1000)),
            ("#4 flagship hw 16384", k4("flagship", "hw", 16384)),
            ("#4 flagship hw 16384 + 37", k4("flagship", "hw", 16384 + 37)),
            ("#4 flagship stub 16384 + 37",
             k4("flagship", "stub", 16384 + 37)),
            ("#4 flagship stub 1000", k4("flagship", "stub", 1000)),
            ("#5 ar1 hw", k5("ar1", 1000, "hw")),
            ("#5 ar1 hw, nsteps 1001", k5("ar1", 1001, "hw")),
            ("#5 ar1 stub, nsteps 257", k5("ar1", 257, "stub")),
            ("#5 ar1 hw, nsteps 1003", k5("ar1", 1003, "hw")),
            ("#5 sir hw, a series", k5("sir", 1000, "hw")),
            ("#5 sir stub, a series, nsteps 1001", k5("sir", 1001, "stub")),
            ("#5 two-leaf state hw, nsteps 1002", k5("two", 1002, "hw")),
            ("#5 two-leaf state stub", k5("two", 1000, "stub")),
            ("#6 flagship hw", k6("flagship", "hw")),
            ("#6 g-and-k stub", k6("gk", "stub")),
            ("#7 hw", k7("hw", False)), ("#7 stub", k7("stub", False)),
            ("#6 flagship hw, odd half 32771", k6("flagship", "hw", 32771)),
            ("#6 flagship hw, a sweep from a generator", k6_sweep("hw")),
            ("#6 flagship stub, a sweep from a generator",
             k6_sweep("stub")),
            ("#9 conjugate hw, a sweep from a generator", k9_sweep("hw")),
            ("#9 conjugate stub, a sweep from a generator",
             k9_sweep("stub")),
            ("#9 conjugate hw 4096, a sweep from a generator",
             k9_sweep("hw", 4096)),
            ("#8 hw", k7("hw", True)), ("#10 hw", k10("hw")),
            ("#10 stub", k10("stub")), ("#10 hw 16384", k10("hw", 16384)),
            ("#10 hw 16384 + 37", k10("hw", 16384 + 37)),
            ("#10 stub 16384 + 37", k10("stub", 16384 + 37)),
            ("#8 stub", k7("stub", True))] + [
        (f"#{k} hw, {w} walkers {t} threads", k7("hw", k == 8, (w, t)))
        for k in (7, 8) for w, t in GEOMETRIES_78] + [
        (f"#2 hw, {w} walkers {t} threads", k2("hw", (w, t)))
        for w, t in GEOMETRIES_2] + [
        (f"#5 ar1 hw, blocks of {t}", k5("ar1", 1000, "hw", t))
        for t in SCAN_THREADS]


# cases that run the flagship kernels' Philox moment sums
# (csrc/moments.cuh moments_philox), whose bits the repair of their
# float32 sums (ROADMAP C2) changed on purpose
PHILOX_MOMENTS = ("#1 hw", "#2 hw", "#7 hw", "#8 hw")


def philox_moments_changed(parent):
    """Whether the parent's Philox moment sums differ from this tree's
    (the parent predates the C2 repair)."""
    def loop(root):
        text = open(os.path.join(root, "kissabc_tpu_torch", "csrc",
                                 "moments.cuh")).read()
        return text[text.index("moments_philox"):]
    return loop(HERE) != loop(parent)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--only", action="append", metavar="TEXT",
                    help="run only the cases whose name holds TEXT "
                    "(repeatable)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("same_bits: no CUDA device", file=sys.stderr)
        return 1
    new = load_package(HERE, "kt_new")
    old = load_package(args.parent, "kt_parent")
    differ = 0
    c2 = philox_moments_changed(args.parent)
    for name, fn in cases(torch, args.n, 1 << 20):
        if args.only and not any(t in name for t in args.only):
            continue
        a, b = flat(fn(new)), flat(fn(old))
        torch.cuda.synchronize()
        unequal = sum(int((x != y).sum()) - int((x.isnan() & y.isnan()).sum())
                      if x.is_floating_point() else int((x != y).sum())
                      for x, y in zip(a, b))
        expected = c2 and name.startswith(PHILOX_MOMENTS)
        differ += 0 if expected else unequal
        print(json.dumps(dict(
            case=name, values=sum(x.numel() for x in a), unequal=unequal,
            **({"expected": "the parent predates the C2 repair of the "
                "Philox moment sums"} if expected else {}))), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(card=card, parent=args.parent, unequal=differ,
                          philox_moments_changed=c2)))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
