#!/usr/bin/env python3
"""Times the compacting kernels, #10 ``fused_abcde_generation``, #6
``fused_ais_sweep`` and the flagship AIS sweeps #7 ``fused_ais_half`` and
#8 ``fused_ais_full``, over a grid of launch geometries (walkers a block
covers, threads a block, lanes a walker) at their production widths, and
checks that every geometry gives the outputs of the default one bit for
bit.

    python3 tools/time_geometry.py [--parent DIR] [--quick]
                                   [--kernels all|78|2|5|4|9]

#4 ``streaming_moment_cost`` (``--kernels 4``, alone): the flagship model
at 1000, 16384, 25344 and 33792 (192 and 256 walkers an SM of the
H100), 65536, 131072, 262144 and 2**20 walkers and g-and-k at 65536 and 131072, 1000 draws, Philox, over a grid of geometries (1, 2, 4, 8 and 16 lanes a
walker, one turn a group, and one thread per walker in blocks of 32 to
256), each by the profiler and by queued events; with ``--parent``, the
parent's kernel (its own geometry) in turns with this checkout's
default. First, each tree's flagship cost unit and smc sweep unit (#3,
which holds #4 too) compiled alone, one nvcc after the other: what the
lane groups in every unit cost in build time. #9 ``fused_tempered_sweep``
(``--kernels 9``, alone): one sweep of the conjugate model at 4096 and
131072 walkers, lam 0.3, two launches from the halves' words, by the
profiler, by queued events and by events around calls (the host's
launches included); with ``--parent``, the parent's two launches (given
shifts) in turns with this checkout's.

#2 ``fused_sweep`` (``--kernels 2``, alone): one sweep at 131072 walkers
on the prior (``chip_smoke.py`` ``kernel-times``' inputs) and on the
population after 50 steps of ``fused-sweep``, at 256, 512 and 1024
walkers a block on 256 or 512 threads and at 128 on 128, each by the
profiler and by queued events; with ``--parent``, the parent's kernel on
the rolls of the same words in turns with this checkout's default. #5
``streaming_scan_cost`` (``--kernels 5``, alone): AR(1) at 131072 x 1000
steps in blocks of 64 to 512 threads, the parent in turns, after the
``ptxas`` registers of each tree's AR(1) and SIR units.

#7 and #8 (``--kernels 78`` times them alone): one sweep at 131072
walkers from the init of ``sample(key=0)`` (59% inside the prior) and
from the ensemble after 100 sweeps of #8 from there (100% inside), at
256, 512 and 1024 walkers a block on 256 or 512 threads, each by the
profiler and by queued events; with ``--parent``,
the parent's kernels through its own interface (shifts instead of words)
in turns with this checkout's default.

The grid runs on copies of the units built with every lane count
(``lane_groups.with_all_lanes``: 1, 2, 4, 8 and 16); the default geometry
and the parent's turns run on the units as the wrappers build them (1
and 4), and the default geometry is timed on the grid's build too
(``all_lanes_ms``). First, the cost of the extra lanes in build time:
each flagship unit (#10, #6) compiled alone, as the wrappers build it
and with every lane count, one nvcc after the other.

#10: the flagship model at 16384 and 131072 walkers x 1000 draws, Philox,
on the inputs of an ABCDE generation (chip_smoke.py ``abcde-kernel-times``).
#6: one sweep (two half-updates of 65536) of the flagship model from the
prior (chip_smoke.py ``ais-kernel-times``) and of g-and-k from the init of
``sample`` (``ais-fused-generic``), and of each after 100 fused sweeps
from the init of ``sample`` (the states a run's sweeps meet), with the
share of walkers inside the prior along the way. Each geometry's time is
the kernel's own by ``torch.profiler`` (``chip_smoke.device_ms``, per
generation or sweep) and by events around launches queued behind a spin
(``chip_smoke.queued_ms``, which drops no launch), beside the lane share
its compaction gives by the plain model (``lane_groups.lane_share``, not
measured) and the blocks an SM holds. With ``--parent``, the kernels of the
checkout under DIR run on the same inputs in the same process, in turns
with this checkout's default geometry (parent, this, this, parent), and
must give the same bits.
Prints one JSON line per geometry, then the card and its power limit.
Needs one card and nvcc; imports nothing of JAX.
"""

import argparse
import importlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

import chip_smoke as CS                                  # noqa: E402
from same_bits import (ais_args, flat, launch_ais,         # noqa: E402
                       load_package, philox_moments_changed)


def grids(quick):
    """(n, [(walkers, threads, lanes)]) per case."""
    if quick:
        return {"abcde 16384": [(64, 256, 8), (64, 256, 1), (32, 128, 16)],
                "abcde 131072": [(512, 256, 4), (1024, 512, 2)],
                "ais": [(256, 256, 4), (512, 256, 1), (128, 128, 8)],
                "flagship ais": [(256, 256), (1024, 512)],
                "sweep": [(512, 512), (128, 128)]}
    return {
        "abcde 16384": [(w, t, l) for w in (32, 64, 128) for t in (128, 256)
                        for l in (1, 4, 8, 16)],
        "abcde 131072": [(w, t, l) for w in (256, 512, 1024)
                         for t in (256, 512) for l in (1, 2, 4, 8)],
        "ais": [(w, t, l) for w in (128, 256, 512) for t in (256, 512)
                for l in (1, 2, 4, 8)],
        "flagship ais": [(w, t) for w in (256, 512, 1024)
                         for t in (256, 512)],
        "sweep": [(w, t) for w in (256, 512, 1024) for t in (256, 512, 1024)
                  if t <= w] + [(128, 128)],
    }


def flagship_ais(torch, kt, old, grid, report, c2=False):
    """#7 and #8 over ``grid`` (walkers, threads) on the two
    ensembles of a sample run; returns the count of geometries (and
    parent runs) whose bits differ from this checkout's default."""
    from kissabc_tpu_torch import models
    from kissabc_tpu_torch.core import ais as AI
    from kissabc_tpu_torch.ops import fused_ais as FA
    from kissabc_tpu_torch.ops import lane_groups as LG

    dev = torch.device("cuda")
    n, h = 131072, 65536
    seed = torch.tensor([2024], dtype=torch.int64, device=dev)
    words13 = torch.cat([FA.uint32_words(
        torch.Generator(device=dev).manual_seed(5), 12), seed])
    prior = models.flagship()[0]
    model_k = kt.ApproxKernelizedPosterior(
        prior, kt.make_flagship_cost_batched(), 0.005, cost_vectorized=True)
    th, ld, _ = AI._init_ensemble(
        model_k, torch.Generator(device=dev).manual_seed(0), n, 100)
    ensembles = {"init of sample(key=0)": (th, ld)}
    sweep8 = kt.make_fused_flagship_ais_sweep_onekernel(n, scale=0.005)
    g7 = torch.Generator(device=dev).manual_seed(7)
    for _ in range(100):
        th, ld = sweep8(g7, th, ld)
    ensembles["after 100 sweeps"] = (th, ld)
    trees = {"this": (FA, kt)} | ({"parent": (old.ops.fused_ais, old)}
                                  if old else {})
    models_ = {(who, full): (mk(n, scale=0.005).model, fa)
               for who, (fa, pkg) in trees.items()
               for full, mk in ((False, pkg.make_fused_flagship_ais_sweep),
                                (True, pkg.
                                 make_fused_flagship_ais_sweep_onekernel))}
    bad = 0
    for ename, (th, ld) in ensembles.items():
        ins = [x.contiguous() for x in (*th, *ld)]
        outs = [torch.empty_like(x) for x in ins]
        for full in (False, True):
            name = "#8 fused_ais_full" if full else "#7 fused_ais_half"
            kernel = "fused_ais_full_kernel" if full else (
                "fused_ais_half_kernel")

            # each tree's launch arguments, made once: raw words, or the
            # parent's shifts and seed
            args = {who: ais_args(m, fa, torch, words13, h, True) if full
                    else [ais_args(m, fa, torch, torch.cat(
                        [words13[6 * k:6 * k + 6], seed]), h, False)
                        for k in (0, 1)]
                    for (who, f), (m, fa) in models_.items() if f == full}

            def sweep(who="this", geometry=None, keep=True):
                m, fa = models_[who, full]
                if full:
                    launch_ais(m, fa, ins, None, args[who], outs, geometry)
                else:
                    for half, (sl, co) in enumerate(
                            ((slice(0, h), slice(h, n)),
                             (slice(h, n), slice(0, h)))):
                        comp = [(ins if half == 0 else outs)[k][co]
                                for k in (0, 1)]
                        launch_ais(m, fa, [x[sl] for x in ins], comp,
                                   args[who][half], [o[sl] for o in outs],
                                   geometry)
                return [x.clone() for x in outs] if keep else None

            def times(**kw):
                return dict(
                    device_ms=CS.device_ms(
                        torch, lambda: sweep(keep=False, **kw), 20, kernel,
                        per_call=1 if full else 2),
                    queued_ms=CS.queued_ms(
                        torch, lambda: sweep(keep=False, **kw), 20))

            ref = sweep()
            m = models_["this", full][0]
            sh = torch.cat([FA.rot_shifts6(words13[:6], h),
                            FA.rot_shifts6(words13[6:12], h)])
            inside = int(m.full_plain(*ins, sh, seed)[4].sum()) if full \
                else None
            default = FA.flagship_geometry(h, LG.sm_count(0))
            rec = dict(case=f"{name}, {ename}", walkers=default.walkers,
                       threads=default.threads, default=True, inside=inside,
                       **times())
            if old:
                rec["parent_same_bits"] = CS.same_bits(sweep("parent"), ref)
                bad += not (rec["parent_same_bits"] or c2)
                turns = [times(who=who) for who in ("parent", "this",
                                                    "this", "parent")]
                rec["parent_ms"] = [turns[0]["device_ms"],
                                    turns[3]["device_ms"]]
                rec["this_ms"] = [t["device_ms"] for t in turns[1:3]]
                rec["parent_queued_ms"] = [turns[0]["queued_ms"],
                                           turns[3]["queued_ms"]]
                rec["this_queued_ms"] = [t["queued_ms"] for t in turns[1:3]]
            report(**rec)
            for w, t in grid:
                ok = CS.same_bits(sweep(geometry=(w, t)), ref)
                bad += not ok
                report(case=f"{name}, {ename}", walkers=w, threads=t,
                       same_bits=ok, **times(geometry=(w, t)),
                       **({"blocks_per_sm": FA.full_grid(
                           h, FA.check_geometry(h, w, t))[0]}
                          if full else {}))
    return bad


def fused_sweep(torch, kt, old, grid, report, c2=False):
    """#2 over ``grid`` (walkers, threads) on two populations at 131072:
    the prior (``chip_smoke.py`` ``kernel-times``) and the population
    after 50 steps of ``fused-sweep``; one sweep on the words [4, 75, 11]
    (the shifts 5 and 77). Returns the count of geometries (and parent
    runs) whose bits differ from this checkout's default."""
    from kissabc_tpu_torch import models
    from kissabc_tpu_torch.ops import kernels as K
    from kissabc_tpu_torch.ops import lane_groups as LG

    dev = torch.device("cuda")
    n = 131072
    prior = models.flagship()[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    mu, sg = prior.sample_tree(gen, n)
    xs = torch.rand(n, generator=gen, device=dev)
    lps = prior.logpdf(prior.push_tree((mu, sg))).float()
    pops = {"the prior": [mu, sg, xs, lps]}
    step = kt.make_fused_flagship_sweep(n)
    th, x, lp = prior.sample_tree(gen, n), torch.ones(n, device=dev), \
        torch.zeros(n, device=dev)
    g7 = torch.Generator(device=dev).manual_seed(7)
    for _ in range(50):
        th, x, lp, _ = step(g7, th, x, lp, 0.5)
    pops["after 50 steps of fused-sweep"] = [th[0], th[1], x, lp]
    words = torch.tensor([4, 75, 11], dtype=torch.int64, device=dev)
    consts = K.fused_sweep_constants(max_stretch=2.0, mu_lo=1.0, mu_hi=3.0,
                                     sg_sigma=0.05, sg_lo=0.0, sg_hi=100.0)
    pkw = dict(consts=consts, ndraws=1000, target_mu=2.0, target_sd=0.04,
               sd_weight=50.0, block=2048, chunk=512, bits="hw")
    bad = 0
    for pname, ins in pops.items():
        ins = [t.contiguous() for t in ins]
        outs = tuple(torch.empty_like(mu) for _ in range(4)) + (
            torch.empty(n, dtype=torch.bool, device=dev),)
        dmu, dsg = K.sweep_partners(ins[0], ins[1], words)
        nsim = int(K.fused_sweep_proposal_plain(
            ins[0], ins[1], dmu, dsg, ins[3], words[2:], consts=consts,
            block=2048, bits="hw")[3].sum())

        def sweep(geo=None):
            K.launch_fused_sweep(n, ins, outs, 0.5, words, geometry=geo,
                                 **pkw)
            return [o.clone() for o in outs]

        eps_t = torch.tensor(0.5, device=dev)

        def parent():   # the parent's kernel on the same words or rolls
            # (eps on the card: a float would be copied there, which
            # waits for a spin)
            PK = old.ops.kernels
            if hasattr(PK, "fused_sweep_words"):
                return PK.fused_sweep_words(*ins, eps_t, words)
            return PK.fused_sweep(ins[0], ins[1], dmu, dsg, ins[2], ins[3],
                                  eps_t, words[2:])

        def times(fn):
            return dict(device_ms=CS.device_ms(torch, fn, 20,
                                               "fused_sweep_kernel"),
                        queued_ms=CS.queued_ms(torch, fn, 20))

        ref = sweep()
        default = K.sweep_geometry(n, LG.sm_count(0))
        rec = dict(case=f"#2 fused_sweep, {pname}", walkers=default.walkers,
                   threads=default.threads, default=True, gate1=nsim,
                   **times(sweep))
        if old:
            rec["parent_same_bits"] = CS.same_bits(list(parent()), ref)
            bad += not (rec["parent_same_bits"] or c2)
            turns = [times(parent if who == "parent" else sweep)
                     for who in ("parent", "this", "this", "parent")]
            for key in ("device_ms", "queued_ms"):
                rec[f"parent_{key}"] = [turns[0][key], turns[3][key]]
                rec[f"this_{key}"] = [t[key] for t in turns[1:3]]
        report(**rec)
        for w, t in grid:
            geo = K.check_sweep_geometry(n, w, t)
            ok = CS.same_bits(sweep(geo), ref)
            bad += not ok
            report(case=f"#2 fused_sweep, {pname}", walkers=w, threads=t,
                   same_bits=ok, **times(lambda: sweep(geo)))
    return bad


def scan_threads(torch, kt, old, threads, report):
    """#5 on AR(1) at 131072 x 1000 steps in blocks of each of
    ``threads``; with a parent, its kernel (one block size) in turns
    with this checkout's default. Returns the count of block sizes (and
    parent runs) whose bits differ from this checkout's default."""
    from kissabc_tpu_torch import models
    from kissabc_tpu_torch.ops import scan as SC

    dev = torch.device("cuda")
    n = 131072
    # the registers of the AR(1) and SIR units of each tree (ptxas -v of
    # this call's builds; a library built before prints nothing)
    for who, pkg in [("this", kt)] + ([("parent", old)] if old else []):
        pm = importlib.import_module(f"{pkg.__name__}.models")
        _, astep, ainit, areduce = pm.ar1()
        _, sstep, sinit, sobs, sreduce, series = pm.sir()
        units = {"ar1": pkg.make_streaming_scan_cost(
            astep, ainit, areduce, nsteps=1000).unit(2),
            "sir": pkg.make_streaming_scan_cost(
                sstep, sinit, sreduce, observe=sobs, series=series,
                nsteps=len(series)).unit(2)}
        build = importlib.import_module(f"{pkg.__name__}.ops._build")
        jobs = {k: build.start(u.source) for k, u in units.items()}
        report(tree=who, scan_ptxas={k: ptxas(j.wait()[2])
                                     for k, j in jobs.items()})
    prior, step, init, reduce_cost = models.ar1()
    th = [x.contiguous() for x in prior.sample_tree(
        torch.Generator(device=dev).manual_seed(0), n)]
    seed = torch.tensor([13], dtype=torch.int64, device=dev)
    c = kt.make_streaming_scan_cost(step, init, reduce_cost, nsteps=1000)
    out = torch.empty((2, n), device=dev)

    def run(t=None):
        c.launch(n, th, seed, out, n, structure=2, threads=t)
        return [out.clone()]

    def times(fn):
        return dict(device_ms=CS.device_ms(torch, fn, 20,
                                           "streaming_scan_cost_kernel"),
                    queued_ms=CS.queued_ms(torch, fn, 20))

    ref = run()
    rec = dict(case="#5 streaming_scan_cost, AR(1) 131072 x 1000",
               threads=SC.SCAN_THREADS, default=True, **times(run))
    bad = 0
    if old:
        _, pstep, pinit, preduce = old.models.ar1()
        pc = old.make_streaming_scan_cost(pstep, pinit, preduce, nsteps=1000)

        def parent():
            return [torch.stack(pc.means(tuple(th), seed))]

        rec["parent_same_bits"] = CS.same_bits(parent(), ref)
        bad += not rec["parent_same_bits"]
        turns = [times(parent if who == "parent" else run)
                 for who in ("parent", "this", "this", "parent")]
        for key in ("device_ms", "queued_ms"):
            rec[f"parent_{key}"] = [turns[0][key], turns[3][key]]
            rec[f"this_{key}"] = [t[key] for t in turns[1:3]]
    report(**rec)
    for t in threads:
        ok = CS.same_bits(run(t), ref)
        bad += not ok
        report(case="#5 streaming_scan_cost, AR(1) 131072 x 1000",
               threads=t, same_bits=ok, **times(lambda: run(t)))
    return bad


def cost_grid(quick):
    """#4's geometries (walkers, threads, lanes): one turn a group, so
    threads = walkers x lanes, from 32 to 512."""
    if quick:
        return [(128, 128, 1), (8, 32, 4), (64, 256, 4), (16, 128, 8)]
    return [(w, w * lanes, lanes) for lanes in (1, 2, 4, 8, 16)
            for w in (2, 4, 8, 16, 32, 64, 128, 256)
            if 32 <= w * lanes <= 512 and (lanes > 1 or w >= 32)]


def cost_widths(torch, kt, old, quick, report):
    """#4 at its paths' widths over ``cost_grid``; returns the count of
    geometries (and parent runs) whose bits differ from this checkout's
    default."""
    from kissabc_tpu_torch import models
    from kissabc_tpu_torch.ops import _build
    from kissabc_tpu_torch.ops import lane_groups as LG

    dev = torch.device("cuda")
    fprior, fdraw, freduce = models.flagship()
    gprior, gdraw, greduce = models.g_and_k()
    trees = [("this", kt)] + ([("parent", old)] if old else [])
    for who, pkg in trees:
        pm = importlib.import_module(f"{pkg.__name__}.models")
        build = importlib.import_module(f"{pkg.__name__}.ops._build")
        _, d, r = pm.flagship()
        report(tree=who, nvcc_seconds={
            "cost flagship": nvcc_seconds(
                build, pkg.make_streaming_moment_cost(d, r).unit(2).source),
            "smc sweep flagship (#3 and #4)": nvcc_seconds(
                build, pkg.make_fused_smc_sweep(*pm.flagship()).unit.source)})
    costs = {"flagship": kt.make_streaming_moment_cost(fdraw, freduce),
             "g-and-k": kt.make_streaming_moment_cost(gdraw, greduce)}
    grid_costs = {k: kt.make_streaming_moment_cost(*m[1:])
                  for k, m in (("flagship", models.flagship()),
                               ("g-and-k", models.g_and_k()))}
    for c in grid_costs.values():
        base = c.unit

        def every_lane(structure, base=base):
            return LG.with_all_lanes(base(structure))

        c.unit = every_lane
    pcosts = {"flagship": old.make_streaming_moment_cost(
        *old.models.flagship()[1:]), "g-and-k": old.make_streaming_moment_cost(
        *old.models.g_and_k()[1:])} if old else {}
    jobs = [_build.start(c.unit(k).source) for c, k in (
        (costs["flagship"], 2), (costs["g-and-k"], 4),
        (grid_costs["flagship"], 2), (grid_costs["g-and-k"], 4))]
    if old:
        for c, k in ((pcosts["flagship"], 2), (pcosts["g-and-k"], 4)):
            old.ops._build.start(c.unit(k).source)
    for job in jobs:
        report(unit=job.lib.name, ptxas=ptxas(job.wait()[2]))
    seed = torch.tensor([17], dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    kernel = "streaming_moment_cost_kernel"
    bad = 0
    for n, model, prior in ((1000, "flagship", fprior),
                            (16384, "flagship", fprior),
                            (25344, "flagship", fprior),
                            (33792, "flagship", fprior),
                            (65536, "flagship", fprior),
                            (131072, "flagship", fprior),
                            (262144, "flagship", fprior),
                            (65536, "g-and-k", gprior),
                            (131072, "g-and-k", gprior),
                            (1 << 20, "flagship", fprior)):
        th = [x.contiguous() for x in prior.sample_tree(gen, n)]
        k = len(th)
        c, gc = costs[model], grid_costs[model]
        out = torch.empty((c.nstats, n), device=dev)

        def run(cost=c, geo=None):
            cost.launch(n, th, seed, out, n, structure=k, geometry=geo)
            return out

        def times(fn):
            return dict(device_ms=CS.device_ms(torch, fn, 20, kernel),
                        queued_ms=CS.queued_ms(torch, fn, 20))

        ref = run().clone()
        default = c.geometry(n, k)
        case = f"#4 {model} {n} x 1000"
        rec = dict(case=case, default=default._asdict(), **times(run))
        if old:
            pc = pcosts[model]

            def parent():
                return torch.stack(pc.moments(tuple(th), seed))

            rec["parent_same_bits"] = CS.same_bits(parent(), ref)
            bad += not rec["parent_same_bits"]
            turns = [times(parent if who == "parent" else run)
                     for who in ("parent", "this", "this", "parent")]
            for key in ("device_ms", "queued_ms"):
                rec[f"parent_{key}"] = [turns[0][key], turns[3][key]]
                rec[f"this_{key}"] = [t[key] for t in turns[1:3]]
        report(**rec)
        for w, t, lanes in cost_grid(quick):
            geo = LG.cost_check(n, w, t, lanes, c.nstats, LG.ALL_LANES)
            ok = CS.same_bits(run(gc, geo), ref)
            bad += not ok
            report(case=case, walkers=w, threads=t, lanes=lanes,
                   same_bits=ok, **times(lambda: run(gc, geo)))
    return bad


def tempered_sweep(torch, kt, old, report):
    """#9's sweep (two launches) at 4096 and 131072, with ``old`` in
    turns with the parent's; returns the count of parent runs whose bits
    differ."""
    from kissabc_tpu_torch import models
    from kissabc_tpu_torch.ops import fused_ais as FA

    dev = torch.device("cuda")
    prior, ll_conj, _, _ = models.conjugate_normal()
    sw = kt.make_fused_tempered_sweep(prior, ll_conj)
    psw = old.make_fused_tempered_sweep(*old.models.conjugate_normal()[:2]) \
        if old else None
    lam = torch.tensor([0.3], device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    for n in (4096, 131072):
        h = n // 2
        th = torch.randn(n, generator=gen, device=dev)
        lp, ll = prior.logpdf(th).float(), ll_conj(th).float()
        words = [FA.uint32_words(gen, 7) for _ in range(2)]
        shifts = [FA.rot_shifts6(w[:6], h) for w in words]
        outs = [torch.empty(h, device=dev) for _ in range(6)]
        oa, ob = ([outs[0]], outs[2], outs[3]), ([outs[1]], outs[4],
                                                 outs[5])

        def this():
            sw.half_words([th[:h]], lp[:h], ll[:h], [th[h:]], words[0], lam,
                          outs=oa)
            sw.half_words([th[h:]], lp[h:], ll[h:], oa[0], words[1], lam,
                          outs=ob)
            return outs

        def parent():
            psw.half([th[:h]], lp[:h], ll[:h], [th[h:]], shifts[0],
                     words[0][6:], lam, outs=oa)
            psw.half([th[h:]], lp[h:], ll[h:], oa[0], shifts[1],
                     words[1][6:], lam, outs=ob)
            return outs

        def times(fn, kernel, per_call):
            return dict(device_ms=CS.device_ms(torch, fn, 50, kernel,
                                               per_call=per_call),
                        queued_ms=CS.queued_ms(torch, fn, 50),
                        events_ms=CS.cuda_ms(torch, fn, 50))

        ref = [x.clone() for x in this()]
        rec = dict(case=f"#9 conjugate {n}, lam 0.3")
        forms = {"this": (this, "fused_tempered_sweep_kernel", 2)}
        if old:
            rec["parent_same_bits"] = CS.same_bits(parent(), ref)
            bad += not rec["parent_same_bits"]
            forms["parent"] = (parent, "fused_tempered_sweep_kernel", 2)
        order = ("parent", "this", "this", "parent") if old else ("this",)
        turns = [(who, times(*forms[who])) for who in order]
        for who in forms:
            for key in ("device_ms", "queued_ms", "events_ms"):
                rec[f"{who}_{key}"] = [t[key] for w, t in turns if w == who]
        report(**rec)
    return bad


def nvcc_seconds(build, text):
    """Seconds of one nvcc of a generated unit on its own, into a fresh
    library (one built before is not reused), then removed."""
    lib = build.generated_path(text)
    fresh = lib.with_name(f"buildcost-{os.getpid()}-{lib.name}")
    src = fresh.with_suffix(".cu")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    seconds = build._Job(fresh, (src,), build.GEN_FLAGS).wait()[1]
    fresh.unlink()
    src.unlink()
    return seconds


def ptxas(log):
    """The registers and spills lines of an nvcc -Xptxas -v log."""
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--kernels", choices=("all", "78", "2", "5", "4", "9"),
                    default="all")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_geometry: no CUDA device", file=sys.stderr)
        return 1
    import kissabc_tpu_torch as kt
    from kissabc_tpu_torch import models
    from kissabc_tpu_torch.core import abcde as AB
    from kissabc_tpu_torch.core import ais as AI
    from kissabc_tpu_torch.ops import fused_abcde as FD
    from kissabc_tpu_torch.ops import lane_groups as LG
    old = load_package(args.parent, "kt_parent") if args.parent else None

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    seed = torch.tensor([2024], dtype=torch.int64, device=dev)
    fprior, fdraw, freduce = models.flagship()
    gprior, gdraw, greduce = models.g_and_k()
    grid = grids(args.quick)
    bad = 0

    def report(**kw):
        print(json.dumps(kw), flush=True)

    # ---- #2, #5 (alone) ---------------------------------------------------
    # a parent from before the repair of the Philox moment sums (ROADMAP
    # C2) gives other bits on Philox on purpose: reported, not counted
    c2 = bool(old) and philox_moments_changed(args.parent)
    report(parent=args.parent, philox_moments_changed=c2)
    if args.kernels == "2":
        return finish(fused_sweep(torch, kt, old, grid["sweep"], report, c2))
    if args.kernels == "5":
        return finish(scan_threads(torch, kt, old, CS.SCAN_THREADS, report))
    if args.kernels == "4":
        return finish(cost_widths(torch, kt, old, args.quick, report))
    if args.kernels == "9":
        return finish(tempered_sweep(torch, kt, old, report))

    # ---- #7 and #8 -------------------------------------------------------
    bad += flagship_ais(torch, kt, old, grid["flagship ais"], report, c2)
    if args.kernels == "78":
        return finish(bad)

    g10 = kt.make_fused_abcde_generation(fprior, fdraw, freduce,
                                         gamma=2.38 / 2.0)
    p10 = old.make_fused_abcde_generation(
        *old.models.flagship(), gamma=2.38 / 2.0) if old else None
    ais = {"flagship": (fprior, fdraw, freduce, 0.005),
           "g-and-k": (gprior, gdraw, greduce, 0.05)}
    sweeps = {name: kt.make_fused_ais_sweep(pr, dr, rc, scale=scale)
              for name, (pr, dr, rc, scale) in ais.items()}
    psweeps = {name: old.make_fused_ais_sweep(
        *(old.models.flagship() if name == "flagship"
          else old.models.g_and_k()), scale=ais[name][3])
        for name in ais} if old else {}
    # the build time of the lanes 2, 8 and 16: each flagship unit as the
    # wrappers build it, then with every lane count, one nvcc at a time
    from kissabc_tpu_torch.ops import _build
    for name, unit in (("abcde", g10.unit),
                       ("ais flagship", sweeps["flagship"].unit)):
        report(unit=name, nvcc_seconds={
            f"lanes {lanes}": nvcc_seconds(_build, u.source)
            for lanes, u in ((LG.LANES, unit),
                             (LG.ALL_LANES, LG.with_all_lanes(unit)))})
    grid10 = kt.make_fused_abcde_generation(fprior, fdraw, freduce,
                                            gamma=2.38 / 2.0)
    grid10.unit = LG.with_all_lanes(grid10.unit)
    grid_sweeps = {name: kt.make_fused_ais_sweep(pr, dr, rc, scale=scale)
                   for name, (pr, dr, rc, scale) in ais.items()}
    for sw in grid_sweeps.values():
        sw.unit = LG.with_all_lanes(sw.unit)
    # every nvcc at once; the ptxas lines of this checkout's units
    jobs = {"abcde": _build.start(g10.unit.source),
            "abcde, every lane count": _build.start(grid10.unit.source)}
    jobs.update({f"ais {k}": _build.start(v.unit.source)
                 for k, v in sweeps.items()})
    jobs.update({f"ais {k}, every lane count": _build.start(v.unit.source)
                 for k, v in grid_sweeps.items()})
    if old:
        for x in [p10] + list(psweeps.values()):
            old.ops._build.start(x.unit.source)
    for name, job in jobs.items():
        report(unit=name, ptxas=ptxas(job.wait()[2]))

    # ---- #10 -------------------------------------------------------------
    cost = kt.make_streaming_moment_cost(fdraw, freduce)
    for n in (16384, 131072):
        th = [x.contiguous() for x in fprior.sample_tree(gen, n)]
        lps = fprior.logpdf_tree(tuple(th)).float()
        ds = cost(tuple(th), gen)
        eps_i = torch.clamp(ds.min(), min=1e-6).expand(n).contiguous()
        order, count = AB.rank_count(ds)
        v = FD.uint32_words(gen, 3 * n).reshape(3, n)
        parents = AB.bases_from_words(v, ds, eps_i, order, count)
        bases = [[x[i] for x in th] for i in parents]
        act = torch.ones(n, device=dev)
        a10 = (th, bases, lps, ds, act, eps_i, seed)
        gate = g10.gate_plain(bases, lps, act, seed)[3]
        ref = g10.run(*a10)
        default = g10.geometry(n)
        rec = dict(case=f"abcde {n}", default=default._asdict(),
                   passes=int(gate.sum()),
                   lane_share_uncompacted=LG.lane_share(
                       gate, LG.check(n, 32, 32, 1, 2)),
                   all_lanes_ms=CS.device_ms(
                       torch, lambda: grid10.run(*a10, geometry=default), 20,
                       "fused_abcde_generation_kernel"))
        if p10 is not None:
            pout = p10.run(*a10)
            rec["parent_same_bits"] = CS.same_bits(pout, ref)
            bad += not rec["parent_same_bits"]
            ts = []
            for who in ("parent", "this", "this", "parent"):
                g = p10 if who == "parent" else g10
                ts.append(CS.device_ms(torch, lambda g=g: g.run(*a10), 20,
                                       "fused_abcde_generation_kernel"))
            rec["parent_ms"], rec["this_ms"] = [ts[0], ts[3]], ts[1:3]
        report(**rec)
        for w, t, lanes in grid[f"abcde {n}"]:
            geo = LG.check(n, w, t, lanes, 2, LG.ALL_LANES)
            out = grid10.run(*a10, geometry=geo)
            ok = CS.same_bits(out, ref)
            bad += not ok
            report(case=f"abcde {n}", walkers=w, threads=t, lanes=lanes,
                   same_bits=ok, ms=CS.device_ms(
                       torch, lambda: grid10.run(*a10, geometry=geo), 20,
                       "fused_abcde_generation_kernel"),
                   queued_ms=CS.queued_ms(
                       torch, lambda: grid10.run(*a10, geometry=geo), 20),
                   lane_share=LG.lane_share(gate, geo),
                   blocks_per_sm=grid10.occupancy(geo))

    # ---- #6 --------------------------------------------------------------
    n, h = 131072, 65536
    sh = torch.tensor([5, 77, 1000, 3, 40000, 65001, 11, 2, 65000, 9, 123,
                       4567], dtype=torch.int64, device=dev) % h
    # the halves' words whose rot_shifts6 at h = 65536 are sh: a tree
    # whose kernel takes words gets them, a parent that takes shifts sh
    wh = torch.tensor([5, 77, 999, 3, 39999, 64999, 11, 2, 64999, 9, 122,
                       4565], dtype=torch.int64, device=dev)
    words6 = [torch.cat([wh[k:k + 6], seed]) for k in (0, 6)]
    flagship_cost = kt.make_flagship_cost_batched()
    starts = {}
    th0 = fprior.sample_tree(gen, n)
    lds0 = kt.ApproxKernelizedPosterior(
        fprior, flagship_cost, 0.005, cost_vectorized=True).loglike_batch(
        th0, gen)
    starts["flagship"] = ([x.contiguous() for x in th0], lds0,
                          (fprior, fdraw, freduce, 0.005))
    model_g = kt.ApproxKernelizedPosterior(
        gprior, kt.make_streaming_moment_cost(gdraw, greduce), 0.05,
        cost_vectorized=True)
    g3 = torch.Generator(device=dev).manual_seed(3)
    thg, ldg, _ = AI._init_ensemble(model_g, g3, n, 100)
    starts["g-and-k"] = ([x.contiguous() for x in thg], ldg,
                         (gprior, gdraw, greduce, 0.05))
    # the states the sweeps of a sample run meet: 100 fused sweeps from
    # the init of sample(key=0) (flagship, tools/profile_torch_ais.py) and
    # from g-and-k's init, with the share of half A's walkers inside the
    # prior along the way
    g0 = torch.Generator(device=dev).manual_seed(0)
    model_k = kt.ApproxKernelizedPosterior(fprior, flagship_cost, 0.005,
                                           cost_vectorized=True)
    thk, ldk, _ = AI._init_ensemble(model_k, g0, n, 100)
    for name, (th, ld) in (("flagship", (thk, ldk)), ("g-and-k", (thg, ldg))):
        sw = sweeps[name]
        g7 = torch.Generator(device=dev).manual_seed(7)
        shares = {}
        for k in range(101):
            if k in (0, 1, 5, 10, 25, 50, 100):
                shares[k] = float(sw.proposal_plain(
                    [x[:h] for x in th], [x[h:] for x in th], sh[:6],
                    seed)[3].float().mean())
            if k < 100:
                th, ld = sw(g7, th, ld)
        report(case=f"ais {name} inside share by sweep", shares=shares)
        starts[f"{name} after 100 sweeps"] = (
            [x.contiguous() for x in th], ld, None)
    for name, (th, (lp, ll), _) in starts.items():
        model = name.split()[0]
        sw, psw = sweeps[model], psweeps.get(model)
        lp, ll = lp.contiguous(), ll.contiguous()
        outs = ([torch.empty_like(x) for x in th], torch.empty_like(lp),
                torch.empty_like(ll))

        def sweep(s=sw, geo=None, keep=True):
            oa = ([o[:h] for o in outs[0]], outs[1][:h], outs[2][:h])
            ob = ([o[h:] for o in outs[0]], outs[1][h:], outs[2][h:])
            kw = {} if geo is None else {"geometry": geo}
            for k, (sl, comp, o) in enumerate((
                    (slice(0, h), [x[h:] for x in th], oa),
                    (slice(h, n), oa[0], ob))):
                args = ([x[sl] for x in th], lp[sl], ll[sl], comp)
                if hasattr(s, "half_words"):
                    s.half_words(*args, words6[k], outs=o, **kw)
                else:
                    s.half(*args, sh[6 * k:6 * k + 6], seed, outs=o, **kw)
            return [x.clone() for x in flat(outs)] if keep else None

        ref = sweep()
        # the walkers inside the prior in both halves: half B proposes
        # against the updated half A
        inside = torch.cat([
            sw.proposal_plain([x[:h] for x in th], [x[h:] for x in th],
                              sh[:6], seed)[3],
            sw.proposal_plain([x[h:] for x in th], [x[:h] for x in ref[:2]],
                              sh[6:], seed)[3]])
        default = sw.geometry(h)
        gsw = grid_sweeps[model]
        rec = dict(case=f"ais {name}", default=default._asdict(),
                   inside=int(inside.sum()),
                   lane_share_uncompacted=LG.lane_share(
                       inside, LG.check(n, 32, 32, 1, 2)),
                   all_lanes_ms=CS.device_ms(
                       torch, lambda: sweep(gsw, default), 20,
                       "fused_ais_sweep_kernel", per_call=2))
        if psw is not None:
            rec["parent_same_bits"] = CS.same_bits(sweep(psw), ref)
            bad += not rec["parent_same_bits"]
            ts = []
            for who in ("parent", "this", "this", "parent"):
                s = psw if who == "parent" else sw
                ts.append(CS.device_ms(torch, lambda s=s: sweep(s), 20,
                                       "fused_ais_sweep_kernel", per_call=2))
            rec["parent_ms"], rec["this_ms"] = [ts[0], ts[3]], ts[1:3]
        report(**rec)
        for w, t, lanes in grid["ais"]:
            geo = LG.check(h, w, t, lanes, sw.nstats, LG.ALL_LANES)
            ok = CS.same_bits(sweep(gsw, geo), ref)
            bad += not ok
            report(case=f"ais {name}", walkers=w, threads=t, lanes=lanes,
                   same_bits=ok, ms=CS.device_ms(
                       torch, lambda: sweep(gsw, geo), 20,
                       "fused_ais_sweep_kernel", per_call=2),
                   queued_ms=CS.queued_ms(
                       torch, lambda: sweep(gsw, geo, keep=False), 20),
                   lane_share=LG.lane_share(inside, LG.check(
                       n, w, t, lanes, sw.nstats, LG.ALL_LANES)),
                   blocks_per_sm=gsw.occupancy(geo))

    return finish(bad)


def finish(bad):
    """The last line: the card, its power limit and the unequal count."""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(card=card, unequal_geometries=bad)))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
