#!/usr/bin/env python3
"""Smoke run of kissabc_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels with nvcc — ``kissabc_tpu_torch/csrc/flagship.cu``
and, one nvcc each and all at once, the generic kernels of
``csrc/generic.cuh`` and the scan kernel of ``csrc/scan.cuh`` with the
user models the script defines compiled into them — holds each kernel
against its plain PyTorch version on the card, and drives the port's
paths:

- slice 1: ``smc`` on the flagship README model through the flagship
  cost kernel at 1000 and 2**20 particles, and the fused flagship sweep
  at 131072 walkers;
- slice 2: ``smc(..., sweep_fused=make_fused_smc_sweep(...))`` with
  ``make_streaming_moment_cost`` on the same model written as a user
  model, at 1000 and 2**20 particles (the JAX bench's ``smc-fused-generic``
  and ``smc-1m`` rows), through the generic cost and sweep kernels;
- slice 3: ``smc`` with ``make_streaming_scan_cost`` on the AR(1) model
  of the JAX bench's ``streaming-scan`` row at 131072 particles x 1000
  steps, through the scan kernel; ``smc`` with the README model's
  per-walker cost ``cost(theta, gen)`` (the JAX default form) at 1000
  particles; and ``smc_stepped`` on the generic fused path, run through
  and run stopped at its first checkpoint and resumed;

and checks each posterior against its limits. Every
phase prints one line with its result and seconds; any failed check
raises and the script exits non-zero. The line before the last is one
JSON object with every kernel's launches on its path, its error against
its plain version and its times; the last line is
``{"ok": true, "device": {...}}``.

Needs one CUDA card and nvcc; imports nothing of JAX. Without a card, or
run from a directory without the package, it exits 1 and prints no result.
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
SCRIPT_LIMIT_S = 1000    # whole run, build included (the limit is 1200 s)
FULL_SMC_LIMIT_S = 420   # the 2**20-particle smc run alone
H100_F32_OPS = 67e12     # float32 outside the tensor cores, H100 SXM
H100_BYTES = 3.35e12     # HBM3, H100 SXM
EPSTOL = 0.011113        # README.md:84 of the reference


class Timeout(Exception):
    pass


def _alarm(seconds):
    def handler(signum, frame):
        raise Timeout(f"wall-clock guard: over {seconds} s")
    signal.signal(signal.SIGALRM, handler)
    signal.alarm(seconds)


def say(line):
    print(line, flush=True)


class Phase:
    """Prints ``[phase] name: result (seconds)`` when the block ends;
    an exception inside propagates and ends the run."""

    def __init__(self, name):
        self.name, self.result = name, ""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        status = "FAILED" if exc_type else "ok"
        say(f"[phase] {self.name}: {status} {self.result} ({dt:.2f} s)")
        return False


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(torch, fn, reps, warmup=2):
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(work):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate (integer operations are counted at
    the float32 rate, which no slower integer unit can beat)."""
    nbytes, ops = work
    t_bytes, t_ops = nbytes / H100_BYTES, ops / H100_F32_OPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def assert_close(torch, got, want, what, rtol=2e-4, atol=2e-5):
    """The JAX golden tolerance of tests/test_pallas.py:104."""
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    ok = torch.isclose(got, want, rtol=rtol, atol=atol)
    check(bool(ok.all()), f"{what}: {int((~ok).sum())} values outside "
          f"rtol={rtol}, atol={atol}; max abs err {max_err(got, want)}")
    return max_err(got, want)


def compare_sweeps(torch, got, want, eps, what, band=1e-5, cost_atol=2e-5):
    """Kernel vs plain sweep on the same inputs, outputs (theta leaves,
    xs, lps, commit): commit masks equal except where a cost lies within
    ``band`` of eps (an uncommitted walker's xs is its input, so the
    committing side's cost is the one looked at); committed leaves and
    lps within the golden tolerance, costs within ``cost_atol``.
    Returns (max abs err, borderline walkers)."""
    gth, gxs, glps, gcm = got
    wth, wxs, wlps, wcm = want
    border = ((gxs - eps).abs() < band) | ((wxs - eps).abs() < band)
    differ = gcm != wcm
    check(bool((~differ | border).all()),
          f"{what}: commit masks differ on {int((differ & ~border).sum())}"
          " walkers away from eps")
    both = gcm & wcm
    err = assert_close(torch, gxs[both], wxs[both], f"{what} committed cost",
                       atol=cost_atol)
    for k, (g, w) in enumerate(zip(list(gth) + [glps], list(wth) + [wlps])):
        err = max(err, assert_close(torch, g[both], w[both],
                                    f"{what} committed output {k}"))
    return err, int(differ.sum())


def flagship_outputs(out):
    """The fused flagship sweep's (mu, sigma, xs, lps, commit) in the
    (theta leaves, xs, lps, commit) form of ``compare_sweeps``."""
    return (out[:2],) + tuple(out[2:])


def check_untouched(torch, inputs, outs, commit, what):
    """Walkers that do not commit keep their inputs bit for bit."""
    keep = ~commit
    for x, o, name in zip(inputs, outs, ("mu", "sigma", "xs", "lps")):
        check(bool(torch.equal(x[keep], o[keep])),
              f"{what}: uncommitted {name} changed")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.exists(os.path.join(HERE, "kissabc_tpu_torch", "csrc",
                                       "flagship.cu")):
        print("chip_smoke: kissabc_tpu_torch not found beside the script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    _alarm(SCRIPT_LIMIT_S)
    t_start = time.perf_counter()

    import kissabc_tpu_torch as kt
    from kissabc_tpu_torch import models
    from kissabc_tpu_torch.ops import _build
    from kissabc_tpu_torch.ops import fused_smc as F
    from kissabc_tpu_torch.ops import kernels as K
    from kissabc_tpu_torch.ops import scan as SC
    from kissabc_tpu_torch.ops import streaming as S

    def reset_counts():
        for module in (K, S, F, SC):
            module.reset_launch_counts()

    def counts():
        return {**K.launches, **S.launches, **F.launches, **SC.launches}

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    with Phase("device") as ph:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout else "n/a"
        say(card)
        ph.result = (f"{kind}, {count} device(s), torch {torch.__version__},"
                     f" CUDA {torch.version.cuda}")

    # the user models of the generic kernels (traced and emitted here)
    fprior, fdraw, freduce = models.flagship()
    gprior, gdraw, greduce = models.g_and_k()

    def linear_reduce(th, m):   # no cancellation, as the JAX golden test
        return m[0] + 10.0 * m[1]

    def ecdf(probes):
        return [lambda x, t=t: (x < t).to(torch.float32) for t in probes]

    def ecdf_reduce(th, m):
        return (torch.square(m[0] - 0.25) + torch.square(m[1] - 0.5)
                + torch.square(m[2] - 0.75))

    costs = {   # name: (cost, theta structure)
        "flagship": (kt.make_streaming_moment_cost(fdraw, freduce), 2),
        "flagship-stub": (kt.make_streaming_moment_cost(
            fdraw, freduce, bits="stub"), 2),
        "ecdf-ragged-stub": (kt.make_streaming_moment_cost(
            fdraw, lambda th, m: m[0],
            stats=ecdf((1.95, 2.0, 2.05)) + [torch.ones_like], ndraws=700,
            bits="stub"), 2),
        "uniform-stub": (kt.make_streaming_moment_cost(
            lambda th, u: -torch.log1p(-u) / th[0], lambda th, m: m[0],
            noise="uniform", bits="stub"), 1),
        "g-and-k": (kt.make_streaming_moment_cost(gdraw, greduce), 4),
    }
    sweeps = {
        "flagship": kt.make_fused_smc_sweep(fprior, fdraw, freduce),
        "linear-stub": kt.make_fused_smc_sweep(fprior, fdraw, linear_reduce,
                                               bits="stub"),
        "g-and-k-ecdf-stub": kt.make_fused_smc_sweep(
            gprior, gdraw, ecdf_reduce, stats=ecdf((2.0, 3.0, 4.0)),
            ndraws=700, bits="stub"),
    }
    # the scan models (slice 3); stub and hw, and any nsteps, share a unit
    aprior, astep, ainit, areduce = models.ar1()
    _, sstep, sinit, sobserve, sreduce, sseries = models.sir()

    def two_leaf_step(th, xt, eps, t):   # tests/test_scan_cost.py:151-168
        x, acc = xt
        x = x + th[0] * 0.1 + eps
        return (x, 0.9 * acc + 0.1 * torch.abs(x))

    scans = {   # name: (cost, theta structure)
        "ar1": (kt.make_streaming_scan_cost(astep, ainit, areduce,
                                            nsteps=1000), 2),
        "ar1-odd-stub": (kt.make_streaming_scan_cost(
            astep, ainit, lambda th, m: m[0] + 10.0 * m[1], nsteps=257,
            bits="stub"), 2),
        "sir-stub": (kt.make_streaming_scan_cost(
            sstep, sinit, sreduce, observe=sobserve, series=sseries,
            nsteps=2 * models.SIR_DAYS, sub_rows=16, bits="stub"), 2),
        "two-leaf-stub": (kt.make_streaming_scan_cost(
            two_leaf_step, lambda th: (th[0], torch.abs(th[0])),
            lambda th, m: m[0], observe=lambda th, xt, t, obs: (xt[1],),
            nsteps=64, bits="stub"), 1),
    }
    units = {}   # generated source -> names (stub and hw share a unit)
    for name, (c, k) in costs.items():
        units.setdefault(c.unit(k).source, []).append(f"cost {name}")
    for name, sw in sweeps.items():
        units.setdefault(sw.unit.source, []).append(f"sweep {name}")
    for name, (c, k) in scans.items():
        units.setdefault(c.unit(k).source, []).append(f"scan {name}")

    ptxas = {}   # unit names -> ptxas lines

    def ptxas_lines(log, prefix):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                ptxas.setdefault(prefix, []).append(line.strip())
                say(f"  ptxas {prefix}: {line.strip()}")

    with Phase("build") as ph:
        # every nvcc starts now: the flagship source and each generated unit
        jobs = [_build.start()] + [_build.start(text) for text in units]
        lib_path, build_s, log = jobs[0].wait()
        ptxas_lines(log, "flagship")
        _build.load()
        ph.result = f"{lib_path.name} compiled in {build_s:.2f} s"

    with Phase("build-generic") as ph:
        slowest = 0.0
        for (text, names), job in zip(units.items(), jobs[1:]):
            path, secs, log = job.wait()
            ptxas_lines(log, "/".join(names))
            _build.load_generated(text)
            slowest = max(slowest, secs)
        ph.result = (f"{len(units)} generated units (generic and scan), the "
                     f"slowest compiled in {slowest:.2f} s, in parallel with "
                     "flagship.cu")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def uniform(n, lo, hi):
        return torch.rand(n, generator=gen, device=dev) * (hi - lo) + lo

    # ---- 3: kernels vs their plain versions on the stub stream ----------
    with Phase("kernel-vs-plain-stub") as ph:
        n, nd = 65536, 1000
        mu, sg = uniform(n, 1.0, 3.0), uniform(n, 0.01, 0.1)
        errs = []
        for nn in (n, 1000):
            kw = dict(ndraws=nd, bits="stub", block=1024, chunk=512,
                      walker_tiles=8)
            got = K.normal_summary_cost(mu[:nn], sg[:nn], 42, **kw)
            want = K.normal_summary_cost_plain(mu[:nn], sg[:nn], 42, **kw)
            errs.append(assert_close(torch, got, want,
                                     f"normal_summary_cost stub n={nn}"))
        dmu, dsg = uniform(n, -0.5, 0.5), uniform(n, -0.02, 0.02)
        xs = torch.ones(n, device=dev)
        lps = torch.full((n,), -3.0, device=dev)
        skw = dict(ndraws=nd, bits="stub", block=2048, chunk=512)
        got = K.fused_sweep(mu, sg, dmu, dsg, xs, lps, 0.5, 7, **skw)
        consts = K.fused_sweep_constants(
            max_stretch=2.0, mu_lo=1.0, mu_hi=3.0, sg_sigma=0.05, sg_lo=0.0,
            sg_hi=100.0)
        want = K.fused_sweep_plain(mu, sg, dmu, dsg, xs, lps, 0.5, 7,
                                   consts=consts, target_mu=2.0,
                                   target_sd=0.04, sd_weight=50.0, **skw)
        err, border = compare_sweeps(torch, flagship_outputs(got),
                                     flagship_outputs(want), 0.5,
                                     "fused_sweep stub")
        check_untouched(torch, (mu, sg, xs, lps), got[:4], got[4],
                        "fused_sweep stub")
        acc = int(got[4].sum())
        check(0 < acc < n, f"fused_sweep stub accepted {acc} of {n}")
        ph.result = (f"cost max|err| {max(errs):.3g}; sweep max|err| "
                     f"{err:.3g}, {acc} commits, {border} borderline")

    with Phase("no-write-past-n") as ph:
        # buffers longer than n, filled with sentinels: a launch over n
        # walkers must leave everything past n as it was
        n, extra = 1000, 1024

        def buf(value, dtype=torch.float32):
            return torch.full((n + extra,), value, dtype=dtype, device=dev)

        seed = torch.tensor([5], dtype=torch.int64, device=dev)
        out = buf(float("nan"))
        K.launch_normal_summary_cost(
            n, buf(2.0), buf(0.04), seed, out, ndraws=nd, target_mu=2.0,
            target_sd=0.04, sd_weight=50.0, block=1024, chunk=512,
            bits="hw", walker_tiles=8)
        outs = [buf(float("nan")) for _ in range(4)] + [buf(7, torch.uint8)]
        K.launch_fused_sweep(
            n, (buf(2.0), buf(0.04), buf(0.01), buf(0.001), buf(1.0),
                buf(0.0)), outs, torch.tensor([0.5], device=dev), seed,
            consts=consts, ndraws=nd, target_mu=2.0, target_sd=0.04,
            sd_weight=50.0, block=2048, chunk=512, bits="hw")
        torch.cuda.synchronize()
        for o in [out] + outs[:4]:
            check(bool(torch.isfinite(o[:n]).all()), "a walker < n unwritten")
            check(bool(torch.isnan(o[n:]).all()), "a walker >= n written")
        check(bool((outs[4][:n] <= 1).all() & (outs[4][n:] == 7).all()),
              "commit mask written past n")
        ph.result = f"n={n} in buffers of {n + extra}: tails untouched"

    # ---- generic kernels vs their plain versions on the stub stream -------
    with Phase("generic-vs-plain-stub") as ph:
        n = 65536
        fth = (uniform(n, 1.0, 3.0), uniform(n, 0.01, 0.1))
        gth = gprior.sample_tree(gen, n)
        errs = {}
        for name, th in (("flagship-stub", fth), ("ecdf-ragged-stub", fth),
                         ("uniform-stub", fth[:1]), ("g-and-k", gth)):
            c = costs[name][0]
            got, want = c.moments(th, 42), c.moments_plain(th, 42)
            errs[f"cost {name}"] = max(
                assert_close(torch, g, w, f"streaming cost {name} moment {p}")
                for p, (g, w) in enumerate(zip(got, want)))
            if name == "ecdf-ragged-stub":   # the boundary mask: E[1] = 1
                check(bool((got[-1] == 1.0).all()), "E[1] != 1 (mask)")
        commits = {}
        for name, th in (("linear-stub", fth), ("g-and-k-ecdf-stub", gth)):
            sw = sweeps[name]
            th = [x.contiguous() for x in th]
            lps = sw.prior.logpdf_tree(tuple(th))
            xs = torch.full((n,), 1e6, device=dev)
            alive = torch.rand(n, generator=gen, device=dev) < 0.9
            r1, r2, seed = 5, n // 2 + 3, 12345
            rs = torch.tensor([r1, r2, seed], dtype=torch.int64, device=dev)
            probe = F.fused_smc_sweep_plain(
                sw, th, xs, lps, torch.ones_like(alive), 1e6, False, r1, r2,
                seed)
            eps = float(probe[1][probe[3]].median())
            got = sw.run(th, xs, lps, alive, eps, False, rs)
            want = F.fused_smc_sweep_plain(sw, th, xs, lps, alive, eps,
                                           False, r1, r2, seed)
            errs[f"sweep {name}"], border = compare_sweeps(
                torch, got, want, eps, f"fused_smc_sweep {name}")
            check_untouched(torch, th + [xs, lps], list(got[0]) + list(
                got[1:3]), got[3], f"fused_smc_sweep {name}")
            acc = int(got[3].sum())
            check(0 < acc < n, f"sweep {name} accepted {acc} of {n}")
            check(not bool(got[3][~alive].any()), "a dead walker committed")
            commits[name] = (acc, border)
        ph.result = (f"max|err| {max(errs.values()):.3g} "
                     f"({json.dumps(errs)}); commits, borderline {commits}")

    with Phase("generic-no-write-past-n") as ph:
        n, extra = 1000, 1024

        def buf(value, dtype=torch.float32):
            return torch.full((n + extra,), value, dtype=dtype, device=dev)

        seed = torch.tensor([5], dtype=torch.int64, device=dev)
        out = torch.full((2, n + extra), float("nan"), device=dev)
        costs["flagship"][0].launch(n, [buf(2.0), buf(0.04)], seed, out,
                                    n + extra, structure=2)
        outs = ([buf(float("nan")), buf(float("nan"))], buf(float("nan")),
                buf(float("nan")), buf(7, torch.uint8))
        ins = (buf(1.0), buf(0.0), buf(True, torch.bool),
               torch.tensor([0.5], device=dev),
               torch.tensor([False], device=dev))
        rs = torch.tensor([3, 17, 5], dtype=torch.int64, device=dev)
        sweeps["flagship"].launch(n, [buf(2.0), buf(0.04)], ins, rs, outs)
        torch.cuda.synchronize()
        for o in list(out) + outs[0] + list(outs[1:3]):
            check(bool(torch.isfinite(o[:n]).all()), "a walker < n unwritten")
            check(bool(torch.isnan(o[n:]).all()), "a walker >= n written")
        check(bool((outs[3][:n] <= 1).all() & (outs[3][n:] == 7).all()),
              "commit mask written past n")
        ph.result = f"n={n} in buffers of {n + extra}: tails untouched"

    # ---- the scan kernel vs its plain version on the stub stream ---------
    with Phase("scan-stub") as ph:
        n = 65536
        th2 = (uniform(n, 0.5, 2.0), uniform(n, 0.5, 1.5))
        sir_th = (uniform(n, 0.05, 0.8), uniform(n, 0.02, 0.4))
        results = {}
        for name, th in (("ar1-odd-stub", th2), ("sir-stub", sir_th),
                         ("two-leaf-stub", th2[:1])):
            c = scans[name][0]
            seed = torch.tensor([42], dtype=torch.int64, device=dev)
            got, want = c.means(th, seed), c.means_plain(th, seed)
            err = max(assert_close(torch, g, w, f"scan {name} mean {p}")
                      for p, (g, w) in enumerate(zip(got, want)))
            unequal = sum(int((g != w).sum()) for g, w in zip(got, want))
            results[name] = (err, unequal)
        # sentinel tails: a launch over n walkers leaves everything past n
        nn, extra = 1000, 1024
        for name, k in (("ar1-odd-stub", 2), ("sir-stub", 2)):
            c = scans[name][0]
            ths = [torch.full((nn + extra,), v, device=dev)
                   for v in (0.5, 0.1)[:k]]
            out = torch.full((c.unit(k).nstats, nn + extra), float("nan"),
                             device=dev)
            c.launch(nn, ths, torch.tensor([5], dtype=torch.int64,
                                           device=dev), out, nn + extra,
                     structure=k)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out[:, :nn]).all()),
                  f"scan {name}: a walker < n unwritten")
            check(bool(torch.isnan(out[:, nn:]).all()),
                  f"scan {name}: a walker >= n written")
        ph.result = ("max|err|, unequal values: " + json.dumps(results)
                     + f"; n={nn} in buffers of {nn + extra}: tails untouched")

    # ---- 4: Philox statistics ----------------------------------------------
    with Phase("philox-statistics") as ph:
        n = 131072
        mu = torch.full((n,), 2.0, device=dev)
        sg = torch.full((n,), 0.04, device=dev)
        c3 = K.normal_summary_cost(mu, sg, 3)
        c4 = K.normal_summary_cost(mu, sg, 4)
        c3b = K.normal_summary_cost(mu, sg, 3)
        m = float(c3.mean())
        check(bool(torch.isfinite(c3).all()), "non-finite Philox costs")
        # E[cost] = E hypot(N(0, 0.04/sqrt(1000)), 50 N(0, 0.04/sqrt(2000)))
        check(abs(m - 0.0357) < 0.004, f"mean cost {m} not 0.0357 +- 0.004")
        check(not torch.allclose(c3, c4), "seeds 3 and 4 gave equal costs")
        check(bool(torch.equal(c3, c3b)), "seed 3 did not repeat")
        ph.result = f"mean cost {m:.5f} at mu=2, sigma=0.04"

    prior = kt.Factored(kt.Uniform(1, 3), kt.TruncatedNormal(0, 0.05, 0, 100))
    cost = kt.make_flagship_cost_batched()

    def run_smc(nparticles, **kw):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = kt.smc(prior, cost, cost_vectorized=True,
                     nparticles=nparticles, epstol=EPSTOL, max_iters=2000,
                     key=2, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        mu_p, sg_p = res.P
        check(res.eps <= EPSTOL, f"eps {res.eps} > {EPSTOL}")
        check(abs(mu_p.mean() - 2.0) < 0.05, f"mean mu {mu_p.mean()}")
        check(abs(sg_p.mean() - 0.0401) < 0.005, f"mean sigma {sg_p.mean()}")
        check(launched["normal_summary_cost"] > 0,
              "smc did not launch the normal_summary_cost kernel")
        check(launched["streaming_moment_cost"] == launched[
            "fused_smc_sweep"] == 0, "the flagship path launched a generic "
              "kernel")
        return res, wall, launched

    # ---- 5/6: the main path ---------------------------------------------
    with Phase("smc-parity") as ph:
        res, wall, launched = run_smc(1000)
        ph.result = (f"n=1000 iterations {res.iterations} eps {res.eps:.6f}"
                     f" mu {res.P[0].mean():.5f} sigma {res.P[1].mean():.5f}"
                     f" wall {wall:.3f} s launches {launched}")

    with Phase("smc-full") as ph:
        _alarm(FULL_SMC_LIMIT_S)
        res, wall, launched = run_smc(1 << 20, min_r_ess=0.5)
        _alarm(max(1, int(SCRIPT_LIMIT_S - (time.perf_counter() - t_start))))
        smc_launches = launched["normal_summary_cost"]
        ph.result = (f"n=2^20 iterations {res.iterations} eps {res.eps:.6f}"
                     f" mu {res.P[0].mean():.5f} sigma {res.P[1].mean():.5f}"
                     f" wall {wall:.3f} s launches {launched}")

    def run_generic_smc(nparticles, **kw):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = kt.smc(fprior, costs["flagship"][0], cost_vectorized=True,
                     sweep_fused=sweeps["flagship"], nparticles=nparticles,
                     epstol=EPSTOL, max_iters=2000, key=2, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        mu_p, sg_p = res.P
        check(res.eps <= EPSTOL, f"eps {res.eps} > {EPSTOL}")
        check(abs(mu_p.mean() - 2.0) < 0.05, f"mean mu {mu_p.mean()}")
        check(abs(sg_p.mean() - 0.0401) < 0.005, f"mean sigma {sg_p.mean()}")
        check(launched["streaming_moment_cost"] > 0,
              "smc did not launch the streaming_moment_cost kernel")
        check(launched["fused_smc_sweep"] > 0,
              "smc did not launch the fused_smc_sweep kernel")
        check(launched["normal_summary_cost"] == launched["fused_sweep"] == 0,
              "the generic path launched a flagship kernel")
        return res, wall, launched

    with Phase("smc-fused-generic") as ph:
        res, wall, launched = run_generic_smc(1000)
        fused_1000 = res
        ph.result = (f"n=1000 iterations {res.iterations} eps {res.eps:.6f}"
                     f" mu {res.P[0].mean():.5f} sigma {res.P[1].mean():.5f}"
                     f" wall {wall:.3f} s launches {launched}")

    with Phase("smc-1m-generic") as ph:
        _alarm(FULL_SMC_LIMIT_S)
        res, wall, launched = run_generic_smc(1 << 20, min_r_ess=0.5)
        _alarm(max(1, int(SCRIPT_LIMIT_S - (time.perf_counter() - t_start))))
        generic_launches = launched
        ph.result = (f"n=2^20 iterations {res.iterations} eps {res.eps:.6f}"
                     f" mu {res.P[0].mean():.5f} sigma {res.P[1].mean():.5f}"
                     f" wall {wall:.3f} s launches {launched}")

    # ---- slice 3: smc_stepped, the scan cost, the per-walker cost --------
    with Phase("smc-stepped-resume") as ph:
        kw = dict(cost_vectorized=True, sweep_fused=sweeps["flagship"],
                  nparticles=1000, epstol=EPSTOL, key=2,
                  checkpoint_every=10)
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts()
            t0 = time.perf_counter()
            whole = kt.smc_stepped(fprior, costs["flagship"][0],
                                   checkpoint_path=os.path.join(tmp, "w.npz"),
                                   max_iters=2000, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = counts()
            path = os.path.join(tmp, "r.npz")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                cut = kt.smc_stepped(fprior, costs["flagship"][0],
                                     checkpoint_path=path, max_iters=10, **kw)
            check(cut.iterations == 10, f"the cut run ran {cut.iterations}")
            log = kt.IterLog(enabled=False)
            resumed = kt.smc_stepped(fprior, costs["flagship"][0],
                                     checkpoint_path=path, resume=True,
                                     log=log, max_iters=2000, **kw)
        check(log.records[0]["iteration"] == 11, "resume did not start at 11")
        for name, r in (("resumed", resumed), ("smc", fused_1000)):
            check(bool((whole.C == r.C).all()) and whole.eps == r.eps
                  and whole.iterations == r.iterations,
                  f"smc_stepped differs from the {name} run: iterations "
                  f"{whole.iterations} vs {r.iterations}, eps {whole.eps} vs "
                  f"{r.eps}, {int((whole.C != r.C).sum())} costs differ")
        check(launched["streaming_moment_cost"] > 0
              and launched["fused_smc_sweep"] > 0,
              f"smc_stepped missed a generic kernel: {launched}")
        check(whole.eps <= EPSTOL, f"eps {whole.eps} > {EPSTOL}")
        ph.result = (f"n=1000 iterations {whole.iterations} eps "
                     f"{whole.eps:.6f}; resumed from iteration 10: C, eps, "
                     f"iterations bit-equal, and equal to smc; wall "
                     f"{wall:.3f} s launches {launched}")

    with Phase("smc-scan-ar1") as ph:
        n, nsteps = 131072, 1000
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = kt.smc(aprior, scans["ar1"][0], nparticles=n,
                     cost_vectorized=True, epstol=0.15, key=9)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        scan_launches = launched["streaming_scan_cost"]
        mu_p, s_p = res.P
        # the limits of tests/test_scan_cost.py:187-189
        check(abs(mu_p.mean() - 1.0) < 0.15, f"mean mu {mu_p.mean()}")
        check(abs(s_p.mean() - 1.0) < 0.25, f"mean s {s_p.mean()}")
        check(res.eps <= 0.15, f"eps {res.eps} > 0.15")
        check(scan_launches > 0, "smc did not launch streaming_scan_cost")
        check(sum(launched.values()) == scan_launches,
              f"the scan path launched another kernel: {launched}")
        ph.result = (f"n={n} x {nsteps} steps iterations {res.iterations} "
                     f"eps {res.eps:.6f} mu {mu_p.mean():.5f} s "
                     f"{s_p.mean():.5f} wall {wall:.3f} s launches {launched}")

    with Phase("smc-perwalker") as ph:
        def readme_cost(theta, g):   # __graft_entry__.py:17-22, per walker
            mu, sigma = theta
            x = mu + sigma * torch.randn(1000, generator=g, device=g.device)
            return torch.hypot(x.mean() - 2.0,
                               (x.std(correction=0) - 0.04) * 50)

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = kt.smc(prior, readme_cost, nparticles=1000, epstol=EPSTOL,
                     key=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mu_p, sg_p = res.P
        check(res.eps <= EPSTOL, f"eps {res.eps} > {EPSTOL}")
        check(abs(mu_p.mean() - 2.0) < 0.05, f"mean mu {mu_p.mean()}")
        check(abs(sg_p.mean() - 0.0401) < 0.005, f"mean sigma {sg_p.mean()}")
        ph.result = (f"n=1000 iterations {res.iterations} eps {res.eps:.6f}"
                     f" mu {mu_p.mean():.5f} sigma {sg_p.mean():.5f}"
                     f" wall {wall:.3f} s (torch.func.vmap, no kernel of "
                     f"the port: launches {counts()})")

    with Phase("streaming-gk") as ph:
        n, nd = 131072, 1000
        c = costs["g-and-k"][0]
        th = gprior.sample_tree(gen, n)
        seed = torch.tensor([7], dtype=torch.int64, device=dev)
        got, want = c.moments(th, seed), c.moments_plain(th, seed)
        err = max(assert_close(torch, g, w, f"g-and-k moment {p}")
                  for p, (g, w) in enumerate(zip(got, want)))
        ms = cuda_ms(torch, lambda: c.moments(th, seed), 10)
        ph.result = (f"n={n} x {nd} draws: {ms:.3f} ms, "
                     f"{n * nd / (ms / 1e3):.4g} draws/s, max|err| {err:.3g}")

    # ---- 7: the fused flagship sweep ------------------------------------
    with Phase("fused-sweep") as ph:
        n, steps = 131072, 100
        step = kt.make_fused_flagship_sweep(n)
        mu, sg = prior.sample_tree(gen, n)
        xs = torch.ones(n, device=dev)
        lps = torch.zeros(n, device=dev)
        th, x_, lp = (mu, sg), xs, lps
        th, x_, lp, _ = step(gen, th, x_, lp, 0.5)  # warm-up
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accepted = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(steps):
            th, x_, lp, acc = step(gen, th, x_, lp, 0.5)
            accepted += acc
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        sweep_launches = K.launches["fused_sweep"]
        check(sweep_launches == steps, f"fused sweep launched "
              f"{sweep_launches} kernels in {steps} steps")
        check(bool(torch.isfinite(x_).all() & (x_ <= 1.0).all()),
              "fused sweep costs not finite or above the start")
        ph.result = (f"{steps} steps at n={n}: {n * steps / dt:.4g} "
                     f"updates/s, accept fraction "
                     f"{int(accepted) / (n * steps):.4f}")

    # ---- timing and checks at the main-path shapes ----------------------
    records = []
    with Phase("kernel-times") as ph:
        n, nd = 1 << 20, 1000
        mu, sg = prior.sample_tree(gen, n)
        seed = torch.tensor([11], dtype=torch.int64, device=dev)
        got = K.normal_summary_cost(mu, sg, seed)
        want = K.normal_summary_cost_plain(mu, sg, seed)
        err1 = assert_close(torch, got, want, "normal_summary_cost n=2^20")
        ms1 = cuda_ms(torch, lambda: K.normal_summary_cost(mu, sg, seed), 10)
        plain1 = cuda_ms(torch, lambda: K.normal_summary_cost_plain(
            mu, sg, seed), 1, warmup=0)
        b1, by1 = bound(K.normal_summary_cost_work(n, nd))
        records.append(dict(
            name="normal_summary_cost", route="cuda",
            source="kissabc_tpu_torch/csrc/flagship.cu",
            replaces="kissabc_tpu/ops/pallas_kernels.py:134",
            launches=smc_launches, max_abs_err=err1, matched=True,
            ms=ms1, plain_ms=plain1, bound_ms=b1, bound_by=by1,
            library_ms=None))

        n = 131072
        mu, sg = prior.sample_tree(gen, n)
        r1, r2 = 5, 77
        dmu = torch.roll(mu, r2) - torch.roll(mu, r1)
        dsg = torch.roll(sg, r2) - torch.roll(sg, r1)
        xs = uniform(n, 0.0, 1.0)
        lps = prior.logpdf(prior.push_tree((mu, sg)))
        args = (mu, sg, dmu, dsg, xs, lps, 0.5, seed)
        got = K.fused_sweep(*args)
        want = K.fused_sweep_plain(*args, consts=consts, ndraws=nd,
                                   target_mu=2.0, target_sd=0.04,
                                   sd_weight=50.0, block=2048, chunk=512,
                                   bits="hw")
        err2, border = compare_sweeps(torch, flagship_outputs(got),
                                      flagship_outputs(want), 0.5,
                                      "fused_sweep n=131072")
        check_untouched(torch, (mu, sg, xs, lps), got[:4], got[4],
                        "fused_sweep n=131072")
        ms2 = cuda_ms(torch, lambda: K.fused_sweep(*args), 50)
        plain2 = cuda_ms(torch, lambda: K.fused_sweep_plain(
            *args, consts=consts, ndraws=nd, target_mu=2.0, target_sd=0.04,
            sd_weight=50.0, block=2048, chunk=512, bits="hw"), 2, warmup=1)
        # the bound counts the simulator only for the walkers that pass
        # gate 1: no other walker's outputs depend on it
        nsim2 = int(K.fused_sweep_proposal_plain(
            mu, sg, dmu, dsg, lps, seed, consts=consts, block=2048,
            bits="hw")[3].sum())
        b2, by2 = bound(K.fused_sweep_work(n, nd, nsim2))
        records.append(dict(
            name="fused_sweep", route="cuda",
            source="kissabc_tpu_torch/csrc/flagship.cu",
            replaces="kissabc_tpu/ops/pallas_kernels.py:295",
            launches=sweep_launches, max_abs_err=err2, matched=True,
            ms=ms2, plain_ms=plain2, bound_ms=b2, bound_by=by2,
            library_ms=None, simulated_share=nsim2 / n))
        # the generic kernels at the shapes of the 2**20 generic path. No
        # single PyTorch call streams a user simulator per walker (or fuses
        # a sweep around one), so library_ms is null for both.
        n = 1 << 20
        cost = costs["flagship"][0]
        th = fprior.sample_tree(gen, n)
        got, want = cost.moments(th, seed), cost.moments_plain(th, seed)
        err3 = max(assert_close(torch, g, w, f"streaming moment {p} n=2^20")
                   for p, (g, w) in enumerate(zip(got, want)))
        ms3 = cuda_ms(torch, lambda: cost.moments(th, seed), 10)
        plain3 = cuda_ms(torch, lambda: cost.moments_plain(th, seed), 1,
                         warmup=0)
        b3, by3 = bound(cost.work(n, 2))
        records.append(dict(
            name="streaming_moment_cost", route="cuda",
            source="kissabc_tpu_torch/csrc/generic.cuh",
            replaces="kissabc_tpu/ops/pallas_kernels.py:2532",
            launches=generic_launches["streaming_moment_cost"],
            max_abs_err=err3, matched=True, ms=ms3, plain_ms=plain3,
            bound_ms=b3, bound_by=by3, library_ms=None))

        sw = sweeps["flagship"]
        th = [x.contiguous() for x in th]
        xs = uniform(n, 0.0, 1.0)
        lps = fprior.logpdf_tree(tuple(th))
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        eps_t = torch.tensor(0.5, device=dev)
        flag_t = torch.tensor(False, device=dev)
        rs = torch.tensor([5, 77, 11], dtype=torch.int64, device=dev)
        got = sw.run(th, xs, lps, alive, eps_t, flag_t, rs)
        want = F.fused_smc_sweep_plain(sw, th, xs, lps, alive, eps_t,
                                       flag_t, 5, 77, 11)
        # the flagship reduce's var = m2 - m1^2 cancels (sigma down to
        # ~0.003: var ~1e-5 against ulp(m2 ~ 4) = 4.8e-7), so one ulp of a
        # moment moves the cost by up to ~4e-3; the kernel and the plain
        # version sum in the same order without FMA (2.4e-7 measured), so
        # the costs and the borderline band are held at 1e-4
        err4, border4 = compare_sweeps(
            torch, got, want, 0.5, "fused_smc_sweep n=2^20", band=1e-4,
            cost_atol=1e-4)
        check_untouched(torch, th + [xs, lps], list(got[0]) + list(got[1:3]),
                        got[3], "fused_smc_sweep n=2^20")
        ms4 = cuda_ms(torch, lambda: sw.run(th, xs, lps, alive, eps_t,
                                            flag_t, rs), 20)
        plain4 = cuda_ms(torch, lambda: F.fused_smc_sweep_plain(
            sw, th, xs, lps, alive, eps_t, flag_t, 5, 77, 11), 1, warmup=0)
        nsim = int(F.proposal_plain(sw, th, lps, alive, 5, 77, 11)[3].sum())
        b4, by4 = bound(sw.work(n, nsim))
        records.append(dict(
            name="fused_smc_sweep", route="cuda",
            source="kissabc_tpu_torch/csrc/generic.cuh",
            replaces="kissabc_tpu/ops/pallas_kernels.py:2159",
            launches=generic_launches["fused_smc_sweep"],
            max_abs_err=err4, matched=True, ms=ms4, plain_ms=plain4,
            bound_ms=b4, bound_by=by4, library_ms=None,
            simulated_share=nsim / n))
        ph.result = (f"normal_summary_cost {ms1:.3f} ms (bound {b1:.3f}); "
                     f"fused_sweep {ms2:.3f} ms (bound {b2:.3f}, {nsim2} "
                     f"of 131072 walkers pass gate 1), "
                     f"{border} borderline commits; streaming_moment_cost "
                     f"{ms3:.3f} ms (bound {b3:.3f}); fused_smc_sweep "
                     f"{ms4:.3f} ms (bound {b4:.3f}, {nsim} of {n} walkers "
                     f"pass gate 1), {border4} borderline")

    with Phase("scan-kernel-times") as ph:
        # the AR(1) model of bench.py:770-779 at the smc-scan-ar1 shape. No
        # PyTorch call runs a per-walker recurrence with in-kernel noise,
        # so library_ms is null.
        n, nsteps = 131072, 1000
        c = scans["ar1"][0]
        th = aprior.sample_tree(gen, n)
        seed = torch.tensor([13], dtype=torch.int64, device=dev)
        got, want = c.means(th, seed), c.means_plain(th, seed)
        err5 = max(assert_close(torch, g, w, f"scan ar1 mean {p} hw")
                   for p, (g, w) in enumerate(zip(got, want)))
        unequal = sum(int((g != w).sum()) for g, w in zip(got, want))
        ms5 = cuda_ms(torch, lambda: c.means(th, seed), 20)
        plain5 = cuda_ms(torch, lambda: c.means_plain(th, seed), 1, warmup=0)
        b5, by5 = bound(c.work(n, 2))
        regs = [line for names, lines in ptxas.items() if "scan ar1" in names
                for line in lines]
        records.append(dict(
            name="streaming_scan_cost", route="cuda",
            source="kissabc_tpu_torch/csrc/scan.cuh",
            replaces="kissabc_tpu/ops/pallas_kernels.py:2800",
            launches=scan_launches, max_abs_err=err5, matched=True, ms=ms5,
            plain_ms=plain5, bound_ms=b5, bound_by=by5, library_ms=None))
        ph.result = (f"n={n} x {nsteps} steps: {ms5:.4f} ms, "
                     f"{n * nsteps / (ms5 / 1e3) / 1e9:.2f} Gsteps/s, bound "
                     f"{b5:.4f} ms ({by5}), plain {plain5:.1f} ms, max|err| "
                     f"{err5:.3g} ({unequal} unequal values); ptxas {regs}")

    signal.alarm(0)
    say(f"[total] {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
