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
import re
import signal
import subprocess
import sys
import tempfile
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
SCRIPT_LIMIT_S = 1000    # whole run, build included (the limit is 1200 s)
FULL_SMC_LIMIT_S = 420   # the 2**20-particle smc run alone
README_LIMIT_S = 300     # the README AIS run (2e4 half-updates) alone
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


def kernel_name(mangled):
    """A function's own identifier out of its Itanium mangling: the last
    name of ``_ZN<len><name>...E`` (namespaces first) or of ``_Z<len>
    <name>``; anything else as it is."""
    pos, name = 2 + mangled.startswith("_ZN"), mangled
    if not mangled.startswith("_Z"):
        return mangled
    while True:
        m = re.match(r"\d+", mangled[pos:])
        if not m:
            return name
        start = pos + m.end()
        pos = start + int(m.group())
        name = mangled[start:pos]


def cuda_timed(torch, fn):
    """(``fn()``, its milliseconds by CUDA events): one run, started on
    an idle device."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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
    from kissabc_tpu_torch.core import ais as AI
    from kissabc_tpu_torch.ops import _build
    from kissabc_tpu_torch.ops import fused_ais as FA
    from kissabc_tpu_torch.ops import fused_smc as F
    from kissabc_tpu_torch.ops import kernels as K
    from kissabc_tpu_torch.ops import scan as SC
    from kissabc_tpu_torch.ops import streaming as S

    def reset_counts():
        for module in (K, S, F, SC, FA):
            module.reset_launch_counts()

    def counts():
        return {**K.launches, **S.launches, **F.launches, **SC.launches,
                **FA.launches}

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
    # the generic AIS sweep's models (slice 4): the flagship model, g-and-k
    # (bench.py:347-383) and the mixed discrete prior of
    # tests/test_pallas.py:811-861
    dprior = kt.Factored(kt.DiscreteUniform(1, 10), kt.Uniform(0.1, 1.0))

    def ddraw(th, eps):
        m, s_ = th
        return m + s_ * eps

    def dreduce(th, mo):
        return torch.abs(mo[0] - 3.0)

    ais_sweeps = {   # name: (sweep, stub twin)
        "flagship": (kt.make_fused_ais_sweep(fprior, fdraw, freduce,
                                             scale=0.005),
                     kt.make_fused_ais_sweep(fprior, fdraw, freduce,
                                             scale=0.5, bits="stub")),
        "g-and-k": (kt.make_fused_ais_sweep(gprior, gdraw, greduce,
                                            scale=0.05),
                    kt.make_fused_ais_sweep(gprior, gdraw, greduce,
                                            scale=0.5, bits="stub")),
        "discrete": (None, kt.make_fused_ais_sweep(
            dprior, ddraw, dreduce, scale=0.5, bits="stub")),
    }
    units = {}   # generated source -> names (stub and hw share a unit)
    for name, (c, k) in costs.items():
        units.setdefault(c.unit(k).source, []).append(f"cost {name}")
    for name, sw in sweeps.items():
        units.setdefault(sw.unit.source, []).append(f"sweep {name}")
    for name, (c, k) in scans.items():
        units.setdefault(c.unit(k).source, []).append(f"scan {name}")
    ais_units = {}
    for name, (_, sw) in ais_sweeps.items():
        ais_units.setdefault(sw.unit.source, []).append(f"ais {name}")

    ptxas = {}   # unit names -> ptxas lines, each after its function

    def ptxas_lines(log, prefix):
        fn = ""
        for line in log.splitlines():
            m = re.search(r"(?:entry function '|Function properties for )"
                          r"(\w+)", line)
            if m:
                fn = kernel_name(m.group(1))
            if "registers" in line or "spill" in line:
                ptxas.setdefault(prefix, []).append(f"{fn}: {line.strip()}")
                say(f"  ptxas {prefix} {fn}: {line.strip()}")

    with Phase("build") as ph:
        # every nvcc starts now: the hand-written sources (flagship.cu and
        # ais.cu, one library) and each generated unit
        jobs = [_build.start()] + [_build.start(text) for text in units]
        ais_jobs = [_build.start(text) for text in ais_units]
        lib_path, build_s, log = jobs[0].wait()
        ptxas_lines(log, "flagship")
        _build.load()
        ph.result = (f"{lib_path.name} (flagship.cu + ais.cu) compiled in "
                     f"{build_s:.2f} s")

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

    with Phase("build-ais") as ph:
        # ais.cu was built into the library of the build phase
        slowest = 0.0
        for (text, names), job in zip(ais_units.items(), ais_jobs):
            _, secs, log = job.wait()
            ptxas_lines(log, "/".join(names))
            _build.load_generated(text)
            slowest = max(slowest, secs)
        ptxas["ais.cu"] = [line for line in ptxas.get("flagship", [])
                           if "_ais_" in line]
        per_sm, sms, grid = FA.full_grid(65536)
        ph.result = (f"ais.cu in {lib_path.name}; {len(ais_units)} generated "
                     f"AIS units, the slowest compiled in {slowest:.2f} s "
                     f"(started with the others); ais.cu ptxas "
                     f"{ptxas['ais.cu']}; kt_fused_ais_full co-resident: "
                     f"{per_sm} blocks/SM x {sms} SMs, grid {grid} blocks of "
                     f"128 for h=65536")

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

    # ---- slice 4: AIS --------------------------------------------------
    def ais_compare(got, want, inputs, what, margin):
        """Kernel vs plain AIS half or sweep on the same inputs; outputs
        (theta leaves..., lp, ll). A walker commits where any output
        differs from its input. The commit masks agree except where the
        plain version's MH log-ratio lies within a rounding band of its
        accept draw (``margin``, the one less the other: the kernels of
        #7 and #8 contract multiply-adds, and sum the moments in another
        order than their plain versions); values
        committed on both sides agree within the golden tolerance, and
        uncommitted walkers keep their inputs bit for bit on both sides.
        Returns (max abs err, unequal values, commits, borderline)."""
        def committed(outs):
            m = torch.zeros_like(inputs[0], dtype=torch.bool)
            for o, x in zip(outs, inputs):
                m |= o != x
            return m
        gc, wc = committed(got), committed(want)
        # a few float32 ulps of the log-densities that make up lw
        band = 1e-4 + 1e-5 * (inputs[-1].abs() + want[-1].abs())
        differ = gc != wc
        border = differ & (margin.abs() < band)
        check(bool((~differ | border).all()), f"{what}: commit masks differ "
              f"on {int((differ & ~border).sum())} walkers away from the "
              "accept threshold")
        both = gc & wc
        err, unequal = 0.0, 0
        for k, (g, w, x) in enumerate(zip(got, want, inputs)):
            err = max(err, assert_close(torch, g[both], w[both],
                                        f"{what} output {k}"))
            check(bool(torch.equal(g[~gc], x[~gc])),
                  f"{what}: uncommitted output {k} changed")
            unequal += int((g[both] != w[both]).sum())
        return err, unequal, int(both.sum()), int(border.sum())

    def flagship_start(n):
        """A population around the posterior: mu ~ U(1.6, 2.4), sigma ~
        U(0.01, 0.1), its prior logpdf and loglikelihoods in [-50, -1]."""
        th = (uniform(n, 1.6, 2.4), uniform(n, 0.01, 0.1))
        lp = prior.logpdf(prior.push_tree(th)).to(torch.float32)
        return th, lp, uniform(n, -50.0, -1.0)

    def population(th):
        mu_, sg_ = (x.double() for x in th)
        return (float(mu_.mean()), float(sg_.mean()), float(mu_.std()),
                float(sg_.std()))

    def same_population(a, b, what):
        """The rule of tests/test_pallas.py:536-542: |d mean mu| < 3e-3,
        |d mean sigma| < 3e-4, each std ratio within 25%."""
        pa, pb = population(a), population(b)
        check(abs(pa[0] - pb[0]) < 3e-3, f"{what}: mean mu {pa[0]} vs "
              f"{pb[0]}")
        check(abs(pa[1] - pb[1]) < 3e-4, f"{what}: mean sigma {pa[1]} vs "
              f"{pb[1]}")
        for k in (2, 3):
            check(abs(pa[k] / pb[k] - 1.0) < 0.25,
                  f"{what}: std ratio {pa[k] / pb[k]}")
        return pb

    flagship_cost = kt.make_flagship_cost_batched()   # kernel #1
    shifts6 = torch.tensor([5, 77, 1000, 3, 40000, 65001], dtype=torch.int64,
                           device=dev)
    shifts12 = torch.cat([shifts6, torch.tensor(
        [11, 2, 65000, 9, 123, 4567], dtype=torch.int64, device=dev)])
    seed_t = torch.tensor([2024], dtype=torch.int64, device=dev)
    fl_kw = dict(ndraws=1000, target_mu=2.0, target_sd=0.04, sd_weight=50.0,
                 a_stretch=3.0, mu_lo=1.0, mu_hi=3.0, sg_sigma=0.05,
                 sg_lo=0.0, sg_hi=100.0, chunk=512)
    with Phase("ais-stub") as ph:
        n, h = 65536, 32768
        res = {}
        # kernel #7: one half-update
        m7 = FA.FlagshipAIS(scale=0.1, block=2048, bits="stub", **fl_kw)
        th, lp, ll = flagship_start(n)
        ins = [th[0][:h], th[1][:h], lp[:h], ll[:h]]
        comp = [th[0][h:], th[1][h:]]
        outs = [torch.empty_like(x) for x in ins]
        m7.launch_half(ins, comp, shifts6[:6] % h, seed_t, outs)
        want = m7.half_plain(*ins, *comp, shifts6 % h, seed_t)
        res["#7 half"] = ais_compare(outs, want[:4], ins,
                                     "fused_ais_half stub", want[5])
        # kernel #8: both halves in one launch
        m8 = FA.FlagshipAIS(scale=0.1, block=1024, bits="stub", **fl_kw)
        ins = [th[0], th[1], lp, ll]
        outs = [torch.empty_like(x) for x in ins]
        m8.launch_full(ins, shifts12 % h, seed_t, outs)
        want = m8.full_plain(*ins, shifts12 % h, seed_t)
        res["#8 full"] = ais_compare(outs, want[:4], ins,
                                     "fused_ais_full stub", want[5])
        check(res["#8 full"][2] > 0, "fused_ais_full stub committed nothing")
        # kernel #6 on its three models: one half-update each
        starts = {"flagship": [th[0], th[1]],
                  "g-and-k": list(gprior.sample_tree(gen, n)),
                  "discrete": [torch.randint(1, 11, (n,), generator=gen,
                                             device=dev).float(),
                               uniform(n, 0.1, 1.0)]}
        for name, leaves in starts.items():
            sw = ais_sweeps[name][1]
            leaves = [x.contiguous() for x in leaves]
            lp6 = sw.prior.logpdf_tree(sw.pushed(leaves)).to(torch.float32)
            ll6 = uniform(n, -20.0, -1.0)
            upd, cmp_ = [x[:h] for x in leaves], [x[h:] for x in leaves]
            got = sw.half(upd, lp6[:h], ll6[:h], cmp_, shifts6 % h, seed_t)
            want = sw.half_plain(upd, lp6[:h], ll6[:h], cmp_, shifts6 % h,
                                 seed_t, terms=True)
            flat = lambda o: list(o[0]) + [o[1], o[2]]  # noqa: E731
            res[f"#6 {name}"] = ais_compare(
                flat(got), flat(want), upd + [lp6[:h], ll6[:h]],
                f"fused_ais_sweep stub {name}", want[3][1])
            check(res[f"#6 {name}"][2] > 0, f"#6 {name} committed nothing")
        ph.result = ("(max|err|, unequal committed values, commits, "
                     "borderline): " + json.dumps(res))

    with Phase("ais-kernel-times") as ph:
        # the main-path shapes: n = 131072 walkers x 1000 draws, Philox
        n, h, nd = 131072, 65536, 1000
        th0 = prior.sample_tree(gen, n)
        model_k = kt.ApproxKernelizedPosterior(prior, flagship_cost,
                                               0.005, cost_vectorized=True)
        lds0 = model_k.loglike_batch(th0, gen)
        ins = [th0[0].contiguous(), th0[1].contiguous(), lds0[0], lds0[1]]
        times, plain_ms = {}, {}   # plain: one whole sweep, the same inputs
        m7 = FA.FlagshipAIS(scale=0.005, block=2048, bits="hw", **fl_kw)
        m8 = FA.FlagshipAIS(scale=0.005, block=1024, bits="hw", **fl_kw)
        sh = shifts12 % h
        outs7 = [torch.empty_like(x) for x in ins]

        def sweep7():
            m7.launch_half([x[:h] for x in ins], [x[h:] for x in ins[:2]],
                           sh[:6], seed_t, [o[:h] for o in outs7])
            m7.launch_half([x[h:] for x in ins], [o[:h] for o in outs7[:2]],
                           sh[6:], seed_t, [o[h:] for o in outs7])

        def plain7():   # half B against the updated half A, as sweep7
            a = m7.half_plain(*(x[:h] for x in ins), ins[0][h:], ins[1][h:],
                              sh[:6], seed_t)
            return a, m7.half_plain(*(x[h:] for x in ins), a[0], a[1],
                                    sh[6:], seed_t)

        sweep7()
        (a7, b7), plain_ms["fused_ais_half"] = cuda_timed(torch, plain7)
        want7 = [torch.cat([a, b]) for a, b in zip(a7, b7)]
        err7 = ais_compare(outs7, want7[:4], ins, "fused_ais_half hw",
                           want7[5])
        nsim7 = int(a7[4].sum() + b7[4].sum())
        times["fused_ais_half"] = cuda_ms(torch, sweep7, 20)
        outs8 = [torch.empty_like(x) for x in ins]
        m8.launch_full(ins, sh, seed_t, outs8)
        want8, plain_ms["fused_ais_full"] = cuda_timed(
            torch, lambda: m8.full_plain(*ins, sh, seed_t))
        err8 = ais_compare(outs8, list(want8[:4]), ins, "fused_ais_full hw",
                           want8[5])
        nsim8 = int(want8[4].sum())
        times["fused_ais_full"] = cuda_ms(
            torch, lambda: m8.launch_full(ins, sh, seed_t, outs8), 20)
        sw6 = ais_sweeps["flagship"][0]
        outs6 = ([torch.empty_like(x) for x in ins[:2]],
                 torch.empty_like(ins[2]), torch.empty_like(ins[3]))

        def halves6(o):
            return [tuple(x[sl] for x in o[0]) + (o[1][sl], o[2][sl])
                    for sl in (slice(0, h), slice(h, n))]

        def sweep6():
            oa, ob = halves6(outs6)
            sw6.half([ins[0][:h], ins[1][:h]], ins[2][:h], ins[3][:h],
                     [ins[0][h:], ins[1][h:]], sh[:6], seed_t,
                     outs=(list(oa[:2]), oa[2], oa[3]))
            sw6.half([ins[0][h:], ins[1][h:]], ins[2][h:], ins[3][h:],
                     list(oa[:2]), sh[6:], seed_t,
                     outs=(list(ob[:2]), ob[2], ob[3]))

        def plain6():
            a = sw6.half_plain([ins[0][:h], ins[1][:h]], ins[2][:h],
                               ins[3][:h], [ins[0][h:], ins[1][h:]], sh[:6],
                               seed_t, terms=True)
            return a, sw6.half_plain([ins[0][h:], ins[1][h:]], ins[2][h:],
                                     ins[3][h:], a[0], sh[6:], seed_t,
                                     terms=True)

        sweep6()
        (a6, b6), plain_ms["fused_ais_sweep"] = cuda_timed(torch, plain6)
        want6 = [torch.cat([a6[0][k], b6[0][k]]) for k in (0, 1)] + [
            torch.cat([a6[1], b6[1]]), torch.cat([a6[2], b6[2]])]
        err6 = ais_compare(list(outs6[0]) + [outs6[1], outs6[2]], want6, ins,
                           "fused_ais_sweep hw flagship",
                           torch.cat([a6[3][1], b6[3][1]]))
        nsim6 = int(a6[3][0].sum() + b6[3][0].sum())
        times["fused_ais_sweep"] = cuda_ms(torch, sweep6, 20)
        w6 = [sw6.work(h, int(x[3][0].sum())) for x in (a6, b6)]
        bounds = {
            "fused_ais_half": bound(m7.work(n, nsim7)),
            "fused_ais_full": bound(m8.work(n, nsim8)),
            "fused_ais_sweep": bound((w6[0][0] + w6[1][0],
                                      w6[0][1] + w6[1][1])),
        }
        ais_err = {"fused_ais_half": err7[0], "fused_ais_full": err8[0],
                   "fused_ais_sweep": err6[0]}
        regs = {names: lines for names, lines in ptxas.items()
                if "ais" in names}   # ais.cu's and the generated units'
        ph.result = "; ".join(
            f"{k} {times[k]:.4f} ms/sweep ({n / (times[k] / 1e3):.4g} "
            f"updates/s), bound {bounds[k][0]:.4f} ms ({bounds[k][1]}), "
            f"plain {plain_ms[k]:.1f} ms/sweep"
            for k in times) + (
            f"; inside the prior {nsim7}, {nsim8}, {nsim6} of {n}; "
            f"(max|err|, unequal committed values, commits, borderline) "
            f"#7 {err7}, #8 {err8}, #6 {err6}; "
            f"ptxas {json.dumps(regs)}")

    def draw_init(model, n, key):
        """The init ``sample(..., key=key)`` makes: ``_init_ensemble`` on
        a generator seeded with ``key``, the first draws of the run."""
        g = torch.Generator(device=dev)
        g.manual_seed(key)
        th, ld, valid = AI._init_ensemble(model, g, n, 100)
        check(bool(valid.all()), "AIS init left invalid walkers")
        return th, ld

    def iterate(sweep, th, ld, sweeps, key):
        g = torch.Generator(device=dev)
        g.manual_seed(key)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(sweeps):
            th, ld = sweep(g, th, ld)
        torch.cuda.synchronize()
        return th, ld, time.perf_counter() - t0, counts()

    with Phase("ais-sample-split") as ph:
        # bench.py:254-296 (ais-sweep): 500 red/black sweeps at n = 131072
        n, ntr = 131072, 500
        model_k = kt.ApproxKernelizedPosterior(prior, flagship_cost,
                                               0.005, cost_vectorized=True)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        post = kt.sample(model_k, kt.AIS(n), n, ntransitions=ntr, key=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        split_launches = launched["normal_summary_cost"]
        check(split_launches >= 2 * ntr + 1,
              f"sample launched normal_summary_cost {split_launches} times")
        check(sum(launched.values()) == split_launches,
              f"the split path launched another kernel: {launched}")
        split_pop = tuple(torch.as_tensor(p.particles, device=dev)
                          for p in post)
        m_mu, m_sg, s_mu, s_sg = population(split_pop)
        check(abs(m_mu - 2.0) < 0.005, f"mean mu {m_mu}")
        check(abs(m_sg - 0.04) < 0.002, f"mean sigma {m_sg}")
        check(0.0040 <= s_mu <= 0.0068, f"std mu {s_mu}")
        ph.result = (f"n={n}, {ntr} sweeps: wall {wall:.3f} s "
                     f"({n * ntr / wall:.4g} updates/s); mu {m_mu:.5f} +- "
                     f"{s_mu:.5f}, sigma {m_sg:.5f} +- {s_sg:.5f}; launches "
                     f"{launched}")

    with Phase("ais-fused") as ph:
        n = 131072
        th0, ld0 = draw_init(model_k, n, 0)
        out = {}
        fused_launches = {}
        for name, mk in (("fused_ais_half", kt.make_fused_flagship_ais_sweep),
                         ("fused_ais_full",
                          kt.make_fused_flagship_ais_sweep_onekernel)):
            th, ld, wall, launched = iterate(mk(n, scale=0.005), th0, ld0,
                                             500, 7)
            fused_launches[name] = launched[name]
            check(launched[name] == (1000 if name == "fused_ais_half"
                                     else 500),
                  f"{name}: {launched[name]} launches in 500 sweeps")
            check(all(bool(torch.isfinite(x).all()) for x in ld),
                  f"{name}: non-finite log-densities")
            pop = same_population(split_pop, th, name)
            out[name] = (f"{wall:.3f} s ({n * 500 / wall:.4g} updates/s), "
                         f"mu {pop[0]:.5f} +- {pop[2]:.5f}, sigma "
                         f"{pop[1]:.5f} +- {pop[3]:.5f}")
        # one sweep of each wrapper, on a CUDA and on a CPU generator, held
        # against its plain version fed the words a clone of the generator
        # gives: the wrappers' draws of shifts and seed, and half B
        # proposing against the updated half A (after the main path's
        # counts were read, so these launches are not counted)
        h = n // 2
        ins = [th0[0], th0[1], ld0[0], ld0[1]]
        for gdev in (dev, torch.device("cpu")):
            for name, mk in (
                    ("fused_ais_half", kt.make_fused_flagship_ais_sweep),
                    ("fused_ais_full",
                     kt.make_fused_flagship_ais_sweep_onekernel)):
                g = torch.Generator(device=gdev)
                g.manual_seed(11)
                replay = torch.Generator(device=gdev)
                replay.set_state(g.get_state())
                sweep = mk(n, scale=0.005)
                (omu, osg), (olp, oll) = sweep(g, th0, ld0)
                m = sweep.model

                def words(k):
                    return FA.uint32_words(replay, k).to(dev)

                if name == "fused_ais_half":
                    w = words(7)
                    a = m.half_plain(*(x[:h] for x in ins), ins[0][h:],
                                     ins[1][h:], FA.rot_shifts6(w[:6], h),
                                     w[6:])
                    w = words(7)
                    b = m.half_plain(*(x[h:] for x in ins), a[0], a[1],
                                     FA.rot_shifts6(w[:6], h), w[6:])
                    want = [torch.cat([x, y]) for x, y in zip(a, b)]
                else:
                    w = words(13)
                    want = m.full_plain(*ins, torch.cat(
                        [FA.rot_shifts6(w[0:6], h),
                         FA.rot_shifts6(w[6:12], h)]), w[12:])
                res = ais_compare([omu, osg, olp, oll], list(want[:4]), ins,
                                  f"{name} sweep, {gdev.type} generator",
                                  want[5])
                check(res[2] > 0, f"{name} sweep committed nothing")
                out[f"{name} replay ({gdev.type} generator)"] = res
        ph.result = json.dumps(out)

    with Phase("ais-fused-generic") as ph:
        n = 131072
        gcost = costs["g-and-k"][0]
        model_g = kt.ApproxKernelizedPosterior(gprior, gcost, 0.05,
                                               cost_vectorized=True)
        thg, ldg = draw_init(model_g, n, 3)
        h = n // 2
        split = AI.make_sweep_halves(model_g, n)
        ths, _, wall_s, _ = iterate(split, AI._halves(thg, h),
                                    AI._halves(ldg, h), 200, 8)
        ths = AI._unhalves(ths)
        thf, _, wall_f, launched = iterate(ais_sweeps["g-and-k"][0], thg, ldg,
                                           200, 7)
        generic_ais_launches = launched["fused_ais_sweep"]
        check(generic_ais_launches == 400, f"#6 launched "
              f"{generic_ais_launches} times in 200 sweeps")
        stats = []
        # the tolerances of tests/test_pallas.py:800-806
        for i, tol in ((0, 0.1), (1, 0.1), (2, 0.25), (3, 0.05)):
            a, b = ths[i].double(), thf[i].double()
            check(abs(float(a.mean() - b.mean())) < tol,
                  f"g-and-k param {i}: mean {float(a.mean())} vs "
                  f"{float(b.mean())}")
            check(abs(float(a.std() / b.std()) - 1.0) < 0.3,
                  f"g-and-k param {i}: std {float(a.std())} vs "
                  f"{float(b.std())}")
            stats.append(f"{float(b.mean()):.4f}+-{float(b.std()):.4f}")
        thff, _, wall_ff, launched = iterate(ais_sweeps["flagship"][0], th0,
                                             ld0, 500, 9)
        generic_ais_launches += launched["fused_ais_sweep"]
        pop = same_population(split_pop, thff, "fused_ais_sweep flagship")
        ph.result = (f"g-and-k n={n}, 200 sweeps: #6 {wall_f:.3f} s "
                     f"({n * 200 / wall_f:.4g} updates/s) vs split "
                     f"{wall_s:.3f} s ({n * 200 / wall_s:.4g}); #6 posterior "
                     f"{stats}; flagship through #6, 500 sweeps: "
                     f"{wall_ff:.3f} s ({n * 500 / wall_ff:.4g} updates/s), "
                     f"mu {pop[0]:.5f} +- {pop[2]:.5f}, sigma {pop[1]:.5f}")

    with Phase("ais-readme") as ph:
        # the reference README's wall-clock claim: AIS(10), 1000 samples,
        # ntransitions=100, per-walker cost (__graft_entry__.py:17-22);
        # gather partners, no kernel of the port (the JAX path is a vmap)
        _alarm(README_LIMIT_S)

        def readme_cost(theta, g):
            mu, sigma = theta
            x = mu + sigma * torch.randn(1000, generator=g, device=g.device)
            return torch.hypot(x.mean() - 2.0,
                               (x.std(correction=0) - 0.04) * 50)

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        post = kt.sample(kt.ApproxKernelizedPosterior(prior, readme_cost,
                                                      0.005),
                         kt.AIS(10), 1000, ntransitions=100, key=3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _alarm(max(1, int(SCRIPT_LIMIT_S - (time.perf_counter() - t_start))))
        m_mu, m_sg, s_mu, s_sg = population(
            tuple(torch.as_tensor(p.particles) for p in post))
        check(abs(m_mu - 2.0) < 0.005, f"mean mu {m_mu}")
        check(abs(m_sg - 0.04) < 0.002, f"mean sigma {m_sg}")
        check(0.0040 <= s_mu <= 0.0068, f"std mu {s_mu}")
        ph.result = (f"AIS(10), 1000 samples, 100 sweeps per block: wall "
                     f"{wall:.3f} s (2e4 half-updates); mu {m_mu:.5f} +- "
                     f"{s_mu:.5f}, sigma {m_sg:.5f} +- {s_sg:.5f}; launches "
                     f"{counts()}")

    for name, src, rep, launched in (
            ("fused_ais_sweep", "kissabc_tpu_torch/csrc/generic.cuh",
             "kissabc_tpu/ops/pallas_kernels.py:1150", generic_ais_launches),
            ("fused_ais_half", "kissabc_tpu_torch/csrc/ais.cu",
             "kissabc_tpu/ops/pallas_kernels.py:525",
             fused_launches["fused_ais_half"]),
            ("fused_ais_full", "kissabc_tpu_torch/csrc/ais.cu",
             "kissabc_tpu/ops/pallas_kernels.py:797",
             fused_launches["fused_ais_full"])):
        # no PyTorch call fuses an ensemble move, a prior, a simulator and
        # an MH accept, so library_ms is null
        records.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launched, max_abs_err=ais_err[name], matched=True,
            ms=times[name], plain_ms=plain_ms[name], bound_ms=bounds[name][0],
            bound_by=bounds[name][1], library_ms=None))

    signal.alarm(0)
    say(f"[total] {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
