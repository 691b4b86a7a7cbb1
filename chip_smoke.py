#!/usr/bin/env python3
"""Smoke run of kissabc_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--save-ais-inputs PATH]

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

and checks each posterior against its limits (slices 4 and 5 add AIS,
tsmc, pfilter and ABCDE and their kernels; slice 6 adds
``abc_rejection``: ``rejection-budget``, the JAX bench's rejection row
uncut, 4096 kept of 131072 x 1600 draws through the flagship cost
kernel, and ``rejection-threshold``, eps 0.05 through kernel #4; then
``host-cost``, smc with a numpy simulator on the host, and
``prior-battery``, the samplers' prior battery of the new distribution
families on the card; slice 7 adds ``prior-table``, kernels #3, #6, #9
and #10 on four priors of 16 marginals that hold every entry of the
generic kernels' prior table, each against its plain version on stub
bits at 65536 walkers, ``smc-1m-generic-priors``, smc at 2^20 particles
on a prior of new families through #4 and #3, ``reference-socks``, the
reference's socks problem through smc and AIS, and ``statistics``, the
statistics functions on the card against the CPU; slice 8 adds #3 on P3
and P4, whose discrete marginals it pushes in the kernel,
``smc-1m-generic-discrete``, smc at 2^20 on the mixed discrete prior of
tests/test_pallas.py:864-890 through #4 and #3, the vector and matrix
families to ``statistics``, and ``matrix-priors``: smc on ``LKJ(2)``, the
covariance example, AIS on ``LKJ(2)``, and each family's logpdf and
10^5 draws on the card). For the kernels redesigned
since, ``radius-exhaustive`` holds the Box-Muller radius of
``csrc/common.cuh`` against ``sqrtf(-2 log1pf(-u))`` at all 2^23 inputs,
and ``kernel-times`` times kernel #3 in blocks of 128 to 1024 threads
and kernel #2 (which takes the step's raw words and derives its partners)
at each geometry of ``GEOMETRIES_2``, ``scan-kernel-times`` kernel #5 in
blocks of ``SCAN_THREADS``, all of which must give equal outputs;
``ais-stub`` and ``ais-kernel-times`` hand #6, #7 and #8 raw words
(their kernels derive the shifts) and check #7 and #8 on two word sets
and time them at each geometry of ``GEOMETRIES_78``; ``tempered-stub``
and ``tempered-kernel-times`` hand #9 raw words and the latter times its
sweep (two launches) at 4096 and 131072 walkers; ``kernel-times`` (2^20) and
``cost-kernel-times`` (1000, 16384, and g-and-k at 131072) time #4 at
each geometry of ``GEOMETRIES_4``, which must give equal outputs. Every
phase prints one line with its result and seconds; any failed check
raises and the script exits non-zero. Slice 9 adds walker sharding on 4
shards of the one card (``mesh-roll``, ``mesh-smc``, ``mesh-costs``,
``mesh-smc-1m-generic``, ``mesh-distributed``); slice 10 the other
samplers on that mesh and on ``(chain=2, walker=2)``: ``mesh-ais`` (AIS
on the README model, roll and gather, and two chains, each bit-equal to
one device), ``mesh-ais-fused-generic`` (#6 once per shard on g-and-k at
131072 x 1000, its partners-given form per shard against the plain
version and the snapshot form), ``mesh-tsmc`` (split bit-equal at 4096,
#9 per shard at 131072), ``mesh-pfilter``, ``mesh-abcde`` (split
bit-equal, #10 per shard at 16384 x 1000) and ``mesh-rejection`` (a
PyTorch cost bit-equal, #1 per shard through ``shard_batched_cost``),
and ABCDE on the one-rank nccl group. The walkthroughs of
``examples_torch/`` come last: ``build-examples`` builds the units of
their kernels that no other phase builds (started with the others),
``examples-kernels`` holds those units (#4: Weibull, g-and-k ecdf; #5:
OU, Wiener, SIR) against their plain versions at the walkthroughs'
1024 walkers, and one half-update of #9 (``example_tsmc``'s unit, h =
2000) and of #6 (``example_fused_ais``' unit, h = 2048) against theirs,
and times them, ``examples`` runs every walkthrough's
``main()`` uncut on the card, its asserts inside, and prints its wall
and its launches on an ``[example]`` line (#4 in ``example_streaming_sim``
and ``example_fused_ais``, #5 in ``example_scan_sim`` and ``example_sir``,
#6 in ``example_fused_ais``, #9 in ``example_tsmc``, each required above
0; the others launch none), ``example-expmix`` runs ``example_expmix``
at 10^6 draws a cost call under its own alarm, and ``matrix-priors``
runs ``example_covariance``. Then ``conformance`` holds the port to
the JAX package's conformance tests on the card (``conformance()``: the
consistency battery's legs for every family of ``tests/battery_specs.py``
on CUDA generators, ``DiscreteUniform``'s int32 draws,
``Factored.rand``/``sample``, ``init_sample``, and the bimodal smc of
``tests/test_gk_multimodal.py`` on one device and on 4 shards) and
prints one JSON line with its wall and its counts; any failed check
fails the run. The line before the last is one JSON
object with every kernel's launches on its path (the walkthroughs'
under their names in ``launches_by_path``), its error against its plain
version and its times; the last line is ``{"ok": true, "device": {...}}``.

Needs one CUDA card and nvcc; imports nothing of JAX. Without a card, or
run from a directory without the package, it exits 1 and prints no result.
"""

import argparse
import ctypes
import importlib
import json
import math
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
EXPMIX_LIMIT_S = 300     # example_expmix (10^6 draws a cost call) alone
# the walkthroughs of examples_torch/, run by the examples phases (the
# covariance example by matrix-priors, expmix in a phase of its own)
EXAMPLES = ("example_n1", "example_n2", "example_socks", "example_gk",
            "example_model_choice", "example_workflow",
            "example_streaming_sim", "example_scan_sim", "example_sir",
            "example_tsmc", "example_fused_ais")
# the kernels each walkthrough reaches on the card; the others reach none
EXAMPLE_KERNELS = {
    "example_streaming_sim": ("streaming_moment_cost",),
    "example_scan_sim": ("streaming_scan_cost",),
    "example_sir": ("streaming_scan_cost",),
    "example_tsmc": ("fused_tempered_sweep",),
    "example_fused_ais": ("fused_ais_sweep", "streaming_moment_cost")}
H100_F32_OPS = 67e12     # float32 outside the tensor cores, H100 SXM
H100_BYTES = 3.35e12     # HBM3, H100 SXM
EPSTOL = 0.011113        # README.md:84 of the reference


# common.cuh's box_muller_radius against sqrtf(-2 log1pf(-u)) for every
# value u = k 2^-23 that to_unit gives: one thread per k
RADIUS_CHECK = r"""
#include "common.cuh"
namespace {
__global__ void radius_check_kernel(unsigned int* bad) {
  uint32_t k = blockIdx.x * blockDim.x + threadIdx.x;
  float u = to_unit(k << 9);
  float want = sqrtf(-2.0f * log1pf(-u));
  if (__float_as_uint(box_muller_radius(u)) != __float_as_uint(want))
    atomicAdd(bad, 1u);
}
}  // namespace
extern "C" int kt_radius_check(unsigned int* bad, void* stream) {
  radius_check_kernel<<<(1 << 23) / 256, 256, 0, (cudaStream_t)stream>>>(bad);
  return (int)cudaGetLastError();
}
extern "C" const char* kt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
"""


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


def device_ms(torch, fn, reps, kernel, per_call=1):
    """Mean device milliseconds per call of ``fn`` spent in the CUDA
    kernel named ``kernel`` (launched ``per_call`` times by each call),
    from ``torch.profiler``'s record of the card's kernel intervals: a
    short kernel's own time, without the host's launch overhead that
    events around a loop of calls measure when the host is the slower
    side. The profiler may miss launches in its window (it recorded 17
    to 19 of 20-23 short launches of #10 on the H100), so the window
    holds ``reps`` calls more than the ``reps`` it must see, and the time
    is the mean of every interval it recorded; a window that saw fewer
    than ``reps`` calls' launches is profiled again, up to three
    windows."""
    from torch.profiler import ProfilerActivity, profile

    spare = reps
    launched = (reps + spare) * per_call
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps + spare):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in e.name]
        if len(spans) >= reps * per_call:
            break
    check(reps * per_call <= len(spans) <= launched,
          f"the profiler saw {len(spans)} launches of {kernel} in "
          f"{reps + spare} calls of {per_call} launches")
    return sum(spans) / 1e3 / len(spans) * per_call


def queued_ms(torch, fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs by CUDA
    events, with the runs queued behind a spin kernel
    (``torch.cuda._sleep``) that lasts until the host has launched them
    all, so the card runs them back to back: their kernels and the gaps
    between them, without the host's launch overhead and without the
    profiler, which may miss launches (a cross-check of ``device_ms``). The
    spin is made four times longer, up to three times, until it outlasts
    the host's launches."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    cycles = int(4 * (time.perf_counter() - t0) * 2e9)   # ~2 GHz
    for _ in range(3):
        spin, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        t0 = time.perf_counter()
        spin.record()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        # the spin began after t0, so it ended after the host's last launch
        if host_ms < spin.elapsed_time(start):
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise AssertionError(f"the host's {reps} launches outlasted a spin of "
                         f"{cycles // 4} cycles")


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


# launch geometries (walkers a block, threads a block, lanes a walker) of
# the lane-group kernels #10 and #6 that abcde-kernel-times and
# ais-kernel-times time, and the stub phases check, beside each width's
# default (ops/lane_groups.py geometry); the lanes are the two that a
# unit instantiates (tools/time_geometry.py times 2, 8 and 16 too)
GEOMETRIES_10 = [(64, 256, 1), (32, 256, 4), (128, 256, 4), (512, 512, 4),
                 (1024, 512, 1), (1024, 512, 4)]
GEOMETRIES_6 = [(512, 512, 1), (512, 512, 4), (1024, 512, 4), (256, 512, 4),
                (128, 512, 4), (64, 256, 4)]
# (walkers, threads) of #7 and #8 (one lane a walker)
GEOMETRIES_78 = [(512, 512), (512, 256), (256, 256), (256, 512), (1024, 512),
                 (128, 128)]
# (walkers, threads) of #2 (one lane a walker), and the block sizes of #5
GEOMETRIES_2 = [(1024, 512), (1024, 1024), (512, 512), (512, 256),
                (256, 256), (256, 512), (1024, 256), (128, 128)]
SCAN_THREADS = (64, 128, 256, 512)
# (walkers, threads, lanes) of #4 timed at each width: one thread per
# walker in blocks of 32 to 256, and groups of 4 lanes (the lanes a unit
# has besides 1) on 32 to 512 threads, one turn a group
GEOMETRIES_4 = [(128, 128, 1), (32, 32, 1), (256, 256, 1), (8, 32, 4),
                (16, 64, 4), (32, 128, 4), (64, 256, 4), (128, 512, 4)]


def same_bits(a, b):
    """Every tensor of two nested outputs equal bit for bit (NaN where
    NaN)."""
    if isinstance(a, (list, tuple)):
        return all(same_bits(x, y) for x, y in zip(a, b))
    nan = a.isnan() if a.is_floating_point() else None
    if nan is None:
        return bool((a == b).all())
    return bool((nan == b.isnan()).all() and (a[~nan] == b[~nan]).all())


def geometry_key(g):
    return f"w{g.walkers} t{g.threads} L{g.lanes}"


def unequal_committed(got, want):
    """Committed values (theta leaves, xs, lps of walkers both sweeps
    commit) that differ between two sweeps' outputs."""
    both = got[3] & want[3]
    return sum(int((g[both] != w[both]).sum()) for g, w in zip(
        list(got[0]) + list(got[1:3]), list(want[0]) + list(want[1:3])))


def unequal_by_output(got, want):
    """``unequal_committed`` output by output: a list of counts (each
    theta leaf, xs, lps)."""
    both = got[3] & want[3]
    return [int((g[both] != w[both]).sum()) for g, w in zip(
        list(got[0]) + list(got[1:3]), list(want[0]) + list(want[1:3]))]


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


def prior_table_priors(kt):
    """Four ``Factored`` priors of 16 marginals that hold every entry of
    the generic kernels' prior table, built from the package ``kt``
    (``tools/same_bits.py`` builds them from two trees)."""
    return {
        "P1": kt.Factored(
            kt.Beta(2.0, 5.0), kt.LogNormal(0.3, 0.8), kt.Laplace(1.0, 2.0),
            kt.Cauchy(0.5, 1.5), kt.Weibull(1.5, 2.0), kt.Chisq(4.0),
            kt.FDist(8.0, 12.0), kt.Logistic(0.5, 1.2), kt.Rayleigh(2.0),
            kt.Pareto(3.0, 2.0), kt.InverseGamma(3.0, 2.0),
            kt.Gumbel(0.5, 2.0), kt.TriangularDist(0.0, 4.0, 1.0),
            kt.Arcsine(1.0, 3.0), kt.Semicircle(2.0), kt.Frechet(5.0, 2.0)),
        "P2": kt.Factored(
            kt.Levy(0.5, 1.5), kt.GeneralizedPareto(0.5, 1.5, 0.2),
            kt.Kumaraswamy(2.0, 3.0), kt.VonMises(0.5, 2.0),
            kt.SymTriangularDist(1.0, 2.0), kt.Cosine(1.0, 2.0),
            kt.Epanechnikov(1.0, 2.0), kt.Biweight(-0.5, 1.5),
            kt.Triweight(0.0, 2.0), kt.JohnsonSU(0.5, 2.0, 0.3, 1.5),
            kt.GeneralizedExtremeValue(0.5, 1.5, 0.2),
            kt.InverseGaussian(2.0, 3.0), kt.Chi(3.0),
            kt.PGeneralizedGaussian(0.5, 1.5, 3.0), kt.Rician(2.0, 1.5),
            kt.Lindley(0.7)),
        "P3": kt.Factored(
            kt.LogitNormal(0.4, 0.9), kt.Exponential(1.5),
            kt.Gamma(2.5, 1.5), kt.LogUniform(0.1, 10.0),
            kt.BetaPrime(3.0, 5.0), kt.StudentT(4.0), kt.Uniform(0.0, 1.0),
            kt.Normal(0.0, 1.0), kt.TruncatedNormal(0.0, 1.0, -1.0, 2.0),
            kt.Truncated(kt.Gamma(2.0, 1.0), 0.5, 6.0),
            2.0 - 3.0 * kt.Exponential(1.0),
            kt.Mixture([kt.Normal(0.0, 0.5), kt.Normal(5.0, 0.5)]),
            kt.Poisson(6.0), kt.Bernoulli(0.3), kt.Binomial(10, 0.4),
            kt.Geometric(0.3)),
        "P4": kt.Factored(
            kt.NegativeBinomial(4.0, 0.3), kt.BetaBinomial(10, 2.0, 3.0),
            kt.Hypergeometric(7, 5, 6), kt.DiscreteUniform(1, 6),
            kt.Erlang(3, 2.0), kt.NormalCanon(2.0, 4.0),
            kt.GeneralizedPareto(0.0, 1.0, -0.25),
            kt.GeneralizedExtremeValue(0.0, 1.0, 0.0),
            kt.TriangularDist(0.0, 2.0, 0.0),
            kt.Mixture([kt.Gamma(2.0, 1.0), kt.LogNormal(0.0, 0.5),
                        kt.Uniform(0.0, 3.0)], [0.2, 0.5, 0.3]),
            1.0 + 2.0 * kt.Beta(2.0, 2.0),
            kt.Truncated(kt.StudentT(4.0), -1.0, 3.0), kt.Beta(0.5, 0.7),
            kt.Rician(6.0, 0.5),
            kt.Mixture([kt.Poisson(2.0), kt.Poisson(9.0)]),
            kt.Poisson(2.0)),
    }


def matrix_families(kt, np):
    """The nine vector and matrix families of slice 8 at the settings of
    tests/test_distributions.py:148-156, :316-343, :1118-1234: name ->
    (family, points off its support, checks of 10^5 draws x against
    ``statistics.mean``/``cov`` m/c, each (what, ok))."""
    S = np.array([[1.0, 0.3], [0.3, 0.8]])
    Psi = np.array([[2.0, 0.4], [0.4, 1.5]])
    cov3 = np.array([[1.0, 0.3, 0.0], [0.3, 2.0, 0.5], [0.0, 0.5, 1.5]])
    bad2 = [[[1.0, 0.0], [0.0, -1.0]], [[1.0, 2.0], [2.0, 1.0]]]
    eye = np.eye

    def rows_unit(x):   # L L^T of a Cholesky factor has a unit diagonal
        r = x @ np.swapaxes(x, -1, -2)
        return np.abs(np.diagonal(r, axis1=-2, axis2=-1) - 1.0).max()

    return {
        "Product": (kt.Product([kt.Normal(0, 1), kt.Normal(5, 2)]),
                    [[0.0, np.inf]],
                    lambda x, m, c: [("mean atol 0.05", np.abs(
                        x.mean(0) - m).max() < 0.05)]),
        "IID": (kt.IID(kt.Poisson(3.0), 3), [[-1.0, 2.0, 3.0]],
                lambda x, m, c: [("mean atol 0.05", np.abs(
                    x.mean(0) - m).max() < 0.05)]),
        "Multinomial": (kt.Multinomial(10, [0.2, 0.5, 0.3]),
                        [[2.0, 5.0, 4.0], [-1.0, 8.0, 3.0]],
                        lambda x, m, c: [
                            ("sum n", np.abs(x.sum(-1) - 10.0).max() < 1e-5),
                            ("mean atol 0.15", np.abs(x.mean(0) - m).max()
                             < 0.15),
                            ("cov atol 0.15", np.abs(np.cov(x.T) - c).max()
                             < 0.15)]),
        "MvLogNormal": (kt.MvLogNormal([0.2, -0.3], [[0.5, 0.2],
                                                     [0.2, 0.4]]),
                        [[1.0, -0.5]],
                        lambda x, m, c: [("mean rtol 0.05", np.allclose(
                            x.mean(0), m, rtol=0.05, atol=0))]),
        "MvTDist": (kt.MvTDist(5.0, [1.0, -2.0, 0.5], cov3), [],
                    lambda x, m, c: [
                        ("mean atol 0.1", np.abs(x.mean(0) - m).max() < 0.1),
                        ("cov rtol 0.15 atol 0.05", np.allclose(
                            np.cov(x.T), c, rtol=0.15, atol=0.05))]),
        "Wishart": (kt.Wishart(5.0, S), bad2,
                    lambda x, m, c: [("mean rtol 0.08", np.allclose(
                        x.mean(0), m, rtol=0.08, atol=0))]),
        "InverseWishart": (kt.InverseWishart(6.0, Psi), bad2,
                           lambda x, m, c: [("mean rtol 0.1", np.allclose(
                               x.mean(0), m, rtol=0.1, atol=0))]),
        "LKJ": (kt.LKJ(3, 1.8), [np.full((3, 3), -0.9) + 1.9 * eye(3)],
                lambda x, m, c: [
                    ("unit diagonal", np.abs(np.diagonal(
                        x, axis1=-2, axis2=-1) - 1.0).max() < 1e-5),
                    ("mean atol 0.03", np.abs(x.mean(0) - m).max() < 0.03)]),
        "LKJCholesky": (kt.LKJCholesky(4, 2.5), [-eye(4)],
                        lambda x, m, c: [
                            ("unit rows", rows_unit(x) < 1e-5),
                            ("E[L L^T] atol 0.03", np.abs(
                                (x @ np.swapaxes(x, -1, -2)).mean(0)
                                - eye(4)).max() < 0.03)]),
    }


def conformance(torch, np, kt, dev):
    """The ``conformance`` phase's checks on the card: the consistency
    battery's sample, logpdf and KS legs (and the quantile leg, and a
    discrete family's int32 draws, pmf and push) for every family of
    ``tests/battery_specs.py`` on a CUDA generator seeded 11;
    ``DiscreteUniform``'s int32 draws; ``Factored.rand``/``sample`` and
    the three density models' ``init_sample`` (structure, dtypes, device,
    law); and the bimodal smc of ``tests/test_gk_multimodal.py`` at 1000
    particles on the card and on ``make_mesh(walker=4, devices=["cuda:0"]
    * 4)``, the sharded run equal to the unsharded one. Returns
    ``{"passed": n, "failed": n, "failures": {check: message}}``; a
    failed check is counted, not raised."""
    import scipy.stats as st
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from battery_specs import CONTINUOUS, DISCRETE, build
    from kissabc_tpu_torch.parallel.mesh import make_mesh
    passed, failures = [], {}
    devtype = torch.device(dev).type   # "cuda" on the card

    def run(name, fn):
        try:
            fn()
            passed.append(name)
        except Exception as e:   # counted; the phase fails on any
            failures[name] = f"{type(e).__name__}: {e}"[:300]

    def gen(seed=11):
        return torch.Generator(device=dev).manual_seed(seed)

    def on_card(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def continuous(d):
        x = d.sample(gen(), (8000,))
        check(x.device.type == devtype and x.shape == (8000,)
              and bool(torch.isfinite(x).all()), "draws finite, on dev")
        bad = ~torch.isfinite(d.logpdf(x))
        if isinstance(d, kt.Arcsine):   # draws on b: logpdf(b) = -inf, as
            check(bool((x[bad] == float(d.b)).all()),   # in the JAX package
                  "non-finite logpdf only on b")
        else:
            check(not bool(bad.any()), "logpdf finite at the draws")
        if hasattr(d, "cdf"):
            ks = st.kstest(x[:4000].cpu().numpy(), lambda v: d.cdf(
                on_card(v)).cpu().numpy().astype(np.float64))
            check(ks.pvalue > 1e-4, f"KS p={ks.pvalue}")
        if hasattr(d, "cdf") and hasattr(d, "quantile"):
            qs = np.asarray([0.05, 0.25, 0.5, 0.75, 0.95], np.float32)
            back = d.cdf(d.quantile(on_card(qs))).cpu().numpy()
            check(np.allclose(back, qs, atol=5e-3),
                  f"cdf(quantile(q)) {back}")

    def discrete(d):
        x = d.sample(gen(), (8000,))
        check(x.dtype == torch.int32 and x.device.type == devtype,
              f"draws {x.dtype} on {x.device}")
        check(bool(torch.isfinite(d.logpdf(x)).all()),
              "logpmf finite at the draws")
        vals, counts = torch.unique(x, return_counts=True)
        emp = counts.cpu().numpy() / 8000
        model = torch.exp(d.logpdf(vals)).cpu().numpy()
        err = 5.0 * np.sqrt(np.maximum(model * (1 - model), 1e-12) / 8000)
        check(not (np.abs(emp - model) > np.maximum(err, 0.01)).any(),
              f"pmf {emp} against {model}")
        check(d.push(x.to(torch.float32) + 0.3).dtype == torch.int32,
              "push to int32")

    for spec in CONTINUOUS:
        run(f"battery {spec}", lambda s=spec: continuous(build(kt, s)))
    for spec in DISCRETE:
        run(f"battery {spec}", lambda s=spec: discrete(build(kt, s)))

    def discrete_uniform():
        x = kt.DiscreteUniform(-2, 7).sample(gen(), (8000,))
        check(x.dtype == torch.int32 and x.device.type == devtype
              and int(x.min()) == -2 and int(x.max()) == 7,
              f"{x.dtype} on {x.device}, range {int(x.min())}..{int(x.max())}")

    def leaves(tree):
        return [(tuple(v.shape), v.dtype, v.device.type) for v in tree]

    f32, i32 = torch.float32, torch.int32
    cov = np.array([[1.0, 0.3], [0.3, 0.5]])
    fac = kt.Factored(kt.DiscreteUniform(1, 6), kt.Normal(0.5, 2.0),
                      kt.MvNormal(np.zeros(2), cov))

    def factored():
        g = gen(5)
        one = [((), i32, devtype), ((), f32, devtype), ((2,), f32, devtype)]
        r = fac.rand(g)
        check(isinstance(r, tuple) and leaves(r) == one, f"rand {leaves(r)}")
        check(leaves(fac.sample(g)) == one, "sample(gen)")
        check(leaves(fac.sample(g, (3, 2))) == [
            ((3, 2), i32, devtype), ((3, 2), f32, devtype),
            ((3, 2, 2), f32, devtype)], "sample(gen, (3, 2))")
        k, z, _ = fac.sample(g, (8000,))
        pmf = torch.bincount(k.to(torch.int64), minlength=7)[1:].cpu()
        check(bool(((pmf / 8000 - 1 / 6).abs() < 0.02).all()),
              f"DiscreteUniform(1, 6) pmf {pmf}")
        check(abs(float(z.mean()) - 0.5) < 6 * 2.0 / math.sqrt(8000)
              and abs(float(z.std()) - 2.0) < 0.1,
              f"Normal(0.5, 2) mean {float(z.mean())} sd {float(z.std())}")

    def init_samples():
        prior = kt.Factored(kt.DiscreteUniform(1, 6), kt.Normal(0.5, 2.0))
        models_ = {
            "ApproxKernelizedPosterior": kt.ApproxKernelizedPosterior(
                prior, lambda th: th[1], 0.1),
            "ApproxPosterior": kt.ApproxPosterior(prior, lambda th: th[1],
                                                  0.1),
            "CommonLogDensity": kt.CommonLogDensity(
                2, lambda g: (torch.randint(1, 7, (), generator=g,
                                            device=g.device, dtype=i32),
                              0.5 + 2.0 * torch.randn(2, generator=g,
                                                      device=g.device)),
                lambda x: -torch.sum(x[1] ** 2))}
        g = gen(3)
        for name, m in models_.items():
            want = [((), f32, devtype), ((2,) if name == "CommonLogDensity"
                                        else (), f32, devtype)]
            got = leaves(m.init_sample(g))
            check(got == want, f"{name}: {got}")
            draws = [m.init_sample(g) for _ in range(1000)]
            k = torch.stack([d[0] for d in draws]).cpu()
            z = torch.stack([d[1].reshape(-1)[0] for d in draws]).cpu()
            check(float(k.min()) == 1 and float(k.max()) == 6
                  and abs(float(k.mean()) - 3.5) < 6 * 1.708 / math.sqrt(1000)
                  and abs(float(z.mean()) - 0.5) < 6 * 2.0 / math.sqrt(1000),
                  f"{name}: means {float(k.mean())}, {float(z.mean())}")

    def bimodal(x, g):   # tests/test_gk_multimodal.py: modes at +-2
        return torch.abs(x * x - 4.0) + 0.1 * torch.abs(
            torch.randn((), generator=g, device=g.device))

    def mixing(res):
        x = res.P.particles
        frac = float((x > 0).mean())
        check(0.2 < frac < 0.8 and np.abs(np.abs(x) - 2).mean() < 0.2,
              f"positive share {frac}, |x| {np.abs(x).mean()}")

    def multimodal_one_device():
        mixing(kt.smc(kt.Uniform(-10, 10), bimodal, nparticles=1000,
                      alpha=0.9, epstol=0.2, key=22, device=dev))

    def multimodal_mesh():
        mesh = make_mesh(walker=4, devices=[
            "cuda:0" if devtype == "cuda" else "cpu"] * 4)
        res = kt.smc(kt.Uniform(-10, 10), bimodal, nparticles=1000,
                     alpha=0.9, epstol=0.2, mesh=mesh, key=23, device=dev)
        mixing(res)
        one = kt.smc(kt.Uniform(-10, 10), bimodal, nparticles=1000,
                     alpha=0.9, epstol=0.2, key=23, device=dev)
        check(np.allclose(np.sort(res.P.particles),
                          np.sort(one.P.particles), rtol=1e-5, atol=0),
              "the sharded run differs from the unsharded one")

    run("DiscreteUniform(-2, 7) int32", discrete_uniform)
    run("Factored.rand/sample", factored)
    run("init_sample", init_samples)
    run("multimodal one device", multimodal_one_device)
    run("multimodal mesh walker=4", multimodal_mesh)
    return {"passed": len(passed), "failed": len(failures),
            "failures": failures}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save-ais-inputs", metavar="PATH",
                    help="also save ais-kernel-times' population and word "
                    "sets to PATH (torch.save), for tools/ais_plain_gap.py "
                    "--population")
    opts = ap.parse_args()
    import numpy as np
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
    from kissabc_tpu_torch.core import abcde as AB
    from kissabc_tpu_torch.core import rejection as RJ
    from kissabc_tpu_torch.ops import _build
    from kissabc_tpu_torch.ops import fused_abcde as FD
    from kissabc_tpu_torch.ops import fused_ais as FA
    from kissabc_tpu_torch.ops import fused_smc as F
    from kissabc_tpu_torch.ops import fused_tempered as FT
    from kissabc_tpu_torch.ops import kernels as K
    from kissabc_tpu_torch.ops import lane_groups as LG
    from kissabc_tpu_torch.ops import moves as M
    from kissabc_tpu_torch.ops import scan as SC
    from kissabc_tpu_torch.ops import streaming as S

    def reset_counts():
        for module in (K, S, F, SC, FA, FT, FD):
            module.reset_launch_counts()

    def counts():
        return {**K.launches, **S.launches, **F.launches, **SC.launches,
                **FA.launches, **FT.launches, **FD.launches}

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
    # slice 5: the tempered sweep's three models (tests/test_pallas.py
    # :1062-1295) and the fused ABC-DE generation's: the flagship model,
    # and the discrete prior of tests/test_abcde_pfilter.py:117-132 with a
    # Gaussian simulator around the particle
    cprior, ll_conj, ll_vec, tsmc_truth = models.conjugate_normal()
    ydata = [float(y) for y in models.TSMC_Y]

    def ll_bounded(theta):
        s_ = 0.0
        for y in ydata:
            s_ = s_ + torch.square(y - theta)
        return -0.5 * s_

    def ll_mixed(theta):
        a, k = theta
        return -0.5 * torch.square(a - 1.2) - 0.5 * torch.square(k - 3.0)

    tempered_models = {
        "conjugate": (cprior, ll_conj),
        "bounded": (kt.Uniform(0.5, 1.5), ll_bounded),
        "mixed": (kt.Factored(kt.Normal(1.0, 1.0), kt.DiscreteUniform(1, 6)),
                  ll_mixed)}
    tempered = {   # name: (sweep, stub twin)
        name: (kt.make_fused_tempered_sweep(p_, ll_),
               kt.make_fused_tempered_sweep(p_, ll_, bits="stub"))
        for name, (p_, ll_) in tempered_models.items()}
    gamma_de = 2.38 / math.sqrt(4.0)   # proposal_width 1, d = 2
    xprior = kt.DiscreteUniform(0, 10)

    def xdraw(x, eps):
        return x + 0.5 * eps

    def xreduce(x, m):
        return torch.abs(m[0] - 5.0)

    abcde_gens = {"flagship": kt.make_fused_abcde_generation(
        fprior, fdraw, freduce, gamma=gamma_de)}
    for cost_on in ("raw", "pushed"):
        abcde_gens[f"flagship-stub-{cost_on}"] = \
            kt.make_fused_abcde_generation(fprior, fdraw, freduce,
                                           gamma=gamma_de, cost_on=cost_on,
                                           bits="stub")
        abcde_gens[f"discrete-stub-{cost_on}"] = \
            kt.make_fused_abcde_generation(xprior, xdraw, xreduce,
                                           gamma=2.38 / math.sqrt(2.0),
                                           cost_on=cost_on, bits="stub")
    # slice 7: every family with an entry in the generic kernels' prior
    # table in one of four priors of 16 marginals, run through #3, #6, #9
    # and #10 on stub bits: nine units
    table_priors = prior_table_priors(kt)

    def ll_table(th):   # #9's conjugate log-likelihood of the first leaf
        return ll_conj(th[0])

    def tdraw(th, eps):   # the flagship draw on the first two leaves
        return fdraw(th[:2], eps)

    def treduce(th, m):
        return freduce(th[:2], m)

    # slice 9 (C4): a Dirac marginal, a float atom and an integer one,
    # pushed to its atom in the kernel; every sweep whose JAX kernel runs
    # it takes it (#3, #6, #9, #10)
    table_priors["P5"] = kt.Factored(
        kt.Uniform(1.5, 2.5), kt.Uniform(0.01, 0.1), kt.Dirac(2.5),
        kt.Dirac(3.0))
    table_sweeps = {   # (kernel, prior): sweep on stub bits
        ("#3", "P1"): kt.make_fused_smc_sweep(
            table_priors["P1"], tdraw, treduce, bits="stub"),
        ("#3", "P2"): kt.make_fused_smc_sweep(
            table_priors["P2"], tdraw, treduce, bits="stub"),
        ("#3", "P3"): kt.make_fused_smc_sweep(
            table_priors["P3"], tdraw, treduce, bits="stub"),
        ("#3", "P4"): kt.make_fused_smc_sweep(
            table_priors["P4"], tdraw, treduce, bits="stub"),
        ("#6", "P3"): kt.make_fused_ais_sweep(
            table_priors["P3"], tdraw, treduce, scale=0.5, bits="stub"),
        ("#6", "P4"): kt.make_fused_ais_sweep(
            table_priors["P4"], tdraw, treduce, scale=0.5, bits="stub"),
        ("#9", "P3"): kt.make_fused_tempered_sweep(
            table_priors["P3"], ll_table, bits="stub"),
        ("#10", "P2"): kt.make_fused_abcde_generation(
            table_priors["P2"], tdraw, treduce, gamma=2.38 / math.sqrt(32.0),
            bits="stub"),
        ("#10", "P4"): kt.make_fused_abcde_generation(
            table_priors["P4"], tdraw, treduce, gamma=2.38 / math.sqrt(32.0),
            bits="stub"),
        ("#3", "P5"): kt.make_fused_smc_sweep(
            table_priors["P5"], tdraw, treduce, bits="stub"),
        ("#6", "P5"): kt.make_fused_ais_sweep(
            table_priors["P5"], tdraw, treduce, scale=0.5, bits="stub"),
        ("#9", "P5"): kt.make_fused_tempered_sweep(
            table_priors["P5"], ll_table, bits="stub"),
        ("#10", "P5"): kt.make_fused_abcde_generation(
            table_priors["P5"], tdraw, treduce, gamma=2.38 / math.sqrt(8.0),
            bits="stub"),
    }
    # slice 7's path at full width: smc-1m-generic with a prior of new
    # families (its cost unit is smc-1m-generic's)
    nprior = kt.Factored(1.0 + 2.0 * kt.Beta(2.0, 2.0),
                         kt.LogNormal(-3.0, 1.0))
    nsweep = kt.make_fused_smc_sweep(nprior, fdraw, freduce)
    # slice 8's: the mixed discrete model of tests/test_pallas.py:864-890
    # at 2^20 through #4 (ndraws 500) and #3, which pushes m in the kernel
    mprior, mdraw, mreduce = models.mixed_discrete()
    mcost = kt.make_streaming_moment_cost(mdraw, mreduce, ndraws=500)
    msweep = kt.make_fused_smc_sweep(mprior, mdraw, mreduce, ndraws=500)
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
    t5_units = {}
    for name, (sw, _) in tempered.items():
        t5_units.setdefault(sw.unit.source, []).append(f"tempered {name}")
    for name, g5 in abcde_gens.items():
        t5_units.setdefault(g5.unit.source, []).append(f"abcde {name}")
    table_units = {sw.unit.source: [f"prior-table {k} {p}"]
                   for (k, p), sw in table_sweeps.items()}
    table_units.setdefault(nsweep.unit.source, []).append(
        "sweep smc-1m-generic-priors")
    # (its cost unit is the flagship cost's: the draw is the same)
    check(mcost.unit(2).source in units, "smc-1m-generic-discrete's cost "
          "unit is not the flagship cost's")
    table_units.setdefault(msweep.unit.source, []).append(
        "sweep smc-1m-generic-discrete")

    # the walkthroughs of examples_torch/ and the units of their kernels:
    # streaming_sim's two #4 units and scan_sim's two #5 units are new;
    # fused_ais' #4 and #6, sir's #5 and tsmc's #9 are the flagship, SIR
    # and conjugate units above (the same generated text)
    EX = {name: importlib.import_module(f"examples_torch.{name}")
          for name in EXAMPLES + ("example_covariance", "example_expmix")}
    ex_stream, ex_scan = EX["example_streaming_sim"], EX["example_scan_sim"]
    ex_fa = EX["example_fused_ais"]
    ex_costs = {   # name: (cost, theta structure, prior), as main builds
        "weibull": (ex_stream.cost, 2, ex_stream.prior),
        "gk-ecdf": (ex_stream.make_gk_cost(ex_stream.gk_probes(dev)), 4,
                    ex_stream.gk_prior)}
    ex_scans = {
        "ou": (ex_scan.cost, 3, ex_scan.prior),
        "wiener": (ex_scan.cost2, 2, ex_scan.prior2),
        "sir": (kt.make_streaming_scan_cost(
            sstep, sinit, sreduce, observe=sobserve, series=sseries,
            nsteps=2 * models.SIR_DAYS), 2, models.sir()[0])}
    built = {**units, **ais_units, **t5_units, **table_units}
    ex_units = {}
    for name, (c, k, _) in {**ex_costs, **ex_scans}.items():
        if c.unit(k).source not in built:
            ex_units.setdefault(c.unit(k).source, []).append(f"example {name}")
    for what, unit in (
            ("fused_ais #4", kt.make_streaming_moment_cost(
                ex_fa.draw, ex_fa.reduce_cost).unit(2)),
            ("fused_ais #6", kt.make_fused_ais_sweep(
                ex_fa.prior, ex_fa.draw, ex_fa.reduce_cost,
                scale=ex_fa.SCALE).unit),
            ("tsmc #9", kt.make_fused_tempered_sweep(
                kt.Normal(0, 1), EX["example_tsmc"].loglike_elem).unit)):
        check(unit.source in built, f"example {what}: its unit is not one "
              "the build phases start")

    ptxas = {}   # unit names -> ptxas lines, each after its function

    def ptxas_lines(log, prefix):
        fn = ""
        for line in log.splitlines():
            m = re.search(r"(?:entry function '|Function properties for )"
                          r"(\w+)", line)
            if m:
                fn = kernel_name(m.group(1))
                targs = re.search(r"ILb([01])ELi(\d+)EE", m.group(1))
                if targs:   # a lane-group kernel's <stub, lanes>
                    fn += f"<{targs.group(1)},{targs.group(2)}>"
            if "registers" in line or "spill" in line:
                ptxas.setdefault(prefix, []).append(f"{fn}: {line.strip()}")
                say(f"  ptxas {prefix} {fn}: {line.strip()}")

    with Phase("build") as ph:
        # every nvcc starts now: the hand-written sources (flagship.cu and
        # ais.cu, one library) and each generated unit
        jobs = [_build.start()] + [_build.start(text) for text in units]
        ais_jobs = [_build.start(text) for text in ais_units]
        t5_jobs = [_build.start(text) for text in t5_units]
        table_jobs = [_build.start(text) for text in table_units]
        ex_jobs = [_build.start(text) for text in ex_units]
        radius_job = _build.start(RADIUS_CHECK)
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
        geo78 = FA.flagship_geometry(65536, LG.sm_count(0))
        per_sm, sms, grid = FA.full_grid(65536, geo78)
        ph.result = (f"ais.cu in {lib_path.name}; {len(ais_units)} generated "
                     f"AIS units, the slowest compiled in {slowest:.2f} s "
                     f"(started with the others); ais.cu ptxas "
                     f"{ptxas['ais.cu']}; kt_fused_ais_full co-resident: "
                     f"{per_sm} blocks/SM x {sms} SMs, grid {grid} blocks of "
                     f"{geo78.threads} threads ({geo78.walkers} walkers a "
                     f"range) for h=65536")

    with Phase("build-tempered-abcde") as ph:
        secs5 = {}
        for (text, names), job in zip(t5_units.items(), t5_jobs):
            _, secs, log = job.wait()
            ptxas_lines(log, "/".join(names))
            _build.load_generated(text)
            secs5["/".join(names)] = round(secs, 2)
        ph.result = (f"{len(t5_units)} generated units of kernels #9 "
                     f"(tempered.cuh) and #10 (generic.cuh, KT_HAS_ABCDE), "
                     f"started with the others; nvcc seconds {secs5}")

    with Phase("build-prior-table") as ph:
        secs7 = {}
        for (text, names), job in zip(table_units.items(), table_jobs):
            _, secs, log = job.wait()
            ptxas_lines(log, "/".join(names))
            _build.load_generated(text)
            secs7["/".join(names)] = round(secs, 2)
        ph.result = (f"{len(table_units)} generated units of the prior "
                     f"table (#3, #6, #9, #10 on four priors of 16 "
                     f"marginals and on P5's Dirac marginals), "
                     f"smc-1m-generic-priors' #3 and "
                     f"smc-1m-generic-discrete's #3, started with the "
                     f"others; nvcc seconds {secs7}")

    with Phase("build-examples") as ph:
        secs_ex = {}
        for (text, names), job in zip(ex_units.items(), ex_jobs):
            _, secs, log = job.wait()
            ptxas_lines(log, "/".join(names))
            _build.load_generated(text)
            secs_ex["/".join(names)] = round(secs, 2)
        ph.result = (f"{len(ex_units)} generated units of the walkthroughs "
                     f"of examples_torch/ (#4: Weibull, g-and-k ecdf; #5: "
                     f"OU, Wiener), started with the others; nvcc seconds "
                     f"{secs_ex}")

    ex_runs = {}   # walkthrough -> wall and launches

    def run_example(name):
        """``main()`` of one walkthrough of examples_torch/ on the card
        (its asserts inside), its wall and the kernels it launched;
        returns main's result."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = EX[name].main()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: v for k, v in counts().items() if v}
        for k in EXAMPLE_KERNELS.get(name, ()):
            check(launched.get(k, 0) > 0, f"{name} launched no {k}")
        check(set(launched) <= set(EXAMPLE_KERNELS.get(name, ())),
              f"{name} launched {launched}")
        ex_runs[name] = dict(wall_s=wall, launches=launched)
        say(f"[example] {name}: {wall:.3f} s, launches {launched}")
        return out

    with Phase("radius-exhaustive") as ph:
        radius_job.wait()
        lib = _build.load_generated(RADIUS_CHECK)
        lib.kt_radius_check.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        bad = torch.zeros(1, dtype=torch.int32, device=dev)
        _build.check(lib, lib.kt_radius_check(
            bad.data_ptr(), torch.cuda.current_stream().cuda_stream),
            "radius_check")
        check(int(bad) == 0, f"box_muller_radius differs from sqrtf(-2 "
              f"log1pf(-u)) at {int(bad)} of 2^23 values of u")
        ph.result = ("box_muller_radius equals sqrtf(-2 log1pf(-u)) bit for "
                     "bit at all 2^23 values of u")

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
        # kernel #2 takes the step's raw words and derives its partners;
        # its plain version takes the rolls roll_shifts makes of them
        xs = torch.ones(n, device=dev)
        lps = torch.full((n,), -3.0, device=dev)
        skw = dict(ndraws=nd, bits="stub", block=2048, chunk=512)
        consts = K.fused_sweep_constants(
            max_stretch=2.0, mu_lo=1.0, mu_hi=3.0, sg_sigma=0.05, sg_lo=0.0,
            sg_hi=100.0)
        words = torch.tensor([4, 75, 7], dtype=torch.int64, device=dev)
        got = K.fused_sweep_words(mu, sg, xs, lps, 0.5, words, **skw)
        dmu, dsg = K.sweep_partners(mu, sg, words)
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
        for w, t in GEOMETRIES_2:   # the same bits on each
            geo = K.check_sweep_geometry(n, w, t)
            other = K.fused_sweep_words(mu, sg, xs, lps, 0.5, words,
                                        geometry=geo, **skw)
            check(same_bits(other, got), f"#2 stub: {geometry_key(geo)} "
                  "differs from the default")
        ph.result = (f"cost max|err| {max(errs):.3g}; sweep max|err| "
                     f"{err:.3g}, {acc} commits, {border} borderline; the "
                     f"sweep's outputs equal bit for bit on "
                     f"{len(GEOMETRIES_2)} geometries")

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
        mu_b = buf(2.0)
        mu_b[:n] = uniform(n, 1.9, 2.1)
        K.launch_fused_sweep(
            n, (mu_b, buf(0.04), buf(1.0), buf(0.0)), outs,
            torch.tensor([0.5], device=dev),
            torch.tensor([3, 17, 5], dtype=torch.int64, device=dev),
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
            commits[name] = (acc, border, unequal_committed(got, want))
        ph.result = (f"max|err| {max(errs.values()):.3g} "
                     f"({json.dumps(errs)}); commits, borderline, unequal "
                     f"committed values {commits}")

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

    def time_cost(c, th, seed, what):
        """Kernel #4 on ``th``: its max|err| against the plain version
        and the plain version's ms (one call), the kernel's own time by
        the profiler (and by queued events) at its default geometry and
        at each of ``GEOMETRIES_4``, which must give the default's
        outputs bit for bit, the time by events around calls of
        ``moments`` (the host's launches included) and the bound."""
        structure, n = len(th), th[0].shape[0]
        got = torch.stack(c.moments(th, seed))
        want, plain = cuda_timed(torch, lambda: c.moments_plain(th, seed))
        err = max(assert_close(torch, g, w, f"streaming moment {p} {what}")
                  for p, (g, w) in enumerate(zip(got, want)))
        leaves = [x.contiguous() for x in th]
        out = torch.empty_like(got)

        def run(geo):
            c.launch(n, leaves, seed, out, n, structure=structure,
                     geometry=geo)

        default = c.geometry(n, structure)
        by_geometry = {}
        for w, t, lanes in [tuple(default[1:])] + [
                g for g in GEOMETRIES_4 if g != tuple(default[1:])]:
            geo = LG.cost_check(n, w, t, lanes, c.nstats)
            run(geo)
            check(same_bits(out, got), f"streaming_moment_cost {what}: "
                  f"{geometry_key(geo)} differs from "
                  f"{geometry_key(default)}")
            by_geometry[geometry_key(geo)] = dict(
                device_ms=device_ms(torch, lambda: run(geo), 20,
                                    "streaming_moment_cost_kernel"),
                queued_ms=queued_ms(torch, lambda: run(geo), 20))
        b, by = bound(c.work(n, structure))
        return dict(max_abs_err=err, plain_ms=plain, bound_ms=b, bound_by=by,
                    geometry=geometry_key(default),
                    ms=by_geometry[geometry_key(default)]["device_ms"],
                    events_ms=cuda_ms(torch, lambda: c.moments(th, seed), 20),
                    by_geometry=by_geometry)
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
        xs = uniform(n, 0.0, 1.0)
        lps = prior.logpdf(prior.push_tree((mu, sg)))
        pkw = dict(consts=consts, ndraws=nd, target_mu=2.0, target_sd=0.04,
                   sd_weight=50.0, block=2048, chunk=512, bits="hw")
        # kernel #2 on the step's words: [4, 75] give the shifts (5, 77)
        # of the JAX bench at n = 131072, then random words; each against
        # the plain version on the rolls of the same words
        words2 = {"shifts (5, 77)": torch.tensor(
            [4, 75, 11], dtype=torch.int64, device=dev),
            "random": FA.uint32_words(gen, 3)}
        check(M.roll_shifts([4, 75], n) == (5, 77),
              "words [4, 75] do not give the shifts (5, 77)")
        err2, border, nsim2 = 0.0, {}, {}
        for wname, words in words2.items():
            got = K.fused_sweep_words(mu, sg, xs, lps, 0.5, words)
            dmu, dsg = K.sweep_partners(mu, sg, words)
            want = K.fused_sweep_plain(mu, sg, dmu, dsg, xs, lps, 0.5,
                                       words[2:], **pkw)
            e, border[wname] = compare_sweeps(
                torch, flagship_outputs(got), flagship_outputs(want), 0.5,
                f"fused_sweep n=131072, {wname} words")
            err2 = max(err2, e)
            check_untouched(torch, (mu, sg, xs, lps), got[:4], got[4],
                            f"fused_sweep n=131072, {wname} words")
            # the bound counts the simulator only for the walkers that
            # pass gate 1: no other walker's outputs depend on it
            nsim2[wname] = int(K.fused_sweep_proposal_plain(
                mu, sg, dmu, dsg, lps, words[2:], consts=consts, block=2048,
                bits="hw")[3].sum())
        words = words2["shifts (5, 77)"]
        ms2 = cuda_ms(torch, lambda: K.fused_sweep_words(
            mu, sg, xs, lps, 0.5, words), 50)
        dmu, dsg = K.sweep_partners(mu, sg, words)
        plain2 = cuda_ms(torch, lambda: K.fused_sweep_plain(
            mu, sg, dmu, dsg, xs, lps, 0.5, words[2:], **pkw), 2, warmup=1)
        b2, by2 = bound(K.fused_sweep_work(n, nd, nsim2["shifts (5, 77)"]))
        # the kernel's own time by the profiler and by queued events at
        # each geometry of GEOMETRIES_2, which must give the default's
        # outputs bit for bit
        geo2 = K.sweep_geometry(n, LG.sm_count(0))
        outs2 = tuple(torch.empty_like(mu) for _ in range(4)) + (
            torch.empty(n, dtype=torch.bool, device=dev),)

        def sweep2(geo):
            K.launch_fused_sweep(n, (mu, sg, xs, lps), outs2, 0.5, words,
                                 geometry=geo, **pkw)

        sweep2(geo2)
        ref2 = [x.clone() for x in outs2]
        by_geometry2 = {}
        for w, t in [(geo2.walkers, geo2.threads)] + [
                g for g in GEOMETRIES_2 if g != (geo2.walkers, geo2.threads)]:
            geo = K.check_sweep_geometry(n, w, t)
            sweep2(geo)
            check(same_bits(list(outs2), ref2), f"fused_sweep hw: "
                  f"{geometry_key(geo)} differs from {geometry_key(geo2)}")
            by_geometry2[geometry_key(geo)] = dict(
                device_ms=device_ms(torch, lambda: sweep2(geo), 20,
                                    "fused_sweep_kernel"),
                queued_ms=queued_ms(torch, lambda: sweep2(geo), 20))
        records.append(dict(
            name="fused_sweep", route="cuda",
            source="kissabc_tpu_torch/csrc/flagship.cu",
            replaces="kissabc_tpu/ops/pallas_kernels.py:295",
            launches=sweep_launches, max_abs_err=err2, matched=True,
            ms=ms2, plain_ms=plain2, bound_ms=b2, bound_by=by2,
            library_ms=None, simulated_share=nsim2["shifts (5, 77)"] / n,
            geometry=geometry_key(geo2),
            device_ms=by_geometry2[geometry_key(geo2)]["device_ms"],
            queued_ms=by_geometry2[geometry_key(geo2)]["queued_ms"],
            by_geometry=by_geometry2,
            registers=[line for line in ptxas.get("flagship", [])
                       if "fused_sweep" in line]))
        # the generic kernels at the shapes of the 2**20 generic path. No
        # single PyTorch call streams a user simulator per walker (or fuses
        # a sweep around one), so library_ms is null for both.
        n = 1 << 20
        th = fprior.sample_tree(gen, n)
        times4 = {n: time_cost(costs["flagship"][0], th, seed,
                               "flagship n=2^20")}
        ms3, b3 = times4[n]["ms"], times4[n]["bound_ms"]

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
        gate1 = F.proposal_plain(sw, th, lps, alive, 5, 77, 11)[3]
        nsim = int(gate1.sum())
        b4, by4 = bound(sw.work(n, nsim))
        # the block size, by measurement: each walker's bits are keyed by
        # its index, so every block size gives the same outputs bit for bit
        ins = sw._inputs(n, xs.device, xs, lps, alive, eps_t, flag_t)
        by_threads, modelled4 = {}, {"uncompacted": F.lane_share(gate1, 32)}
        for t in (128, 256, 512, 1024):
            outs = ([torch.empty_like(x) for x in th],
                    torch.empty_like(xs), torch.empty_like(lps),
                    torch.empty(n, dtype=torch.bool, device=dev))
            sw.launch(n, th, ins, rs, outs, threads=t)
            for g, o in zip(list(got[0]) + list(got[1:]),
                            list(outs[0]) + list(outs[1:])):
                check(bool(torch.equal(g, o)), f"fused_smc_sweep: blocks of "
                      f"{t} differ from blocks of {F.SWEEP_THREADS}")
            by_threads[t] = dict(
                ms=cuda_ms(torch, lambda: sw.launch(n, th, ins, rs, outs,
                                                    threads=t), 20),
                blocks_per_sm=sw.occupancy(t))
            modelled4[t] = F.lane_share(gate1, t)
        records.append(dict(
            name="fused_smc_sweep", route="cuda",
            source="kissabc_tpu_torch/csrc/generic.cuh",
            replaces="kissabc_tpu/ops/pallas_kernels.py:2159",
            launches=generic_launches["fused_smc_sweep"],
            max_abs_err=err4, matched=True, ms=ms4, plain_ms=plain4,
            bound_ms=b4, bound_by=by4, library_ms=None,
            simulated_share=nsim / n, threads=F.SWEEP_THREADS,
            unequal=unequal_committed(got, want), by_threads=by_threads))
        ph.result = (f"normal_summary_cost {ms1:.3f} ms (bound {b1:.3f}); "
                     f"fused_sweep {ms2:.4f} ms (bound {b2:.4f}, {nsim2} "
                     f"of 131072 walkers pass gate 1), borderline commits "
                     f"{border}; by geometry {json.dumps(by_geometry2)}; "
                     f"streaming_moment_cost "
                     f"{ms3:.3f} ms (bound {b3:.3f}, "
                     f"{times4[n]['geometry']}; by geometry "
                     f"{json.dumps(times4[n]['by_geometry'])}); "
                     f"fused_smc_sweep "
                     f"{ms4:.3f} ms (bound {b4:.3f}, {nsim} of {n} walkers "
                     f"pass gate 1), {border4} borderline, blocks of "
                     f"{F.SWEEP_THREADS}; by block size "
                     f"{json.dumps(by_threads)}; modelled lane shares "
                     f"(fused_smc.lane_share on the gate-1 mask, not "
                     f"measured) {json.dumps(modelled4)}")

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
        # the kernel's own time by the profiler and by queued events in
        # blocks of SCAN_THREADS, which must give equal outputs
        leaves5 = [x.contiguous() for x in th]
        out5 = torch.empty((2, n), device=dev)
        by_threads5 = {}
        for t in SCAN_THREADS:
            c.launch(n, leaves5, seed, out5, n, structure=2, threads=t)
            check(same_bits(list(out5), list(got)), f"scan: blocks of {t} "
                  f"differ from blocks of {SC.SCAN_THREADS}")
            by_threads5[t] = dict(
                device_ms=device_ms(torch, lambda: c.launch(
                    n, leaves5, seed, out5, n, structure=2, threads=t), 20,
                    "streaming_scan_cost_kernel"),
                queued_ms=queued_ms(torch, lambda: c.launch(
                    n, leaves5, seed, out5, n, structure=2, threads=t), 20))
        records.append(dict(
            name="streaming_scan_cost", route="cuda",
            source="kissabc_tpu_torch/csrc/scan.cuh",
            replaces="kissabc_tpu/ops/pallas_kernels.py:2800",
            launches=scan_launches, max_abs_err=err5, matched=True, ms=ms5,
            plain_ms=plain5, bound_ms=b5, bound_by=by5, library_ms=None,
            threads=SC.SCAN_THREADS, by_threads=by_threads5, registers=regs))
        ph.result = (f"n={n} x {nsteps} steps: {ms5:.4f} ms, "
                     f"{n * nsteps / (ms5 / 1e3) / 1e9:.2f} Gsteps/s, bound "
                     f"{b5:.4f} ms ({by5}), plain {plain5:.1f} ms, max|err| "
                     f"{err5:.3g} ({unequal} unequal values); blocks of "
                     f"{SC.SCAN_THREADS}; by block size "
                     f"{json.dumps(by_threads5)}; ptxas {regs}")

    with Phase("cost-kernel-times") as ph:
        # kernel #4 at the widths of its other paths: 1000 (smc-fused-
        # generic's init) and 16384 (abcde-fused's split generations) on
        # the flagship model, 131072 on g-and-k (streaming-gk, the split
        # AIS sweeps of ais-fused-generic)
        for n, (name, pr) in ((1000, ("flagship", fprior)),
                              (16384, ("flagship", fprior)),
                              (131072, ("g-and-k", gprior))):
            times4[n] = time_cost(costs[name][0], pr.sample_tree(gen, n),
                                  torch.tensor([17], dtype=torch.int64,
                                               device=dev), f"{name} n={n}")
        ph.result = "; ".join(
            f"n={n}: {t['ms']:.5f} ms on the card ({t['geometry']}), "
            f"{t['events_ms']:.5f} ms by events, bound {t['bound_ms']:.5f} "
            f"ms ({t['bound_by']}), plain {t['plain_ms']:.1f} ms, max|err| "
            f"{t['max_abs_err']:.3g}; by geometry "
            f"{json.dumps(t['by_geometry'])}" for n, t in times4.items())

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

    def flat(o):
        """A half-update's (theta leaves, lp, ll) as one list."""
        return list(o[0]) + [o[1], o[2]]

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
    # #7 and #8 take raw words (six shift words a half, then the seed)
    # and derive the shifts in the kernel; their plain versions take the
    # shifts rot_shifts6 makes of the same words
    words13 = torch.cat([FA.uint32_words(
        torch.Generator(device=dev).manual_seed(5), 12), seed_t])
    # ais-kernel-times keeps the inputs it had when #7 and #8 took shifts:
    # these words give, at h = 65536, shifts12 and the seed 2024
    words_h65536 = torch.tensor([5, 77, 999, 3, 39999, 64999, 11, 2, 64999,
                                 9, 122, 4565, 2024], dtype=torch.int64,
                                device=dev)

    def shifts_of(words, h):
        return torch.cat([FA.rot_shifts6(words[k:k + 6], h)
                          for k in range(0, len(words) - 1, 6)])

    def words7(half):   # one half's shift words and the seed
        return torch.cat([words13[6 * half:6 * half + 6], seed_t])
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
        m7.launch_half(ins, comp, words7(0), outs)
        want = m7.half_plain(*ins, *comp, shifts_of(words7(0), h), seed_t)
        res["#7 half"] = ais_compare(outs, want[:4], ins,
                                     "fused_ais_half stub", want[5])
        for w, t in GEOMETRIES_78:   # the same bits on each
            other = [torch.empty_like(x) for x in ins]
            geo = FA.check_geometry(h, w, t)
            m7.launch_half(ins, comp, words7(0), other, geo)
            check(same_bits(other, outs), f"#7 stub: "
                  f"{geometry_key(geo)} differs from the default")
        # kernel #8: both halves in one launch
        m8 = FA.FlagshipAIS(scale=0.1, block=1024, bits="stub", **fl_kw)
        ins = [th[0], th[1], lp, ll]
        outs = [torch.empty_like(x) for x in ins]
        m8.launch_full(ins, words13, outs)
        want = m8.full_plain(*ins, shifts_of(words13, h), seed_t)
        res["#8 full"] = ais_compare(outs, want[:4], ins,
                                     "fused_ais_full stub", want[5])
        check(res["#8 full"][2] > 0, "fused_ais_full stub committed nothing")
        for w, t in GEOMETRIES_78:
            other = [torch.empty_like(x) for x in ins]
            geo = FA.check_geometry(h, w, t)
            m8.launch_full(ins, words13, other, geo)
            check(same_bits(other, outs), f"#8 stub: "
                  f"{geometry_key(geo)} differs from the default")
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
            # the kernel takes the half's words; the plain version the
            # shifts rot_shifts6 makes of them
            got = sw.half_words(upd, lp6[:h], ll6[:h], cmp_, words7(0))
            want = sw.half_plain(upd, lp6[:h], ll6[:h], cmp_,
                                 shifts_of(words7(0), h), seed_t, terms=True)
            res[f"#6 {name}"] = ais_compare(
                flat(got), flat(want), upd + [lp6[:h], ll6[:h]],
                f"fused_ais_sweep stub {name}", want[3][1])
            check(res[f"#6 {name}"][2] > 0, f"#6 {name} committed nothing")
            for w, t, lanes in GEOMETRIES_6:   # the same bits on each
                geo = LG.check(h, w, t, lanes, sw.nstats)
                other = sw.half_words(upd, lp6[:h], ll6[:h], cmp_,
                                      words7(0), geometry=geo)
                check(same_bits(flat(other), flat(got)),
                      f"#6 {name} stub: {geometry_key(geo)} differs from "
                      f"{geometry_key(sw.geometry(h))}")
        ph.result = ("(max|err|, unequal committed values, commits, "
                     "borderline): " + json.dumps(res) + f"; each model's "
                     f"outputs equal bit for bit on {len(GEOMETRIES_6)} "
                     f"more geometries of #6, #7's and #8's on "
                     f"{len(GEOMETRIES_78)} of theirs")

    with Phase("ais-kernel-times") as ph:
        # the main-path shapes: n = 131072 walkers x 1000 draws, Philox
        n, h, nd = 131072, 65536, 1000
        th0 = prior.sample_tree(gen, n)
        model_k = kt.ApproxKernelizedPosterior(prior, flagship_cost,
                                               0.005, cost_vectorized=True)
        lds0 = model_k.loglike_batch(th0, gen)
        ins = [th0[0].contiguous(), th0[1].contiguous(), lds0[0], lds0[1]]
        if opts.save_ais_inputs:
            torch.save(dict(ins=[x.cpu() for x in ins], words={
                "words13": words13.cpu(),
                "words_h65536": words_h65536.cpu()}), opts.save_ais_inputs)
        times, plain_ms = {}, {}   # plain: one whole sweep, the same inputs
        m7 = FA.FlagshipAIS(scale=0.005, block=2048, bits="hw", **fl_kw)
        m8 = FA.FlagshipAIS(scale=0.005, block=1024, bits="hw", **fl_kw)
        sh = shifts_of(words_h65536, h)   # #6's plain version takes shifts
        check(torch.equal(sh, shifts12), "words_h65536 give other shifts")
        # #6 (and #9) take each half's six shift words and the seed
        w6 = [torch.cat([words_h65536[k:k + 6], seed_t]) for k in (0, 6)]
        outs7 = [torch.empty_like(x) for x in ins]
        outs8 = [torch.empty_like(x) for x in ins]
        cur = {}   # the word set the sweeps run on

        def sweep7(geo=None):
            wa, wb = (torch.cat([cur["words"][k:k + 6], seed_t])
                      for k in (0, 6))
            m7.launch_half([x[:h] for x in ins], [x[h:] for x in ins[:2]],
                           wa, [o[:h] for o in outs7], geo)
            m7.launch_half([x[h:] for x in ins], [o[:h] for o in outs7[:2]],
                           wb, [o[h:] for o in outs7], geo)

        def plain7():   # half B against the updated half A, as sweep7
            shw = shifts_of(cur["words"], h)
            a = m7.half_plain(*(x[:h] for x in ins), ins[0][h:], ins[1][h:],
                              shw[:6], seed_t)
            return a, m7.half_plain(*(x[h:] for x in ins), a[0], a[1],
                                    shw[6:], seed_t)

        def sweep8(geo=None):
            m8.launch_full(ins, cur["words"], outs8, geo)

        # #7 and #8 against their plain versions on both word sets (C2:
        # words13's shifts put a walker near the target); the times on
        # words13, the last
        res7, res8 = {}, {}
        for wname, words in (("words_h65536", words_h65536),
                             ("words13", words13)):
            cur["words"] = torch.cat([words[:12], seed_t])
            sweep7()
            (a7, b7), plain_ms["fused_ais_half"] = cuda_timed(torch, plain7)
            want7 = [torch.cat([a, b]) for a, b in zip(a7, b7)]
            res7[wname] = ais_compare(outs7, want7[:4], ins,
                                      f"fused_ais_half hw, {wname}",
                                      want7[5])
            nsim7 = int(a7[4].sum() + b7[4].sum())
            sweep8()
            want8, plain_ms["fused_ais_full"] = cuda_timed(
                torch, lambda: m8.full_plain(*ins, shifts_of(
                    cur["words"], h), seed_t))
            res8[wname] = ais_compare(outs8, list(want8[:4]), ins,
                                      f"fused_ais_full hw, {wname}",
                                      want8[5])
            nsim8 = int(want8[4].sum())
        err7 = (max(r[0] for r in res7.values()),) + res7["words13"][1:]
        err8 = (max(r[0] for r in res8.values()),) + res8["words13"][1:]
        times["fused_ais_half"] = cuda_ms(torch, sweep7, 20)
        times["fused_ais_full"] = cuda_ms(torch, sweep8, 20)
        # #7's and #8's own time by the profiler and by queued events, at
        # the default geometry and at each of GEOMETRIES_78, which must give
        # the default's outputs bit for bit
        geo78 = FA.flagship_geometry(h, LG.sm_count(0))
        extra78 = {}
        for name, run, outs_, kernel, per_call in (
                ("fused_ais_half", sweep7, outs7, "fused_ais_half_kernel", 2),
                ("fused_ais_full", sweep8, outs8, "fused_ais_full_kernel",
                 1)):
            ref = [x.clone() for x in outs_]
            by_geometry = {}
            for w, t in [(geo78.walkers, geo78.threads)] + [
                    g for g in GEOMETRIES_78
                    if g != (geo78.walkers, geo78.threads)]:
                geo = FA.check_geometry(h, w, t)
                run(geo)
                check(same_bits(outs_, ref), f"{name} hw: "
                      f"{geometry_key(geo)} differs from "
                      f"{geometry_key(geo78)}")
                by_geometry[geometry_key(geo)] = dict(
                    device_ms=device_ms(torch, lambda: run(geo), 20, kernel,
                                        per_call=per_call),
                    queued_ms=queued_ms(torch, lambda: run(geo), 20),
                    **({"blocks_per_sm": FA.full_grid(h, geo)[0]}
                       if name == "fused_ais_full" else {}))
            default = by_geometry[geometry_key(geo78)]
            extra78[name] = dict(
                device_ms=default["device_ms"],
                queued_ms=default["queued_ms"],
                geometry=geometry_key(geo78),
                registers=[line for line in ptxas.get("ais.cu", [])
                           if kernel in line],
                by_geometry=by_geometry)
        sw6 = ais_sweeps["flagship"][0]
        outs6 = ([torch.empty_like(x) for x in ins[:2]],
                 torch.empty_like(ins[2]), torch.empty_like(ins[3]))

        def halves6(o):
            return [tuple(x[sl] for x in o[0]) + (o[1][sl], o[2][sl])
                    for sl in (slice(0, h), slice(h, n))]

        def sweep6(geo=None):
            oa, ob = halves6(outs6)
            sw6.half_words([ins[0][:h], ins[1][:h]], ins[2][:h], ins[3][:h],
                           [ins[0][h:], ins[1][h:]], w6[0],
                           outs=(list(oa[:2]), oa[2], oa[3]), geometry=geo)
            sw6.half_words([ins[0][h:], ins[1][h:]], ins[2][h:], ins[3][h:],
                           list(oa[:2]), w6[1],
                           outs=(list(ob[:2]), ob[2], ob[3]), geometry=geo)

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
        # #6's time by events around 20 sweeps (two launches each, the
        # host's wrapper included), as #7's and #8's; beside it the
        # kernel's own, by the profiler and by events around sweeps queued
        # behind a spin. Then every geometry of GEOMETRIES_6, which must
        # give the default's outputs bit for bit
        times["fused_ais_sweep"] = cuda_ms(torch, sweep6, 20)
        inside6 = torch.cat([a6[3][0], b6[3][0]])
        ref6 = [x.clone() for x in list(outs6[0]) + list(outs6[1:])]
        geo6 = sw6.geometry(h)
        by_geometry6, modelled6 = {}, {}
        for w, t, lanes in [tuple(geo6[1:])] + [
                g for g in GEOMETRIES_6 if g != tuple(geo6[1:])]:
            geo = LG.check(h, w, t, lanes, sw6.nstats)
            sweep6(geo)
            check(same_bits(list(outs6[0]) + list(outs6[1:]), ref6),
                  f"#6 flagship hw: {geometry_key(geo)} differs from "
                  f"{geometry_key(geo6)}")
            by_geometry6[geometry_key(geo)] = dict(
                device_ms=device_ms(torch, lambda: sweep6(geo), 20,
                                    "fused_ais_sweep_kernel", per_call=2),
                queued_ms=queued_ms(torch, lambda: sweep6(geo), 20),
                blocks_per_sm=sw6.occupancy(geo))
            modelled6[geometry_key(geo)] = LG.lane_share(
                inside6, LG.check(n, w, t, lanes, sw6.nstats))
        modelled6["uncompacted"] = LG.lane_share(
            inside6, LG.check(n, 32, 32, 1, sw6.nstats))
        extra6 = dict(
            device_ms=device_ms(torch, sweep6, 20, "fused_ais_sweep_kernel",
                                per_call=2),
            queued_ms=queued_ms(torch, sweep6, 20),
            geometry=geometry_key(geo6),
            registers=ptxas.get("ais flagship", []),
            by_geometry=by_geometry6)
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
            f"#7 {json.dumps(res7)}, #8 {json.dumps(res8)}, #6 {err6}; "
            f"#7, #8 on the card by the "
            f"profiler and by queued events, by geometry "
            f"{json.dumps({k: v['by_geometry'] for k, v in extra78.items()})}"
            f"; #6 on the card "
            f"{extra6['device_ms']:.4f} ms/sweep by the profiler, "
            f"{extra6['queued_ms']:.4f} by queued events; by geometry "
            f"{json.dumps(by_geometry6)}; modelled lane shares "
            f"(lane_groups.lane_share on the plain version's inside mask, "
            f"not measured) {json.dumps(modelled6)}; ptxas "
            f"{json.dumps(regs)}")

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
            bound_by=bounds[name][1], library_ms=None,
            **(extra6 if name == "fused_ais_sweep" else
               extra78[name])))

    # ---- slice 5: tsmc, pfilter, ABCDE; kernels #9 and #10 -------------
    with Phase("tempered-stub") as ph:
        # kernel #9, one half-update at h = 32768 on stub bits, against its
        # plain version on the card, on the three models at lam 0, 0.3, 1
        n, h = 65536, 32768
        res = {}
        for name, (p_, ll_) in tempered_models.items():
            sw = tempered[name][1]
            if name == "conjugate":
                leaves = [torch.randn(n, generator=gen, device=dev)]
            elif name == "bounded":
                leaves = [uniform(n, 0.5, 1.5)]
            else:
                leaves = [torch.randn(n, generator=gen, device=dev) + 1.0,
                          torch.randint(1, 7, (n,), generator=gen,
                                        device=dev).float()
                          + uniform(n, -0.4, 0.4)]
            pushed = sw.pushed(leaves)
            lp5 = p_.logpdf_tree(pushed).float()
            ll5 = ll_(pushed).float()
            upd, cmp_ = [x[:h] for x in leaves], [x[h:] for x in leaves]
            for lam in (0.0, 0.3, 1.0):
                # the kernel takes the half's words; the plain version the
                # shifts rot_shifts6 makes of them
                got = sw.half_words(upd, lp5[:h], ll5[:h], cmp_, words7(0),
                                    lam)
                want = sw.half_plain(upd, lp5[:h], ll5[:h], cmp_,
                                     shifts_of(words7(0), h), seed_t, lam,
                                     terms=True)
                r = ais_compare(flat(got), flat(want),
                                upd + [lp5[:h], ll5[:h]],
                                f"fused_tempered_sweep stub {name} "
                                f"lam={lam}", want[3][1])
                check(r[2] > 0, f"#9 {name} lam={lam} committed nothing")
                res[f"{name} lam={lam}"] = r
        ph.result = ("(max|err|, unequal committed values, commits, "
                     "borderline): " + json.dumps(res))

    def abcde_compare(got, want, inputs, hi, what, band=1e-4,
                      cost_atol=1e-4):
        """Kernel vs plain ABC-DE generation on the same inputs, outputs
        (theta leaves, lps, ds, gate) and the plain version's simulated
        cost ``dp``: the gate masks equal; the commit masks equal except
        where ``dp`` lies within ``band`` (relative, floor 1) of
        ``hi = max(eps_i, ds)``; committed values within the golden
        tolerance (ds within ``cost_atol``: the flagship reduce's
        ``m2 - m1^2`` cancels, see kernel-times); walkers that do not
        commit keep their inputs bit for bit. Returns (max abs err,
        unequal committed values, commits, borderline, gate passes)."""
        gate_g, gate_w = got[-1] > 0.5, want[3] > 0.5
        check(bool(torch.equal(gate_g, gate_w)), f"{what}: gate masks "
              f"differ on {int((gate_g != gate_w).sum())} walkers")
        outs_g = list(got[0]) + [got[1], got[2]]
        outs_w = list(want[0]) + [want[1], want[2]]

        def committed(outs):
            m = torch.zeros_like(gate_g)
            for o, x in zip(outs, inputs):
                m |= o != x
            return m

        gc, wc = committed(outs_g), committed(outs_w)
        differ = gc != wc
        border = differ & ((want[4] - hi).abs() < band * hi.abs().clamp(
            min=1.0))
        check(bool((~differ | border).all()), f"{what}: commit masks "
              f"differ on {int((differ & ~border).sum())} walkers away from "
              "max(eps_i, ds)")
        check(not bool(gc[~gate_g].any()), f"{what}: a walker committed "
              "without passing the gate")
        both = gc & wc
        err, unequal = 0.0, 0
        for k, (g, w, x) in enumerate(zip(outs_g, outs_w, inputs)):
            kw = {"atol": cost_atol} if k == len(inputs) - 1 else {}
            err = max(err, assert_close(torch, g[both], w[both],
                                        f"{what} output {k}", **kw))
            check(bool(torch.equal(g[~gc], x[~gc])),
                  f"{what}: uncommitted output {k} changed")
            unequal += int((g[both] != w[both]).sum())
        return (err, unequal, int(both.sum()), int(border.sum()),
                int(gate_g.sum()))

    def abcde_generation_inputs(g5, leaves, cost_hi):
        """Bases and partners gathered at random from the population, its
        prior logpdf with every 13th walker at -inf, costs in [0,
        cost_hi), thresholds 0.3 at or below 0.3 else 0.8, half of the
        walkers inactive."""
        n = leaves[0].shape[0]
        idx = [torch.randint(0, n, (n,), generator=gen, device=dev)
               for _ in range(3)]
        bases = [[x[i] for x in leaves] for i in idx]
        pushed = g5.prior.push_tree(leaves[0] if len(leaves) == 1
                                    else tuple(leaves))
        lps = g5.prior.logpdf_tree(pushed).float().contiguous()
        lps[::13] = float("-inf")
        ds = uniform(n, 0.0, cost_hi)
        active = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
        eps_i = torch.where(ds <= 0.3, 0.3, 0.8)
        return bases, lps, ds, active, eps_i

    with Phase("abcde-stub") as ph:
        # kernel #10 at n = 65536 x 1000 draws on stub bits against its
        # plain version on the card: the flagship model with the cost on
        # the raw and on the pushed proposal, and the discrete prior
        n = 65536
        res = {}
        for name in ("flagship-stub-raw", "flagship-stub-pushed",
                     "discrete-stub-raw", "discrete-stub-pushed"):
            g5 = abcde_gens[name]
            if name.startswith("flagship"):
                leaves = [uniform(n, 1.5, 2.5), uniform(n, 0.01, 0.1)]
            else:
                leaves = [torch.randint(0, 11, (n,), generator=gen,
                                        device=dev).float()
                          + uniform(n, -0.4, 0.4)]
            bases, lps, ds, active, eps_i = abcde_generation_inputs(
                g5, leaves, 3.0)
            got = g5.run(leaves, bases, lps, ds, active, eps_i, seed_t)
            want = g5.generation_plain(leaves, bases, lps, ds, active,
                                       eps_i, seed_t, terms=True)
            r = abcde_compare(got, want, leaves + [lps, ds],
                              torch.maximum(eps_i, ds), f"#10 {name}")
            check(r[2] > 0, f"#10 {name} committed nothing")
            check(not bool((got[3] > 0.5)[active == 0].any()),
                  f"#10 {name}: an inactive walker passed the gate")
            res[name] = r
            for w, t, lanes in GEOMETRIES_10:   # the same bits on each
                geo = LG.check(n, w, t, lanes, g5.nstats)
                other = g5.run(leaves, bases, lps, ds, active, eps_i, seed_t,
                               geometry=geo)
                check(same_bits(other, got), f"#10 {name}: "
                      f"{geometry_key(geo)} differs from "
                      f"{geometry_key(g5.geometry(n))}")
        ph.result = ("(max|err|, unequal committed values, commits, "
                     "borderline, gate passes): " + json.dumps(res)
                     + f"; each model's outputs equal bit for bit on "
                     f"{len(GEOMETRIES_10)} more geometries of #10")

    with Phase("tempered-kernel-times") as ph:
        # kernel #9 per sweep at 131072 walkers, Philox, the conjugate
        # loglike at lam = 0.3, on each half's words (words_h65536: the
        # shifts12 of earlier runs); the plain version as one whole sweep
        # on the same inputs; also at tsmc-conjugate's 4096
        sw9 = tempered["conjugate"][0]
        lam9 = torch.tensor(0.3, device=dev)
        times9 = {}
        for n in (131072, 4096):
            h = n // 2
            th9 = torch.randn(n, generator=gen, device=dev)
            lp9, ll9 = cprior.logpdf(th9).float(), ll_conj(th9).float()
            w9 = [torch.cat([words_h65536[k:k + 6], seed_t]) for k in (0, 6)]
            outs9 = ([torch.empty_like(th9)], torch.empty_like(lp9),
                     torch.empty_like(ll9))
            oa9, ob9 = ([[o[0][0][sl]], o[1][sl], o[2][sl]] for o, sl in (
                (outs9, slice(0, h)), (outs9, slice(h, n))))

            def sweep9():
                sw9.half_words([th9[:h]], lp9[:h], ll9[:h], [th9[h:]], w9[0],
                               lam9, outs=oa9)
                sw9.half_words([th9[h:]], lp9[h:], ll9[h:], oa9[0], w9[1],
                               lam9, outs=ob9)

            sweep9()
            sh9 = shifts_of(words_h65536, h)

            def plain9():
                a = sw9.half_plain([th9[:h]], lp9[:h], ll9[:h], [th9[h:]],
                                   sh9[:6], seed_t, lam9, terms=True)
                return a, sw9.half_plain([th9[h:]], lp9[h:], ll9[h:], a[0],
                                         sh9[6:], seed_t, lam9, terms=True)

            (a9, b9), plain9_ms = cuda_timed(torch, plain9)
            want9 = [torch.cat([a9[0][0], b9[0][0]]),
                     torch.cat([a9[1], b9[1]]), torch.cat([a9[2], b9[2]])]
            err9 = ais_compare(flat(outs9), want9, [th9, lp9, ll9],
                               f"fused_tempered_sweep hw n={n}",
                               torch.cat([a9[3][1], b9[3][1]]))
            # the kernels' own time by the profiler and by queued events,
            # and the sweep's time by events around 50 calls, the host's
            # wrapper and launch overhead included
            w = sw9.work(h)
            times9[n] = dict(
                device_ms=device_ms(torch, sweep9, 50,
                                    "fused_tempered_sweep_kernel",
                                    per_call=2),
                queued_ms=queued_ms(torch, sweep9, 50),
                events_ms=cuda_ms(torch, sweep9, 50),
                plain_ms=plain9_ms, bound=bound((2 * w[0], 2 * w[1])),
                err=err9)
        t9 = times9[131072]
        regs = {names: lines for names, lines in ptxas.items()
                if "tempered" in names}
        ph.result = "; ".join(
            f"n={n}: {t['device_ms']:.5f} ms/sweep on the card "
            f"({t['queued_ms']:.5f} queued), {t['events_ms']:.4f} ms by "
            f"events with the host's launches; bound "
            f"{t['bound'][0]:.5f} ms ({t['bound'][1]}), plain "
            f"{t['plain_ms']:.1f} ms/sweep; (max|err|, unequal committed "
            f"values, commits, borderline) {t['err']}"
            for n, t in times9.items()) + f"; ptxas {json.dumps(regs)}"

    with Phase("abcde-kernel-times") as ph:
        # kernel #10 per generation at 16384 and 131072 walkers x 1000
        # draws on the flagship model, Philox, on the inputs of an ABCDE
        # generation (costs from kernel #4, eps unreachable, the rank
        # trick's bases); the plain version on the same inputs
        g10 = abcde_gens["flagship"]
        times10 = {}
        for n in (16384, 131072):
            th10 = [x.contiguous() for x in fprior.sample_tree(gen, n)]
            lps10 = fprior.logpdf_tree(tuple(th10)).float()
            ds10 = costs["flagship"][0](tuple(th10), gen)
            eps_i10 = torch.clamp(ds10.min(), min=1e-6).expand(n).contiguous()
            order10, count10 = AB.rank_count(ds10)
            v10 = FD.uint32_words(gen, 3 * n).reshape(3, n)
            parents = AB.bases_from_words(v10, ds10, eps_i10, order10,
                                          count10)
            bases10 = [[x[i] for x in th10] for i in parents]
            act10 = torch.ones(n, device=dev)
            args10 = (th10, bases10, lps10, ds10, act10, eps_i10, seed_t)
            got = g10.run(*args10)
            want, plain_ms10 = cuda_timed(torch, lambda: g10.generation_plain(
                *args10, terms=True))
            err10 = abcde_compare(got, want, th10 + [lps10, ds10],
                                  torch.maximum(eps_i10, ds10),
                                  f"#10 hw n={n}")
            # the clocks up first: the one-wave kernel back to back for
            # half a second; then its own time as the median of 5 repeats
            # of 20 launches by the profiler, with their spread
            t_end = time.perf_counter() + 0.5
            while time.perf_counter() < t_end:
                for _ in range(50):
                    g10.run(*args10)
                torch.cuda.synchronize()
            reps10 = sorted(device_ms(torch, lambda: g10.run(*args10), 20,
                                      "fused_abcde_generation_kernel")
                            for _ in range(5))
            ms10 = reps10[2]
            events10 = cuda_ms(torch, lambda: g10.run(*args10), 20)
            queued10 = queued_ms(torch, lambda: g10.run(*args10), 20)
            nsim10 = int(want[3].sum())
            gate10 = want[3] > 0.5
            geo10 = g10.geometry(n)
            by_geometry10, modelled10 = {}, {}
            for w, t, lanes in [tuple(geo10[1:])] + [
                    g for g in GEOMETRIES_10 if g != tuple(geo10[1:])]:
                geo = LG.check(n, w, t, lanes, g10.nstats)
                check(same_bits(g10.run(*args10, geometry=geo), got),
                      f"#10 hw n={n}: {geometry_key(geo)} differs from "
                      f"{geometry_key(geo10)}")
                by_geometry10[geometry_key(geo)] = dict(
                    device_ms=device_ms(torch, lambda: g10.run(
                        *args10, geometry=geo), 20,
                        "fused_abcde_generation_kernel"),
                    queued_ms=queued_ms(torch, lambda: g10.run(
                        *args10, geometry=geo), 20),
                    blocks_per_sm=g10.occupancy(geo))
                modelled10[geometry_key(geo)] = LG.lane_share(gate10, geo)
            modelled10["uncompacted"] = LG.lane_share(
                gate10, LG.check(n, 32, 32, 1, 2))
            times10[n] = (ms10, plain_ms10, bound(g10.work(n, nsim10)),
                          err10, nsim10, events10, dict(
                              repeats_ms=reps10, queued_ms=queued10,
                              geometry=geometry_key(geo10),
                              by_geometry=by_geometry10), modelled10)
        regs = {names: lines for names, lines in ptxas.items()
                if "abcde" in names}
        ph.result = "; ".join(
            f"n={n}: {t[0]:.4f} ms/generation on the card, median of "
            f"{t[6]['repeats_ms']} ({n / (t[0] / 1e3):.4g} updates/s), "
            f"{t[6]['queued_ms']:.4f} ms by queued events, {t[5]:.4f} ms "
            f"by events, bound {t[2][0]:.4f} ms ({t[2][1]}, {t[4]} walkers "
            f"pass the gate), plain {t[1]:.1f} ms; (max|err|, unequal, "
            f"commits, borderline, gate passes) {t[3]}; by geometry "
            f"{json.dumps(t[6]['by_geometry'])}; modelled lane shares "
            f"(lane_groups.lane_share on the plain version's gate mask, not "
            f"measured) {json.dumps(t[7])}"
            for n, t in times10.items()) + f"; ptxas {json.dumps(regs)}"

    with Phase("tsmc-conjugate") as ph:
        # bench.py:825-881: 4096 particles, 5 MCMC steps, key 1, warm; the
        # split rejuvenation, then the fused sweep (#9), then #9 at 131072
        m_t, sd_t, logz_t = tsmc_truth

        def run_tsmc(n, fused, key):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = kt.tsmc(cprior, ll_vec, nparticles=n, mcmc_steps=5,
                        loglike_vectorized=True, key=key,
                        sweep_fused=tempered["conjugate"][0] if fused
                        else None)
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0

        out = {}
        tempered_launches = 0
        for label, n, fused in (("split", 4096, False), ("fused", 4096, True),
                                ("fused", 131072, True)):
            run_tsmc(n, fused, 11)   # warm
            reset_counts()
            r, wall = run_tsmc(n, fused, 1)
            launched = counts()
            check(r.lam == 1.0, f"tsmc {label} n={n}: lam {r.lam}")
            check(abs(r.P.mean() - m_t) < 0.02,
                  f"tsmc {label} n={n}: mean {r.P.mean()} vs {m_t}")
            check(abs(r.P.std() - sd_t) < 0.02,
                  f"tsmc {label} n={n}: sd {r.P.std()} vs {sd_t}")
            check(abs(r.log_evidence - logz_t) < 0.15,
                  f"tsmc {label} n={n}: log Z {r.log_evidence} vs {logz_t}")
            n9 = launched["fused_tempered_sweep"]
            check(n9 == (2 * 5 * r.iterations if fused else 0),
                  f"tsmc {label} n={n}: {n9} launches of #9 in "
                  f"{r.iterations} iterations")
            check(sum(launched.values()) == n9,
                  f"tsmc launched another kernel: {launched}")
            tempered_launches += n9
            out[f"{label} n={n}"] = (
                f"wall {wall:.4f} s, {r.iterations} iterations, mean "
                f"{r.P.mean():.5f} sd {r.P.std():.5f} log Z "
                f"{r.log_evidence:.4f} (truth {m_t:.5f}, {sd_t:.5f}, "
                f"{logz_t:.4f}), ESS {r.ess:.1f}, #9 launches {n9}")
        ph.result = json.dumps(out)

    with Phase("pfilter-mixture") as ph:
        # bench.py:884-911: Uniform(-10, 10), the 0.1N+N mixture cost per
        # walker, 4096 particles, key 4, warm
        def run_pf(key):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = kt.pfilter(kt.Uniform(-10, 10), models.mixture_cost, 4096,
                           key=key)
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0

        run_pf(11)
        reset_counts()
        r, wall = run_pf(4)
        m = float(r.P.mean())
        check(abs(m) < 0.25 and r.eps < 1.0,
              f"pfilter: mean {m}, eps {r.eps}")
        ph.result = (f"n=4096: wall {wall:.4f} s, {r.iterations} "
                     f"iterations, eps {r.eps:.5f}, mean {m:.5f}, unfixed "
                     f"{r.unfixed} (per-walker vmap; launches {counts()})")

    with Phase("abcde-dirac") as ph:
        # bench.py:914-938: Normal(1, 0.2), |x^2 + 1 - 1.5|, eps 0.01, 1024
        # particles, 2000 generations, earlystop, key 1, warm
        def run_dirac(key):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = kt.ABCDE(kt.Normal(1, 0.2), models.dirac_cost, 0.01,
                         nparticles=1024, generations=2000, earlystop=True,
                         verbose=False, key=key)
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0

        run_dirac(11)
        r, wall = run_dirac(1)
        m = float(r.P.mean())
        check(r.reached_eps and abs(m - math.sqrt(0.5)) < 0.02,
              f"ABCDE dirac: reached {r.reached_eps}, mean {m}")
        ph.result = (f"n=1024: wall {wall:.4f} s, {r.iterations} "
                     f"generations, nsim {r.nsim}, mean {m:.5f} (truth "
                     f"{math.sqrt(0.5):.5f})")

    with Phase("abcde-fused") as ph:
        # bench.py:940-987: the flagship streaming model at 16384 particles
        # x 1000 draws, eps 1e-6 (unreachable): the marginal time per
        # generation from 20 and 520 generations (median of 3 runs after a
        # warm one), fused (#10) and split (kernel #4); then the rule of
        # tests/test_pallas.py:1404-1416 at 4096 particles, 60 generations
        nb = 16384
        scost = costs["flagship"][0]

        def run_de(n, fused, gens, key, eps=1e-6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = kt.ABCDE(fprior, scost, eps, nparticles=n, generations=gens,
                         cost_vectorized=True, verbose=False, key=key,
                         sweep_fused=abcde_gens["flagship"] if fused
                         else None)
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0

        out = {}
        for label, fused in (("fused", True), ("split", False)):
            reset_counts()
            walls = {}
            for gens in (20, 520):
                run_de(nb, fused, gens, 12)
                ts = []
                for rep in range(3):
                    r, wall = run_de(nb, fused, gens, 2 + rep)
                    ts.append(wall)
                walls[gens] = sorted(ts)[1]
            launched = counts()
            if fused:
                abcde_launches = launched["fused_abcde_generation"]
                check(abcde_launches == 4 * (20 + 520),
                      f"#10 launched {abcde_launches} times")
            else:
                check(launched["fused_abcde_generation"] == 0,
                      "the split path launched #10")
                cost_split_launches = launched["streaming_moment_cost"]
            check(launched["streaming_moment_cost"] > 0,
                  f"ABCDE {label} did not launch kernel #4: {launched}")
            marg = (walls[520] - walls[20]) / 500
            mu = float(r.P[0].mean())
            check(abs(mu - 2.0) < 0.05, f"ABCDE {label}: mean mu {mu}")
            out[label] = (f"{marg * 1e3:.4f} ms/generation marginal, "
                          f"{nb / marg:.4g} updates/s (walls 20: "
                          f"{walls[20]:.4f} s, 520: {walls[520]:.4f} s), "
                          f"mu {mu:.5f}, launches {launched}")
        for label, fused in (("fused", True), ("split", False)):
            r, wall = run_de(4096, fused, 60, 2, eps=0.02)
            mu, sg = (float(p.mean()) for p in r.P)
            check(abs(mu - 2.0) < 0.02 and abs(sg - 0.04) < 0.003,
                  f"ABCDE {label} n=4096: mu {mu}, sigma {sg}")
            out[f"{label} rule n=4096"] = (f"mu {mu:.5f} sigma {sg:.5f}, "
                                           f"nsim {r.nsim}, wall "
                                           f"{wall:.3f} s")
        ph.result = json.dumps(out)

    # ---- slice 6: abc_rejection, host_cost, the prior battery ----------
    def profiled(fn, nchunks):
        """One run of ``fn`` under torch.profiler: CUDA events a chunk,
        the host's waits for the card (cudaStreamSynchronize,
        cudaDeviceSynchronize) and its copies (cudaMemcpyAsync, which
        includes copies on the card that do not wait), the device's busy
        time, its idle share of the profiled wall, and device ms a chunk
        of the kernels whose names hold ``normal_summary_cost``,
        ``streaming_moment_cost`` or ``sort``."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        devs = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        spans, end = 0.0, float("-inf")
        for s, e in sorted((e.time_range.start, e.time_range.end)
                           for e in devs):
            spans += max(0.0, e - max(s, end))
            end = max(end, e)
        by = {}
        for e in devs:
            for key in ("normal_summary_cost", "streaming_moment_cost",
                        "sort"):
                if key in e.name.lower():
                    by[key] = by.get(key, 0.0) + (e.time_range.end
                                                  - e.time_range.start)
        calls = {e.key: e.count for e in prof.key_averages()}
        syncs = (calls.get("cudaStreamSynchronize", 0)
                 + calls.get("cudaDeviceSynchronize", 0))
        copies = calls.get("cudaMemcpyAsync", 0)
        return dict(chunks=nchunks, cuda_events_per_chunk=len(devs) / nchunks,
                    host_syncs=syncs, host_syncs_per_chunk=syncs / nchunks,
                    memcpy_calls=copies, wall_profiled_s=wall,
                    device_busy_s=spans / 1e6,
                    device_idle_share=1 - spans / 1e6 / wall,
                    device_ms_per_chunk={k: v / 1e3 / nchunks
                                         for k, v in by.items()})

    def parity(P, what):
        mu_p, sg_p = P
        check(abs(mu_p.mean() - 2.0) < 0.05, f"{what}: mean mu {mu_p.mean()}")
        check(abs(sg_p.mean() - 0.0401) < 0.005,
              f"{what}: mean sigma {sg_p.mean()}")

    with Phase("rejection-budget") as ph:
        # bench.py:605-632 (row_rejection), uncut: the flagship cost (#1),
        # 4096 particles, chunks of 131072, 1600 chunks; timed as
        # _time_scalar_fn(reps=3) times it (two warm calls, three timed)
        n_r, b_r, nch_r = 4096, 131072, 1600
        nsims_r = b_r * nch_r
        rcost = kt.make_flagship_cost_batched()

        def rejection(seed, chunks=nch_r):
            return kt.abc_rejection(prior, rcost, n_r, nsims=b_r * chunks,
                                    batch=b_r, cost_vectorized=True, key=seed)

        rejection(101)
        rejection(102)
        walls = []
        for rep in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rejection(rep)
            walls.append(time.perf_counter() - t0)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rejection(7)
        wall7 = time.perf_counter() - t0
        launched = counts()
        rejection_launches = launched["normal_summary_cost"]
        check(rejection_launches == nch_r,
              f"budget mode launched #1 {rejection_launches} times")
        check(sum(launched.values()) == rejection_launches,
              f"budget mode launched another kernel: {launched}")
        check(res.naccept == n_r and res.nsims == nsims_r,
              f"naccept {res.naccept}, nsims {res.nsims}")
        check(abs(res.log_evidence - math.log(n_r / nsims_r)) < 1e-12,
              f"log_evidence {res.log_evidence}")
        cs = res.C.particles
        check(bool((np.diff(cs) >= 0).all()) and cs[-1] == np.float32(
            res.eps), "costs not ascending to eps")
        check(abs(res.eps - 0.007323) < 0.05 * 0.007323,
              f"eps {res.eps} not within 5% of 0.007323")
        parity(res.P, "rejection-budget")
        prof_r = profiled(lambda: rejection(8, 100), 100)
        # the chunk's two parts alone at the chunk's shapes: #1 on a prior
        # draw (against its plain version) and the merge with a full buffer
        th = prior.sample_tree(gen, b_r)
        seed = torch.tensor([13], dtype=torch.int64, device=dev)
        got = K.normal_summary_cost(th[0], th[1], seed)
        err1c = assert_close(torch, got, K.normal_summary_cost_plain(
            th[0], th[1], seed), "normal_summary_cost n=131072")
        ms1c = cuda_ms(torch, lambda: K.normal_summary_cost(th[0], th[1],
                                                            seed), 20)
        b1c = bound(K.normal_summary_cost_work(b_r, 1000))
        buf_th = prior.sample_tree(gen, n_r)
        buf_cs = torch.sort(got[:n_r]).values
        merge_ms = cuda_ms(torch, lambda: RJ.merge_best(
            buf_th, buf_cs, th, got, n_r), 50)
        merge_queued = queued_ms(torch, lambda: RJ.merge_best(
            buf_th, buf_cs, th, got, n_r), 50)
        # a whole chunk (prior draw, seed, #1, merge): by events, paced by
        # the host's launches, and queued behind a spin, the card's time;
        # 20 chunks (680 launches): the stream's queue of pending launches
        # (~1000) must not fill while the spin runs, or the host waits
        draw = RJ._make_draw_chunk(prior, rcost, b_r, True)

        def chunk():
            RJ.merge_best(buf_th, buf_cs, *draw(gen), n_r)

        chunk_ms, chunk_queued = cuda_ms(torch, chunk, 20), queued_ms(
            torch, chunk, 20)
        med = sorted(walls)[1]
        rejection_budget = dict(
            sims_per_s_median=nsims_r / med, sims_per_s_best=nsims_r /
            min(walls), walls_s=walls, wall_counted_s=wall7, eps=res.eps,
            log_evidence=res.log_evidence, launches=launched,
            cost_ms_131072=ms1c, cost_bound_ms_131072=b1c[0],
            cost_max_abs_err_131072=err1c, merge_ms=merge_ms,
            merge_queued_ms=merge_queued, chunk_ms=chunk_ms,
            chunk_queued_ms=chunk_queued, profile_100_chunks=prof_r)
        ph.result = (f"{card}: {nsims_r / med:.4g} sims/s (median of 3 warm "
                     f"calls; best {nsims_r / min(walls):.4g}; walls "
                     f"{[round(w, 4) for w in walls]} s); eps {res.eps:.6f}, "
                     f"mu {res.P[0].mean():.5f} sigma {res.P[1].mean():.5f}; "
                     f"#1 {ms1c:.4f} ms and the merge {merge_ms:.4f} ms "
                     f"({merge_queued:.4f} queued) a chunk alone, a whole "
                     f"chunk {chunk_ms:.4f} ms ({chunk_queued:.4f} queued); "
                     f"{json.dumps(prof_r)}; launches {launched}")

    with Phase("rejection-threshold") as ph:
        # threshold mode through kernel #4: the flagship model as a user
        # model, 4096 particles, eps 0.05, batches of 16384, max_sims 2^24
        tcost = kt.make_streaming_moment_cost(fdraw, freduce, ndraws=1000)

        def threshold(seed):
            return kt.abc_rejection(fprior, tcost, 4096, eps=0.05,
                                    batch=16384, max_sims=1 << 24,
                                    cost_vectorized=True, key=seed)

        threshold(101)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = threshold(3)
        wall_t = time.perf_counter() - t0
        launched = counts()
        threshold_launches = launched["streaming_moment_cost"]
        batches = res.nsims // 16384
        check(threshold_launches == batches,
              f"{threshold_launches} launches of #4 in {batches} batches")
        check(sum(launched.values()) == threshold_launches,
              f"threshold mode launched another kernel: {launched}")
        cs = res.C.particles
        check(bool(np.isfinite(cs).all()), "the buffer did not fill")
        check(bool((cs <= 0.05).all() and (np.diff(cs) >= 0).all()),
              "costs above eps or not ascending")
        parity(res.P, "rejection-threshold")
        prof_t = profiled(lambda: threshold(4), batches)
        # the acceptance mass of 2^22 fresh prior draws through the cost
        hits = 0
        for _ in range(4):
            th = fprior.sample_tree(gen, 1 << 20)
            hits += int((tcost(th, gen) <= 0.05).sum())
        share = hits / (1 << 22)
        check(abs(res.log_evidence - math.log(share)) < 0.1,
              f"log_evidence {res.log_evidence} vs log {share}")
        rejection_threshold = dict(
            sims_per_s=res.nsims / wall_t, wall_s=wall_t, nsims=res.nsims,
            naccept=res.naccept, log_evidence=res.log_evidence,
            log_share_2_22=math.log(share), launches=launched,
            profile=prof_t)
        ph.result = (f"{card}: {res.nsims / wall_t:.4g} sims/s ({batches} "
                     f"batches in {wall_t:.4f} s), naccept {res.naccept}, "
                     f"log Z {res.log_evidence:.4f} vs {math.log(share):.4f} "
                     f"from 2^22 draws; mu {res.P[0].mean():.5f} sigma "
                     f"{res.P[1].mean():.5f}; {json.dumps(prof_t)}; "
                     f"launches {launched}")

    with Phase("host-cost") as ph:
        # smc on the README model through host_cost: the cost simulated
        # with numpy on the host, one round trip a sweep
        def readme_sim(thetas, seeds):
            mu, sigma = thetas
            out = np.empty(len(mu))
            for i in range(len(mu)):
                z = np.random.default_rng(int(seeds[i])).standard_normal(1000)
                x = mu[i] + sigma[i] * z
                out[i] = np.hypot(x.mean() - 2.0, (x.std() - 0.04) * 50)
            return out

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = kt.smc(prior, kt.host_cost(readme_sim), cost_vectorized=True,
                     nparticles=1000, epstol=EPSTOL, key=2)
        wall = time.perf_counter() - t0
        check(res.eps <= EPSTOL, f"eps {res.eps} > {EPSTOL}")
        parity(res.P, "host-cost")
        ph.result = (f"n=1000 iterations {res.iterations} eps {res.eps:.6f} "
                     f"mu {res.P[0].mean():.5f} sigma {res.P[1].mean():.5f} "
                     f"wall {wall:.3f} s (numpy on the host; launches "
                     f"{counts()})")

    with Phase("prior-battery") as ph:
        # tests/test_sampler_prior_battery.py on the card: smc on each
        # family at 128 particles (256 for the vector leaves), AIS on the
        # truncated Poisson and the mixture, with that file's checks
        def scalar_cost(target):
            return lambda x, g: torch.abs(x.to(torch.float32) - target)

        cases = [
            (kt.LogUniform(0.1, 10.0), 2.0,
             lambda P: abs(P.median() - 2.0) < 0.5),
            (kt.BetaPrime(3.0, 5.0), 0.5,
             lambda P: abs(P.median() - 0.5) < 0.3),
            (kt.Poisson(6.0), 4.0,
             lambda P: np.all(P.particles == np.round(P.particles))
             and abs(P.median() - 4.0) <= 1.0),
            (kt.Truncated(kt.Poisson(6.0), 2, 12), 4.0,
             lambda P: P.particles.min() >= 2 and P.particles.max() <= 12),
            (kt.DiscreteNonParametric([0.5, 1.5, 4.0], [0.3, 0.4, 0.3]), 1.5,
             lambda P: set(np.unique(P.particles)) <= {0.5, 1.5, 4.0}
             and abs(P.median() - 1.5) < 1e-6),
            (kt.Truncated(kt.StudentT(4.0), -1.0, 3.0), 1.0,
             lambda P: P.particles.min() >= -1.0 - 1e-5
             and P.particles.max() <= 3.0 + 1e-5
             and abs(P.median() - 1.0) < 0.5),
            (kt.Mixture([kt.Normal(0.0, 0.5), kt.Normal(5.0, 0.5)],
                        [0.5, 0.5]), 5.0,
             lambda P: abs(P.median() - 5.0) < 0.5),
            (2.0 - 3.0 * kt.Exponential(1.0), 0.0,
             lambda P: P.particles.max() <= 2.0 + 1e-5
             and abs(P.median()) < 0.5)]
        out = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for p_, target, ok in cases:
                r = kt.smc(p_, scalar_cost(target), nparticles=128,
                           max_iters=25, key=11)
                P = r.P
                check(bool(np.isfinite(P.particles).all()) and ok(P),
                      f"prior battery: {p_!r}: median {P.median()}")
                out[repr(p_)[:40]] = round(P.median(), 5)
            mv_t = torch.tensor([1.0, -1.0, 0.5], device=dev)
            r = kt.smc(kt.MvNormal(np.zeros(3), np.eye(3) * 4.0),
                       lambda x, g: torch.linalg.norm(x - mv_t),
                       nparticles=256, max_iters=30, key=12)
            med = [p.median() for p in r.P]
            check(np.allclose(med, [1.0, -1.0, 0.5], atol=0.5),
                  f"prior battery MvNormal: {med}")
            out["MvNormal"] = [round(m, 4) for m in med]
            di_t = torch.tensor([0.6, 0.3, 0.1], device=dev)
            r = kt.smc(kt.Dirichlet(np.array([2.0, 2.0, 2.0])),
                       lambda x, g: torch.linalg.norm(x - di_t),
                       nparticles=256, max_iters=30, key=13)
        arr = np.stack([p.particles for p in r.P], axis=-1)
        med = np.median(arr, axis=0)
        check(bool((arr > 0).all()) and np.allclose(arr.sum(-1), 1.0,
                                                    atol=1e-4)
              and np.allclose(med, [0.6, 0.3, 0.1], atol=0.2),
              f"prior battery Dirichlet: median {med}")
        out["Dirichlet"] = [round(float(m), 4) for m in med]
        r = kt.sample(kt.ApproxKernelizedPosterior(
            kt.Truncated(kt.Poisson(6.0), 2, 12),
            lambda x: torch.abs(x.to(torch.float32) - 4.0), 0.5),
            kt.AIS(32), 256, ntransitions=4, key=14)
        check(bool(np.all(r.particles == np.round(r.particles)))
              and 2 <= r.particles.min() and r.particles.max() <= 12
              and abs(r.median() - 4.0) <= 1.0,
              f"prior battery AIS truncated Poisson: median {r.median()}")
        r2 = kt.sample(kt.ApproxKernelizedPosterior(
            kt.Mixture([kt.Normal(0.0, 0.5), kt.Normal(5.0, 0.5)]),
            lambda x: torch.abs(x - 5.0), 0.2), kt.AIS(32), 256,
            ntransitions=4, key=15)
        check(abs(r2.median() - 5.0) < 0.5,
              f"prior battery AIS mixture: median {r2.median()}")
        out["AIS"] = [r.median(), round(r2.median(), 5)]
        ph.result = json.dumps(out)

    # ---- slice 7: the prior table, a new prior at 2^20, socks, stats ---
    def table_population(prior, n):
        """A population drawn from the prior (float32 leaves, each
        discrete one moved by U(-0.4, 0.4) so the push rounds it)."""
        leaves = []
        for d, x in zip(prior.p, prior.sample_tree(gen, n)):
            x = x.to(torch.float32)
            if d.discrete:
                x = x + uniform(n, -0.4, 0.4)
            leaves.append(x.contiguous())
        return leaves

    table_times = {}
    partner_table = {}   # #3's partner form: commits of each bit-equal pair
    with Phase("prior-table") as ph:
        # kernels #3, #6, #9 and #10 at 65536 walkers on stub bits, each
        # on priors whose marginals cover every entry of the prior table,
        # against their plain versions with the stub phases' comparisons
        n, h = 65536, 32768
        res = {}
        for (kname, pname), sw in table_sweeps.items():
            p_ = table_priors[pname]
            leaves = table_population(p_, n)
            what = f"prior-table {kname} {pname}"
            if kname == "#3":
                lps = p_.logpdf_tree(p_.push_tree(tuple(leaves))).to(
                    torch.float32)
                xs = torch.full((n,), 1e6, device=dev)
                alive = torch.rand(n, generator=gen, device=dev) < 0.9
                r1, r2, seed = 5, n // 2 + 3, 12345
                rs = torch.tensor([r1, r2, seed], dtype=torch.int64,
                                  device=dev)
                probe = F.fused_smc_sweep_plain(
                    sw, leaves, xs, lps, torch.ones_like(alive), 1e6, False,
                    r1, r2, seed)
                check(bool(probe[3].any()), f"{what}: no walker passes "
                      "gate 1")
                eps = float(probe[1][probe[3]].median())
                got = sw.run(leaves, xs, lps, alive, eps, False, rs)
                want = F.fused_smc_sweep_plain(sw, leaves, xs, lps, alive,
                                               eps, False, r1, r2, seed)
                err, border = compare_sweeps(torch, got, want, eps, what)
                check_untouched(torch, leaves + [xs, lps], list(got[0])
                                + list(got[1:3]), got[3], what)
                acc = int(got[3].sum())
                check(0 < acc, f"{what} committed nothing")
                unequal = unequal_committed(got, want)
                # the kernel repeats its plain version op for op: bit for
                # bit (P3, P4: the push of the discrete marginals too)
                check(err == 0 and unequal == 0 and border == 0,
                      f"{what}: not bit-equal to the plain version (max|err| "
                      f"{err}, {unequal} unequal, {border} masks differ)")
                # the form a shard of a mesh launches: the partners given
                # as two more pointer sets (the leaves rolled by r2 and
                # r1), shifts 0; bit for bit against the plain version and
                # against the snapshot form above
                parts = ([torch.roll(x, r2, 0) for x in leaves],
                         [torch.roll(x, r1, 0) for x in leaves])
                rs0 = torch.tensor([0, 0, seed], dtype=torch.int64,
                                   device=dev)
                gotp = sw.run(leaves, xs, lps, alive, eps, False, rs0,
                              partners=parts)
                wantp = F.fused_smc_sweep_plain(sw, leaves, xs, lps, alive,
                                                eps, False, 0, 0, seed,
                                                partners=parts)
                errp, borderp = compare_sweeps(torch, gotp, wantp, eps,
                                               f"{what} partners")
                unequalp = unequal_committed(gotp, wantp)
                check(errp == 0 and unequalp == 0 and borderp == 0
                      and same_bits(list(gotp[0]) + list(gotp[1:]),
                                    list(got[0]) + list(got[1:])),
                      f"{what} partners: not bit-equal to the plain version "
                      f"or the snapshot form (max|err| {errp}, {unequalp} "
                      f"unequal, {borderp} masks differ)")
                partner_table[f"{kname} {pname}"] = int(gotp[3].sum())
                res[f"{kname} {pname}"] = (err, unequal, acc, border)
                eps_t = torch.tensor(eps, device=dev)
                flag_t = torch.tensor(False, device=dev)
                ms = cuda_ms(torch, lambda: sw.run(leaves, xs, lps, alive,
                                                   eps_t, flag_t, rs), 20)
                plain = cuda_ms(torch, lambda: F.fused_smc_sweep_plain(
                    sw, leaves, xs, lps, alive, eps_t, flag_t, r1, r2,
                    seed), 1, warmup=0)
                nsim = int(F.proposal_plain(sw, leaves, lps, alive, r1, r2,
                                            seed)[3].sum())
                b, by = bound(sw.work(n, nsim))
                # at 65536 the wrapper's host time (16 leaves) can pass
                # the kernel's: its own time by the profiler beside
                dev_ms = device_ms(torch, lambda: sw.run(
                    leaves, xs, lps, alive, eps_t, flag_t, rs), 20,
                    "fused_smc_sweep_kernel")
                table_times[f"#3 {pname}"] = dict(
                    ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=b,
                    bound_by=by, simulated=nsim, prior_ops=sw.unit.prior_ops,
                    width=n)
            elif kname in ("#6", "#9"):
                pushed = sw.pushed(leaves)
                lp = p_.logpdf_tree(pushed).to(torch.float32)
                ll = (uniform(n, -20.0, -1.0) if kname == "#6"
                      else ll_table(pushed).to(torch.float32))
                upd, cmp_ = [x[:h] for x in leaves], [x[h:] for x in leaves]
                extra = () if kname == "#6" else (0.3,)
                got = sw.half_words(upd, lp[:h], ll[:h], cmp_, words7(0),
                                    *extra)
                want = sw.half_plain(upd, lp[:h], ll[:h], cmp_,
                                     shifts_of(words7(0), h), seed_t,
                                     *extra, terms=True)
                r = ais_compare(flat(got), flat(want),
                                upd + [lp[:h], ll[:h]], what, want[3][1])
                check(r[2] > 0, f"{what} committed nothing")
                res[f"{kname} {pname}"] = r
                if kname == "#6":
                    ms = cuda_ms(torch, lambda: sw.half_words(
                        upd, lp[:h], ll[:h], cmp_, words7(0)), 20)
                    plain = cuda_ms(torch, lambda: sw.half_plain(
                        upd, lp[:h], ll[:h], cmp_, shifts_of(words7(0), h),
                        seed_t), 1, warmup=0)
                    nsim = int(want[3][0].sum())
                    b, by = bound(sw.work(h, nsim))
                    dev_ms = device_ms(torch, lambda: sw.half_words(
                        upd, lp[:h], ll[:h], cmp_, words7(0)), 20,
                        "fused_ais_sweep_kernel")
                    table_times[f"#6 {pname}"] = dict(
                        ms_half=ms, device_ms_half=dev_ms,
                        plain_ms_half=plain, bound_ms_half=b, bound_by=by,
                        inside=nsim, prior_ops=sw.unit.prior_ops,
                        push_ops=sw.unit.push_ops, width=h)
            else:   # #10
                # thresholds up to 1000: the flagship cost of these
                # priors' first two leaves is ~10-100, not the README's
                # ~0.01-3, so ds from [0, 3) would let no walker commit
                bases, lps, ds, active, eps_i = abcde_generation_inputs(
                    sw, leaves, 1000.0)
                got = sw.run(leaves, bases, lps, ds, active, eps_i, seed_t)
                want = sw.generation_plain(leaves, bases, lps, ds, active,
                                           eps_i, seed_t, terms=True)
                r = abcde_compare(got, want, leaves + [lps, ds],
                                  torch.maximum(eps_i, ds), what)
                check(r[4] > 0, f"{what}: no walker passed the gate")
                res[f"{kname} {pname}"] = r
        for key, r in res.items():   # C4: the Dirac pairs bit for bit
            if key.endswith("P5"):
                check(r[0] == 0 and r[1] == 0 and r[3] == 0 and r[2] > 0,
                      f"prior-table {key}: not bit-equal to the plain "
                      f"version: {r}")
        regs = {names: lines for names, lines in ptxas.items()
                if names.startswith("prior-table")}
        ph.result = ("(max|err|, unequal committed values, commits, "
                     "borderline[, gate passes]): " + json.dumps(res)
                     + "; #3 with the partners given, bit-equal, commits "
                     + json.dumps(partner_table)
                     + "; times " + json.dumps(table_times)
                     + "; ptxas " + json.dumps(regs))

    with Phase("smc-1m-generic-priors") as ph:
        # smc-1m-generic with a prior of new families: #4 at the init, #3
        # every sweep, 2^20 particles
        _alarm(FULL_SMC_LIMIT_S)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = kt.smc(nprior, costs["flagship"][0], cost_vectorized=True,
                     sweep_fused=nsweep, nparticles=1 << 20, epstol=EPSTOL,
                     max_iters=2000, min_r_ess=0.5, key=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _alarm(max(1, int(SCRIPT_LIMIT_S - (time.perf_counter() - t_start))))
        priors_launches = counts()
        mu_p, sg_p = res.P
        check(res.eps <= EPSTOL, f"eps {res.eps} > {EPSTOL}")
        check(abs(mu_p.mean() - 2.0) < 0.05, f"mean mu {mu_p.mean()}")
        check(abs(sg_p.mean() - 0.0401) < 0.005, f"mean sigma {sg_p.mean()}")
        check(priors_launches["streaming_moment_cost"] > 0
              and priors_launches["fused_smc_sweep"] > 0,
              "smc-1m-generic-priors did not launch kernels #4 and #3")
        ph.result = (f"n=2^20 iterations {res.iterations} eps {res.eps:.6f}"
                     f" mu {mu_p.mean():.5f} sigma {sg_p.mean():.5f} wall "
                     f"{wall:.3f} s launches {priors_launches}")
        priors_smc = dict(iterations=res.iterations, wall_s=wall,
                          eps=res.eps,
                          launches=priors_launches["fused_smc_sweep"])

    with Phase("smc-1m-generic-discrete") as ph:
        # tests/test_pallas.py:864-890 at the reference's production width:
        # the mixed discrete prior through #4 at the init and #3 every
        # sweep, which pushes m in the kernel; m comes back integral
        _alarm(FULL_SMC_LIMIT_S)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = kt.smc(mprior, mcost, cost_vectorized=True, sweep_fused=msweep,
                     nparticles=1 << 20, epstol=0.08, key=5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _alarm(max(1, int(SCRIPT_LIMIT_S - (time.perf_counter() - t_start))))
        discrete_launches = counts()
        m_post, s_post = res.P
        check(bool(np.all(m_post.particles == np.round(m_post.particles))),
              "smc-1m-generic-discrete: m particles not integral")
        check(abs(m_post.mean() - 3.0) < 0.3, f"mean m {m_post.mean()}")
        check(abs(s_post.mean() - 0.5) < 0.15, f"mean s {s_post.mean()}")
        check(res.eps <= 0.08, f"eps {res.eps} > 0.08")
        check(discrete_launches["streaming_moment_cost"] > 0
              and discrete_launches["fused_smc_sweep"] > 0,
              "smc-1m-generic-discrete did not launch kernels #4 and #3")
        ph.result = (f"n=2^20 iterations {res.iterations} eps {res.eps:.6f}"
                     f" m {m_post.mean():.5f} s {s_post.mean():.5f} wall "
                     f"{wall:.3f} s launches #3 "
                     f"{discrete_launches['fused_smc_sweep']} #4 "
                     f"{discrete_launches['streaming_moment_cost']}")
        discrete_smc = dict(iterations=res.iterations, wall_s=wall,
                            eps=res.eps,
                            launches=discrete_launches["fused_smc_sweep"])

    with Phase("reference-socks") as ph:
        # KissABC.jl's runtests socks problem at the reference parity
        # file's settings and bands (tests/test_reference_parity.py:53-72);
        # the per-walker cost through torch.func.vmap, no kernel of the port
        sprior, scost = models.socks()
        reset_counts()
        t0 = time.perf_counter()
        r = kt.smc(sprior, scost, nparticles=2000, alpha=0.95, r_epstol=0,
                   epstol=0.01, key=11)
        wall_smc = time.perf_counter() - t0
        n_post, p_post = r.P
        check(abs(n_post.mean() - 46.2) < 4.0, f"socks smc n {n_post.mean()}")
        check(abs(p_post.mean() - 0.866) < 0.03,
              f"socks smc p {p_post.mean()}")
        check(bool(np.allclose(n_post.particles,
                               np.round(n_post.particles))),
              "socks smc: n_socks particles not integers")
        t0 = time.perf_counter()
        ra = kt.sample(kt.ApproxPosterior(sprior, scost, 0.1), kt.AIS(500),
                       2000, ntransitions=20, discard_initial=4000, key=12)
        wall_ais = time.perf_counter() - t0
        an, ap = ra
        check(abs(an.mean() - 46.2) < 5.0, f"socks AIS n {an.mean()}")
        check(abs(ap.mean() - 0.866) < 0.04, f"socks AIS p {ap.mean()}")
        check(bool(np.allclose(an.particles, np.round(an.particles))),
              "socks AIS: n_socks particles not integers")
        check(not any(counts().values()), "socks ran a kernel of the port")
        ph.result = (f"smc: {r.iterations} iterations, eps {r.eps}, n "
                     f"{n_post.mean():.3f}, p {p_post.mean():.5f}, "
                     f"{wall_smc:.2f} s; AIS: n {an.mean():.3f}, p "
                     f"{ap.mean():.5f}, {wall_ais:.2f} s")

    families = matrix_families(kt, np)
    cpu_gen = torch.Generator().manual_seed(16)
    with Phase("statistics") as ph:
        # the pointwise functions on CUDA tensors equal them on CPU tensors
        # (the CPU tests' tolerances: logpdf 16 ulps, the rest 4e-6), and
        # rand draws on the card
        out = {}
        xs_c = np.linspace(-0.5, 1.5, 257).astype(np.float32)
        xs_d = np.arange(-1, 15, dtype=np.float32)
        q = np.linspace(0.01, 0.99, 99).astype(np.float32)
        for d, x in ((kt.Beta(2.0, 5.0), xs_c),
                     (kt.Truncated(kt.Poisson(6.0), 2, 12), xs_d)):
            xc, xg = torch.from_numpy(x), torch.from_numpy(x).to(dev)
            for fname in ("cdf", "logpdf", "insupport", "ccdf"):
                f = getattr(kt, fname)
                a, b = f(d, xg), f(d, xc)
                check(a.device.type == "cuda", f"{fname} left the card")
                a = a.cpu()
                if fname == "insupport":
                    check(bool(torch.equal(a, b)), f"{fname}({d!r})")
                    continue
                fin = torch.isfinite(b)
                check(bool(torch.equal(torch.isfinite(a), fin)),
                      f"{fname}({d!r}): finite cells differ")
                tol = (16 * 1.1920929e-07 * b[fin].abs().clamp(min=1.0)
                       if fname == "logpdf" else 4e-6)
                e = (a[fin] - b[fin]).abs()
                check(bool((e <= tol).all()), f"{fname}({d!r}): max err "
                      f"{float(e.max())}")
                out[f"{type(d).__name__} {fname}"] = float(e.max())
            qa = kt.quantile(d, torch.from_numpy(q).to(dev)).cpu()
            qb = kt.quantile(d, torch.from_numpy(q))
            check(bool((qa.double() - qb.double()).abs().max() <= 4e-6),
                  f"quantile({d!r})")
            out[f"{type(d).__name__} quantile"] = max_err(qa, qb)
        draw = kt.rand(kt.Gamma(2.0, 1.5), (4, 5), key=3)
        check(draw.device.type == "cuda" and draw.shape == (4, 5),
              "rand did not draw on the card")
        tup = kt.rand(kt.Factored(kt.Beta(2.0, 2.0), kt.Poisson(3.0)), 6,
                      key=1)
        check(tup[0].device.type == "cuda" and tup[1].dtype == torch.int32,
              "rand of a Factored prior")
        # slice 8's families: the statistics functions on CUDA tensors
        # against CPU tensors (logpdf within rtol 1e-5, atol 1e-5, the CPU
        # tests' tolerance against JAX, -inf in the same places;
        # insupport equal), mean and cov as host values beside rand's
        # draws on the card
        for name, (d, bad, _) in families.items():
            xc = torch.cat([d.sample(cpu_gen, (1024,)).to(torch.float32),
                            torch.tensor(np.asarray(bad, np.float32)).reshape(
                                (-1,) + tuple(d.sample(cpu_gen, ()).shape))])
            a, b = kt.logpdf(d, xc.to(dev)), kt.logpdf(d, xc)
            check(a.device.type == "cuda", f"logpdf({name}) left the card")
            a = a.cpu()
            fin = torch.isfinite(b)
            check(bool(torch.equal(torch.isfinite(a), fin))
                  and bool((a[~fin] == float("-inf")).all()),
                  f"logpdf({name}): -inf cells differ")
            check(bool(torch.allclose(a[fin], b[fin], rtol=1e-5,
                                      atol=1e-5)),
                  f"logpdf({name}): max err {max_err(a[fin], b[fin])}")
            out[f"{name} logpdf"] = max_err(a[fin], b[fin])
            if name in ("Product", "IID", "MvLogNormal", "MvTDist"):
                check(bool(torch.equal(kt.insupport(d, xc.to(dev)).cpu(),
                                       kt.insupport(d, xc))),
                      f"insupport({name}) card vs CPU")
            if name != "LKJCholesky":
                x = kt.rand(d, 100_000, key=5).double()
                check(x.device.type == "cuda", f"rand({name}) left the card")
                m = torch.as_tensor(np.asarray(kt.mean(d), np.float64),
                                    device=dev)
                out[f"{name} mean"] = max_err(x.mean(0), m)
        ph.result = "max|err| card vs CPU " + json.dumps(out)

    with Phase("matrix-priors") as ph:
        # slice 8's families as priors on the card, through the per-walker
        # cost (torch.func.vmap; no kernel of the port: the JAX kernels
        # take only [n] leaves): smc on LKJ(2, 1.0) at the settings of
        # tests/test_distributions.py:1259-1280; the covariance example
        # (examples_torch/example_covariance.py, uncut);
        # AIS on the LKJ prior; then each family's logpdf on the card
        # against the CPU and 10^5 draws against statistics.mean/cov
        out = {}
        reset_counts()

        def corr_cost(R, g):
            cl, _ = torch.linalg.cholesky_ex(R)
            z = torch.randn((500, 2), generator=g, device=g.device) @ cl.T
            r = torch.mean(z[:, 0] * z[:, 1]) / (
                torch.std(z[:, 0], correction=0)
                * torch.std(z[:, 1], correction=0))
            return torch.abs(r - 0.6)

        t0 = time.perf_counter()
        r = kt.smc(kt.LKJ(2, 1.0), corr_cost, nparticles=128, epstol=0.05,
                   max_iters=150, key=5)
        wall = time.perf_counter() - t0
        P = r.P   # row-major [R00, R01, R10, R11]
        check(P[0].approx(1.0) and P[0].std() == 0.0, "LKJ smc: R00 != 1")
        check(abs(P[1].mean() - 0.6) < 0.08, f"LKJ smc: r {P[1].mean()}")
        check(P[1].particles.max() <= 1.0 + 1e-6, "LKJ smc: r > 1")
        out["lkj-smc"] = dict(iterations=r.iterations, eps=float(r.eps),
                              r=P[1].mean(), wall_s=wall)
        check(not any(counts().values()), "lkj-smc ran a kernel")

        # examples_torch/example_covariance.py, uncut (its asserts inside)
        r, obs = run_example("example_covariance")
        out["covariance"] = dict(
            iterations=r.iterations, eps=float(r.eps), r=r.P[1].mean(),
            s1=r.P[4].mean(), s2=r.P[5].mean(), obs=list(obs),
            wall_s=ex_runs["example_covariance"]["wall_s"])

        t0 = time.perf_counter()
        ra = kt.sample(kt.ApproxKernelizedPosterior(kt.LKJ(2, 1.0), corr_cost,
                                                    0.05),
                       kt.AIS(32), 256, ntransitions=4, discard_initial=256,
                       key=14)
        wall = time.perf_counter() - t0
        x = np.stack([p_.particles for p_ in ra], -1).reshape(-1, 2, 2)
        check(bool(np.array_equal(x, np.swapaxes(x, -1, -2))),
              "LKJ AIS: a posterior matrix is not symmetric")
        check(bool((np.diagonal(x, axis1=-2, axis2=-1) == 1.0).all()),
              "LKJ AIS: a diagonal entry is not 1")
        check(bool((np.linalg.eigvalsh(x) > 0).all()),
              "LKJ AIS: a posterior matrix is not positive definite")
        out["lkj-ais"] = dict(r=ra[1].mean(), r_sd=ra[1].std(), wall_s=wall)
        check(not any(counts().values()), "lkj-ais ran a kernel")

        for k, (name, (d, bad, checks)) in enumerate(families.items()):
            xc = torch.cat([d.sample(cpu_gen, (4096,)).to(torch.float32),
                            torch.tensor(np.asarray(bad, np.float32)).reshape(
                                (-1,) + tuple(d.sample(cpu_gen, ()).shape))])
            a, b = d.logpdf(xc.to(dev)).cpu(), d.logpdf(xc)
            fin = torch.isfinite(b)
            check(bool(torch.equal(torch.isfinite(a), fin)),
                  f"{name}: -inf cells differ, card vs CPU")
            check(len(bad) == int((~fin).sum()),
                  f"{name}: {int((~fin).sum())} cells -inf, {len(bad)} off "
                  "the support")
            check(bool(torch.allclose(a[fin], b[fin], rtol=1e-5, atol=1e-5)),
                  f"{name} logpdf: max err {max_err(a[fin], b[fin])}")
            g = torch.Generator(device=dev).manual_seed(100 + k)
            xd = d.sample(g, (100_000,))
            check(xd.device.type == "cuda", f"{name} drew off the card")
            xd = xd.double().cpu().numpy()
            m = np.asarray(kt.mean(d)) if name != "LKJCholesky" else None
            c = (np.asarray(kt.cov(d)) if name in ("Product", "IID",
                                                    "Multinomial", "MvTDist")
                 else None)
            for what, ok in checks(xd, m, c):
                check(bool(ok), f"{name} draws: {what}")
            out[name] = dict(logpdf_max_abs_err=max_err(a[fin], b[fin]),
                             neg_inf=len(bad), draws_ok=[
                                 w for w, _ in checks(xd, m, c)])
        ph.result = json.dumps(out)

    # ---- slice 9: walker sharding, 4 shards on the one card ------------
    # (four shards on one card measure what sharding costs, not a speed-up)
    from kissabc_tpu_torch.parallel import distributed as PD
    from kissabc_tpu_torch.parallel import mesh as PM
    mesh4 = PM.make_mesh(walker=4, devices=["cuda:0"] * 4)
    mesh_launches = {}

    with Phase("mesh-roll") as ph:
        # roll_walkers at 2^20 walkers, 2 leaves: each shift equals
        # torch.roll of the joined population bit for bit, with exactly 2
        # shard-sized transfers per leaf and shard
        n = 1 << 20
        s_ = n // 4
        leaves = (uniform(n, 0.0, 1.0), uniform(n, -1.0, 1.0))
        sh = PM.place(mesh4, leaves)
        shifts = [0, 1, -1, s_, -s_, s_ + 7, n - 1, -(n + 3)]
        for shift in shifts:
            PM.reset_transfer_counts()
            rolled = PM.roll_walkers(sh, shift, mesh4)
            moved = PM.transfers["permute"]
            for a, b in zip(PM.join(rolled), leaves):
                check(bool(torch.equal(a, torch.roll(b, shift, 0))),
                      f"mesh-roll: shift {shift} is not torch.roll")
            check(moved == 2 * 2 * 4, f"mesh-roll: shift {shift} made "
                  f"{moved} transfers, not 2 per leaf and shard")
        roll_ms = cuda_ms(torch, lambda: PM.roll_walkers(sh, s_ + 7, mesh4),
                          20)
        torch_ms = cuda_ms(torch, lambda: [torch.roll(x, s_ + 7, 0)
                                           for x in leaves], 20)
        mesh_roll = dict(n=n, leaves=2, shards=4, shifts=shifts,
                         transfers_per_leaf_and_shard=2,
                         roll_walkers_ms=roll_ms, torch_roll_ms=torch_ms)
        ph.result = json.dumps(mesh_roll)

    with Phase("mesh-smc") as ph:
        # the smc-perwalker model at 4096 particles, the same key, on one
        # device and on 4 shards: the same particles (bit for bit with the
        # roll scheme, rtol 1e-5 otherwise) and iterations
        out = {}
        kw = dict(nparticles=4096, epstol=EPSTOL, key=2)
        for scheme in ("roll", "auto"):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = kt.smc(prior, readme_cost, partner_scheme=scheme, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            b = kt.smc(prior, readme_cost, partner_scheme=scheme, mesh=mesh4,
                       **kw)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            equal = all(np.array_equal(x.particles, y.particles)
                        for x, y in zip(a.P, b.P))
            close = all(np.allclose(x.particles, y.particles, rtol=1e-5)
                        for x, y in zip(a.P, b.P))
            check(a.iterations == b.iterations and (equal or (
                scheme != "roll" and close)),
                  f"mesh-smc {scheme}: sharded differs: iterations "
                  f"{a.iterations} vs {b.iterations}, equal {equal}")
            check(not any(counts().values()), "mesh-smc ran a kernel")
            check(a.eps <= EPSTOL and abs(a.P[0].mean() - 2.0) < 0.05,
                  f"mesh-smc {scheme}: eps {a.eps}, mu {a.P[0].mean()}")
            out[scheme] = dict(iterations=a.iterations, eps=a.eps,
                               bit_equal=equal, wall_s=t1 - t0,
                               mesh_wall_s=t2 - t1)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "mesh.npz")
            skw = dict(kw, partner_scheme="roll", checkpoint_every=5)
            whole = kt.smc_stepped(prior, readme_cost, mesh=mesh4, **skw)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                cut = kt.smc_stepped(prior, readme_cost, mesh=mesh4,
                                     checkpoint_path=path, max_iters=5,
                                     **skw)
            check(cut.iterations == 5, f"the cut run ran {cut.iterations}")
            resumed = kt.smc_stepped(prior, readme_cost, checkpoint_path=path,
                                     resume=True, **skw)   # one device
        check(all(np.array_equal(x.particles, y.particles)
                  for x, y in zip(whole.P, resumed.P))
              and whole.iterations == resumed.iterations,
              "mesh-smc: smc_stepped stopped on the mesh and resumed on one "
              "device differs from the uninterrupted sharded run")
        out["stepped"] = dict(iterations=whole.iterations,
                              resumed_equal=True)
        mesh_smc = out
        ph.result = json.dumps(out)

    with Phase("mesh-costs") as ph:
        # shard_batched_cost of kernels #1 and #5: one launch per shard,
        # each shard's costs those of its block with the shard's seed, and
        # the kernel's output on each block against its plain version
        # (#1's costs; #5's means, which its reduce_cost turns into costs
        # in PyTorch) at the golden tolerance
        out = {}
        mesh_cost_err = {}
        for name, (base, th, kname) in {
                "#1": (kt.make_flagship_cost_batched(),
                       prior.sample_tree(gen, 1 << 20),
                       "normal_summary_cost"),
                "#5": (scans["ar1"][0], aprior.sample_tree(gen, 131072),
                       "streaming_scan_cost")}.items():
            cost_ = kt.shard_batched_cost(base, mesh4)
            sh = PM.place(mesh4, th)
            g2 = torch.Generator(device=dev).manual_seed(31)
            reset_counts()
            got = cost_(sh, g2)
            torch.cuda.synchronize()
            launched = counts()[kname]
            check(launched == 4, f"mesh-costs {name}: {launched} launches, "
                  "not one per shard")
            mesh_launches[kname] = launched
            seed = S.uint32_words(torch.Generator(device=dev).manual_seed(31),
                                  1)
            err = 0.0
            for g, block in zip(sh.index, sh.shards):
                check(got.shards[g].device == mesh4.device_of(g),
                      f"mesh-costs {name}: shard {g} off its device")
                seed_g = PM.fold_seed(seed, g)
                want = base.seeded(block, seed_g)
                check(bool(torch.equal(got.shards[g], want)),
                      f"mesh-costs {name}: shard {g} differs")
                what = f"mesh-costs {name} shard {g}"
                if name == "#1":
                    err = max(err, assert_close(
                        torch, got.shards[g],
                        K.normal_summary_cost_plain(*block, seed_g), what))
                else:
                    err = max(err, *(assert_close(torch, a, b, what)
                                     for a, b in zip(
                                         base.means(block, seed_g),
                                         base.means_plain(block, seed_g))))
            seeds = {int(PM.fold_seed(seed, g)) for g in range(4)}
            check(len(seeds) == 4, f"mesh-costs {name}: shard seeds {seeds}")
            mesh_cost_err[kname] = err
            out[name] = dict(launches=launched, n=len(got.shards) * int(
                got.shards[0].shape[0]), max_abs_err=err)
        ph.result = json.dumps(out)

    with Phase("mesh-smc-1m-generic") as ph:
        # smc-1m-generic at full width on 4 shards: #4 through
        # shard_batched_cost, #3 built for the mesh; each launches once per
        # shard a call. Beside it, the unsharded run in this script
        _alarm(FULL_SMC_LIMIT_S)
        mcost4 = kt.shard_batched_cost(costs["flagship"][0], mesh4)
        msweep4 = kt.make_fused_smc_sweep(fprior, fdraw, freduce, mesh=mesh4)

        class Counted:   # the sweeps smc runs, for #3's launches a sweep
            def __init__(self, sweep):
                self.sweep, self.mesh, self.calls = sweep, sweep.mesh, 0

            def __call__(self, *args):
                self.calls += 1
                return self.sweep(*args)

        counted = Counted(msweep4)
        kw = dict(cost_vectorized=True, nparticles=1 << 20, epstol=EPSTOL,
                  max_iters=2000, min_r_ess=0.5, key=2)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = kt.smc(fprior, mcost4, sweep_fused=counted, mesh=mesh4, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        _alarm(max(1, int(SCRIPT_LIMIT_S - (time.perf_counter() - t_start))))
        n3, n4 = launched["fused_smc_sweep"], launched["streaming_moment_cost"]
        check(n4 == 4, f"mesh-smc-1m-generic: #4 launched {n4} times, not "
              "once per shard at the init")
        check(counted.calls > 0 and n3 == 4 * counted.calls,
              f"mesh-smc-1m-generic: #3 launched {n3} times in "
              f"{counted.calls} sweeps, not once per shard a sweep")
        check(launched["normal_summary_cost"] == launched["fused_sweep"] == 0,
              "mesh-smc-1m-generic launched a flagship kernel")
        mu_p, sg_p = res.P
        check(res.eps <= EPSTOL, f"eps {res.eps} > {EPSTOL}")
        check(abs(mu_p.mean() - 2.0) < 0.05, f"mean mu {mu_p.mean()}")
        check(abs(sg_p.mean() - 0.0401) < 0.005, f"mean sigma {sg_p.mean()}")
        # the population stays on its shards: one sweep's outputs
        th4 = PM.place(mesh4, fprior.sample_tree(gen, 1 << 20))
        o = msweep4(gen, th4, PM.place(mesh4, torch.ones(1 << 20,
                                                         device=dev)),
                    PM.place(mesh4, torch.zeros(1 << 20, device=dev)),
                    PM.place(mesh4, torch.ones(1 << 20, dtype=torch.bool,
                                               device=dev)),
                    torch.tensor(0.5, device=dev),
                    torch.tensor(False, device=dev))
        check(all(t.device == mesh4.device_of(g) and t.shape[0] == 1 << 18
                  for g, tr in zip(o[0].index, o[0].shards) for t in tr),
              "mesh-smc-1m-generic: a shard left its device")
        # #3 in the form this path launches it: the sharded sweep on a
        # population of 2^20, each shard's outputs against the plain
        # version on its block, with the partners rolled from the joined
        # leaves by torch.roll and the shard's folded seed; bit for bit on
        # stub bits, on hw bits the comparison of the 2^20 check
        msweep4s = kt.make_fused_smc_sweep(fprior, fdraw, freduce,
                                           mesh=mesh4, bits="stub")
        n, s_ = 1 << 20, (1 << 20) // 4
        thm = [x.contiguous() for x in fprior.sample_tree(gen, n)]
        xsm = torch.full((n,), 1e6, device=dev)
        lpsm = fprior.logpdf_tree(tuple(thm)).to(torch.float32)
        alivem = torch.rand(n, generator=gen, device=dev) < 0.9
        flag_f = torch.tensor(False, device=dev)
        partner_check = {}
        for bits_, sw_ in (("hw", msweep4), ("stub", msweep4s)):
            words = S.uint32_words(torch.Generator(device=dev).manual_seed(
                41), 3)
            r1, r2 = M.roll_shifts(words[:2].tolist(), n)

            def plain(g, eps_):
                blk = slice(g * s_, (g + 1) * s_)
                return F.fused_smc_sweep_plain(
                    sw_, [x[blk] for x in thm], xsm[blk], lpsm[blk],
                    alivem[blk], eps_, flag_f, 0, 0,
                    PM.fold_seed(words[2], g).reshape(1), partners=(
                        [torch.roll(x, r2, 0)[blk] for x in thm],
                        [torch.roll(x, r1, 0)[blk] for x in thm]))

            probe = plain(0, torch.tensor(1e6, device=dev))
            check(bool(probe[3].any()), "mesh-smc-1m-generic: no walker "
                  "passes gate 1")
            eps_t = torch.tensor(float(probe[1][probe[3]].median()),
                                 device=dev)
            reset_counts()
            o = sw_(torch.Generator(device=dev).manual_seed(41),
                    PM.place(mesh4, tuple(thm)), PM.place(mesh4, xsm),
                    PM.place(mesh4, lpsm), PM.place(mesh4, alivem), eps_t,
                    flag_f)
            check(counts()["fused_smc_sweep"] == 4, "mesh-smc-1m-generic: "
                  f"the {bits_} sweep did not launch #3 once per shard")
            errs, borders, unequal, acc = [], 0, np.zeros(4, np.int64), 0
            for g in range(4):
                blk = slice(g * s_, (g + 1) * s_)
                want = plain(g, eps_t)
                got = (list(o[0].shards[g]), o[1].shards[g], o[2].shards[g],
                       o[1].shards[g] != xsm[blk])   # xs in: 1e6 > eps
                what = f"mesh-smc-1m-generic #3 {bits_} shard {g}"
                if bits_ == "hw":
                    err_, border_ = compare_sweeps(
                        torch, got, want, eps_t, what, band=1e-4,
                        cost_atol=1e-4)
                else:
                    err_, border_ = compare_sweeps(torch, got, want, eps_t,
                                                   what)
                unequal += unequal_by_output(got, want)
                check_untouched(torch, [x[blk] for x in thm]
                                + [xsm[blk], lpsm[blk]], got[0]
                                + [got[1], got[2]], got[3], what)
                errs.append(err_)
                borders += border_
                acc += int(want[3].sum())
            check(acc > 0, f"mesh-smc-1m-generic #3 {bits_}: no commit")
            check(abs(int(o[3]) - acc) <= borders, f"mesh-smc-1m-generic "
                  f"#3 {bits_}: {int(o[3])} accepts, plain {acc}")
            if bits_ == "stub":
                # the flagship prior's entries are not bit-equal to their
                # plain versions (an ulp where one divides): the masks are
                # held exactly, the values at the golden tolerance; the
                # partner pointers bit for bit in prior-table
                check(borders == 0, f"mesh-smc-1m-generic #3 stub: "
                      f"{borders} commit masks differ")
            partner_check[bits_] = dict(
                max_abs_err=max(errs), masks_differ=borders, accepted=acc,
                unequal_mu_sigma_xs_lps=unequal.tolist(), r1=r1, r2=r2)
        mesh_launches["fused_smc_sweep"] = n3
        mesh_launches["streaming_moment_cost"] = n4
        # the unsharded run, the same settings, in this script
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = kt.smc(fprior, costs["flagship"][0],
                     sweep_fused=sweeps["flagship"], **kw)
        torch.cuda.synchronize()
        ref_wall = time.perf_counter() - t0
        _alarm(max(1, int(SCRIPT_LIMIT_S - (time.perf_counter() - t_start))))
        check(ref.eps <= EPSTOL and abs(ref.P[0].mean() - 2.0) < 0.05
              and abs(ref.P[1].mean() - 0.0401) < 0.005,
              "mesh-smc-1m-generic: the unsharded run fails the parity rule")
        mesh_1m = dict(
            iterations=res.iterations, eps=res.eps, mu=mu_p.mean(),
            sigma=sg_p.mean(), wall_s=wall, launches_3=n3, launches_4=n4,
            sweeps=counted.calls, kernel_3_vs_plain=partner_check,
            unsharded=dict(iterations=ref.iterations, eps=ref.eps,
                           mu=ref.P[0].mean(), sigma=ref.P[1].mean(),
                           wall_s=ref_wall))
        ph.result = json.dumps(mesh_1m)

    with Phase("mesh-distributed") as ph:
        # one nccl rank on the card (world size 1): global_mesh(walker=1)
        # runs mesh-smc's roll case through torch.distributed's
        # collectives, and equals the single-process result
        with __import__("socket").socket() as so:
            so.bind(("localhost", 0))
            port = so.getsockname()[1]
        check(PD.initialize(f"localhost:{port}", 1, 0), "initialize")
        try:
            gm = PD.global_mesh(walker=1)
            info = PD.process_info()
            check(gm.distributed and info["process_count"] == 1,
                  f"mesh-distributed: {info}")
            t0 = time.perf_counter()
            r = kt.smc(prior, readme_cost, partner_scheme="roll", mesh=gm,
                       **dict(nparticles=4096, epstol=EPSTOL, key=2))
            wall = time.perf_counter() - t0
            de_kw = dict(nparticles=4096, generations=50, verbose=False,
                         key=1)
            t0 = time.perf_counter()
            rd = kt.ABCDE(kt.Normal(1, 0.2), models.dirac_cost, 0.01,
                          mesh=gm, **de_kw)
            wall_de = time.perf_counter() - t0
        finally:
            PD.shutdown()
        a = kt.smc(prior, readme_cost, partner_scheme="roll",
                   **dict(nparticles=4096, epstol=EPSTOL, key=2))
        check(all(np.array_equal(x.particles, y.particles)
                  for x, y in zip(a.P, r.P)) and a.iterations == r.iterations,
              "mesh-distributed: the one-rank nccl mesh differs")
        ad = kt.ABCDE(kt.Normal(1, 0.2), models.dirac_cost, 0.01, **de_kw)
        check(np.array_equal(ad.P.particles, rd.P.particles)
              and ad.nsim == rd.nsim,
              "mesh-distributed: ABCDE on the one-rank nccl mesh differs")
        ph.result = (f"nccl, world size 1: smc iterations {r.iterations}, "
                     f"equal to one device, wall {wall:.3f} s; ABCDE 50 "
                     f"generations at 4096 equal to one device, wall "
                     f"{wall_de:.3f} s")

    # ---- slice 10: walker sharding of the other samplers ---------------
    # 4 shards of the one card (mesh4), and (chain=2, walker=2) for chains
    mesh22 = PM.make_mesh(chain=2, walker=2, devices=["cuda:0"] * 4)
    mesh10 = {}     # each phase's record
    launches10 = {}
    partner_forms = {}

    def rolled_block(comp, shifts, blk):
        """A shard's partner leaves, leaf-major: each leaf of the whole
        other half rolled by -r (torch.roll), the shard's block."""
        return [torch.roll(c, -int(r), 0)[blk] for c in comp for r in shifts]

    def check_partner_form(sw, stub_sw, upd, lp, ll, comp, extra, what):
        """Kernel #6 or #9 on one half of h walkers as 4 shards run it:
        each shard's partners-given kernel (``half_parts``, the shard's
        folded seed) against the plain partner form on torch.roll'ed
        partners, on Philox and stub bits (masks equal but at the accept
        threshold, values at the golden tolerance); on stub bits the
        partner form given the snapshot's rolls over the whole half gives
        the snapshot form's bits; then each form's time at h and the
        partner form's at a shard's h / 4, by events with the host's
        launches."""
        h = upd[0].shape[0]
        s4 = h // 4
        words = FA.uint32_words(torch.Generator(device=dev).manual_seed(21),
                                7)
        shifts = FA.rot_shifts6(words[:6], h).tolist()
        out = {}
        for bits_, w in (("hw", sw), ("stub", stub_sw)):
            tot = [0.0, 0, 0, 0]
            for g in range(4):
                blk = slice(g * s4, (g + 1) * s4)
                parts = rolled_block(comp, shifts, blk)
                seed_g = PM.fold_seed(words[6], g).reshape(1)
                ins = [x[blk] for x in upd] + [lp[blk], ll[blk]]
                got = w.half_parts([x[blk] for x in upd], lp[blk], ll[blk],
                                   parts, seed_g, *extra)
                want = w.half_plain([x[blk] for x in upd], lp[blk], ll[blk],
                                    None, None, seed_g, *extra, terms=True,
                                    partners=parts)
                r = ais_compare(flat(got), flat(want), ins,
                                f"{what} {bits_} shard {g}", want[3][1])
                tot = [max(tot[0], r[0])] + [a + b for a, b in
                                             zip(tot[1:], r[1:])]
            check(tot[2] > 0, f"{what} {bits_}: no commit")
            out[bits_] = dict(zip(("max_abs_err", "unequal", "commits",
                                   "borderline"), tot))
        whole = rolled_block(comp, shifts, slice(0, h))
        snap = stub_sw.half_words(upd, lp, ll, comp, words, *extra)
        given = stub_sw.half_parts(upd, lp, ll, whole, words[6:], *extra)
        check(same_bits(flat(snap), flat(given)), f"{what}: the partner "
              "form given the snapshot's rolls is not the snapshot form")
        out["snapshot_rolls_bit_equal"] = True
        out["ms_snapshot_h"] = cuda_ms(torch, lambda: sw.half_words(
            upd, lp, ll, comp, words, *extra), 20)
        out["ms_partners_h"] = cuda_ms(torch, lambda: sw.half_parts(
            upd, lp, ll, whole, words[6:], *extra), 20)
        blk0 = slice(0, s4)
        parts0 = rolled_block(comp, shifts, blk0)
        out["ms_partners_shard"] = cuda_ms(torch, lambda: sw.half_parts(
            [x[blk0] for x in upd], lp[blk0], ll[blk0], parts0, words[6:],
            *extra), 20)
        out["h"] = h
        return out

    with Phase("mesh-ais") as ph:
        # the README model (per-walker cost, 1000 draws a walker, as
        # ais-readme) at 4096 walkers, 20 sweeps, on one device and on 4
        # shards, roll and gather: bit-equal, no kernel; then chains=2 on
        # (chain=2, walker=2) against the unsharded chains=2 run
        model_r = kt.ApproxKernelizedPosterior(prior, readme_cost, 0.005)
        out = {}
        kw = dict(ntransitions=20, key=5)
        for scheme in ("roll", "gather"):
            reset_counts()
            PM.reset_transfer_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = kt.sample(model_r, kt.AIS(4096), 4096, partner_scheme=scheme,
                          **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            b = kt.sample(model_r, kt.AIS(4096), 4096, partner_scheme=scheme,
                          mesh=mesh4, **kw)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            check(all(np.array_equal(x.particles, y.particles)
                      for x, y in zip(a, b)),
                  f"mesh-ais {scheme}: sharded differs from one device")
            check(not any(counts().values()), "mesh-ais ran a kernel")
            out[scheme] = dict(bit_equal=True, wall_s=t1 - t0,
                               mesh_wall_s=t2 - t1,
                               permutes=PM.transfers["permute"],
                               joins=PM.transfers["join"],
                               shift_reads=PM.host_reads["shifts"])
        kw2 = dict(kw, chains=2, partner_scheme="roll")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = kt.sample(model_r, kt.AIS(4096), 4096, **kw2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        b = kt.sample(model_r, kt.AIS(4096), 4096, mesh=mesh22, **kw2)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(len(b[0]) == 2 * 4096 and all(
            np.array_equal(x.particles, y.particles) for x, y in zip(a, b)),
            "mesh-ais: (chain=2, walker=2) differs from the unsharded "
            "chains=2 run")
        check(not any(counts().values()), "mesh-ais ran a kernel")
        out["chains2"] = dict(bit_equal=True, wall_s=t1 - t0,
                              mesh_wall_s=t2 - t1)
        mesh10["ais"] = out
        ph.result = json.dumps(out)

    with Phase("mesh-ais-fused-generic") as ph:
        # ais-fused-generic on 4 shards: g-and-k at 131072 x 1000 draws,
        # 200 sweeps through #6 built for the mesh (8 launches a sweep),
        # the posterior within the tolerances ais-fused-generic uses
        # against the split run; then #6's partner form per shard
        n, h = 131072, 65536
        msw6 = kt.make_fused_ais_sweep(gprior, gdraw, greduce, scale=0.05,
                                       halves=True, mesh=mesh4)
        halves0 = (AI._halves(thg, h),
                   ((ldg[0][:h], ldg[1][:h]), (ldg[0][h:], ldg[1][h:])))
        PM.reset_transfer_counts()
        thm, _, wall_m, launched = iterate(msw6, *halves0, 200, 7)
        n6 = launched["fused_ais_sweep"]
        check(n6 == 8 * 200, f"mesh #6 launched {n6} times in 200 sweeps")
        check(sum(launched.values()) == n6,
              f"mesh-ais-fused-generic launched another kernel: {launched}")
        check(PM.host_reads["shifts"] == 400 and PM.transfers["join"] == 0,
              f"mesh #6: {PM.host_reads} host reads, {PM.transfers}")
        launches10["fused_ais_sweep"] = n6
        thm = AI._unhalves(tuple(PM.join(x) for x in thm))
        stats = []
        for i, tol in ((0, 0.1), (1, 0.1), (2, 0.25), (3, 0.05)):
            a_, b_ = ths[i].double(), thm[i].double()
            check(abs(float(a_.mean() - b_.mean())) < tol,
                  f"mesh g-and-k param {i}: mean {float(a_.mean())} vs "
                  f"{float(b_.mean())}")
            check(abs(float(a_.std() / b_.std()) - 1.0) < 0.3,
                  f"mesh g-and-k param {i}: std {float(a_.std())} vs "
                  f"{float(b_.std())}")
            stats.append(f"{float(b_.mean()):.4f}+-{float(b_.std()):.4f}")
        upd6 = [x[:h].contiguous() for x in thg]
        comp6 = [x[h:].contiguous() for x in thg]
        partner_forms["fused_ais_sweep"] = check_partner_form(
            msw6, ais_sweeps["g-and-k"][1], upd6, ldg[0][:h].contiguous(),
            ldg[1][:h].contiguous(), comp6, (), "mesh #6")
        mesh10["ais_fused_generic"] = dict(
            sweeps=200, wall_s=wall_m, unsharded_wall_s=wall_f,
            launches=n6, posterior=stats,
            partner_form=partner_forms["fused_ais_sweep"])
        ph.result = json.dumps(mesh10["ais_fused_generic"])

    with Phase("mesh-tsmc") as ph:
        # the conjugate model: the split rejuvenation at 4096 bit-equal to
        # one device; #9 built for the mesh at 131072, 5 MCMC steps, once
        # per shard a half-update, lam 1 and the tsmc-conjugate bands; then
        # #9's partner form per shard
        m_t, sd_t, logz_t = tsmc_truth
        out = {}
        kw = dict(nparticles=4096, mcmc_steps=5, loglike_vectorized=True,
                  key=1)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = kt.tsmc(cprior, ll_vec, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        b = kt.tsmc(cprior, ll_vec, mesh=mesh4, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(np.array_equal(a.P.particles, b.P.particles)
              and a.log_evidence == b.log_evidence
              and a.iterations == b.iterations,
              f"mesh-tsmc split: sharded differs: {a.iterations} vs "
              f"{b.iterations} iterations, log Z {a.log_evidence} vs "
              f"{b.log_evidence}")
        check(not any(counts().values()), "mesh-tsmc split ran a kernel")
        out["split n=4096"] = dict(bit_equal=True, iterations=b.iterations,
                                   log_evidence=b.log_evidence,
                                   wall_s=t1 - t0, mesh_wall_s=t2 - t1)
        msw9 = kt.make_fused_tempered_sweep(cprior, ll_conj, mesh=mesh4)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = kt.tsmc(cprior, ll_vec, nparticles=131072, mcmc_steps=5,
                    loglike_vectorized=True, key=1, mesh=mesh4,
                    sweep_fused=msw9)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n9 = counts()["fused_tempered_sweep"]
        check(n9 == 4 * 2 * 5 * r.iterations, f"mesh #9 launched {n9} "
              f"times in {r.iterations} iterations")
        check(sum(counts().values()) == n9, "mesh-tsmc launched another "
              f"kernel: {counts()}")
        launches10["fused_tempered_sweep"] = n9
        check(r.lam == 1.0, f"mesh tsmc: lam {r.lam}")
        check(abs(r.P.mean() - m_t) < 0.02, f"mesh tsmc: mean {r.P.mean()}")
        check(abs(r.P.std() - sd_t) < 0.02, f"mesh tsmc: sd {r.P.std()}")
        check(abs(r.log_evidence - logz_t) < 0.15,
              f"mesh tsmc: log Z {r.log_evidence} vs {logz_t}")
        out["fused n=131072"] = dict(
            iterations=r.iterations, mean=float(r.P.mean()),
            sd=float(r.P.std()), log_evidence=r.log_evidence, wall_s=wall,
            launches=n9)
        h = 65536
        th9 = torch.randn(2 * h, generator=gen, device=dev)
        lp9, ll9 = cprior.logpdf(th9).float(), ll_conj(th9).float()
        partner_forms["fused_tempered_sweep"] = check_partner_form(
            msw9, tempered["conjugate"][1], [th9[:h]], lp9[:h], ll9[:h],
            [th9[h:]], (torch.tensor(0.3, device=dev),), "mesh #9")
        out["partner_form"] = partner_forms["fused_tempered_sweep"]
        mesh10["tsmc"] = out
        ph.result = json.dumps(out)

    with Phase("mesh-pfilter") as ph:
        # pfilter-mixture on 4 shards: bit-equal to one device
        kw = dict(key=4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = kt.pfilter(kt.Uniform(-10, 10), models.mixture_cost, 4096, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        b = kt.pfilter(kt.Uniform(-10, 10), models.mixture_cost, 4096,
                       mesh=mesh4, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(np.array_equal(a.P.particles, b.P.particles)
              and np.array_equal(a.C.particles, b.C.particles)
              and a.eps == b.eps and a.iterations == b.iterations,
              "mesh-pfilter: sharded differs from one device")
        check(abs(float(b.P.mean())) < 0.25 and b.eps < 1.0,
              f"mesh pfilter: mean {float(b.P.mean())}, eps {b.eps}")
        mesh10["pfilter"] = dict(bit_equal=True, iterations=b.iterations,
                                 eps=b.eps, wall_s=t1 - t0,
                                 mesh_wall_s=t2 - t1)
        ph.result = json.dumps(mesh10["pfilter"])

    with Phase("mesh-abcde") as ph:
        # the split generation with a PyTorch cost (abcde-dirac's model,
        # 4096, 100 generations) bit-equal to one device; #10 built for
        # the mesh at 16384 x 1000 (4 launches a generation), #4 by
        # shard_batched_cost at the init, 60 generations and the rule of
        # abcde-fused; then each shard's #10 against its plain version
        out = {}
        kw = dict(nparticles=4096, generations=100, earlystop=True,
                  verbose=False, key=1)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = kt.ABCDE(kt.Normal(1, 0.2), models.dirac_cost, 0.01, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        b = kt.ABCDE(kt.Normal(1, 0.2), models.dirac_cost, 0.01, mesh=mesh4,
                     **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(np.array_equal(a.P.particles, b.P.particles)
              and np.array_equal(a.C.particles, b.C.particles)
              and a.nsim == b.nsim and a.iterations == b.iterations,
              "mesh-abcde split: sharded differs from one device")
        check(not any(counts().values()), "mesh-abcde split ran a kernel")
        out["split n=4096"] = dict(bit_equal=True, iterations=b.iterations,
                                   nsim=b.nsim, wall_s=t1 - t0,
                                   mesh_wall_s=t2 - t1)
        mgen = kt.make_fused_abcde_generation(fprior, fdraw, freduce,
                                              gamma=gamma_de, mesh=mesh4)
        mcost = kt.shard_batched_cost(costs["flagship"][0], mesh4)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = kt.ABCDE(fprior, mcost, 0.02, nparticles=16384, generations=60,
                     cost_vectorized=True, verbose=False, key=2, mesh=mesh4,
                     sweep_fused=mgen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        n10, n4 = (launched["fused_abcde_generation"],
                   launched["streaming_moment_cost"])
        check(n10 == 4 * 60, f"mesh #10 launched {n10} times in 60 "
              "generations")
        check(n4 >= 4 and n4 % 4 == 0, f"mesh #4 launched {n4} times")
        check(sum(launched.values()) == n10 + n4,
              f"mesh-abcde launched another kernel: {launched}")
        launches10["fused_abcde_generation"] = n10
        launches10["streaming_moment_cost"] = n4
        mu, sg = (float(p.mean()) for p in r.P)
        check(abs(mu - 2.0) < 0.02 and abs(sg - 0.04) < 0.003,
              f"mesh ABCDE n=16384: mu {mu}, sigma {sg}")
        out["fused n=16384"] = dict(generations=60, mu=mu, sigma=sg,
                                    nsim=r.nsim, wall_s=wall, launches_10=n10,
                                    launches_4=n4)
        # one generation on 4 shards: the wrapper once per shard with the
        # shard's folded seed, each shard against its plain version
        n = 16384
        s4 = n // 4
        leaves = [uniform(n, 1.5, 2.5), uniform(n, 0.01, 0.1)]
        bases, lps, ds, active, eps_i = abcde_generation_inputs(
            mgen, leaves, 3.0)
        reset_counts()
        o = mgen(torch.Generator(device=dev).manual_seed(9), tuple(leaves),
                 tuple(tuple(b_) for b_ in bases), lps, ds, active, eps_i)
        check(counts()["fused_abcde_generation"] == 4,
              "mesh #10 did not launch once per shard")
        seed = FA.uint32_words(torch.Generator(device=dev).manual_seed(9), 1)
        tot = [0.0, 0, 0, 0, 0]
        for g in range(4):
            blk = slice(g * s4, (g + 1) * s4)
            seed_g = PM.fold_seed(seed, g)
            args = ([x[blk] for x in leaves],
                    [[x[blk] for x in b_] for b_ in bases], lps[blk],
                    ds[blk], active[blk], eps_i[blk], seed_g)
            got = (list(o[0].shards[g]), o[1].shards[g], o[2].shards[g],
                   o[3].shards[g])
            check(same_bits(got, mgen.run(*args)), f"mesh #10 shard {g}: "
                  "the sharded call differs from the kernel on its block")
            want = mgen.generation_plain(*args, terms=True)
            rr = abcde_compare(got, want, args[0] + [lps[blk], ds[blk]],
                               torch.maximum(eps_i[blk], ds[blk]),
                               f"mesh #10 shard {g}")
            tot = [max(tot[0], rr[0])] + [x + y for x, y in
                                          zip(tot[1:], rr[1:])]
        check(tot[2] > 0, "mesh #10: no commit")
        out["per_shard_vs_plain"] = dict(zip(
            ("max_abs_err", "unequal", "commits", "borderline",
             "gate_passes"), tot))
        partner_forms["fused_abcde_generation"] = out["per_shard_vs_plain"]
        mesh10["abcde"] = out
        ph.result = json.dumps(out)

    with Phase("mesh-rejection") as ph:
        # budget mode: with a batched PyTorch cost (the README model, 100
        # draws a walker) 4096 kept of 10 chunks of 131072, bit-equal to
        # one device; through #1 by shard_batched_cost, 4096 kept of 100
        # chunks of 131072 (rejection-budget's, cut from 1600 chunks), 4
        # launches a chunk, and the parity rule
        def torch_cost(th, g):
            mu, sg = th
            x = mu[:, None] + sg[:, None] * torch.randn(
                mu.shape[0], 100, generator=g, device=g.device)
            return torch.hypot(x.mean(1) - 2.0,
                               (x.std(1, correction=0) - 0.04) * 50)

        out = {}
        kw = dict(nsims=131072 * 10, batch=131072, cost_vectorized=True,
                  key=3)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = kt.abc_rejection(prior, torch_cost, 4096, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        b = kt.abc_rejection(prior, torch_cost, 4096, mesh=mesh4, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(np.array_equal(a.C.particles, b.C.particles) and all(
            np.array_equal(x.particles, y.particles)
            for x, y in zip(a.P, b.P)),
            "mesh-rejection: sharded differs from one device")
        check(not any(counts().values()), "mesh-rejection ran a kernel")
        out["pytorch cost, 10 chunks"] = dict(
            bit_equal=True, eps=b.eps, wall_s=t1 - t0, mesh_wall_s=t2 - t1)
        rc1 = kt.shard_batched_cost(kt.make_flagship_cost_batched(), mesh4)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = kt.abc_rejection(prior, rc1, 4096, nsims=131072 * 100,
                             batch=131072, cost_vectorized=True, key=7,
                             mesh=mesh4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n1 = counts()["normal_summary_cost"]
        check(n1 == 4 * 100, f"mesh #1 launched {n1} times in 100 chunks")
        check(sum(counts().values()) == n1,
              f"mesh-rejection launched another kernel: {counts()}")
        launches10["normal_summary_cost"] = n1
        check(r.naccept == 4096 and bool((np.diff(r.C.particles) >= 0).all()),
              f"mesh rejection: naccept {r.naccept}")
        parity(r.P, "mesh-rejection")
        out["#1 by shard_batched_cost, 100 chunks"] = dict(
            eps=r.eps, mu=float(r.P[0].mean()), sigma=float(r.P[1].mean()),
            wall_s=wall, sims_per_s=131072 * 100 / wall, launches=n1)
        mesh10["rejection"] = out
        ph.result = json.dumps(out)

    # ---- the walkthroughs of examples_torch/ -----------------------------
    ex_times = {}   # kernel -> walkthrough unit -> its times and error

    with Phase("examples-kernels") as ph:
        # the walkthroughs' units of #4 and #5 at their width, 1024 walkers
        # (SIR's unit is sir-stub's, here on Philox bits), each against its
        # plain version on the same inputs at the golden tolerance; the
        # g-and-k ecdf's indicator summaries flip where a draw lies within
        # an ulp of a probe, so they are held within 2 / ndraws (two draws
        # a walker) and the unequal values counted
        seed_ex = torch.tensor([19], dtype=torch.int64, device=dev)
        for name, (c, k, pr) in {**ex_costs, **ex_scans}.items():
            th = tuple(x.contiguous() for x in pr.sample_tree(gen, 1024))
            if name in ex_scans:
                kernel, fn, plain_fn = ("streaming_scan_cost", c.means,
                                        c.means_plain)
            else:
                kernel, fn, plain_fn = ("streaming_moment_cost", c.moments,
                                        c.moments_plain)
            got = torch.stack(fn(th, seed_ex))
            want, plain = cuda_timed(
                torch, lambda: torch.stack(plain_fn(th, seed_ex)))
            if name == "gk-ecdf":
                err = max_err(got, want)
                check(err <= 2.0 / c.ndraws + 1e-6, f"example gk-ecdf: "
                      f"max|err| {err} against the plain version")
            else:
                err = max(assert_close(torch, g, w, f"example {name} {p}")
                          for p, (g, w) in enumerate(zip(got, want)))
            b, by = bound(c.work(1024, k))
            ex_times.setdefault(kernel, {})[name] = dict(
                width=1024, max_abs_err=err, unequal=int((got != want).sum()),
                ms=device_ms(torch, lambda: fn(th, seed_ex), 20,
                             f"{kernel}_kernel"),
                events_ms=cuda_ms(torch, lambda: fn(th, seed_ex), 20),
                plain_ms=plain, bound_ms=b, bound_by=by)
        # the walkthroughs' #9 and #6 at their own widths, one half-update
        # each on Philox bits, the same inputs on both sides, held to the
        # plain version by ais_compare: example_tsmc's conjugate unit at
        # h = 2000 (4000 particles: the last warp partial) at lam 0.3,
        # example_fused_ais' flagship unit at h = 2048 (4096 walkers)
        ex_halves = {}
        n = 4000
        sw = kt.make_fused_tempered_sweep(kt.Normal(0, 1),
                                          EX["example_tsmc"].loglike_elem)
        leaves = [torch.randn(n, generator=gen, device=dev)]
        pushed = sw.pushed(leaves)
        ex_halves["fused_tempered_sweep"] = (
            "tsmc-conjugate", sw, leaves,
            kt.Normal(0, 1).logpdf_tree(pushed).float(),
            EX["example_tsmc"].loglike_elem(pushed).float(), (0.3,))
        n = 4096
        sw = kt.make_fused_ais_sweep(ex_fa.prior, ex_fa.draw,
                                     ex_fa.reduce_cost, scale=ex_fa.SCALE)
        # a population of the posterior's size (mu 2 +- 0.02, sigma 0.04
        # +- 0.001), its loglikelihoods -cost / scale of the exact
        # moments, so some 20% of the walkers commit, as in the run
        leaves = [uniform(n, 1.98, 2.02), uniform(n, 0.039, 0.041)]
        ex_halves["fused_ais_sweep"] = (
            "fused-ais-flagship", sw, leaves,
            ex_fa.prior.logpdf_tree(sw.pushed(leaves)).float(),
            (-torch.hypot(leaves[0] - 2.0, (leaves[1] - 0.04) * 50.0)
             / ex_fa.SCALE).float(), ())
        for kernel, (name, sw, leaves, lp, ll, extra) in ex_halves.items():
            n = leaves[0].shape[0]
            h = n // 2
            upd, cmp_ = [x[:h] for x in leaves], [x[h:] for x in leaves]
            args = (upd, lp[:h], ll[:h], cmp_)
            got = sw.half_words(*args, words7(0), *extra)
            want, plain = cuda_timed(torch, lambda: sw.half_plain(
                *args, shifts_of(words7(0), h), seed_t, *extra, terms=True))
            r = ais_compare(flat(got), flat(want), upd + [lp[:h], ll[:h]],
                            f"example {name} h={h}", want[3][1])
            check(r[2] > 0, f"example {name} h={h} committed nothing")
            b, by = bound(sw.work(h) if extra else
                          sw.work(h, int(want[3][0].sum())))
            ex_times.setdefault(kernel, {})[name] = dict(
                width=h, max_abs_err=r[0], unequal=r[1], commits=r[2],
                borderline=r[3],
                ms=device_ms(torch, lambda: sw.half_words(
                    *args, words7(0), *extra), 20, f"{kernel}_kernel"),
                events_ms=cuda_ms(torch, lambda: sw.half_words(
                    *args, words7(0), *extra), 20),
                plain_ms=plain, bound_ms=b, bound_by=by)
        ph.result = json.dumps(ex_times)

    with Phase("examples") as ph:
        # every walkthrough's main() at its own settings, uncut, its
        # asserts inside; the JAX tests' checks of those without asserts
        # (tests/test_examples.py:8-21, :94-107, :110-124), and for
        # example_gk the g-and-k bands of example_streaming_sim
        res = {name: run_example(name) for name in EXAMPLES}
        for post in (res["example_n1"][0], res["example_n1"][1].P):
            check(abs(post[0].mean() - 2.0) < 0.05, f"example_n1: {post}")
        for post in (res["example_n2"][0], res["example_n2"][1].P):
            check(abs(post[0].mean() - 1.0) < 0.25, f"example_n2: {post}")
        gk = res["example_gk"]
        check(gk.eps <= 0.05 and all(
            p_.approx(t_, atol=a_) for p_, t_, a_ in zip(
                gk.P, (3.0, 1.0, 2.0, 0.5), (0.3, 0.35, 0.7, 0.4))),
            f"example_gk: eps {gk.eps}, {gk.P}")
        ts, tsf, logz = res["example_tsmc"]
        check(abs(ts.log_evidence - logz) < 0.5
              and abs(tsf.log_evidence - logz) < 0.5,
              f"example_tsmc: log-evidence {ts.log_evidence}, fused "
              f"{tsf.log_evidence}, analytic {logz}")
        ph.result = json.dumps(ex_runs)

    with Phase("example-expmix") as ph:
        # 10^6 draws a cost call, AIS(100), 100 samples after 2000
        # discarded: the JAX test's bands (tests/test_examples.py:127-145,
        # u1 0.49 +- 0.12, p1 0.88 +- 0.12), no tighter; the reference's
        # CI is printed beside the posterior
        _alarm(EXPMIX_LIMIT_S)
        u1p, p1p = run_example("example_expmix")
        _alarm(max(1, int(SCRIPT_LIMIT_S - (time.perf_counter() - t_start))))
        check(u1p.approx(0.49, atol=0.12) and p1p.approx(0.88, atol=0.12),
              f"example_expmix: u1 {u1p}, p1 {p1p}")
        ex_runs["example_expmix"].update(u1=[u1p.mean(), u1p.std()],
                                         p1=[p1p.mean(), p1p.std()])
        ph.result = json.dumps(ex_runs["example_expmix"])

    with Phase("conformance") as ph:
        t0 = time.perf_counter()
        conf = conformance(torch, np, kt, dev)
        conf["seconds"] = time.perf_counter() - t0
        say(json.dumps({"conformance": conf}))
        check(conf["failed"] == 0, f"conformance: {conf['failed']} failed")
        ph.result = f"{conf['passed']} passed, {conf['failed']} failed"

    for rec in records:   # the prior table's times beside #3's and #6's
        if rec["name"] == "fused_smc_sweep":
            rec["prior_table"] = {k: v for k, v in table_times.items()
                                  if k.startswith("#3")}
            rec["launches_by_path"] = {
                "smc-1m-generic": rec["launches"],
                "smc-1m-generic-priors": priors_smc["launches"],
                "smc-1m-generic-discrete": discrete_smc["launches"],
                "mesh-smc-1m-generic": mesh_launches["fused_smc_sweep"]}
            rec["launches"] += (priors_smc["launches"]
                                + discrete_smc["launches"]
                                + mesh_launches["fused_smc_sweep"])
            rec["mesh_smc_1m_generic"] = mesh_1m
            rec["prior_table_partners_bit_equal"] = partner_table
            rec["max_abs_err"] = max(rec["max_abs_err"], *(
                v["max_abs_err"] for v in partner_check.values()))
            rec["smc_1m_generic_priors"] = priors_smc
            rec["smc_1m_generic_discrete"] = discrete_smc
        if rec["name"] == "fused_ais_sweep":
            rec["prior_table"] = {k: v for k, v in table_times.items()
                                  if k.startswith("#6")}
    t4 = times4[16384]
    records.append(dict(
        name="streaming_moment_cost", route="cuda",
        source="kissabc_tpu_torch/csrc/generic.cuh",
        replaces="kissabc_tpu/ops/pallas_kernels.py:2532",
        launches=(cost_split_launches + threshold_launches
                  + discrete_launches["streaming_moment_cost"]
                  + mesh_launches["streaming_moment_cost"]),
        launches_by_path={"abcde-fused split": cost_split_launches,
                          "rejection-threshold": threshold_launches,
                          "smc-1m-generic-discrete":
                          discrete_launches["streaming_moment_cost"],
                          "mesh-smc-1m-generic":
                          mesh_launches["streaming_moment_cost"]},
        rejection_threshold=rejection_threshold, max_abs_err=max(
            t["max_abs_err"] for t in times4.values()), matched=True,
        ms=t4["ms"], plain_ms=t4["plain_ms"], bound_ms=t4["bound_ms"],
        bound_by=t4["bound_by"], library_ms=None, library_note="no PyTorch "
        "call streams a user simulator's moments per walker", width=16384,
        path="abcde-fused split", events_ms=t4["events_ms"],
        geometry=t4["geometry"],
        launches_smc_1m_generic=generic_launches["streaming_moment_cost"],
        by_width={n: {k: v for k, v in t.items() if k != "max_abs_err"}
                  for n, t in times4.items()}))
    records.append(dict(
        name="fused_tempered_sweep", route="cuda",
        source="kissabc_tpu_torch/csrc/tempered.cuh",
        replaces="kissabc_tpu/ops/pallas_kernels.py:1585",
        launches=tempered_launches, max_abs_err=max(
            t["err"][0] for t in times9.values()), matched=True,
        ms=t9["events_ms"], plain_ms=t9["plain_ms"],
        bound_ms=t9["bound"][0], bound_by=t9["bound"][1], library_ms=None,
        library_note="no PyTorch call fuses a move, a prior, a likelihood "
        "and an MH accept", device_ms=t9["device_ms"],
        queued_ms=t9["queued_ms"], by_width={n: {k: v for k, v in t.items() if k not in ("err", "bound")}
                  for n, t in times9.items()}))
    t10 = times10[16384]
    records.append(dict(
        name="fused_abcde_generation", route="cuda",
        source="kissabc_tpu_torch/csrc/generic.cuh",
        replaces="kissabc_tpu/ops/pallas_kernels.py:1841",
        launches=abcde_launches, max_abs_err=max(
            t[3][0] for t in times10.values()), matched=True,
        ms=t10[0], plain_ms=t10[1], bound_ms=t10[2][0], bound_by=t10[2][1],
        library_ms=None, library_note="no PyTorch call fuses a DE step, a "
        "prior gate, a simulator and a commit", events_ms=t10[5],
        ms_131072=times10[131072][0], bound_ms_131072=times10[131072][2][0],
        **t10[6], registers=[line for names, lines in ptxas.items()
                             if "abcde flagship" in names for line in lines],
        at_131072={k: v for k, v in times10[131072][6].items()
                   if k != "repeats_ms"}))

    for rec in records:   # #1 also runs budget mode's chunks
        if rec["name"] == "normal_summary_cost":
            rec["launches_by_path"] = {
                "smc-full": smc_launches,
                "rejection-budget": rejection_launches,
                "mesh-costs": mesh_launches["normal_summary_cost"]}
            rec["launches"] = (smc_launches + rejection_launches
                               + mesh_launches["normal_summary_cost"])
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     rejection_budget["cost_max_abs_err_131072"],
                                     mesh_cost_err["normal_summary_cost"])
            rec["rejection_budget"] = rejection_budget
        if rec["name"] == "streaming_scan_cost":
            rec["launches_by_path"] = {
                "smc-scan-ar1": rec["launches"],
                "mesh-costs": mesh_launches["streaming_scan_cost"]}
            rec["launches"] += mesh_launches["streaming_scan_cost"]
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     mesh_cost_err["streaming_scan_cost"])
    for rec in records:   # slice 10's mesh paths
        path = {"fused_ais_sweep": "mesh-ais-fused-generic",
                "fused_tempered_sweep": "mesh-tsmc",
                "fused_abcde_generation": "mesh-abcde",
                "normal_summary_cost": "mesh-rejection",
                "streaming_moment_cost": "mesh-abcde"}.get(rec["name"])
        if path is None:
            continue
        if "launches_by_path" not in rec:
            rec["launches_by_path"] = {"single device": rec["launches"]}
        rec["launches_by_path"][path] = launches10[rec["name"]]
        rec["launches"] += launches10[rec["name"]]
        if rec["name"] in partner_forms:
            form = partner_forms[rec["name"]]
            rec["mesh_per_shard"] = form
            rec["max_abs_err"] = max(rec["max_abs_err"], *(
                v["max_abs_err"] for v in form.values()
                if isinstance(v, dict)), form.get("max_abs_err", 0.0))
    for rec in records:   # the walkthroughs' launches and kernel checks
        for name in EXAMPLE_KERNELS:
            n = ex_runs[name]["launches"].get(rec["name"], 0)
            if not n:
                continue
            if "launches_by_path" not in rec:
                rec["launches_by_path"] = {"single device": rec["launches"]}
            rec["launches_by_path"][name] = n
            rec["launches"] += n
        if rec["name"] in ex_times:
            rec["examples"] = ex_times[rec["name"]]
            rec["max_abs_err"] = max(rec["max_abs_err"], *(
                v["max_abs_err"] for v in ex_times[rec["name"]].values()))
    say(json.dumps({"examples": ex_runs}))
    say(json.dumps({"mesh": {"roll": mesh_roll, "smc": mesh_smc,
                             "smc_1m_generic": mesh_1m, **mesh10}}))
    signal.alarm(0)
    say(f"[total] {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
