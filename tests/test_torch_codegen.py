"""kissabc_tpu_torch/ops/codegen.py: user models written in PyTorch,
traced into expression graphs and emitted as the CUDA device functions
of the generic kernels. The graph, evaluated on tensors, is the callable
bit for bit; an op the kernels cannot hold raises when the model is
built; constants are float32 bit patterns; and the emitted functions,
compiled as host C++ (CUDA qualifiers defined away), agree with PyTorch
to a few float32 ulps.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch import models
from kissabc_tpu_torch.ops import _build
from kissabc_tpu_torch.ops import codegen as C
from torch_threads import one_torch_thread  # noqa: F401


_, flagship_draw, flagship_reduce = models.flagship()
_, gk_draw, gk_reduce = models.g_and_k()


def every_op(th, e):
    """One model through every supported op."""
    a, b = th
    x = (a - e) / (b + 2.0) * 3.0 + (-e) ** 2 + e ** 3 - 1.0 / (b + 1.0)
    y = torch.where(e > 0.5, torch.sin(e), torch.cos(e)) + e.abs().sqrt()
    y = y + torch.expm1(e * 0.1) - torch.log(b) + torch.exp(-a * 0.2)
    y = y + torch.maximum(x, y) - torch.minimum(x * 0.5, y)
    y = y + x.clamp(min=-1.0, max=4.0) + torch.clamp(y, max=3.0)
    y = y + (e <= 0.0).to(torch.float32) + (a >= 2.0).float() \
        + (e < a).float() * (e != b).float() + (a == a).float()
    return y + torch.hypot(x, y) * 0.5 + torch.square(torch.tanh(x)) \
        + torch.log1p(torch.abs(y)) + torch.ones_like(e) \
        - torch.zeros_like(e) + 2.0 - e


ECDF = [lambda x, t=t: (x < t).to(torch.float32) for t in (1.0, 2.0, 3.0)]


def _thetas(k, n, seed):
    rng = np.random.default_rng(seed)
    lo = np.array([1.0, 0.1, -1.0, 0.0])[:k]
    hi = np.array([3.0, 3.0, 5.0, 0.9])[:k]
    return [torch.from_numpy(rng.uniform(lo[i], hi[i], n).astype(np.float32))
            for i in range(k)]


def _noise(n, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).normal(size=n).astype(np.float32))


# ---------------------------------------------------------------------------
# the recorded graph equals the callable
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draw,k", [(flagship_draw, 2), (gk_draw, 4),
                                    (every_op, 2),
                                    (lambda th, u: -torch.log1p(-u) / th[0],
                                     1)])
def test_draw_graph_equals_callable_bitwise(draw, k):
    th, e = _thetas(k, 4096, 1), _noise(4096, 2)
    if k == 1:
        e = e.abs() / (e.abs().max() + 1.0)   # uniform-like in [0, 1)
    graph = C.trace_draw(draw, k)
    got = C.evaluate(graph, {"theta": th, "noise": e})
    want = draw(tuple(th), e)
    assert torch.equal(got, want)


@pytest.mark.parametrize("reduce_cost", [flagship_reduce, gk_reduce])
def test_reduce_graph_equals_callable_bitwise(reduce_cost):
    th = _thetas(2, 4096, 3)
    m = (1.5 + _noise(4096, 4) * 0.5, 4.0 + _noise(4096, 5).abs())
    graph = C.trace_reduce(reduce_cost, 2, 2)
    got = C.evaluate(graph, {"theta": th, "m": list(m)})
    assert torch.equal(got, reduce_cost(tuple(th), m))


def test_stats_graphs_equal_callables_bitwise():
    x = _noise(4096, 6) * 2.0 + 1.5
    graphs = C.trace_stats(ECDF, 3)
    for g, fn in zip(graphs, ECDF):
        assert torch.equal(C.evaluate(g, {"x": x}), fn(x))
    chain = C.trace_stats(None, 3)   # the raw power chain x, x*x, x*x*x
    for p, g in enumerate(chain):
        want = x if p == 0 else (x * x if p == 1 else x * x * x)
        assert torch.equal(C.evaluate(g, {"x": x}), want)


def test_probe_structure():
    assert C.probe_structure(lambda th, e: th + e) is None
    assert C.probe_structure(lambda th, e: th[0] * e) == 1
    assert C.probe_structure(flagship_draw) == 2
    assert C.probe_structure(gk_draw) == 4


# ---------------------------------------------------------------------------
# unsupported ops raise when the model is built
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draw,op", [
    (lambda th, e: torch.sigmoid(e), "sigmoid"),
    (lambda th, e: e.erf(), "erf"),
    (lambda th, e: torch.atan2(e, th[0]), "atan2"),
    (lambda th, e: e ** 0.5, "pow"),
    (lambda th, e: 2.0 ** e, "pow"),
    (lambda th, e: e.to(torch.float64), "to"),
])
def test_unsupported_op_raises_at_build(draw, op):
    prior = kt.Factored(kt.Uniform(1, 3), kt.Uniform(0, 1))
    with pytest.raises(NotImplementedError, match=op):
        kt.make_streaming_moment_cost(draw, lambda th, m: m[0])
    with pytest.raises(NotImplementedError, match=op):
        kt.make_fused_smc_sweep(prior, draw, lambda th, m: m[0])


def test_unsupported_reduce_and_prior_raise_at_build():
    prior = kt.Factored(kt.Uniform(1, 3), kt.Uniform(0, 1))
    with pytest.raises(NotImplementedError, match="logsumexp"):
        kt.make_fused_smc_sweep(
            prior, flagship_draw,
            lambda th, m: torch.logsumexp(m[0], 0))

    class Laplace(kt.Normal):
        pass

    with pytest.raises(NotImplementedError, match="prior table"):
        kt.make_fused_smc_sweep(kt.Factored(kt.Uniform(1, 3), Laplace(0, 1)),
                                flagship_draw, flagship_reduce)
    with pytest.raises(TypeError, match="truth value"):
        C.trace_draw(lambda th, e: e if e > 0 else -e, None)


# ---------------------------------------------------------------------------
# float32 constants
# ---------------------------------------------------------------------------

def test_constants_are_float32_bit_patterns():
    assert C.f32_literal(0.1) == "__uint_as_float(0x3dcccccdu)"
    assert C.f32_literal(np.float32(-np.inf)) == "__uint_as_float(0xff800000u)"
    text, _ = C.emit_function("draw", "const float* th, float e",
                              C.trace_draw(lambda th, e: e * 0.3 + 1e-3,
                                           None))
    for v in (0.3, 1e-3):
        bits = int(np.float32(v).view(np.uint32))
        assert f"0x{bits:08x}u" in text
    assert "0.3" not in text.replace(f"{0.3!r}", "")   # no decimal literal


def test_generated_unit_and_op_counts():
    prior = models.flagship()[0]
    g = C.generate(flagship_draw, structure=2, nstats=2, stats=None,
                   nmoments=2, noise="normal", reduce_cost=flagship_reduce,
                   prior=prior)
    for needle in ("#define KT_NPARAMS 2", "#define KT_NSTATS 2",
                   "#define KT_NOISE_NORMAL 1", "#define KT_HAS_SWEEP 1",
                   '#include "generic.cuh"', "float draw(const float* th",
                   "float reduce_cost(", "float prior_logpdf("):
        assert needle in g.source
    assert (g.draw_ops, g.stat_ops) == (2, 1)
    assert g.reduce_ops == 12 and g.prior_ops == 14
    c = C.generate(gk_draw, structure=4, nstats=3, stats=ECDF, nmoments=2,
                   noise="uniform")
    assert "KT_HAS_SWEEP 0" in c.source and "stat_2(" in c.source
    assert "KT_NOISE_NORMAL 0" in c.source and c.draw_ops == 13


# ---------------------------------------------------------------------------
# the emitted device functions, compiled as host C++
# ---------------------------------------------------------------------------

_PRELUDE = r"""
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __forceinline__ inline
static inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
"""

_RUNNERS = r"""
extern "C" void run_draw(const float* th, const float* e, float* out, int n) {
  for (int i = 0; i < n; ++i) {
    float t[K];
    for (int k = 0; k < K; ++k) t[k] = th[k * n + i];
    out[i] = draw(t, e[i]);
  }
}
extern "C" void run_stats(const float* x, float* out, int n) {
  for (int i = 0; i < n; ++i) {
    float g[S];
    stats_of(x[i], g);
    for (int j = 0; j < S; ++j) out[j * n + i] = g[j];
  }
}
#ifdef SWEEP
extern "C" void run_reduce(const float* th, const float* m, float* out,
                           int n) {
  for (int i = 0; i < n; ++i) {
    float t[K], mm[S];
    for (int k = 0; k < K; ++k) t[k] = th[k * n + i];
    for (int j = 0; j < S; ++j) mm[j] = m[j * n + i];
    out[i] = reduce_cost(t, mm);
    out[n + i] = prior_logpdf(t);
  }
}
#endif
"""


def _host_library(tmp_path, unit):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the emitted code")
    src = tmp_path / "unit.cpp"
    defines = (f"#define K {unit.nparams}\n#define S {unit.nstats}\n"
               + ("#define SWEEP\n" if unit.reduce_ops else ""))
    src.write_text(_PRELUDE + unit.functions + defines + _RUNNERS)
    lib = tmp_path / "unit.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _ulps(a, b):
    """Float32 ulps between two tensors, on the scale of the larger
    magnitude or 1: the draws and costs here are sums of terms of order
    one, so a result near zero carries the rounding of its terms."""
    scale = torch.maximum(a.abs(), b.abs()).clamp(min=1.0)
    spacing = torch.from_numpy(np.spacing(scale.numpy().astype(np.float32)))
    return ((a - b).abs() / spacing).max().item()


# the host libm (glibc) and PyTorch's CPU kernels (SLEEF) each round tanh,
# exp, log1p, sin, cos to within 1-2 ulps; in the g-and-k draw
# exp(k*log1p(e*e)) scales log1p's rounding by k*log1p(e*e) (up to ~3)
# before tanh's and exp's own: 8 ulps measured on these inputs, 16 allowed
ULP_TOL = 16


@pytest.mark.parametrize("name,draw,k,stats,reduce_cost", [
    ("flagship", flagship_draw, 2, None, flagship_reduce),
    ("g-and-k", gk_draw, 4, ECDF, gk_reduce),
    ("every-op", every_op, 2, None, None),
])
def test_emitted_functions_match_torch_on_host(tmp_path, name, draw, k,
                                               stats, reduce_cost):
    n = 2048
    if reduce_cost is not None:
        prior = (models.flagship() if k == 2 else models.g_and_k())[0]
    nstats = len(stats) if stats else 2
    unit = C.generate(draw, structure=k, nstats=nstats, stats=stats,
                      nmoments=2, noise="normal", reduce_cost=reduce_cost,
                      prior=prior if reduce_cost else None)
    lib = _host_library(tmp_path, unit)
    th, e = _thetas(k, n, 7), _noise(n, 8)
    if reduce_cost is not None:   # the last leaf across its support's edge
        th[-1] = th[-1] * 0.05 - 0.01 if k == 2 else th[-1] * 1.3 - 0.05
    flat = torch.cat(th).contiguous()
    out = torch.empty(n)
    lib.run_draw(_ptr(flat), _ptr(e), _ptr(out), n)
    x = draw(tuple(th), e)
    assert _ulps(out, x) <= ULP_TOL, name

    sout = torch.empty(nstats * n)
    lib.run_stats(_ptr(x), _ptr(sout), n)
    want = torch.stack([C.evaluate(g, {"x": x})
                        for g in C.trace_stats(stats, nstats)])
    assert torch.equal(sout.view(nstats, n), want)

    if reduce_cost is not None:
        m = [x * 0.5 + 2.0, x * x * 0.1 + 4.0, x][:nstats]
        mflat = torch.stack(m).contiguous()   # held while C reads it
        rout = torch.empty(2 * n)
        lib.run_reduce(_ptr(flat), _ptr(mflat), _ptr(rout), n)
        assert _ulps(rout[:n], reduce_cost(tuple(th), m)) <= ULP_TOL
        want_lp = prior.logpdf_tree(tuple(th))
        got_lp = rout[n:]
        finite = torch.isfinite(want_lp)
        assert torch.equal(torch.isfinite(got_lp), finite)
        assert 0 < int(finite.sum()) < n   # both branches of the support
        assert _ulps(got_lp[finite], want_lp[finite]) <= ULP_TOL


# ---------------------------------------------------------------------------
# the AIS sweep's prior: the discrete push
# ---------------------------------------------------------------------------

_PUSH_RUNNER = r"""
extern "C" void run_push(const float* th, float* out, int n) {
  for (int i = 0; i < n; ++i) {
    float t[K], p[K];
    for (int k = 0; k < K; ++k) t[k] = th[k * n + i];
    prior_push(t, p);
    for (int k = 0; k < K; ++k) out[k * n + i] = p[k];
    out[K * n + i] = prior_logpdf(p);
  }
}
"""

DISCRETE_PRIOR = kt.Factored(kt.DiscreteUniform(1, 10), kt.Uniform(0.1, 1.0))


def test_ais_unit_pushes_discrete_marginals():
    unit = C.generate(flagship_draw, structure=2, nstats=2, stats=None,
                      nmoments=2, noise="normal",
                      reduce_cost=lambda th, m: torch.abs(m[0] - 3.0),
                      prior=DISCRETE_PRIOR, ais=True)
    for needle in ("#define KT_HAS_AIS 1", "#define KT_HAS_SWEEP 0",
                   "void prior_push(", "rintf(th[0])", "out[1] = th[1];"):
        assert needle in unit.source
    assert unit.push_ops == 1 and unit.prior_ops == 7
    # the smc sweep pushes too, as the JAX kernel: a discrete marginal
    # builds there
    sweep = kt.make_fused_smc_sweep(DISCRETE_PRIOR, flagship_draw,
                                    lambda th, m: m[0])
    for needle in ("#define KT_HAS_SWEEP 1", "void prior_push(",
                   "rintf(th[0])", "out[1] = th[1];"):
        assert needle in sweep.unit.source
    assert sweep.unit.push_ops == 1


def test_emitted_discrete_push_matches_torch_on_host(tmp_path):
    """``prior_push`` rounds half to even as ``DiscreteUniform.push``
    (``torch.round``) and ``prior_logpdf`` of the pushed value equals
    the port's logpdf of the pushed tree, bit for bit; the continuous
    leaf passes unchanged."""
    _check_host_push(tmp_path, C.generate(
        flagship_draw, structure=2, nstats=2, stats=None, nmoments=2,
        noise="normal", reduce_cost=lambda th, m: torch.abs(m[0] - 3.0),
        prior=DISCRETE_PRIOR, ais=True))


def test_emitted_smc_push_matches_torch_on_host(tmp_path):
    """The smc sweep's unit (kernel #3) emits the same push: ``rintf``
    on the discrete marginal, bit for bit ``DiscreteUniform.push``."""
    _check_host_push(tmp_path, kt.make_fused_smc_sweep(
        DISCRETE_PRIOR, flagship_draw, lambda th, m: m[0]).unit)


def _check_host_push(tmp_path, unit):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the emitted code")
    src = tmp_path / "unit.cpp"
    src.write_text(_PRELUDE + unit.functions + "#define K 2\n" + _PUSH_RUNNER)
    lib_path = tmp_path / "unit.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    halves = torch.tensor([0.5, 1.5, 2.5, 3.5, 9.5, 10.5, -0.5, 10.49])
    m = torch.cat([halves, torch.rand(2040, generator=torch.Generator()
                                      .manual_seed(3)) * 12.0 - 1.0])
    s = torch.rand(m.shape[0], generator=torch.Generator().manual_seed(4))
    n = m.shape[0]
    flat = torch.cat([m, s]).contiguous()
    out = torch.empty(3 * n)
    lib.run_push(_ptr(flat), _ptr(out), n)
    pushed = DISCRETE_PRIOR.push_tree((m, s))
    assert torch.equal(out[:n], pushed[0].to(torch.float32))
    assert torch.equal(out[n:2 * n], s)
    assert torch.equal(out[:8], torch.tensor([0., 2., 2., 4., 10., 10., -0.,
                                              10.]))
    want = DISCRETE_PRIOR.logpdf_tree(
        tuple(x.to(torch.float32) for x in pushed))
    assert torch.equal(out[2 * n:], want)
    assert 0 < int(torch.isfinite(want).sum()) < n


# ---------------------------------------------------------------------------
# the entry points a unit declares against those the wrappers bind
# ---------------------------------------------------------------------------

_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


def _entry_points(text):
    """extern "C" function -> its ctypes argument types (a pointer or the
    stream a ``c_void_p``), from preprocessed C++."""
    out = {}
    for m in re.finditer(r'extern "C" [\w ]+?\**\s*(kt_\w+)\(([^)]*)\)', text):
        args = [a.split() for a in m.group(2).split(",") if a.strip()]
        out[m.group(1)] = [ctypes.c_void_p if "*" in "".join(a)
                           else _C_TYPES[a[-2]] for a in args]
    return out


def _preprocessed(tmp_path, source):
    """``source`` (a unit or a file of csrc/) through the host C
    preprocessor, with the CUDA headers empty: only the entry points its
    macros enable remain."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to preprocess the unit")
    for header in ("cuda_runtime.h", "cooperative_groups.h"):
        (tmp_path / header).write_text("")
    unit = tmp_path / "unit.cu"
    unit.write_text(source)
    csrc = Path(kt.__file__).parent / "csrc"
    return subprocess.run(
        ["g++", "-E", "-P", "-x", "c++", "-std=c++17", "-I", str(tmp_path),
         "-I", str(csrc), str(unit)], check=True, capture_output=True,
        text=True).stdout


def test_sweep_unit_declares_what_fused_smc_binds(tmp_path):
    """The flagship model's unit for kernel #3 declares the sweep's entry
    points with the argument types ``ops/_build.py`` gives ctypes (a
    mismatch would pass pointers or floats in the wrong registers), and
    no entry point of the AIS or ABC-DE units."""
    sweep = kt.make_fused_smc_sweep(*models.flagship())
    found = _entry_points(_preprocessed(tmp_path, sweep.unit.source))
    assert set(found) == {"kt_streaming_moment_cost", "kt_fused_smc_sweep",
                          "kt_fused_smc_sweep_occupancy", "kt_error_string"}
    for name in ("kt_streaming_moment_cost", "kt_fused_smc_sweep",
                 "kt_fused_smc_sweep_occupancy"):
        assert found[name] == _build.GEN_SIGNATURES[name], name


@pytest.mark.parametrize("name", sorted(_build.GEN_SIGNATURES))
def test_generated_entry_points_match_their_bindings(tmp_path, name):
    """Every entry point of the generated units, declared by one of the
    templates with all its features on, as ``ops/_build.py`` binds it."""
    source = "\n".join(
        ["#define KT_NPARAMS 2", "#define KT_NSTATS 2",
         "#define KT_NOISE_NORMAL 1", "#define KT_HAS_SWEEP 1",
         "#define KT_HAS_AIS 1", "#define KT_HAS_ABCDE 1",
         '#include "generic.cuh"', '#include "scan.cuh"',
         '#include "tempered.cuh"'])
    found = _entry_points(_preprocessed(tmp_path, source))
    assert found[name] == _build.GEN_SIGNATURES[name]


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_hand_written_entry_points_match_their_bindings(tmp_path, name):
    found = _entry_points(_preprocessed(
        tmp_path, '#include "flagship.cu"\n#include "ais.cu"\n'))
    assert found[name] == _build._SIGNATURES[name]
