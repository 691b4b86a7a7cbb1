"""kissabc_tpu_torch's sequential-simulator cost
(``make_streaming_scan_cost``, TPU kernel #5), mirroring
tests/test_scan_cost.py on the CPU: the plain version against the JAX
Pallas kernel in interpret mode on the stub bit stream (odd nsteps,
series reads, a two-leaf state, uniform noise, the SIR example), the
AR(1) stationary moments of the Philox stream, smc recovering AR(1),
the JAX package's validation messages, and the scan model's emitted
device functions compiled as host C++ (skipped without ``g++``). The
CUDA kernel is held against the plain version on the card by
chip_smoke.py.
"""

import ctypes
import importlib.util
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kissabc_tpu.ops.pallas_kernels import (
    make_streaming_scan_cost as jax_scan_cost)
import kissabc_tpu_torch as kt
from kissabc_tpu_torch import models
from kissabc_tpu_torch.ops import codegen as C
from kissabc_tpu_torch.ops import scan as S
from kissabc_tpu_torch.utils.rng import as_generator

RTOL, ATOL = 3e-4, 3e-5   # the JAX golden tolerance (test_scan_cost.py:104)
A = models.AR1_A
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_ar1_step(th, x, eps, t):
    mu, s = th
    return (1.0 - A) * x + A * mu + s * eps


def _jax_seed(key):
    """The seed the JAX cost draws from its key (pallas_kernels.py:3096)."""
    return int(jax.random.bits(key, (), jnp.uint32))


_, AR1_STEP, AR1_INIT, AR1_REDUCE = models.ar1()


def _two_leaf_models(lib):
    """The two-component state of test_scan_cost.py:151-168, in JAX
    (``lib=jnp``) or PyTorch (``lib=torch``)."""
    def step(th, xt, eps, t):
        x, acc = xt
        x = x + th[0] * 0.1 + eps
        return (x, 0.9 * acc + 0.1 * lib.abs(x))

    def init(th):
        return (th[0], lib.abs(th[0]))

    def observe(th, xt, t, obs):
        return (xt[1], xt[0] * (t.astype(jnp.float32) if lib is jnp
                                else t.float()))

    return step, init, observe


SIR = _load_example("example_sir")
_, SIR_STEP, SIR_INIT, SIR_OBSERVE, SIR_REDUCE, SIR_SERIES = models.sir()


def _sir_jax_series():
    series = np.zeros((2 * SIR.DAYS,), np.float32)
    series[1::2] = SIR.observed_curve()
    return series


# name: (JAX kwargs, port kwargs, thetas, nsteps, tiling)
def _cases():
    rng = np.random.default_rng(7)
    ar_th = (rng.uniform(0.5, 2.0, 2100).astype(np.float32),
             rng.uniform(0.5, 1.5, 2100).astype(np.float32))
    y = np.linspace(0.0, 2.0, 7).astype(np.float32)
    sir_th = (rng.uniform(0.05, 0.8, 2048).astype(np.float32),
              rng.uniform(0.02, 0.4, 2048).astype(np.float32))
    jstep2, jinit2, jobs2 = _two_leaf_models(jnp)
    tstep2, tinit2, tobs2 = _two_leaf_models(torch)
    sq12 = np.float32(np.sqrt(12.0))
    return {
        # test_scan_cost.py:82-100: programs and slabs, odd nsteps
        "ar1-odd": (dict(step=_jax_ar1_step, init=lambda th: th[0],
                         reduce_cost=lambda th, m: m[0] + 10.0 * m[1]),
                    dict(step=AR1_STEP, init=AR1_INIT,
                         reduce_cost=lambda th, m: m[0] + 10.0 * m[1]),
                    ar_th, 11, dict(block=128, walker_tiles=16, sub_rows=8)),
        # test_scan_cost.py:103-123: series reads in step order
        "series": (dict(step=_jax_ar1_step, init=lambda th: th[0],
                        reduce_cost=lambda th, m: m[0],
                        observe=lambda th, x, t, obs: (jnp.abs(x - obs),),
                        series=y),
                   dict(step=AR1_STEP, init=AR1_INIT,
                        reduce_cost=lambda th, m: m[0],
                        observe=lambda th, x, t, obs: (torch.abs(x - obs),),
                        series=y),
                   (ar_th[0][:1024], ar_th[1][:1024]), 7,
                   dict(block=128, walker_tiles=8, sub_rows=8)),
        # the SIR example: t % 2, where, clamp with tensor bounds, series
        "sir": (dict(step=SIR.sir_step, init=SIR.sir_init,
                     reduce_cost=lambda th, m: m[0],
                     observe=SIR.sir_observe, series=_sir_jax_series()),
                dict(step=SIR_STEP, init=SIR_INIT, reduce_cost=SIR_REDUCE,
                     observe=SIR_OBSERVE, series=SIR_SERIES),
                sir_th, 2 * SIR.DAYS,
                dict(block=128, walker_tiles=8, sub_rows=8)),
        # test_scan_cost.py:151-168 with an odd nsteps and a traced t
        "two-leaf-state": (dict(step=jstep2, init=jinit2, observe=jobs2,
                                reduce_cost=lambda th, m: m[0] + m[1]),
                           dict(step=tstep2, init=tinit2, observe=tobs2,
                                reduce_cost=lambda th, m: m[0] + m[1]),
                           (ar_th[0][:1024],), 9,
                           dict(block=256, walker_tiles=4, sub_rows=16)),
        # test_scan_cost.py:266-300: centred uniforms
        "uniform": (dict(step=lambda th, x, e, t: (1.0 - A) * x + A * th[0]
                         + th[1] * (e - 0.5) * sq12,
                         init=lambda th: th[0],
                         reduce_cost=lambda th, m: m[0] + m[1],
                         noise="uniform"),
                    dict(step=lambda th, x, e, t: (1.0 - A) * x + A * th[0]
                         + th[1] * (e - 0.5) * sq12,
                         init=AR1_INIT, reduce_cost=lambda th, m: m[0] + m[1],
                         noise="uniform"),
                    (ar_th[0][:1024], ar_th[1][:1024]), 8,
                    dict(block=128, walker_tiles=8, sub_rows=8)),
    }


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_interpret_on_stub_bits(name):
    jkw, tkw, thetas, nsteps, tiles = CASES[name]
    key = jax.random.key(len(name))
    jcost = jax_scan_cost(nsteps=nsteps, bits="stub", interpret=True,
                          **tiles, **jkw)
    want = np.asarray(jcost(tuple(jnp.asarray(t) for t in thetas), key))
    tcost = kt.make_streaming_scan_cost(nsteps=nsteps, bits="stub", **tiles,
                                        **tkw)
    th = tuple(torch.from_numpy(t) for t in thetas)
    means = tcost.means(th, _jax_seed(key))
    got = tkw["reduce_cost"](th, means).numpy()
    assert got.shape == want.shape == (len(thetas[0]),)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the batched call draws its seed from the generator and reduces
    out = tcost(th, as_generator(0, "cpu"))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert S.launches["streaming_scan_cost"] == 0   # the CPU launches none


def test_ar1_stationary_moments_on_philox():
    """test_scan_cost.py:126-148 on the port's Philox stream: the
    time-averaged mean and variance of AR(1) against the closed forms."""
    n, nsteps = 4096, 512
    mu, s = torch.ones(n), torch.ones(n)
    cost = kt.make_streaming_scan_cost(AR1_STEP, AR1_INIT,
                                       lambda th, m: m[0], nsteps=nsteps)
    m1, m2 = cost.means((mu, s), 5)
    var = (m2 - m1 * m1).numpy()
    stat_var = 1.0 / (1.0 - (1.0 - float(A)) ** 2)
    assert abs(float(m1.mean()) - 1.0) < 0.02
    assert abs(var.mean() - stat_var) / stat_var < 0.1
    assert 0.02 < float(m1.std()) < 0.5
    again = cost.means((mu, s), 5)
    other = cost.means((mu, s), 6)
    assert torch.equal(again[0], m1) and not torch.equal(other[0], m1)


def test_smc_recovers_ar1_parameters():
    """test_scan_cost.py:171-189: 512 particles, nsteps 256, epstol 0.15,
    key 9, with the JAX test's limits on the posterior means."""
    prior = kt.Factored(kt.Uniform(0, 2), kt.Uniform(0.3, 2.0))
    cost = kt.make_streaming_scan_cost(AR1_STEP, AR1_INIT, AR1_REDUCE,
                                       nsteps=256)
    res = kt.smc(prior, cost, nparticles=512, cost_vectorized=True,
                 epstol=0.15, key=9, device="cpu")
    mu_post, s_post = res.P
    assert abs(mu_post.mean() - 1.0) < 0.15
    assert abs(s_post.mean() - 1.0) < 0.25
    assert res.eps <= 0.15


# ---------------------------------------------------------------------------
# validation: the JAX package's messages
# ---------------------------------------------------------------------------

def _messages(jmake, tmake):
    with pytest.raises(ValueError) as jerr:
        jmake()
    with pytest.raises(ValueError) as terr:
        tmake()
    return str(jerr.value), str(terr.value)


@pytest.mark.parametrize("bad", [
    dict(nsteps=0), dict(noise="cauchy"), dict(block=100),
    dict(sub_rows=7), dict(nmoments=0), dict(nmoments=9),
])
def test_validation_messages_match_jax(bad):
    kw = {"nsteps": 4, **bad}
    j, t = _messages(
        lambda: jax_scan_cost(_jax_ar1_step, lambda th: th[0],
                              lambda th, m: m[0], **kw),
        lambda: kt.make_streaming_scan_cost(AR1_STEP, AR1_INIT,
                                            lambda th, m: m[0], **kw))
    assert t == j


def test_series_and_leaf_messages_match_jax():
    j, t = _messages(
        lambda: jax_scan_cost(_jax_ar1_step, lambda th: th[0],
                              lambda th, m: m[0], nsteps=4,
                              observe=lambda th, x, t, obs: (x,),
                              series=np.zeros((5,), np.float32)),
        lambda: kt.make_streaming_scan_cost(
            AR1_STEP, AR1_INIT, lambda th, m: m[0], nsteps=4,
            observe=lambda th, x, t, obs: (x,),
            series=np.zeros((5,), np.float32)))
    assert t == j
    # per-walker scalar leaves
    j, t = _messages(
        lambda: jax_scan_cost(_jax_ar1_step, lambda th: th[0],
                              lambda th, m: m[0], nsteps=4)(
            (jnp.ones((8, 2)), jnp.ones((8, 2))), jax.random.key(0)),
        lambda: kt.make_streaming_scan_cost(
            AR1_STEP, AR1_INIT, lambda th, m: m[0], nsteps=4)(
            (torch.ones(8, 2), torch.ones(8, 2)), as_generator(0, "cpu")))
    assert t == j
    # a per-program row count that no slab height divides
    j, t = _messages(
        lambda: jax_scan_cost(_jax_ar1_step, lambda th: th[0],
                              lambda th, m: m[0], nsteps=4, block=128,
                              walker_tiles=1, interpret=True, bits="stub")(
            (jnp.ones((128,)), jnp.ones((128,))), jax.random.key(0)),
        lambda: kt.make_streaming_scan_cost(
            AR1_STEP, AR1_INIT, lambda th, m: m[0], nsteps=4, block=128,
            walker_tiles=1, bits="stub")(
            (torch.ones(128), torch.ones(128)), as_generator(0, "cpu")))
    assert t == j and "view-rows" in t
    # observe must return a tuple: JAX names the abstract value's type,
    # the port the traced value's, after the same words
    j, t = _messages(
        lambda: jax_scan_cost(_jax_ar1_step, lambda th: th[0],
                              lambda th, m: m, nsteps=4,
                              observe=lambda th, x, t, obs: x)(
            (jnp.ones((128,)), jnp.ones((128,))), jax.random.key(0)),
        lambda: kt.make_streaming_scan_cost(
            AR1_STEP, AR1_INIT, lambda th, m: m, nsteps=4,
            observe=lambda th, x, t, obs: x))
    prefix = "observe must return a tuple of 1..16 values, got "
    assert j.startswith(prefix) and t.startswith(prefix)


@pytest.mark.parametrize("step,op", [
    (lambda th, x, e, t: x + torch.sigmoid(e), "sigmoid"),
    (lambda th, x, e, t: x % 2.0 + e, "remainder"),
    (lambda th, x, e, t: x + e * t ** 2, "pow"),
    (lambda th, x, e, t: x + e * (t // 2), "floor_divide"),
])
def test_unsupported_op_raises_at_build(step, op):
    with pytest.raises(NotImplementedError, match=op):
        kt.make_streaming_scan_cost(step, lambda th: th[0],
                                    lambda th, m: m[0], nsteps=4)


def test_structure_and_work():
    cost = kt.make_streaming_scan_cost(SIR_STEP, SIR_INIT, SIR_REDUCE,
                                       observe=SIR_OBSERVE,
                                       series=SIR_SERIES, nsteps=100)
    g = cost.graphs
    assert g.structure == 2 and g.state_is_tuple and len(g.init) == 2
    u = cost.unit(2)
    for needle in ("#define KT_NPARAMS 2", "#define KT_NSTATE 2",
                   "#define KT_NSTATS 1", "#define KT_NSERIES 1",
                   '#include "scan.cuh"', "kt_imod(t, 2)", "obs[0]"):
        assert needle in u.source, needle
    nbytes, ops = cost.work(1000, 2)
    assert nbytes == 4 * 1000 * 3 + 4 * 100 + 8
    per_step = S.NOISE_OPS["normal"] + u.step_ops + u.observe_ops + 1
    assert ops == 1000 * (u.init_ops + 100 * per_step + 1)
    ar1 = kt.make_streaming_scan_cost(AR1_STEP, AR1_INIT, AR1_REDUCE,
                                      nsteps=1000)
    au = ar1.unit(2)
    assert (au.step_ops, au.observe_ops, au.nstats) == (5, 1, 2)
    with pytest.raises(ValueError):   # the model unpacks two leaves
        ar1((torch.ones(4),), as_generator(0, "cpu"))
    with pytest.raises(ValueError, match="different lengths"):
        ar1((torch.ones(4), torch.ones(5)), as_generator(0, "cpu"))
    # a tuple series reaches observe as a tuple
    two = kt.make_streaming_scan_cost(
        AR1_STEP, AR1_INIT, lambda th, m: m[0], nsteps=3,
        observe=lambda th, x, t, obs: (x - obs[0] * obs[1],),
        series=(np.ones(3, np.float32), np.arange(3, dtype=np.float32)))
    assert two.unit(2).nseries == 2 and "obs[1]" in two.unit(2).source
    assert two.means((torch.ones(8), torch.ones(8)), 1)[0].shape == (8,)


def test_scan_graphs_equal_callables_bitwise():
    """The recorded step and observe graphs, evaluated on tensors, are
    the SIR callables bit for bit, for even and odd t."""
    g = C.trace_scan(SIR_STEP, SIR_INIT, SIR_OBSERVE, 2,
                     S.Series(SIR_SERIES, 100))
    probed = C.probe_scan(SIR_STEP, SIR_INIT, SIR_OBSERVE,
                          S.Series(SIR_SERIES, 100))
    assert probed.structure == g.structure == 2
    assert len(probed.step) == len(g.step) == 2
    rng = np.random.default_rng(4)
    n = 4096
    th = [torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32))
          for lo, hi in ((0.05, 0.8), (0.02, 0.4))]
    x = [torch.from_numpy(rng.uniform(0, 1000, n).astype(np.float32))
         for _ in range(2)]
    e = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 100, n).astype(np.int32))
    obs = torch.from_numpy(rng.uniform(0, 500, n).astype(np.float32))
    env = {"theta": th, "xs": x, "noise": e, "t": t, "obs": [obs]}
    want = SIR_STEP(tuple(th), tuple(x), e, t)
    for graph, w in zip(g.step, want):
        assert torch.equal(C.evaluate(graph, env), w)
    (got,) = (C.evaluate(o, env) for o in g.observe)
    assert torch.equal(got, SIR_OBSERVE(tuple(th), tuple(x), t, obs)[0])


# ---------------------------------------------------------------------------
# the emitted scan functions, compiled as host C++
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

_RUNNER = r"""
extern "C" void run_scan(const float* th, const float* x, const float* e,
                         const int* t, const float* obs, float* x0,
                         float* xn, float* o, int n) {
  for (int i = 0; i < n; ++i) {
    float ti[KT_NPARAMS], xi[KT_NSTATE], x0i[KT_NSTATE], xni[KT_NSTATE];
    float ob[KT_NSERIES > 0 ? KT_NSERIES : 1], oi[KT_NSTATS];
    for (int k = 0; k < KT_NPARAMS; ++k) ti[k] = th[k * n + i];
    for (int k = 0; k < KT_NSTATE; ++k) xi[k] = x[k * n + i];
    for (int k = 0; k < KT_NSERIES; ++k) ob[k] = obs[k * n + i];
    scan_init(ti, x0i);
    scan_step(ti, xi, e[i], t[i], xni);
    scan_observe(ti, xi, t[i], ob, oi);
    for (int k = 0; k < KT_NSTATE; ++k) {
      x0[k * n + i] = x0i[k];
      xn[k * n + i] = xni[k];
    }
    for (int p = 0; p < KT_NSTATS; ++p) o[p * n + i] = oi[p];
  }
}
"""


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _flat(tensors):
    return torch.stack(list(tensors)).contiguous()


# Absolute difference allowed between the host build and PyTorch on the
# CPU. Only correctly rounded operations occur (+ - * /, sqrt, abs,
# comparisons, selects, min/max), so without contraction the bits agree,
# except that SIR divides by the constant 1000: the emitted code
# multiplies by its float32 reciprocal, as PyTorch does on CUDA, where
# the CPU divides. The flows differ by an ulp and the states (up to 1000
# here) by a few ulps of 1000 after the subtractions: 4 ulps of 1000.
HOST_ATOL = {"ar1": 0.0, "sir": 4 * float(np.spacing(np.float32(1000.0))),
             "two-leaf-state": 0.0}


@pytest.mark.parametrize("name", list(HOST_ATOL))
def test_emitted_scan_functions_match_torch_on_host(tmp_path, name):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the emitted code")
    step, init, observe, series, k = {
        "ar1": (AR1_STEP, AR1_INIT, None, None, 2),
        "sir": (SIR_STEP, SIR_INIT, SIR_OBSERVE, SIR_SERIES, 2),
        "two-leaf-state": _two_leaf_models(torch) + (None, 1),
    }[name]
    cost = kt.make_streaming_scan_cost(step, init, lambda th, m: m[0],
                                       observe=observe, series=series,
                                       nsteps=100)
    structure = cost.graphs.structure
    unit = cost.unit(structure)
    src = tmp_path / "scan.cpp"
    defines = "".join(line + "\n" for line in unit.source.splitlines()
                      if line.startswith("#define"))
    src.write_text(_PRELUDE + defines + unit.functions + _RUNNER)
    lib_path = tmp_path / "scan.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    n = 4096
    rng = np.random.default_rng(9)
    th = [torch.from_numpy(rng.uniform(0.05, 2.0, n).astype(np.float32))
          for _ in range(k)]
    x = [torch.from_numpy(rng.uniform(0, 1000, n).astype(np.float32))
         for _ in range(unit.nstate)]
    e = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 100, n).astype(np.int32))
    obs = torch.from_numpy(rng.uniform(0, 500, n).astype(np.float32))
    x0 = torch.empty(unit.nstate * n)
    xn = torch.empty(unit.nstate * n)
    o = torch.empty(unit.nstats * n)
    flat_th, flat_x = _flat(th), _flat(x)
    lib.run_scan(_ptr(flat_th), _ptr(flat_x), _ptr(e), _ptr(t), _ptr(obs),
                 _ptr(x0), _ptr(xn), _ptr(o), n)
    theta = th[0] if structure is None else tuple(th)
    state = tuple(x) if cost.graphs.state_is_tuple else x[0]
    leaves = S._state_leaves

    def full(v):
        return S._f32(v, th[0])

    want_x0 = [full(v) for v in leaves(init(theta))]
    want_xn = [full(v) for v in leaves(step(theta, state, e, t))]
    want_o = [full(v) for v in cost.observe(theta, state, t, obs)]
    for got, want in ((x0, want_x0), (xn, want_xn), (o, want_o)):
        got, want = got.view(-1, n), torch.stack(want)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.allclose(got, want, rtol=0.0, atol=HOST_ATOL[name],
                              equal_nan=True)
