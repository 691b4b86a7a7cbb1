"""kissabc_tpu_torch's fused tempered sweep (``ops/fused_tempered.py``,
kernel #9): its plain version held on the CPU against the JAX Pallas
kernel ``make_fused_tempered_sweep`` in interpret mode on the stub bit
stream, given the JAX sweep's own partner shifts and seeds; the sweep's
contract and messages; tsmc through it on the conjugate-normal oracle,
a bounded prior and a mixed discrete prior (the cases of
``tests/test_pallas.py::TestFusedTemperedSweep``); and the emitted
``loglike`` compiled as host C++ against torch. The CUDA kernel is held
against the plain version on the card by chip_smoke.py.

Tolerance: the JAX golden tolerance (rtol 2e-4, atol 2e-5,
tests/test_pallas.py:104) on committed values; uncommitted walkers keep
their inputs bit for bit. The commit masks agree, except where the
tempered MH log-ratio lies within 1e-4 of the accept draw (XLA's CPU
``exp``/``log`` and PyTorch's differ by an ulp). The tsmc runs keep the
tolerances of the JAX tests they mirror.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

import kissabc_tpu as ka
from kissabc_tpu.ops import pallas_kernels as JP
import kissabc_tpu_torch as kt
from kissabc_tpu_torch import convert
from kissabc_tpu_torch.ops import codegen as C
from kissabc_tpu_torch.ops import fused_ais as FA
from kissabc_tpu_torch.ops import fused_tempered as FT

RTOL, ATOL = 2e-4, 2e-5
BORDER = 1e-4
Y = np.array([1.2, 0.8, 1.5, 0.9, 1.1, 1.3, 0.7, 1.0], np.float32)
K = len(Y)
CONST = np.float32(K / 2 * np.log(2 * np.pi))
KW = dict(block=128, walker_tiles=2, bits="stub")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(lib):
    """(prior, elementwise loglike) per case, in ``jnp`` or ``torch``:
    the conjugate normal of tests/test_tsmc.py, the bounded Uniform prior
    (and a variant whose loglike is -inf on part of the support, for the
    lam = 0 and -inf edges), and the mixed discrete prior of
    tests/test_pallas.py:1262-1295."""
    if lib is torch:
        dist, where = kt, torch.where
    else:
        dist, where = ka, jnp.where

    def conj(theta):
        s = 0.0
        for y in Y:
            s = s + lib.square(np.float32(y) - theta)
        return -0.5 * s - CONST

    def bounded(theta):
        s = 0.0
        for y in Y:
            s = s + lib.square(np.float32(y) - theta)
        return -0.5 * s

    def cut(theta):
        return where(theta > 1.0, bounded(theta), -np.inf)

    def mixed(theta):
        a, k = theta
        return (-0.5 * lib.square(a - np.float32(1.2))
                - 0.5 * lib.square(k - np.float32(3.0)))

    return {
        "conjugate": (dist.Normal(0, 1), conj),
        "bounded": (dist.Uniform(0.5, 1.5), bounded),
        "bounded-cut": (dist.Uniform(0.5, 1.5), cut),
        "mixed-discrete": (dist.Factored(dist.Normal(1.0, 1.0),
                                         dist.DiscreteUniform(1, 6)), mixed),
        # a Dirac marginal: pushed to its atom 2.5 in the kernel
        "dirac": (dist.Factored(dist.Normal(1.0, 1.0), dist.Dirac(2.5)),
                  mixed),
    }


def _start(case, n, rng):
    if case == "conjugate":
        return rng.normal(0, 1, n).astype(np.float32)
    if case.startswith("bounded"):
        return rng.uniform(0.5, 1.5, n).astype(np.float32)
    if case == "dirac":
        return (rng.normal(1, 1, n).astype(np.float32),
                rng.uniform(2.0, 3.0, n).astype(np.float32))
    return (rng.normal(1, 1, n).astype(np.float32),
            (rng.integers(1, 7, n) + rng.uniform(-0.4, 0.4, n))
            .astype(np.float32))


def _leaves(th):
    return list(th) if isinstance(th, tuple) else [th]


@pytest.mark.parametrize("h", [256, 300])
@pytest.mark.parametrize("case", ["conjugate", "bounded", "bounded-cut",
                                  "mixed-discrete", "dirac"])
def test_half_updates_match_the_pallas_kernel(case, h):
    """JAX ``make_fused_tempered_sweep`` (interpret, stub) on a key
    against the port's half-updates given the shifts and seeds that key
    gives (``_rot_shifts6`` and the split chain of
    pallas_kernels.py:1801-1832), at lam 0, 0.3, 0.7 and 1: half A
    against the old half B, half B against the port's half A. h = 300
    leaves a tail of 44 walkers in the last 128-row of a stub tile."""
    n = 2 * h
    jprior, jll = _models(jnp)[case]
    pprior, pll = _models(torch)[case]
    rng = np.random.default_rng(5)
    th = _start(case, n, rng)
    jth = tuple(map(jnp.asarray, th)) if isinstance(th, tuple) \
        else jnp.asarray(th)
    lp = np.asarray(jprior.logpdf_tree(jprior.push_tree(jth)), np.float32)
    ll = np.asarray(jll(jprior.push_tree(jth)), np.float32).copy()
    if case == "bounded-cut":   # old walkers at -inf too
        ll[::7] = -np.inf
    jsw = jax.jit(ka.make_fused_tempered_sweep(jprior, jll, interpret=True,
                                               **KW))
    psw = kt.make_fused_tempered_sweep(pprior, pll, **KW)

    def halves(x):
        return ((tuple(a[:h] for a in x), tuple(a[h:] for a in x))
                if isinstance(x, tuple) else (x[:h], x[h:]))

    def draws(k):
        kp, ks = jax.random.split(k)
        return (torch.tensor([int(x) for x in JP._rot_shifts6(kp, h)]),
                int(jax.random.bits(ks, (), jnp.uint32)))

    key = jax.random.key(9)
    (sa, seeda), (sb, seedb) = map(draws, jax.random.split(key))
    (tha, thb), ((lpa, lla), (lpb, llb)) = convert.ais_state_from_numpy(
        th, (lp, ll), halves=True)
    inputs = _leaves(th) + [lp, ll]
    commits = 0
    for lam in (0.0, 0.3, 0.7, 1.0):
        jout = jsw(key, halves(jth), ((jnp.asarray(lp[:h]),
                                       jnp.asarray(ll[:h])),
                                      (jnp.asarray(lp[h:]),
                                       jnp.asarray(ll[h:]))),
                   jnp.float32(lam))
        want = [np.concatenate([np.asarray(a), np.asarray(b)])
                for a, b in zip(_leaves(jout[0][0]), _leaves(jout[0][1]))]
        want += [np.concatenate([np.asarray(jout[1][0][j]),
                                 np.asarray(jout[1][1][j])]) for j in (0, 1)]
        a = psw.half_plain(_leaves(tha), lpa, lla, _leaves(thb), sa, seeda,
                           lam, terms=True)
        b = psw.half_plain(_leaves(thb), lpb, llb, a[0], sb, seedb, lam,
                           terms=True)
        got = [torch.cat([x, y]).numpy() for x, y in zip(a[0], b[0])] + [
            torch.cat([a[1], b[1]]).numpy(), torch.cat([a[2], b[2]]).numpy()]
        border = np.concatenate([t[3][1].abs().numpy() < BORDER
                                 for t in (a, b)])
        commits += _same(got, want, inputs, allowed=border)
        moved = np.any([g != x for g, x in zip(got, inputs)], axis=0)
        if case == "bounded-cut":
            old_inf = ll == -np.inf
            if lam == 0.0:
                # 0 * -inf is NaN: a proposal whose loglike is -inf never
                # commits, nor does a walker at -inf
                assert np.isfinite(got[-1][moved]).all()
                assert not (moved & old_inf).any()
            else:   # a walker at -inf takes any valid finite proposal
                assert (moved & old_inf).any()
        if case.startswith("bounded"):   # nothing outside the support
            assert ((got[0] >= 0.5) & (got[0] <= 1.5)).all()
            assert np.isfinite(got[-2]).all()
    assert commits > 0


def _same(got, want, inputs, allowed=None):
    """Committed values within the golden tolerance, the commit masks
    equal (or differing only where ``allowed``), uncommitted walkers
    untouched on both sides (NaN-free, -inf equal to -inf). Returns the
    number of commits."""
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]

    def committed(outs):
        return np.any([o != x for o, x in zip(outs, inputs)], axis=0)

    gc, wc = committed(got), committed(want)
    differ = gc != wc
    ok = ~differ if allowed is None else (~differ | allowed)
    assert ok.all(), f"commit masks differ on {int((~ok).sum())} walkers"
    both = gc & wc
    for g, w, x in zip(got, want, inputs):
        np.testing.assert_allclose(g[both], w[both], rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(g[~gc], x[~gc])
        np.testing.assert_array_equal(w[~wc], x[~wc])
    return int(both.sum())


# ---------------------------------------------------------------------------
# the sweep's contract and messages (TestFusedTemperedSweep)
# ---------------------------------------------------------------------------

def _conj_state(n, seed):
    prior, ll_elem = _models(torch)["conjugate"]
    g = torch.Generator().manual_seed(seed)
    th = torch.randn(n, generator=g)
    lp, ll = prior.logpdf(th), ll_elem(th)
    h = n // 2
    return prior, ll_elem, ((th[:h], th[h:]), ((lp[:h], ll[:h]),
                                               (lp[h:], ll[h:])))


def test_validation_messages():
    prior, ll_elem = _models(torch)["conjugate"]
    with pytest.raises(ValueError, match="multiple of 128"):
        kt.make_fused_tempered_sweep(prior, ll_elem, block=100)
    with pytest.raises(ValueError, match="bits"):
        kt.make_fused_tempered_sweep(prior, ll_elem, bits="tpu")
    with pytest.raises(TypeError, match="Mesh"):
        kt.make_fused_tempered_sweep(prior, ll_elem, mesh=object())
    with pytest.raises(NotImplementedError, match="not supported"):
        kt.make_fused_tempered_sweep(prior, lambda th: torch.erf(th))
    sweep = kt.make_fused_tempered_sweep(prior, ll_elem, **KW)
    th = torch.randn(128, generator=torch.Generator().manual_seed(0))
    lp, ll = -0.5 * th * th, ll_elem(th)
    gen = torch.Generator()
    with pytest.raises(ValueError, match="at least 6"):
        sweep(gen, (th[:2], th[2:4]), ((lp[:2], ll[:2]), (lp[2:4], ll[2:4])),
              0.5)
    with pytest.raises(ValueError, match="leaves"):
        sweep(gen, ((th[:64], th[:64]), (th[64:], th[64:])),
              ((lp[:64], ll[:64]), (lp[64:], ll[64:])), 0.5)
    assert sweep.mesh is None
    with pytest.raises(ValueError, match="equal red/black halves"):
        sweep.half([th[:64]], lp[:64], ll[:64], [th[64:127]], [1] * 6, 0,
                   0.5)
    with pytest.raises(ValueError, match="unsupported device"):
        sweep.half([th[:64].to("meta")], lp[:64], ll[:64], [th[64:]],
                   [1] * 6, 0, 0.5)


def test_sweep_is_two_half_updates_with_words_from_the_generator():
    """Each half draws seven words from ``gen`` in one draw (six shift
    words, then the seed) and runs ``half_words`` on them, which is
    ``half`` on the shifts ``rot_shifts6`` makes of the first six; half B
    proposes against the updated half A; the inputs are not written."""
    prior, ll_elem, (th, ld) = _conj_state(512, 1)
    sweep = kt.make_fused_tempered_sweep(prior, ll_elem, **KW)
    keep = [x.clone() for x in (th[0], th[1], ld[0][0], ld[0][1])]
    (ta, tb), ((lpa, lla), (lpb, llb)) = sweep(
        torch.Generator().manual_seed(3), th, ld, 0.7)
    assert all(torch.equal(a, b) for a, b in zip(
        keep, (th[0], th[1], ld[0][0], ld[0][1])))
    g = torch.Generator().manual_seed(3)
    wa, wb = sweep._draws(g), sweep._draws(g)
    assert wa.shape == wb.shape == (7,)
    a = sweep.half_words([th[0]], *ld[0], [th[1]], wa, 0.7)
    b = sweep.half_words([th[1]], *ld[1], a[0], wb, 0.7)
    for got, want in zip((ta, lpa, lla, tb, lpb, llb),
                         (a[0][0], a[1], a[2], b[0][0], b[1], b[2])):
        assert torch.equal(got, want)
    a2 = sweep.half([th[0]], *ld[0], [th[1]], FA.rot_shifts6(wa[:6], 256),
                    wa[6:], 0.7)
    for got, want in zip((ta, lpa, lla), (a2[0][0], a2[1], a2[2])):
        assert torch.equal(got, want)


def test_sweep_hands_the_kernel_words_on_the_walkers_device(monkeypatch):
    """On the kernel's path a sweep is two draws of seven words from
    ``gen`` (which may live on another device than the walkers), half A's
    first, and one launch a half given them on the walkers' device, with
    no ``rot_shifts6`` on the way; ``half_words`` is one launch. The
    walkers' device is reported as ``meta`` here, and the launches record
    what they are given."""
    prior, ll_elem, (th, ld) = _conj_state(256, 2)
    sweep = kt.make_fused_tempered_sweep(prior, ll_elem, **KW)
    meta = torch.device("meta")
    seen = []
    monkeypatch.setattr(sweep, "_checked", lambda upd, comp, lp, ll: (
        [x.to(meta) for x in upd], [x.to(meta) for x in comp], lp.to(meta),
        ll.to(meta), meta))
    monkeypatch.setattr(FT, "rot_shifts6", lambda *a: pytest.fail(
        "rot_shifts6 on the kernel's path: the kernel derives the shifts"))
    monkeypatch.setattr(sweep, "launch", lambda upd, lp, ll, comp, words,
                        lam, outs: seen.append((words.device, words.shape,
                                                lam.shape)))
    g = torch.Generator().manual_seed(5)
    th_m = tuple(x.to(meta) for x in th)
    ld_m = tuple(tuple(x.to(meta) for x in half) for half in ld)
    sweep(g, th_m, ld_m, 0.5)
    assert seen == [(meta, (7,), (1,))] * 2
    sweep.half_words([th_m[0]], *ld_m[0], [th_m[1]], sweep._draws(g), 0.5)
    assert seen[2:] == [(meta, (7,), (1,))]


def test_determinism_and_movement():
    """The same generator state gives bit-identical halves; walkers move;
    the carried lp and ll equal the recomputed values of the committed
    walkers (raw, unscaled)."""
    prior, ll_elem, (th, ld) = _conj_state(256, 3)
    sweep = kt.make_fused_tempered_sweep(prior, ll_elem, **KW)
    (ta1, tb1), ((lpa1, lla1), _) = sweep(torch.Generator().manual_seed(3),
                                          th, ld, 0.7)
    (ta2, _), _ = sweep(torch.Generator().manual_seed(3), th, ld, 0.7)
    assert torch.equal(ta1, ta2)
    moved = (ta1 != th[0]).float().mean()
    assert 0.05 < moved <= 1.0
    np.testing.assert_allclose(lla1.numpy(), ll_elem(ta1).numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lpa1.numpy(), prior.logpdf(ta1).numpy(),
                               rtol=2e-5, atol=2e-5)


def _truth():
    cov = np.eye(K) + np.ones((K, K))
    return (Y.sum() / (K + 1), 1.0 / np.sqrt(K + 1),
            st.multivariate_normal(np.zeros(K), cov).logpdf(Y))


def test_tsmc_conjugate_through_the_fused_sweep():
    """tsmc with the fused sweep (plain version, stub bits) hits the
    conjugate-normal posterior and evidence (the tolerances of
    tests/test_pallas.py:1167-1171)."""
    prior, ll_elem = _models(torch)["conjugate"]
    sweep = kt.make_fused_tempered_sweep(prior, ll_elem, **KW)
    yt = torch.from_numpy(Y)

    def ll(theta):
        return -0.5 * torch.sum((yt - theta) ** 2) - K / 2 * np.log(2 * np.pi)

    res = kt.tsmc(prior, ll, nparticles=2048, mcmc_steps=5,
                  sweep_fused=sweep, key=1, device="cpu")
    m, sd, logz = _truth()
    assert res.lam == 1.0
    assert abs(res.P.mean() - m) < 0.03
    assert abs(res.P.std() - sd) < 0.03
    assert abs(res.log_evidence - logz) < 0.2


def test_bounded_prior_invalid_proposals_rejected():
    """Proposals outside a Uniform prior's support never commit: after
    five sweeps every walker is in the support with a finite lp."""
    prior, ll_elem = _models(torch)["bounded"]
    sweep = kt.make_fused_tempered_sweep(prior, ll_elem, **KW)
    g = torch.Generator().manual_seed(5)
    n, h = 256, 128
    th = torch.rand(n, generator=g) + 0.5
    lp, ll = prior.logpdf(th), ll_elem(th)
    state = ((th[:h], th[h:]), ((lp[:h], ll[:h]), (lp[h:], ll[h:])))
    for _ in range(5):
        state = sweep(g, state[0], state[1], 0.3)
    for half, (lph, _) in zip(state[0], state[1]):
        assert bool(((half >= 0.5) & (half <= 1.5)).all())
        assert bool(torch.isfinite(lph).all())


def test_mixed_discrete_prior_push_in_kernel():
    """Factored(continuous, discrete): the push rounds the discrete
    marginal before the prior and the loglike see it, the committed
    walker keeps the float shadow, and tsmc's pushed output is
    integral."""
    prior, ll_elem = _models(torch)["mixed-discrete"]
    sweep = kt.make_fused_tempered_sweep(prior, ll_elem, **KW)

    def ll(theta):
        a, k = theta
        return -0.5 * torch.square(a - 1.2) - 0.5 * torch.square(k - 3.0)

    res = kt.tsmc(prior, ll, nparticles=1024, mcmc_steps=4,
                  sweep_fused=sweep, key=4, device="cpu")
    a_post, k_post = res.P
    kv = np.asarray(k_post.particles, np.float64)
    assert np.allclose(kv, np.round(kv)), kv[:8]
    assert 1.0 <= kv.min() and kv.max() <= 6.0
    assert abs(a_post.mean() - 1.1) < 0.15


# ---------------------------------------------------------------------------
# the emitted log-likelihood
# ---------------------------------------------------------------------------

def test_generated_tempered_unit():
    prior, ll_elem = _models(torch)["mixed-discrete"]
    unit = C.generate_tempered(ll_elem, prior)
    for needle in ("#define KT_NPARAMS 2", "float loglike(const float* th)",
                   "void prior_push(", "rintf(th[1])",
                   '#include "tempered.cuh"'):
        assert needle in unit.source
    assert unit.loglike_ops == 7 and unit.push_ops == 1
    prior, ll_elem = _models(torch)["conjugate"]
    conj = C.generate_tempered(ll_elem, prior)
    assert conj.nparams == 1 and conj.loglike_ops == 3 * K + 2


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
extern "C" void run(const float* th, float* out, int n) {
  for (int i = 0; i < n; ++i) {
    float t[K], p[K];
    for (int k = 0; k < K; ++k) t[k] = th[k * n + i];
    prior_push(t, p);
    out[i] = loglike(p);
    out[n + i] = prior_logpdf(p);
  }
}
"""


@pytest.mark.parametrize("case", ["conjugate", "bounded-cut",
                                  "mixed-discrete"])
def test_emitted_loglike_matches_torch_on_host(tmp_path, case):
    """The emitted ``loglike`` and ``prior_logpdf`` of the pushed value,
    compiled as host C++ without FMA contraction, equal torch's on the
    same points bit for bit (sums, products and squares only: no
    transcendental of two libraries)."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the emitted code")
    prior, ll_elem = _models(torch)[case]
    unit = C.generate_tempered(ll_elem, prior)
    src = tmp_path / "unit.cpp"
    src.write_text(_PRELUDE + unit.functions + f"#define K {unit.nparams}\n"
                   + _RUNNER)
    lib_path = tmp_path / "unit.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    n = 2048
    th = _start(case, n, np.random.default_rng(11))
    leaves = [torch.from_numpy(x) for x in _leaves(th)]
    flat = torch.cat(leaves).contiguous()
    out = torch.empty(2 * n)
    lib.run(ctypes.c_void_p(flat.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            n)
    pushed = FT.FusedTemperedSweep(prior, ll_elem, a_stretch=3.0,
                                   **KW).pushed(leaves)
    assert torch.equal(out[:n], ll_elem(pushed))
    assert torch.equal(out[n:], prior.logpdf_tree(pushed))
