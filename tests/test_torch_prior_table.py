"""The generic kernels' prior table (``ops/codegen.py``
``_marginal_logpdf``, ``emit_prior``): each family's entry, the
``prior_logpdf`` (and ``prior_push``) that kernels #3, #6, #9 and #10
compile, built as host C++ with ``g++`` against ``tests/host_cuda/``
(``common.cuh`` for ``kt_i0e``) and held against the family's torch
``logpdf`` (of the pushed value) on a grid that crosses the support's
edges:

- the same cells are finite on both sides, and -inf equals -inf;
- the finite values within each family's stated ulps of max(1, |value|)
  (``ULPS``; for a pmf summing ``lgamma`` terms, ulps of its largest
  term). The entry repeats the torch formula op for op, but divides by a
  constant as the card does (a multiply by the float32 reciprocal, up to
  an ulp from the CPU's division) and calls glibc's ``logf``/``powf``/
  ``lgammaf`` where PyTorch's CPU kernels call their own vectorized ones;
  the measured maxima are in ``ULPS``' comments;
- ``prior_push`` rounds the discrete marginals half to even.

Then the four fused sweeps build on a prior of each group and their plain
versions run on the CPU, and the families still without an entry raise
``NotImplementedError`` naming themselves.
"""

import numpy as np
import pytest
import torch
from scipy import special as sps

import kissabc_tpu_torch as kt
from host_cuda.build import build_program
from kissabc_tpu_torch.ops import codegen as C
from kissabc_tpu_torch.ops import fused_abcde as FD
from kissabc_tpu_torch.ops import fused_ais as FA
from kissabc_tpu_torch.ops import fused_smc as F
from kissabc_tpu_torch.ops import fused_tempered as FT

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# name: (family, grid lo, hi)
ENTRIES = {
    "Exponential": (kt.Exponential(1.5), -1, 10),
    "Gamma": (kt.Gamma(2.5, 1.5), -1, 15),
    "LogUniform": (kt.LogUniform(0.1, 10.0), 0.05, 11),
    "BetaPrime": (kt.BetaPrime(3.0, 5.0), -0.5, 6),
    "StudentT": (kt.StudentT(4.0), -8, 8),
    "Beta": (kt.Beta(2.0, 5.0), -0.2, 1.2),
    "LogNormal": (kt.LogNormal(-3.0, 1.0), -0.1, 1.0),
    "Laplace": (kt.Laplace(1.0, 2.0), -8, 10),
    "Cauchy": (kt.Cauchy(0.5, 1.5), -20, 20),
    "Weibull": (kt.Weibull(1.5, 2.0), -0.5, 8),
    "Chisq": (kt.Chisq(4.0), -1, 20),
    "FDist": (kt.FDist(8.0, 12.0), -0.5, 6),
    "Logistic": (kt.Logistic(0.5, 1.2), -10, 10),
    "Rayleigh": (kt.Rayleigh(2.0), -1, 10),
    "Pareto": (kt.Pareto(3.0, 2.0), 1, 12),
    "InverseGamma": (kt.InverseGamma(3.0, 2.0), -0.2, 5),
    "Gumbel": (kt.Gumbel(0.5, 2.0), -6, 14),
    "TriangularDist": (kt.TriangularDist(0.0, 4.0, 1.0), -1, 5),
    "TriangularDist-left": (kt.TriangularDist(0.0, 2.0, 0.0), -0.5, 2.5),
    "Arcsine": (kt.Arcsine(1.0, 3.0), 0.5, 3.5),
    "Semicircle": (kt.Semicircle(2.0), -2.5, 2.5),
    "Frechet": (kt.Frechet(5.0, 2.0), -0.5, 8),
    "Levy": (kt.Levy(0.5, 1.5), 0, 20),
    "GeneralizedPareto": (kt.GeneralizedPareto(0.5, 1.5, 0.2), 0, 12),
    "GeneralizedPareto-neg": (kt.GeneralizedPareto(0.0, 1.0, -0.25),
                              -0.5, 4.5),
    "Kumaraswamy": (kt.Kumaraswamy(2.0, 3.0), -0.1, 1.1),
    "VonMises": (kt.VonMises(0.5, 2.0), -3, 4),
    "SymTriangularDist": (kt.SymTriangularDist(1.0, 2.0), -1.5, 3.5),
    "Cosine": (kt.Cosine(1.0, 2.0), -1.5, 3.5),
    "Epanechnikov": (kt.Epanechnikov(1.0, 2.0), -1.5, 3.5),
    "Biweight": (kt.Biweight(-0.5, 1.5), -2.5, 1.5),
    "Triweight": (kt.Triweight(0.0, 2.0), -2.5, 2.5),
    "JohnsonSU": (kt.JohnsonSU(0.5, 2.0, 0.3, 1.5), -10, 10),
    "GeneralizedExtremeValue": (kt.GeneralizedExtremeValue(0.5, 1.5, 0.2),
                                -8, 12),
    "GeneralizedExtremeValue-0": (kt.GeneralizedExtremeValue(0.0, 1.0, 0.0),
                                  -4, 8),
    "InverseGaussian": (kt.InverseGaussian(2.0, 3.0), -0.5, 10),
    "Chi": (kt.Chi(3.0), -0.5, 5),
    "PGeneralizedGaussian": (kt.PGeneralizedGaussian(0.5, 1.5, 3.0), -3, 4),
    "Rician": (kt.Rician(2.0, 1.5), -0.5, 9),
    "Rician-far": (kt.Rician(6.0, 0.5), 3, 9),
    "Lindley": (kt.Lindley(0.7), -0.5, 15),
    "LogitNormal": (kt.LogitNormal(0.4, 0.9), -0.1, 1.1),
    "Erlang": (kt.Erlang(3, 2.0), -1, 20),
    "NormalCanon": (kt.NormalCanon(2.0, 4.0), -2, 3),
    "Truncated-Gamma": (kt.Truncated(kt.Gamma(2.0, 1.5), 1.0, 4.0), 0, 5),
    "Truncated-StudentT": (kt.Truncated(kt.StudentT(4.0), -1.0, 3.0), -2, 4),
    "Affine-Exponential": (2.0 - 3.0 * kt.Exponential(1.0), -10, 3),
    "Affine-Beta": (1.0 + 2.0 * kt.Beta(2.0, 2.0), 0.5, 3.5),
    "Affine-Normal": (0.5 * kt.Normal(1.0, 2.0) + 1.0, -6, 8),
    "Mixture": (kt.Mixture([kt.Normal(0.0, 0.5), kt.Normal(5.0, 0.5)],
                           [0.3, 0.7]), -3, 8),
    "Mixture-3": (kt.Mixture([kt.Gamma(2.0, 1.0), kt.LogNormal(0.0, 0.5),
                              kt.Uniform(0.0, 3.0)], [0.2, 0.5, 0.3]),
                  -0.5, 8),
    # the integer discrete families: the entry reads the pushed value
    "Poisson": (kt.Poisson(6.0), -2.6, 30.6),
    "Bernoulli": (kt.Bernoulli(0.3), -1.6, 2.6),
    "Binomial": (kt.Binomial(10, 0.4), -2.6, 12.6),
    "Geometric": (kt.Geometric(0.3), -2.6, 40.6),
    "NegativeBinomial": (kt.NegativeBinomial(4.0, 0.3), -2.6, 60.6),
    "BetaBinomial": (kt.BetaBinomial(10, 2.0, 3.0), -2.6, 12.6),
    "Hypergeometric": (kt.Hypergeometric(7, 5, 6), -1.6, 8.6),
    "Hypergeometric-big": (kt.Hypergeometric(30, 20, 12), -1.6, 14.6),
    "Mixture-Poisson": (kt.Mixture([kt.Poisson(2.0), kt.Poisson(9.0)]),
                        -1.6, 20.6),
    "Socks-NegativeBinomial": (kt.NegativeBinomial(
        -900.0 / (30.0 - 225.0), (-900.0 / (30.0 - 225.0))
        / (30.0 + -900.0 / (30.0 - 225.0))), -2.6, 120.6),
}

# the ulps each entry is held to: 16 for every family, as the codegen's
# other host tests, on max(1, |value|), for a pmf of lgamma terms on its
# largest term, and for the smoothing kernels, GEV and GPD on their
# conditioning at the support's edges (``_scale``)
ULPS = 16
_LGAMMA_SHIFT = {"Poisson": 1.0, "Binomial": 11.0, "BetaBinomial": 13.0,
                 "NegativeBinomial": 4.0, "Socks-NegativeBinomial": 5.7,
                 "Hypergeometric": 8.0, "Hypergeometric-big": 31.0,
                 "Mixture-Poisson": 1.0}
NAMES = sorted(ENTRIES)
_EDGE_CONDITIONED = (kt.Epanechnikov, kt.Biweight, kt.Triweight,
                     kt.SymTriangularDist, kt.Cosine,
                     kt.GeneralizedExtremeValue, kt.GeneralizedPareto)


def _scale(name, x):
    x = np.asarray(x, np.float64)
    scale = np.ones_like(x)
    if name in _LGAMMA_SHIFT:
        scale = np.maximum(scale, np.abs(sps.gammaln(
            np.abs(np.round(x)) + _LGAMMA_SHIFT[name])))
    # z = (x - mu) / sigma is a multiply by the reciprocal in the entry
    # and a division in PyTorch on the CPU (an ulp apart): near a support
    # edge where the logpdf's slope is steep (the smoothing kernels, GEV
    # and GPD below their edges) that ulp is magnified by the formula's
    # conditioning |(x - mu) logpdf'(x)|, taken in float64 by autograd
    d = ENTRIES[name][0]
    if isinstance(d, _EDGE_CONDITIONED):
        xx = torch.tensor(x, dtype=torch.float64, requires_grad=True)
        lp = d.logpdf(xx)
        (grad,) = torch.autograd.grad(lp.sum(), xx)
        cond = np.abs((x - float(d.mu)) * grad.detach().numpy())
        scale = np.maximum(scale, np.nan_to_num(cond, posinf=0.0))
    return scale


_MAIN = r"""
#include "common.cuh"
namespace {
%s
}  // namespace
extern "C" void run(int which, const float* th, float* lp, float* pushed,
                    int n) {
  for (int i = 0; i < n; ++i) {
    float t[1] = {th[i]}, p[1];
    switch (which) {
%s
    }
    pushed[i] = p[0];
  }
}
"""


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """One host library of every entry's ``prior_logpdf_<j>`` and
    ``prior_push_<j>``."""
    import ctypes
    fns, cases = [], []
    for j, name in enumerate(NAMES):
        text, _, _ = C.emit_prior(ENTRIES[name][0])
        fns.append(text.replace("prior_logpdf(", f"prior_logpdf_{j}(")
                   .replace("prior_push(", f"prior_push_{j}("))
        cases.append(f"      case {j}: prior_push_{j}(t, p); "
                     f"lp[i] = prior_logpdf_{j}(p); break;")
    root = tmp_path_factory.mktemp("prior_table")
    (root / "prior_table_main.cpp").write_text(
        _MAIN % ("\n".join(fns), "\n".join(cases)))
    lib = ctypes.CDLL(str(build_program(root, None, "prior_table_main.cpp",
                                        shared=True)))
    lib.run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int]
    return lib


def _grid(name, n=1201):
    _, lo, hi = ENTRIES[name]
    x = np.linspace(lo, hi, n).astype(np.float32)
    return torch.from_numpy(x)


def _run(lib, name, x):
    lp, pushed = torch.empty_like(x), torch.empty_like(x)
    lib.run(NAMES.index(name), x.data_ptr(), lp.data_ptr(),
            pushed.data_ptr(), x.numel())
    return lp, pushed


@pytest.mark.parametrize("name", NAMES)
def test_entry_matches_torch_logpdf_on_host(library, name):
    d = ENTRIES[name][0]
    x = _grid(name)
    got, pushed = _run(library, name, x)
    want_push = d.push(x)
    assert torch.equal(pushed, want_push.to(torch.float32))
    want = d.logpdf(want_push).to(torch.float32)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[~fin], want[~fin])
    assert 0 < int(fin.sum()), name   # a grid inside the support
    if name not in ("Cauchy", "JohnsonSU", "Logistic", "Laplace",
                    "StudentT", "Gumbel", "Mixture", "Affine-Normal",
                    "GeneralizedExtremeValue-0", "NormalCanon",
                    "PGeneralizedGaussian", "Rician-far"):
        assert int(fin.sum()) < x.numel(), name   # and across its edge
    g = got[fin].double().numpy()
    w = want[fin].double().numpy()
    tol = ULPS * EPS32 * np.maximum(_scale(name, pushed[fin].numpy()),
                                    np.abs(w))
    assert (np.abs(g - w) <= tol).all(), (name, (np.abs(g - w) / tol).max())


@pytest.mark.parametrize("name", ["Poisson", "Binomial", "Hypergeometric",
                                  "Mixture-Poisson"])
def test_push_rounds_half_to_even(library, name):
    x = torch.tensor([0.5, 1.5, 2.5, 3.49, 3.51, -0.5, 4.0])
    _, pushed = _run(library, name, x)
    assert pushed.tolist() == [0.0, 2.0, 2.0, 3.0, 4.0, -0.0, 4.0]


def test_entry_op_counts_and_helpers():
    """The operation counts feed the kernels' bounds; Rician calls
    ``kt_i0e`` (58 operations), a traced entry names its values by
    marginal, and the written entries keep their text."""
    _, ops, push_ops = C.emit_prior(kt.Factored(kt.Rician(2.0, 1.5),
                                                kt.Uniform(0.0, 1.0)))
    assert ops > 58 and push_ops == 0
    text, ops, _ = C.emit_prior(kt.Factored(kt.Beta(2.0, 2.0),
                                            kt.LogNormal(-3.0, 1.0)))
    assert "p0_0" in text and "p1_0" in text and ops > 10
    text, ops, _ = C.emit_prior(kt.Factored(
        kt.Uniform(1.0, 3.0), kt.TruncatedNormal(0.0, 0.05, 0.0, 100.0)))
    assert ops == 3 + 6 + 4 + 1 and "p0_" not in text


def test_i0e_plain_counterpart_matches_kernel_helper(tmp_path):
    """``distributions.i0e`` (the plain version) and ``kt_i0e`` (the
    device helper, on the host) give the same float32 bits for |x| <= 8,
    and within two ulps above, where PyTorch's CPU ``sqrt`` is not
    correctly rounded (glibc's and the card's are)."""
    import ctypes
    main = r"""
#include "common.cuh"
extern "C" void run(const float* x, float* y, int n) {
  for (int i = 0; i < n; ++i) y[i] = kt_i0e(x[i]);
}
"""
    (tmp_path / "i0e_main.cpp").write_text(main)
    lib = ctypes.CDLL(str(build_program(tmp_path, None, "i0e_main.cpp",
                                        shared=True)))
    x = torch.cat([torch.linspace(-30.0, 30.0, 6001),
                   torch.tensor([0.0, 8.0, 8.000001, 7.999999, 1e-30])])
    y = torch.empty_like(x)
    lib.run(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
            x.numel())
    want = kt.distributions.i0e(x)
    inner = x.abs() <= 8.0
    assert torch.equal(y[inner], want[inner])
    spacing = torch.from_numpy(np.spacing(want[~inner].numpy()))
    assert ((y[~inner] - want[~inner]).abs() <= 2 * spacing).all()


# ---------------------------------------------------------------------------
# the four fused sweeps on a prior of each group, plain versions on the CPU
# ---------------------------------------------------------------------------

def _draw(th, eps):
    return th[0] + 0.1 * eps


def _reduce(th, m):
    return torch.abs(m[0] - 1.0)


def _loglike(th):
    return -0.5 * torch.square(th[0] - 1.0)


GROUPS = {   # a continuous group and a discrete one, each through every sweep
    "continuous": kt.Factored(kt.Beta(2.0, 2.0), kt.Rician(2.0, 1.5),
                              kt.Truncated(kt.Gamma(2.0, 1.0), 0.5, 6.0),
                              2.0 - 3.0 * kt.Exponential(1.0),
                              kt.Mixture([kt.Normal(0.0, 1.0),
                                          kt.Laplace(3.0, 1.0)])),
    "discrete": kt.Factored(kt.Normal(1.0, 1.0), kt.NegativeBinomial(4.0, 0.3),
                            kt.Hypergeometric(7, 5, 6), kt.Bernoulli(0.3)),
}


def _population(prior, n, seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return [x.to(torch.float32) for x in prior.sample_tree(g, n)]


@pytest.mark.parametrize("kind", ["smc", "ais", "tempered", "abcde"])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_sweeps_build_and_run_plain(kind, group):
    prior = GROUPS[group]
    n = 256
    th = _population(prior, n, 3)
    lps = prior.logpdf_tree(prior.push_tree(tuple(th))).to(torch.float32)
    assert torch.isfinite(lps).all()
    if kind == "smc":
        sw = kt.make_fused_smc_sweep(prior, _draw, _reduce, ndraws=16)
        assert "prior_logpdf" in sw.unit.source
        assert "prior_push" in sw.unit.source
        out = F.fused_smc_sweep_plain(
            sw, th, torch.full((n,), 1e6), lps, torch.ones(n, dtype=bool),
            1e6, False, 5, 100, 7)
        assert torch.isfinite(out[2][out[3]]).all()
        assert 0 < int(out[3].sum())
    elif kind == "ais":
        sw = kt.make_fused_ais_sweep(prior, _draw, _reduce, scale=0.1,
                                     ndraws=16)
        h = n // 2
        assert "prior_push" in sw.unit.source
        ll = torch.full((n,), -1.0)
        words = torch.arange(1, 8, dtype=torch.int64)
        out = sw.half_words([x[:h] for x in th], lps[:h], ll[:h],
                            [x[h:] for x in th], words)
        assert torch.isfinite(out[1]).all()
    elif kind == "tempered":
        sw = kt.make_fused_tempered_sweep(prior, _loglike)
        h = n // 2
        ll = _loglike(sw.pushed(th)).to(torch.float32)
        words = torch.arange(1, 8, dtype=torch.int64)
        out = sw.half_words([x[:h] for x in th], lps[:h], ll[:h],
                            [x[h:] for x in th], words, 0.3)
        assert torch.isfinite(out[1]).all()
    else:
        g5 = kt.make_fused_abcde_generation(prior, _draw, _reduce,
                                            gamma=1.0, ndraws=16)
        gen = torch.Generator()
        gen.manual_seed(4)
        idx = [torch.randint(0, n, (n,), generator=gen) for _ in range(3)]
        bases = [[x[i] for x in th] for i in idx]
        ds = torch.rand(n, generator=gen)
        out = g5.run(th, bases, lps, ds, torch.ones(n), torch.full((n,), 0.8),
                     torch.tensor([11]))
        assert torch.isfinite(out[1][out[3] > 0.5]).all()
    assert FA.launches.get("fused_ais_sweep", 0) == 0
    assert F.launches.get("fused_smc_sweep", 0) == 0
    assert FT.launches.get("fused_tempered_sweep", 0) == 0
    assert FD.launches.get("fused_abcde_generation", 0) == 0


STILL_MISSING = [kt.Skellam(2.0, 3.0), kt.NoncentralChisq(4.0, 2.5),
                 kt.PoissonBinomial([0.2, 0.5]), kt.Categorical([0.3, 0.7]),
                 kt.DiscreteNonParametric([0.5, 1.5], [0.5, 0.5]),
                 kt.Truncated(kt.Poisson(6.0), 2, 12),
                 kt.Mixture([kt.Normal(0.0, 1.0),
                             kt.NoncentralChisq(4.0, 2.5)])]


@pytest.mark.parametrize("dist", STILL_MISSING,
                         ids=[repr(d)[:32] for d in STILL_MISSING])
def test_families_without_entry_raise_naming_themselves(dist):
    prior = kt.Factored(kt.Uniform(0.0, 1.0), dist)
    with pytest.raises(NotImplementedError) as err:
        kt.make_fused_ais_sweep(prior, _draw, _reduce, scale=0.1)
    inner = dist.components[1] if isinstance(dist, kt.Mixture) else dist
    assert f"{type(inner).__name__} has no entry" in str(err.value)


# the JAX kernels refuse the same six families: their push or logpdf reads
# a host table, which a pallas_call cannot capture
_JAX_REFUSED = {
    "Skellam": lambda ka: ka.Skellam(2.0, 3.0),
    "NoncentralChisq": lambda ka: ka.NoncentralChisq(4.0, 2.5),
    "PoissonBinomial": lambda ka: ka.PoissonBinomial([0.2, 0.5]),
    "Categorical": lambda ka: ka.Categorical([0.3, 0.7]),
    "DiscreteNonParametric": lambda ka: ka.DiscreteNonParametric(
        [0.5, 1.5], [0.5, 0.5]),
    "TruncatedDiscrete": lambda ka: ka.Truncated(ka.Poisson(6.0), 2, 12),
}


@pytest.mark.parametrize("family", sorted(_JAX_REFUSED))
def test_jax_smc_sweep_refuses_the_same_families(family):
    """The port's refusal matches the reference: the JAX #3 in interpret
    mode on stub bits raises "captures constants" for each family that
    the port refuses, and the port names it."""
    import jax
    import jax.numpy as jnp

    import kissabc_tpu as ka

    n = 256
    jprior = ka.Factored(_JAX_REFUSED[family](ka), ka.Uniform(0.1, 1.0))
    sweep = ka.make_fused_smc_sweep(
        jprior, lambda th, e: th[1] + th[1] * e,
        lambda th, m: jnp.abs(m[0] - 3.0), ndraws=16, block=128, chunk=128,
        walker_tiles=2, bits="stub", interpret=True)
    rng = np.random.default_rng(0)
    th = (jnp.asarray(rng.uniform(1, 3, n), jnp.float32),
          jnp.asarray(rng.uniform(0.1, 1.0, n), jnp.float32))
    with pytest.raises(Exception, match="captures constants"):
        sweep(jax.random.key(1), th, jnp.full(n, 1e6, jnp.float32),
              jnp.zeros(n, jnp.float32), jnp.ones(n, bool),
              jnp.float32(0.5), jnp.asarray(False))
    tprior = kt.Factored(_JAX_REFUSED[family](kt), kt.Uniform(0.1, 1.0))
    with pytest.raises(NotImplementedError, match="captures constants"):
        kt.make_fused_smc_sweep(tprior, _draw, _reduce)


@pytest.mark.parametrize("atom", [2.5, 3.0, -0.1])
def test_dirac_entry_pushes_its_atom_on_host(atom, tmp_path):
    """A ``Dirac`` marginal's entry: the push sets the atom (a float atom
    stays, an integer one goes through int32), as ``Dirac.push``; the
    logpdf of the pushed value is 0 at every walker."""
    import ctypes
    d = kt.Dirac(atom)
    text, ops, push_ops = C.emit_prior(kt.Factored(d, kt.Uniform(0.0, 1.0)))
    assert "rintf" not in text and push_ops == 0
    main = _MAIN.replace("float t[1] = {th[i]}, p[1];",
                         "float t[2] = {th[i], 0.5f}, p[2];")
    (tmp_path / "dirac_main.cpp").write_text(
        main % (text, "      case 0: prior_push(t, p); "
                      "lp[i] = prior_logpdf(p); break;"))
    lib = ctypes.CDLL(str(build_program(tmp_path, None, "dirac_main.cpp",
                                        shared=True)))
    x = torch.linspace(atom - 3.0, atom + 3.0, 257)
    lp, pushed = torch.empty_like(x), torch.empty_like(x)
    lib.run(ctypes.c_int(0), ctypes.c_void_p(x.data_ptr()),
            ctypes.c_void_p(lp.data_ptr()), ctypes.c_void_p(pushed.data_ptr()),
            ctypes.c_int(x.numel()))
    assert torch.equal(pushed, d.push(x).to(torch.float32))
    want = (d.logpdf(d.push(x)) + kt.Uniform(0.0, 1.0).logpdf(
        torch.full_like(x, 0.5))).to(torch.float32)
    assert torch.equal(lp, want) and torch.isfinite(lp).all()
