"""kissabc_tpu_torch/statistics.py: Distributions.jl's functional
statistics surface on the port, mirroring ``tests/test_statistics.py``
for every case whose family the port has (the vector and matrix
families Product/IID, Multinomial, MvLogNormal, MvTDist, Wishart,
InverseWishart, LKJ and LKJCholesky are not ported yet).

Oracles: scipy frozen objects built here with their own conventions (at
``tests/test_statistics.py``'s tolerances), the JAX package's own
``statistics`` (at rtol 1e-6: the same host scipy computations), and
empirical moments of the port's own samplers for the override families.
The pointwise functions return tensors on ``x``'s device; ``rand`` draws
from a generator seeded by ``key`` on the device named.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import scipy.stats as st
import torch

import kissabc_tpu as ka
import kissabc_tpu_torch as kt
from kissabc_tpu import statistics as kas
from kissabc_tpu_torch import distributions as D
from kissabc_tpu_torch import statistics as kts
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


# (family, args, scipy twin built independently here): TWIN_CASES of
# tests/test_statistics.py:24-70, every family of which the port has
TWIN_CASES = [
    ("Normal", (1.5, 2.0), st.norm(1.5, 2.0)),
    ("Uniform", (-1.0, 3.0), st.uniform(-1.0, 4.0)),
    ("Exponential", (2.5,), st.expon(scale=2.5)),
    ("Beta", (2.0, 5.0), st.beta(2.0, 5.0)),
    ("Gamma", (2.5, 1.7), st.gamma(2.5, scale=1.7)),
    ("LogNormal", (0.3, 0.8), st.lognorm(0.8, scale=np.exp(0.3))),
    ("Laplace", (1.0, 2.0), st.laplace(1.0, 2.0)),
    ("StudentT", (5.0,), st.t(5.0)),
    ("Weibull", (2.0, 1.5), st.weibull_min(2.0, scale=1.5)),
    ("Chisq", (4.0,), st.chi2(4.0)),
    ("Chi", (3.0,), st.chi(3.0)),
    ("NoncentralChisq", (4.0, 2.5), st.ncx2(4.0, 2.5)),
    ("FDist", (8.0, 12.0), st.f(8.0, 12.0)),
    ("Logistic", (0.5, 1.2), st.logistic(0.5, 1.2)),
    ("Rayleigh", (2.0,), st.rayleigh(scale=2.0)),
    ("Pareto", (3.0, 2.0), st.pareto(3.0, scale=2.0)),
    ("GeneralizedPareto", (0.5, 1.5, 0.2), st.genpareto(0.2, 0.5, 1.5)),
    ("GeneralizedExtremeValue", (0.5, 1.5, 0.2),
     st.genextreme(-0.2, 0.5, 1.5)),
    ("InverseGamma", (3.0, 2.0), st.invgamma(3.0, scale=2.0)),
    ("InverseGaussian", (2.0, 3.0), st.invgauss(2.0 / 3.0, scale=3.0)),
    ("Gumbel", (0.5, 2.0), st.gumbel_r(0.5, 2.0)),
    ("TriangularDist", (0.0, 4.0, 1.0), st.triang(0.25, loc=0, scale=4)),
    ("SymTriangularDist", (1.0, 2.0), st.triang(0.5, loc=-1, scale=4)),
    ("Cosine", (1.0, 2.0), st.cosine(loc=1.0, scale=2.0 / np.pi)),
    ("Arcsine", (1.0, 3.0), st.arcsine(loc=1.0, scale=2.0)),
    ("Semicircle", (2.0,), st.semicircular(scale=2.0)),
    ("Frechet", (5.0, 2.0), st.invweibull(5.0, scale=2.0)),
    ("LogUniform", (0.5, 4.0), st.loguniform(0.5, 4.0)),
    ("JohnsonSU", (0.5, 2.0, 0.3, 1.5),
     st.johnsonsu(0.3, 1.5, loc=0.5, scale=2.0)),
    ("BetaPrime", (3.0, 5.0), st.betaprime(3.0, 5.0)),
    ("PGeneralizedGaussian", (0.5, 1.5, 3.0),
     st.gennorm(3.0, loc=0.5, scale=1.5)),
    ("Rician", (2.0, 1.5), st.rice(2.0 / 1.5, scale=1.5)),
    ("Poisson", (3.5,), st.poisson(3.5)),
    ("Bernoulli", (0.3,), st.bernoulli(0.3)),
    ("Binomial", (10, 0.4), st.binom(10, 0.4)),
    ("Geometric", (0.3,), st.geom(0.3, loc=-1)),
    ("NegativeBinomial", (4.0, 0.3), st.nbinom(4.0, 0.3)),
    ("BetaBinomial", (10, 2.0, 3.0), st.betabinom(10, 2.0, 3.0)),
    ("Hypergeometric", (7, 5, 6), st.hypergeom(12, 7, 6)),
    ("Skellam", (2.0, 3.0), st.skellam(2.0, 3.0)),
    ("DiscreteUniform", (2, 9), st.randint(2, 10)),
]
_STATS = ("mean", "var", "std", "median", "entropy", "minimum", "maximum",
          "skewness", "kurtosis")


@pytest.mark.parametrize("fam,args,twin", TWIN_CASES,
                         ids=[c[0] for c in TWIN_CASES])
def test_twin_families_moments_and_support(fam, args, twin):
    d = getattr(kt, fam)(*args)
    assert np.isclose(kt.mean(d), twin.mean(), rtol=1e-5, atol=1e-6)
    assert np.isclose(kt.var(d), twin.var(), rtol=1e-5, atol=1e-6)
    assert np.isclose(kt.std(d), twin.std(), rtol=1e-5, atol=1e-6)
    assert np.isclose(kt.median(d), twin.median(), rtol=1e-5, atol=1e-6)
    assert np.isclose(kt.entropy(d), twin.entropy(), rtol=1e-5, atol=1e-6)
    lo, hi = twin.support()
    assert np.isclose(kt.minimum(d), lo, rtol=1e-6, atol=1e-6)
    assert np.isclose(kt.maximum(d), hi, rtol=1e-6, atol=1e-6)
    assert np.isclose(kt.skewness(d), twin.stats(moments="s"), rtol=1e-5,
                      atol=1e-6, equal_nan=True)
    assert np.isclose(kt.kurtosis(d), twin.stats(moments="k"), rtol=1e-5,
                      atol=1e-6, equal_nan=True)
    # and the JAX package's own statistics, at rtol 1e-6
    j = getattr(ka, fam)(*args)
    for name in _STATS:
        assert np.isclose(getattr(kt, name)(d), getattr(ka, name)(j),
                          rtol=1e-6, atol=0.0, equal_nan=True), name


# families with no scipy twin (or overrides that do not delegate):
# empirical moments of the port's own sampler (tests/test_statistics.py
# :98-114)
OVERRIDE_CASES = [
    kt.Kumaraswamy(2.0, 3.0),
    kt.Lindley(0.7),
    kt.LogitNormal(0.4, 0.9),
    kt.Epanechnikov(1.0, 2.0),
    kt.Biweight(-0.5, 1.5),
    kt.Triweight(0.0, 2.0),
    kt.Mixture([kt.Normal(0.0, 1.0), kt.Normal(4.0, 2.0)], [0.25, 0.75]),
    (2.0 + 3.0 * kt.Exponential(1.5)),
    (2.0 - 3.0 * kt.Exponential(1.5)),
    kt.Truncated(kt.Normal(0.0, 1.0), 0.5, 2.0),
    kt.Truncated(kt.Gamma(2.0, 1.5), 1.0, np.inf),
    kt.Truncated(kt.Poisson(3.0), 1, 5),
    kt.DiscreteNonParametric([0.5, 1.5, 4.0], [0.2, 0.5, 0.3]),
    kt.PoissonBinomial([0.2, 0.5, 0.9]),
]


@pytest.mark.parametrize("i,d", list(enumerate(OVERRIDE_CASES)),
                         ids=[repr(d)[:40] for d in OVERRIDE_CASES])
def test_override_families_empirical_moments(i, d):
    n = 200_000
    g = torch.Generator()
    g.manual_seed(100 + i)
    x = d.sample(g, (n,)).numpy().astype(np.float64)
    m, s = kt.mean(d), kt.std(d)
    # mean within 6 standard errors; std within 3%
    assert abs(x.mean() - m) < 6.0 * s / np.sqrt(n) + 1e-4, (x.mean(), m)
    assert np.isclose(x.std(ddof=1), s, rtol=0.03), (x.std(ddof=1), s)
    assert kt.minimum(d) - 1e-5 <= x.min()
    assert x.max() <= kt.maximum(d) + 1e-5


def test_frechet_divergent_moments():
    assert kt.skewness(kt.Frechet(2.5, 1.0)) == np.inf
    assert kt.kurtosis(kt.Frechet(2.5, 1.0)) == np.inf
    assert kt.kurtosis(kt.Frechet(3.5, 1.0)) == np.inf
    assert np.isfinite(kt.skewness(kt.Frechet(3.5, 1.0)))
    assert np.isfinite(kt.kurtosis(kt.Frechet(4.5, 1.0)))


def test_truncated_continuous_vs_truncnorm():
    d = kt.Truncated(kt.Normal(0.0, 1.0), 0.5, 2.0)
    f = st.truncnorm(0.5, 2.0)
    assert np.isclose(kt.mean(d), f.mean(), rtol=1e-6)
    assert np.isclose(kt.var(d), f.var(), rtol=1e-6)
    assert np.isclose(kt.median(d), f.median(), rtol=1e-6)
    assert np.isclose(kt.entropy(d), f.entropy(), rtol=1e-5)
    assert kt.minimum(d) == 0.5 and kt.maximum(d) == 2.0


def test_vonmises_circular_stats():
    import scipy.special as sp
    d = kt.VonMises(0.5, 2.0)
    r = sp.i1(2.0) / sp.i0(2.0)
    assert kt.mean(d) == kt.median(d) == kt.mode(d) == 0.5
    assert np.isclose(kt.var(d), 1.0 - r, rtol=1e-7)
    assert np.isclose(kt.entropy(d),
                      np.log(2 * np.pi * sp.i0(2.0)) - 2.0 * r, rtol=1e-7)
    assert np.isclose(kt.minimum(d), 0.5 - np.pi)
    assert np.isclose(kt.maximum(d), 0.5 + np.pi)


def test_modes():
    assert kt.mode(kt.Normal(1.5, 2.0)) == 1.5
    assert np.isclose(kt.mode(kt.Gamma(3.0, 2.0)), 4.0)
    assert np.isclose(kt.mode(kt.Beta(3.0, 2.0)), 2.0 / 3.0)
    assert np.isclose(kt.mode(kt.LogNormal(0.3, 0.8)),
                      np.exp(0.3 - 0.64), rtol=1e-6)
    assert kt.mode(kt.Exponential(2.0)) == 0.0
    assert kt.mode(kt.Poisson(3.5)) == 3.0
    assert kt.mode(kt.Binomial(10, 0.4)) == 4.0
    assert kt.mode(kt.TriangularDist(0.0, 4.0, 1.0)) == 1.0
    assert kt.mode(kt.Dirac(7.0)) == 7.0
    assert kt.mode(kt.DiscreteNonParametric([1.0, 2.0], [0.7, 0.3])) == 1.0
    assert kt.mode(kt.Categorical([0.2, 0.5, 0.3])) == 1.0
    for d in (kt.Weibull(2.0, 1.5), kt.Frechet(5.0, 2.0), kt.Lindley(0.7),
              kt.Kumaraswamy(2.0, 3.0), 2.0 + 3.0 * kt.Gamma(3.0, 2.0),
              kt.Epanechnikov(1.0, 2.0), kt.Levy(0.5, 1.5)):
        j = ka.mode({kt.Weibull: ka.Weibull(2.0, 1.5),
                     kt.Frechet: ka.Frechet(5.0, 2.0),
                     kt.Lindley: ka.Lindley(0.7),
                     kt.Kumaraswamy: ka.Kumaraswamy(2.0, 3.0),
                     kt.Affine: 2.0 + 3.0 * ka.Gamma(3.0, 2.0),
                     kt.Epanechnikov: ka.Epanechnikov(1.0, 2.0),
                     kt.Levy: ka.Levy(0.5, 1.5)}[type(d)])
        assert np.isclose(kt.mode(d), j, rtol=1e-12)
    with pytest.raises(NotImplementedError):
        kt.mode(kt.Beta(0.5, 0.5))


def test_multivariate_mean_cov_entropy():
    mu = np.array([1.0, 2.0])
    sig = np.array([[2.0, 0.5], [0.5, 1.0]])
    d = kt.MvNormal(mu, sig)
    assert np.allclose(kt.mean(d), mu)
    assert np.allclose(kt.cov(d), sig, atol=1e-6)
    assert np.allclose(kt.var(d), np.diag(sig), atol=1e-6)
    assert np.isclose(kt.entropy(d),
                      st.multivariate_normal(mu, sig).entropy(), rtol=1e-6)
    a = np.array([2.0, 3.0, 5.0])
    di = kt.Dirichlet(a)
    assert np.allclose(kt.mean(di), a / a.sum(), atol=1e-7)
    assert np.allclose(np.diag(kt.cov(di)), st.dirichlet(a).var(),
                       rtol=1e-6)
    assert np.allclose(kt.mode(di), (a - 1) / (a.sum() - 3))


def test_factored_tuplewise():
    fac = kt.Factored(kt.Uniform(0.0, 1.0), kt.Poisson(3.0))
    assert kt.mean(fac) == (0.5, 3.0)
    assert np.allclose(kt.var(fac), (1.0 / 12.0, 3.0))
    assert np.isclose(kt.entropy(fac), 0.0 + st.poisson(3.0).entropy(),
                      rtol=1e-6)
    assert kt.minimum(fac) == (0.0, 0.0)
    ok = kt.insupport(fac, (torch.tensor(0.5), torch.tensor(2.0)))
    bad = kt.insupport(fac, (torch.tensor(1.5), torch.tensor(2.0)))
    assert bool(ok) and not bool(bad)


def test_insupport_pointwise():
    assert bool(kt.insupport(kt.Beta(2.0, 2.0), 0.5))
    assert not bool(kt.insupport(kt.Beta(2.0, 2.0), 1.5))
    assert bool(kt.insupport(kt.Poisson(3.0), 2.0))
    assert not bool(kt.insupport(kt.Poisson(3.0), 2.5))   # integrality
    assert bool(kt.insupport(kt.Dirac(1.5), 1.5))
    assert not bool(kt.insupport(kt.Dirac(1.5), 2.0))
    d = kt.DiscreteNonParametric([0.5, 4.0], [0.5, 0.5])
    assert bool(kt.insupport(d, 4.0)) and not bool(kt.insupport(d, 1.0))
    out = kt.insupport(kt.Uniform(0.0, 1.0), torch.tensor([-0.5, 0.5, 1.5]))
    assert out.tolist() == [False, True, False] and out.dtype == torch.bool


def test_pointwise_ccdf_logcdf_cquantile():
    d = kt.Normal(0.0, 1.0)
    x = torch.tensor(0.7)
    assert np.isclose(float(kt.ccdf(d, x)), st.norm.sf(0.7), rtol=1e-5)
    assert np.isclose(float(kt.logcdf(d, x)), st.norm.logcdf(0.7),
                      rtol=1e-5)
    assert np.isclose(float(kt.logccdf(d, x)), st.norm.logsf(0.7),
                      rtol=1e-5)
    assert np.isclose(float(kt.cquantile(d, 0.975)), st.norm.ppf(0.025),
                      rtol=1e-4)
    assert np.isclose(float(kt.quantile(d, 0.975)), st.norm.ppf(0.975),
                      rtol=1e-4)
    assert np.isclose(float(kt.pdf(d, x)), st.norm.pdf(0.7), rtol=1e-5)
    assert np.isclose(float(kt.logpdf(d, x)), st.norm.logpdf(0.7),
                      rtol=1e-5)
    assert np.isclose(float(kt.cdf(d, x)), st.norm.cdf(0.7), rtol=1e-5)


@pytest.mark.parametrize("fam,args", [("Gamma", (2.0, 1.5)),
                                      ("Beta", (2.0, 5.0)),
                                      ("Weibull", (1.5, 2.0)),
                                      ("Binomial", (10, 0.4)),
                                      ("Skellam", (2.0, 3.0))])
def test_pointwise_functions_match_jax(fam, args):
    """cdf, ccdf, logcdf, logccdf, pdf, quantile and cquantile of the
    port equal the JAX package's within 4e-6 (logs: on exp), insupport
    exactly; each returns a tensor."""
    import jax.numpy as jnp
    d, j = getattr(kt, fam)(*args), getattr(ka, fam)(*args)
    x = np.linspace(-1.0, 12.0, 131).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if hasattr(j, "cdf"):
        for name in ("cdf", "ccdf"):
            got = getattr(kt, name)(d, xt)
            assert torch.is_tensor(got)
            np.testing.assert_allclose(
                got.numpy(), np.asarray(getattr(kas, name)(j, xj)), atol=4e-6)
        for name in ("logcdf", "logccdf"):
            np.testing.assert_allclose(
                torch.exp(getattr(kt, name)(d, xt)).numpy(),
                np.exp(np.asarray(getattr(kas, name)(j, xj))), atol=4e-6)
    np.testing.assert_allclose(
        kt.pdf(d, xt).numpy(), np.asarray(kas.pdf(j, xj)), rtol=1e-5,
        atol=1e-7)
    assert torch.equal(kt.insupport(d, xt),
                       torch.from_numpy(np.array(kas.insupport(j, xj))))
    if hasattr(j, "quantile"):
        q = np.linspace(0.05, 0.95, 19).astype(np.float32)
        for name in ("quantile", "cquantile"):
            np.testing.assert_allclose(
                getattr(kt, name)(d, torch.from_numpy(q)).numpy(),
                np.asarray(getattr(kas, name)(j, jnp.asarray(q))), atol=4e-6)
    assert np.isclose(float(kt.loglikelihood(d, xt[(x > 0) & (x < 1)])),
                      float(kas.loglikelihood(j, xj[(x > 0) & (x < 1)])),
                      rtol=1e-5)


def test_params_and_cloud_inputs():
    assert kt.params(kt.Normal(1.0, 2.0)) == (1.0, 2.0)
    assert kt.params(kt.Hypergeometric(7, 5, 6)) == (7, 5, 6)
    assert kt.params(kt.Beta(2.0, 5.0)) == ka.params(ka.Beta(2.0, 5.0))
    assert kt.params(kt.JohnsonSU(0.5, 2.0, 0.3, 1.5)) == \
        ka.params(ka.JohnsonSU(0.5, 2.0, 0.3, 1.5))
    mu, cv = kt.params(kt.MvNormal(np.zeros(2), np.eye(2)))
    assert np.allclose(mu, 0.0) and np.allclose(cv, np.eye(2))
    base, lo, hi = kt.params(kt.Truncated(kt.Normal(0.0, 1.0), -1.0, 2.0))
    assert type(base) is kt.Normal and (lo, hi) == (-1.0, 2.0)
    p = kt.Particles(np.array([1.0, 2.0, 3.0]))
    assert kt.mean(p) == 2.0
    assert np.isclose(kt.std(p), 1.0)
    assert kt.median([1.0, 2.0, 9.0]) == 2.0
    ps = (kt.Particles(np.array([1.0, 2.0, 3.0])),
          kt.Particles(np.array([2.0, 4.0, 7.0])))
    assert np.allclose(kt.mean(ps), [2.0, 13.0 / 3.0])


def test_aliases_and_wrappers_dispatch():
    assert np.isclose(kt.mean(kt.NormalCanon(2.0, 4.0)), 0.5)
    assert np.isclose(kt.mean(kt.Erlang(3, 2.0)), 6.0)
    tn = kt.TruncatedNormal(0.0, 1.0, 0.5, 2.0)
    assert np.isclose(kt.mean(tn), st.truncnorm(0.5, 2.0).mean(), rtol=1e-6)
    assert np.isclose(kt.mean(kt.TDist(5.0)), 0.0)


def test_truncated_general_bases():
    """Truncated's host normalizer reaches the twin registry, so
    truncated() works over the univariate families (tests/
    test_statistics.py:294-318)."""
    from scipy.integrate import quad
    cases = [
        (kt.Truncated(kt.Cauchy(0.0, 1.0), -2.0, 3.0), st.cauchy(0, 1),
         -2.0, 3.0),
        (kt.Truncated(kt.Gumbel(0.0, 1.0), -1.0, 2.0), st.gumbel_r(0, 1),
         -1.0, 2.0),
        (kt.Truncated(kt.StudentT(4.0), -1.5, 1.5), st.t(4.0), -1.5, 1.5),
        (kt.Truncated(kt.FDist(5.0, 9.0), 0.5, 3.0), st.f(5.0, 9.0),
         0.5, 3.0),
    ]
    g = torch.Generator()
    g.manual_seed(5)
    for d, f, lo, hi in cases:
        mass = f.cdf(hi) - f.cdf(lo)
        mid = 0.5 * (lo + hi)
        assert np.isclose(float(d.logpdf(torch.tensor(mid))),
                          f.logpdf(mid) - np.log(mass), rtol=1e-4)
        m = quad(lambda v: v * f.pdf(v), lo, hi)[0] / mass
        assert np.isclose(kt.mean(d), m, rtol=1e-5)
        x = d.sample(g, (20000,)).numpy()
        assert lo - 1e-5 <= x.min() and x.max() <= hi + 1e-5
        assert abs(x.mean() - m) < 5 * x.std() / np.sqrt(x.size)


def test_new_cdf_quantile_legs_vs_scipy():
    for d, f in [(kt.StudentT(4.0), st.t(4.0)),
                 (kt.FDist(5.0, 9.0), st.f(5.0, 9.0)),
                 (kt.InverseGamma(3.0, 2.0), st.invgamma(3.0, scale=2.0)),
                 (kt.VonMises(0.5, 2.0), st.vonmises(2.0, loc=0.5))]:
        qs = np.asarray([0.1, 0.35, 0.6, 0.9], np.float32)
        xs = np.asarray(f.ppf(qs), np.float32)
        assert np.allclose(d.cdf(torch.from_numpy(xs)).numpy(), qs,
                           atol=2e-5)
        assert np.allclose(d.quantile(torch.from_numpy(qs)).numpy(), xs,
                           atol=2e-4)


FIT_CASES = [
    (kt.Normal, kt.Normal(1.5, 2.0), [("mu", 1.5), ("sigma", 2.0)]),
    (kt.LogNormal, kt.LogNormal(0.3, 0.8), [("mu", 0.3), ("sigma", 0.8)]),
    (kt.Exponential, kt.Exponential(2.5), [("theta", 2.5)]),
    (kt.Laplace, kt.Laplace(1.0, 2.0), [("mu", 1.0), ("sigma", 2.0)]),
    (kt.Rayleigh, kt.Rayleigh(1.5), [("sigma", 1.5)]),
    (kt.Pareto, kt.Pareto(3.0, 2.0), [("alpha", 3.0), ("theta", 2.0)]),
    (kt.Poisson, kt.Poisson(4.0), [("lam", 4.0)]),
    (kt.Bernoulli, kt.Bernoulli(0.3), [("p", 0.3)]),
    (kt.Geometric, kt.Geometric(0.35), [("p", 0.35)]),
    (kt.Gamma, kt.Gamma(2.5, 1.7), [("alpha", 2.5), ("theta", 1.7)]),
    (kt.Weibull, kt.Weibull(2.0, 1.5), [("alpha", 2.0), ("theta", 1.5)]),
    (kt.Beta, kt.Beta(2.0, 5.0), [("alpha", 2.0), ("beta", 5.0)]),
    (kt.Gumbel, kt.Gumbel(0.5, 2.0), [("mu", 0.5), ("theta", 2.0)]),
    (kt.InverseGaussian, kt.InverseGaussian(2.0, 3.0),
     [("mu", 2.0), ("lam", 3.0)]),
]


@pytest.mark.parametrize("cls,d,ps", FIT_CASES,
                         ids=[c[0].__name__ for c in FIT_CASES])
def test_fit_mle_recovers_parameters(cls, d, ps):
    g = torch.Generator()
    g.manual_seed(0)
    x = d.sample(g, (60_000,))
    f = kt.fit(cls, x)
    assert type(f) is cls
    for name, val in ps:
        got = float(getattr(f, name))
        assert abs(got - val) < 0.08 * max(abs(val), 1.0) + 0.02, (
            name, got, val)
    # the same samples give the JAX package's fit (the same host code)
    j = ka.fit(getattr(ka, cls.__name__), x.numpy())
    for name, _ in ps:
        assert np.isclose(float(getattr(f, name)), float(getattr(j, name)),
                          rtol=1e-6)


def test_fit_mle_multivariate_categorical_uniform():
    g = torch.Generator()
    g.manual_seed(0)
    mv = kt.MvNormal(np.array([1.0, 2.0]), np.array([[2.0, 0.5],
                                                      [0.5, 1.0]]))
    f = kt.fit_mle(kt.MvNormal, mv.sample(g, (100_000,)))
    assert np.allclose(f.mean, [1.0, 2.0], atol=0.03)
    assert np.allclose(np.asarray(f.cov), [[2.0, 0.5], [0.5, 1.0]],
                       atol=0.06)
    cat = kt.fit(kt.Categorical, kt.Categorical([0.2, 0.5, 0.3]).sample(
        g, (60_000,)))
    assert np.allclose(cat.p, [0.2, 0.5, 0.3], atol=0.015)
    uni = kt.fit(kt.Uniform, kt.Uniform(-1.0, 3.0).sample(g, (60_000,)))
    assert abs(float(uni.a) + 1.0) < 0.01 and abs(float(uni.b) - 3.0) < 0.01
    with pytest.raises(NotImplementedError):
        kt.fit(kt.Dirichlet, np.zeros((10, 2)))


def test_convenience_functions():
    assert kt.support(kt.Beta(2.0, 3.0)) == (0.0, 1.0)
    t = kt.truncated(kt.Normal(0.0, 1.0), lower=0.5)
    assert float(t.lo) == 0.5 and kt.maximum(t) == np.inf
    assert type(kt.truncated(kt.Poisson(3.0), 1, 5)).__name__ == \
        "TruncatedDiscrete"
    assert isinstance(
        kt.product_distribution([kt.Normal(0, 1), kt.Poisson(2.0)]),
        kt.Factored)
    # homogeneous univariate marginals are the JAX package's Product
    assert isinstance(
        kt.product_distribution([kt.Normal(0, 1), kt.Normal(2, 3)]),
        kt.Product)
    mv = kt.MvNormal(np.zeros(2), np.array([[4.0, 1.0], [1.0, 1.0]]))
    assert np.allclose(kt.cor(mv), [[1.0, 0.5], [0.5, 1.0]], atol=1e-6)
    xs = torch.tensor([0.5, -0.3])
    assert np.isclose(float(kt.loglikelihood(kt.Normal(0.0, 1.0), xs)),
                      st.norm.logpdf(xs.numpy()).sum(), rtol=1e-5)
    r = kt.rand(kt.Normal(0.0, 1.0), 5, key=2, device="cpu")
    assert r.shape == (5,) and r.device.type == "cpu"
    assert torch.equal(r, kt.rand(kt.Normal(0.0, 1.0), 5, key=2,
                                  device="cpu"))
    tup = kt.rand(kt.Factored(kt.Uniform(0, 1), kt.Poisson(3.0)), 4, key=1,
                  device="cpu")
    assert tup[0].shape == (4,) and tup[1].dtype == torch.int32
    two = kt.rand(kt.Gamma(2.0, 1.0), (2, 3), key=0, device="cpu")
    assert two.shape == (2, 3)
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            kt.rand(kt.Normal(0.0, 1.0), 5)


def test_truncated_far_tail_stats():
    t = kt.Truncated(kt.Normal(0.0, 1.0), 8.0, 9.0)
    f = st.truncnorm(8.0, 9.0)
    assert np.isclose(kt.mean(t), f.mean(), rtol=1e-8)
    assert np.isclose(kt.median(t), f.median(), rtol=1e-8)
    assert np.isclose(kt.var(t), f.var(), rtol=1e-6)
    xs = np.linspace(8.0, 9.0, 200_001)
    p = f.pdf(xs)
    h = -np.trapezoid(p * np.log(np.maximum(p, 1e-300)), xs)
    assert np.isclose(kt.entropy(t), h, rtol=1e-5)
    tw = kt.Truncated(kt.Normal(0.0, 1.0), -1e4, 1e4)
    assert np.isclose(kt.var(tw), 1.0, rtol=1e-5)
    tw2 = kt.Truncated(kt.Normal(0.0, 1.0), -1e4, 0.5)
    assert np.isclose(kt.mean(tw2), st.truncnorm(-1e4, 0.5).mean(),
                      rtol=1e-6)
    assert np.isclose(kt.entropy(tw2), st.truncnorm(-1e4, 0.5).entropy(),
                      rtol=1e-5)


def test_truncated_vonmises():
    tv = kt.Truncated(kt.VonMises(0.5, 2.0), 0.0, 1.0)
    g = torch.Generator()
    g.manual_seed(0)
    x = tv.sample(g, (5000,)).numpy()
    assert x.min() >= 0.0 and x.max() <= 1.0
    assert np.isfinite(kt.mean(tv))


TAIL_CASES = [
    (kt.Normal(0.0, 1.0), st.norm(), [3.0, 8.0, 12.0, -3.0]),
    (kt.Exponential(2.0), st.expon(scale=2.0), [1.0, 50.0, 200.0]),
    (kt.Weibull(1.5, 2.0), st.weibull_min(1.5, scale=2.0),
     [1.0, 20.0, 60.0]),
    (kt.LogNormal(0.0, 1.0), st.lognorm(1.0), [1.0, 100.0, 1e4]),
    (kt.Logistic(0.0, 1.0), st.logistic(), [1.0, 40.0, 90.0]),
    (kt.Cauchy(0.0, 1.0), st.cauchy(), [1.0, 1e4, 1e8]),
    (kt.Pareto(2.5, 1.0), st.pareto(2.5), [2.0, 1e4, 1e8]),
    (kt.Gumbel(0.0, 1.0), st.gumbel_r(), [1.0, 30.0, 80.0]),
    (kt.Frechet(2.0, 1.0), st.invweibull(2.0), [1.0, 1e3, 1e6]),
    (kt.Rayleigh(1.0), st.rayleigh(), [1.0, 10.0, 25.0]),
    (kt.Laplace(0.0, 1.0), st.laplace(), [1.0, 40.0, 80.0]),
]


@pytest.mark.parametrize("d,tw,xs", TAIL_CASES,
                         ids=[type(c[0]).__name__ for c in TAIL_CASES])
def test_tail_accurate_survival_functions(d, tw, xs):
    for x in xs:
        got = float(kts.logccdf(d, np.float32(x)))
        ref = tw.logsf(x)
        assert abs(got - ref) / max(abs(ref), 1e-12) < 5e-5, (x, got, ref)
        if ref > -80:   # the survival function representable in float32
            assert np.isclose(float(kts.ccdf(d, np.float32(x))), tw.sf(x),
                              rtol=2e-4)


def test_fallback_survival_function():
    g = kt.Gamma(2.0, 1.0)
    assert np.isclose(float(kts.ccdf(g, np.float32(1.0))),
                      st.gamma(2.0).sf(1.0), rtol=1e-5)
    # the fallback logccdf floors at log(1e-37)
    assert float(kts.logccdf(g, np.float32(100.0))) <= np.log(1e-36)


def test_one_twin_registry():
    """The port keeps one scipy twin registry, statistics._twin: the
    distributions module has none of its own, and Truncated's host cdf of
    a family without a written branch (Gumbel) goes through it."""
    assert not hasattr(D, "_twin")
    t = kts._twin(kt.Gumbel(0.0, 1.0))
    assert np.isclose(D._host_cdf(kt.Gumbel(0.0, 1.0), 0.5), t.cdf(0.5),
                      rtol=0, atol=0)
    assert kts._twin(kt.Dirac(1.0)) is None


NOT_YET_PORTED = []


def _jax_imports(module):
    """The names kissabc_tpu/__init__.py imports from ``module``."""
    text = (REPO / "kissabc_tpu" / "__init__.py").read_text()
    block = re.search(rf"from \.{module} import \(([^)]*)\)", text).group(1)
    block = " ".join(line.split("#")[0] for line in block.splitlines())
    return [n.strip() for n in block.split(",") if n.strip()]


def test_top_level_names():
    """Every distribution and statistics name the JAX package exports is
    in the port's top level (and its ``__all__``), or on the list of
    names not ported yet, which ROADMAP.md's queue A lists too."""
    names = _jax_imports("distributions") + _jax_imports("statistics")
    assert len(names) > 100
    missing = [n for n in names if not hasattr(kt, n)]
    assert sorted(missing) == sorted(NOT_YET_PORTED)
    assert all(n in kt.__all__ for n in names if n not in NOT_YET_PORTED)
    assert set(_jax_imports("statistics")) == set(kts.__all__)
    roadmap = (REPO / "ROADMAP.md").read_text()
    for n in NOT_YET_PORTED:
        assert f"`{n}`" in roadmap, n
