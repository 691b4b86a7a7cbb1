"""The univariate distribution families of kissabc_tpu_torch held against
the JAX package on the same numpy points (36 continuous and 10 discrete
families beside the prior battery's):

- ``logpdf`` within 16 float32 ulps of max(1, |value|), as
  ``tests/test_torch_distributions_battery.py`` (the gap is the two
  libraries' ``lgamma``/``log1p``/``pow``/``cos``); a pmf that sums
  ``lgamma`` terms (Binomial, BetaBinomial, NegativeBinomial, Skellam) is
  held on the scale of its largest term, max(1, |value|, |lgamma(|x| +
  c)|), since each library rounds each term; Cosine's ``log(1 + cos(pi
  z))`` also gets the rounding of ``cos`` magnified by 1/(1 + cos(pi z)),
  the formula's own conditioning at the support's edges;
- ``pdf`` equal to ``exp(logpdf)``;
- ``cdf``, ``sf`` (and ``exp(logsf)``) and ``quantile`` within 4e-6
  (absolute) of JAX where the JAX family has them (where a quantile is
  too large for float32 to place within 4e-6, JAX's cdf at it within
  4e-6 of q);
- sampling against scipy: for a continuous family the Kolmogorov-Smirnov
  distance under its 0.1% critical value (1.95/sqrt(n)), for a discrete
  one the pmf within 5 standard errors on every atom of mass >= 1e-3;
- ``push`` dtypes and values, the discrete bases of ``Truncated``, the
  constructors ``Erlang``/``NormalCanon``, ``convert.prior_from_numpy``
  building each family, and draws that take only the given generator.
"""

import contextlib
import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import special as sps
from scipy import stats

import kissabc_tpu as ka
import kissabc_tpu_torch as kt
from kissabc_tpu_torch import convert
from torch_threads import one_torch_thread  # noqa: F401

EPS32 = float(np.finfo(np.float32).eps)


def _u(name, lo, hi, n=400):
    rng = np.random.default_rng(sum(map(ord, name)))
    return rng.uniform(lo, hi, n)


def _ints(lo, hi):
    return np.arange(lo, hi + 1, dtype=np.float64)


# name: (constructor name, args, points, scipy twin)
CONTINUOUS = {
    "Beta": ("Beta", (2.0, 5.0), (-0.2, 1.2), stats.beta(2.0, 5.0)),
    "Beta-small": ("Beta", (0.5, 0.7), (-0.1, 1.1), stats.beta(0.5, 0.7)),
    "LogNormal": ("LogNormal", (0.3, 0.8), (-0.5, 8.0),
                  stats.lognorm(0.8, scale=np.exp(0.3))),
    "Laplace": ("Laplace", (1.0, 2.0), (-8, 10), stats.laplace(1.0, 2.0)),
    "Cauchy": ("Cauchy", (0.5, 1.5), (-20, 20), stats.cauchy(0.5, 1.5)),
    "Weibull": ("Weibull", (1.5, 2.0), (-0.5, 8), stats.weibull_min(
        1.5, scale=2.0)),
    "Chisq": ("Chisq", (4.0,), (-1, 20), stats.chi2(4.0)),
    "FDist": ("FDist", (8.0, 12.0), (-0.5, 6), stats.f(8.0, 12.0)),
    "Logistic": ("Logistic", (0.5, 1.2), (-10, 10),
                 stats.logistic(0.5, 1.2)),
    "Rayleigh": ("Rayleigh", (2.0,), (-1, 10), stats.rayleigh(scale=2.0)),
    "Pareto": ("Pareto", (3.0, 2.0), (1.0, 12), stats.pareto(3.0,
                                                               scale=2.0)),
    "InverseGamma": ("InverseGamma", (3.0, 2.0), (-0.2, 5),
                     stats.invgamma(3.0, scale=2.0)),
    "Gumbel": ("Gumbel", (0.5, 2.0), (-6, 14), stats.gumbel_r(0.5, 2.0)),
    "TriangularDist": ("TriangularDist", (0.0, 4.0, 1.0), (-1, 5),
                       stats.triang(0.25, loc=0, scale=4)),
    "TriangularDist-left": ("TriangularDist", (0.0, 2.0, 0.0), (-0.5, 2.5),
                            stats.triang(0.0, loc=0, scale=2)),
    "Arcsine": ("Arcsine", (1.0, 3.0), (0.5, 3.5),
                stats.arcsine(loc=1.0, scale=2.0)),
    "Semicircle": ("Semicircle", (2.0,), (-2.5, 2.5),
                   stats.semicircular(scale=2.0)),
    "Frechet": ("Frechet", (5.0, 2.0), (-0.5, 8),
                stats.invweibull(5.0, scale=2.0)),
    "Levy": ("Levy", (0.5, 1.5), (0.0, 20), stats.levy(0.5, 1.5)),
    "GeneralizedPareto": ("GeneralizedPareto", (0.5, 1.5, 0.2), (0, 12),
                          stats.genpareto(0.2, 0.5, 1.5)),
    "GeneralizedPareto-neg": ("GeneralizedPareto", (0.0, 1.0, -0.25),
                              (-0.5, 4.5), stats.genpareto(-0.25, 0, 1)),
    "Kumaraswamy": ("Kumaraswamy", (2.0, 3.0), (-0.1, 1.1), None),
    "VonMises": ("VonMises", (0.5, 2.0), (-3.0, 4.0),
                 stats.vonmises(2.0, loc=0.5)),
    "SymTriangularDist": ("SymTriangularDist", (1.0, 2.0), (-1.5, 3.5),
                          stats.triang(0.5, loc=-1, scale=4)),
    "Cosine": ("Cosine", (1.0, 2.0), (-1.5, 3.5),
               stats.cosine(loc=1.0, scale=2.0 / np.pi)),
    "Epanechnikov": ("Epanechnikov", (1.0, 2.0), (-1.5, 3.5), None),
    "Biweight": ("Biweight", (-0.5, 1.5), (-2.5, 1.5), None),
    "Triweight": ("Triweight", (0.0, 2.0), (-2.5, 2.5), None),
    "JohnsonSU": ("JohnsonSU", (0.5, 2.0, 0.3, 1.5), (-10, 10),
                  stats.johnsonsu(0.3, 1.5, loc=0.5, scale=2.0)),
    "GeneralizedExtremeValue": ("GeneralizedExtremeValue", (0.5, 1.5, 0.2),
                                (-6, 12), stats.genextreme(-0.2, 0.5, 1.5)),
    "GeneralizedExtremeValue-0": ("GeneralizedExtremeValue",
                                  (0.0, 1.0, 0.0), (-4, 8),
                                  stats.genextreme(0.0, 0.0, 1.0)),
    "InverseGaussian": ("InverseGaussian", (2.0, 3.0), (-0.5, 10),
                        stats.invgauss(2.0 / 3.0, scale=3.0)),
    "Chi": ("Chi", (3.0,), (-0.5, 5), stats.chi(3.0)),
    "PGeneralizedGaussian": ("PGeneralizedGaussian", (0.5, 1.5, 3.0),
                             (-3, 4), stats.gennorm(3.0, loc=0.5, scale=1.5)),
    "Rician": ("Rician", (2.0, 1.5), (-0.5, 9),
               stats.rice(2.0 / 1.5, scale=1.5)),
    "Lindley": ("Lindley", (0.7,), (-0.5, 15), None),
    "LogitNormal": ("LogitNormal", (0.4, 0.9), (-0.1, 1.1), None),
    "NoncentralChisq": ("NoncentralChisq", (4.0, 2.5), (-1, 25),
                        stats.ncx2(4.0, 2.5)),
}

DISCRETE = {
    "Bernoulli": ("Bernoulli", (0.3,), _ints(-1, 2), stats.bernoulli(0.3)),
    "Binomial": ("Binomial", (10, 0.4), _ints(-2, 12), stats.binom(10, 0.4)),
    "Geometric": ("Geometric", (0.3,), _ints(-2, 40), stats.geom(0.3,
                                                                 loc=-1)),
    "BetaBinomial": ("BetaBinomial", (10, 2.0, 3.0), _ints(-2, 12),
                     stats.betabinom(10, 2.0, 3.0)),
    "Hypergeometric": ("Hypergeometric", (7, 5, 6), _ints(-1, 8),
                       stats.hypergeom(12, 7, 6)),
    "Skellam": ("Skellam", (2.0, 3.0), _ints(-15, 12),
                stats.skellam(2.0, 3.0)),
    "NegativeBinomial": ("NegativeBinomial", (4.0, 0.3), _ints(-2, 60),
                         stats.nbinom(4.0, 0.3)),
    "Categorical": ("Categorical", ([0.2, 0.5, 0.3],), _ints(-1, 4),
                    stats.rv_discrete(values=([0, 1, 2], [0.2, 0.5, 0.3]))),
    "Dirac": ("Dirac", (3.0,), np.array([2.0, 3.0, 3.5, 4.0]), None),
    "PoissonBinomial": ("PoissonBinomial", ([0.2, 0.5, 0.9],),
                        np.array([-1, 0, 1, 2, 3, 4, 1.5]), None),
}

CONT_NAMES, DISC_NAMES = sorted(CONTINUOUS), sorted(DISCRETE)


@contextlib.contextmanager
def fast_vonmises_ppf():
    """scipy's VonMises quantile by vectorized bisection of its own cdf
    while the JAX package builds its 8193-point table (scipy root-finds
    each point alone, ~30 s a table); ``test_vonmises_table_is_scipys``
    holds the port's table, built the same way, to scipy's ``ppf``."""
    def ppf(self, q, kappa):
        q = np.asarray(q, np.float64)
        lo, hi = np.full(q.shape, -np.pi), np.full(q.shape, np.pi)
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            below = self._cdf(mid, kappa) < q
            lo, hi = np.where(below, mid, lo), np.where(below, hi, mid)
        return 0.5 * (lo + hi)

    with mock.patch.object(type(stats.vonmises), "_ppf", ppf):
        yield


@functools.lru_cache(maxsize=None)
def _pair(name):
    if name in CONTINUOUS:
        fam, args, (lo, hi), twin = CONTINUOUS[name]
        x = _u(name, lo, hi)
    else:
        fam, args, x, twin = DISCRETE[name]
    x = np.asarray(x, np.float32)
    with fast_vonmises_ppf():
        j = getattr(ka, fam)(*args)
    return j, getattr(kt, fam)(*args), x, twin


def _within_ulps(got, want, n=16, scale=1.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[~fin], want[~fin])
    err = np.abs(got[fin] - want[fin])
    scale = np.broadcast_to(scale, want.shape)[fin]
    tol = n * EPS32 * np.maximum(scale, np.abs(want[fin]))
    assert (err <= tol).all(), (err / tol).max()


# the lgamma terms' scale: |lgamma(|x| + c)| for the largest c of a term
_LGAMMA_SHIFT = {"Binomial": 11.0, "BetaBinomial": 13.0,
                 "NegativeBinomial": 4.0, "Skellam": 3.0}


def _scale(name, x):
    x = np.asarray(x, np.float64)
    scale = np.ones_like(x)
    if name in _LGAMMA_SHIFT:
        scale = np.maximum(scale, np.abs(sps.gammaln(
            np.abs(x) + _LGAMMA_SHIFT[name])))
    if name == "Cosine":   # cos's rounding over 1 + cos(pi z)
        z = np.clip((x - 1.0) / 2.0, -1.0, 1.0)
        p1 = np.maximum(1.0 + np.cos(np.pi * z), 1e-37)
        scale = np.maximum(scale, 1.0 / (8.0 * p1))
    return scale


@pytest.mark.parametrize("name", CONT_NAMES + DISC_NAMES)
def test_logpdf_matches_jax(name):
    j, t, x, _ = _pair(name)
    xt = torch.from_numpy(x)
    lp = t.logpdf(xt)
    _within_ulps(lp.numpy(), np.asarray(j.logpdf(jnp.asarray(x))),
                 scale=_scale(name, x))
    assert torch.equal(t.pdf(xt), torch.exp(lp))


_WITH_CDF = [n for n in CONT_NAMES + DISC_NAMES
             if hasattr(_pair(n)[0], "cdf")]


@pytest.mark.parametrize("name", _WITH_CDF)
def test_cdf_sf_quantile_match_jax(name):
    j, t, x, _ = _pair(name)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(t.cdf(xt).numpy(), np.asarray(j.cdf(xj)),
                               atol=4e-6)
    np.testing.assert_allclose(t.sf(xt).numpy(), np.asarray(j.sf(xj)),
                               atol=4e-6)
    np.testing.assert_allclose(torch.exp(t.logsf(xt)).numpy(),
                               np.exp(np.asarray(j.logsf(xj))), atol=4e-6)
    if not hasattr(j, "quantile"):
        return
    q = np.linspace(0.01, 0.99, 99).astype(np.float32)
    got = t.quantile(torch.from_numpy(q)).numpy()
    near = np.abs(got.astype(np.float64) - np.asarray(
        j.quantile(jnp.asarray(q)), np.float64)) <= 4e-6
    # a bisection's answer moves by the cdf's last ulp over the density,
    # so where float32 cannot place it within 4e-6 (Levy's 0.99 quantile
    # is 2387) JAX's cdf at the port's quantile is held to q instead
    back = np.abs(np.asarray(j.cdf(jnp.asarray(got)), np.float64) - q)
    assert (near | (back <= 4e-6)).all(), name


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


_KS_N = 20000


@pytest.mark.parametrize("name", CONT_NAMES)
def test_continuous_sampling_ks(name):
    j, t, _, twin = _pair(name)
    x = t.sample(_gen(1), (_KS_N,))
    assert x.dtype == torch.float32 and x.shape == (_KS_N,)
    xs = x.numpy().astype(np.float64)
    assert np.isfinite(xs).all()
    # families without a scipy twin: their own (JAX-checked) cdf
    cdf = twin.cdf if twin is not None else (
        lambda v: t.cdf(torch.from_numpy(np.asarray(v, np.float32)))
        .numpy().astype(np.float64))
    d = stats.kstest(xs, cdf).statistic
    assert d < 1.95 / np.sqrt(_KS_N), (name, d)


@pytest.mark.parametrize("name", DISC_NAMES)
def test_discrete_sampling_pmf(name):
    j, t, x, twin = _pair(name)
    n = 40000
    s = t.sample(_gen(2), (n,))
    assert s.dtype == torch.int32 or name == "Dirac", s.dtype
    v = s.numpy().astype(np.int64)
    ks = np.arange(v.min() - 1, v.max() + 2)
    pmf = (twin.pmf(ks) if twin is not None else
           np.exp(t.logpdf(torch.from_numpy(ks.astype(np.float32))).numpy()
                  .astype(np.float64)))
    emp = np.array([(v == k).mean() for k in ks])
    sel = pmf >= 1e-3
    se = np.sqrt(pmf * (1 - pmf) / n) + 1e-12
    assert (np.abs(emp - pmf)[sel] <= 5 * se[sel] + 1e-9).all(), name
    assert emp[~sel].sum() < 0.01


@pytest.mark.parametrize("name", DISC_NAMES)
def test_discrete_push(name):
    _, t, _, _ = _pair(name)
    v = torch.tensor([2.5, 3.5, -0.5, 0.49, 1.51])
    p = t.push(v)
    if name == "Dirac":
        assert torch.equal(p, torch.full((5,), 3, dtype=torch.int32))
        assert kt.Dirac(1.5).push(v).dtype == torch.float32
    else:   # round half to even, as jnp.round
        assert p.dtype == torch.int32
        assert p.tolist() == [2, 4, 0, 0, 2]


@pytest.mark.parametrize("name", CONT_NAMES)
def test_continuous_push_is_float32_identity(name):
    _, t, x, _ = _pair(name)
    v = torch.from_numpy(x)
    assert torch.equal(t.push(v), v) and t.push(v).dtype == torch.float32


@pytest.mark.parametrize("name", CONT_NAMES + DISC_NAMES)
def test_draws_take_only_the_given_generator(name):
    _, t, _, _ = _pair(name)
    torch.manual_seed(123)
    before = torch.get_rng_state()
    a = t.sample(_gen(5), (64,))
    assert torch.equal(torch.get_rng_state(), before)
    b = t.sample(_gen(5), (64,))
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", CONT_NAMES + DISC_NAMES)
def test_prior_from_numpy_builds_each_family(name):
    fam, args = (CONTINUOUS.get(name) or DISCRETE[name])[:2]
    _, t, x, _ = _pair(name)
    keys = {"Beta": ("alpha", "beta"), "LogNormal": ("mu", "sigma"),
            "Laplace": ("mu", "sigma"), "Cauchy": ("mu", "sigma"),
            "Weibull": ("alpha", "theta"), "Chisq": ("nu",),
            "FDist": ("nu1", "nu2"), "Logistic": ("mu", "theta"),
            "Rayleigh": ("sigma",), "Pareto": ("alpha", "theta"),
            "InverseGamma": ("alpha", "theta"), "Gumbel": ("mu", "theta"),
            "TriangularDist": ("a", "b", "c"), "Arcsine": ("a", "b"),
            "Semicircle": ("r",), "Frechet": ("alpha", "theta"),
            "Levy": ("mu", "sigma"),
            "GeneralizedPareto": ("mu", "sigma", "xi"),
            "Kumaraswamy": ("a", "b"), "VonMises": ("mu", "kappa"),
            "SymTriangularDist": ("mu", "sigma"), "Cosine": ("mu", "sigma"),
            "Epanechnikov": ("mu", "sigma"), "Biweight": ("mu", "sigma"),
            "Triweight": ("mu", "sigma"),
            "JohnsonSU": ("xi", "lam", "gamma", "delta"),
            "GeneralizedExtremeValue": ("mu", "sigma", "xi"),
            "InverseGaussian": ("mu", "lam"), "Chi": ("nu",),
            "PGeneralizedGaussian": ("mu", "alpha", "p"),
            "Rician": ("nu", "sigma"), "Lindley": ("theta",),
            "LogitNormal": ("mu", "sigma"),
            "NoncentralChisq": ("nu", "lam"), "Bernoulli": ("p",),
            "Binomial": ("n", "p"), "Geometric": ("p",),
            "BetaBinomial": ("n", "alpha", "beta"),
            "Hypergeometric": ("s", "f", "n"), "Skellam": ("mu1", "mu2"),
            "NegativeBinomial": ("r", "p"), "Categorical": ("p",),
            "Dirac": ("value",), "PoissonBinomial": ("ps",)}[fam]
    built = convert.prior_from_numpy(
        ("Factored", [(fam, dict(zip(keys, args))),
                      ("Uniform", {"a": 0, "b": 1})]))
    assert type(built.p[0]) is type(t)
    xt = torch.from_numpy(x)
    assert torch.equal(built.p[0].logpdf(xt), t.logpdf(xt))


def test_constructors_and_truncated_discrete_bases():
    g = kt.Erlang(3, 2.0)
    assert type(g) is kt.Gamma and float(g.alpha) == 3.0
    with pytest.raises(ValueError):
        kt.Erlang(2.5)
    n = kt.NormalCanon(2.0, 4.0)
    assert type(n) is kt.Normal and float(n.mu) == 0.5 \
        and float(n.sigma) == 0.5
    # every discrete family with a host pmf truncates to a table
    for fam, args in (("Binomial", (10, 0.4)), ("Geometric", (0.3,)),
                      ("NegativeBinomial", (4.0, 0.3)),
                      ("Bernoulli", (0.3,)), ("BetaBinomial", (10, 2., 3.)),
                      ("Hypergeometric", (7, 5, 6)),
                      ("Skellam", (2.0, 3.0))):
        lo, hi = (0, 1) if fam == "Bernoulli" else (1, 4)
        tt = kt.Truncated(getattr(kt, fam)(*args), lo, hi)
        tj = ka.Truncated(getattr(ka, fam)(*args), lo, hi)
        assert type(tt).__name__ == "TruncatedDiscrete"
        x = np.arange(-1, 6, dtype=np.float32)
        _within_ulps(tt.logpdf(torch.from_numpy(x)).numpy(),
                     np.asarray(tj.logpdf(jnp.asarray(x))))
    # a continuous new base truncates through the twin registry
    tt = kt.Truncated(kt.Gumbel(0.0, 1.0), -1.0, 2.0)
    tj = ka.Truncated(ka.Gumbel(0.0, 1.0), -1.0, 2.0)
    x = np.linspace(-2, 3, 101).astype(np.float32)
    _within_ulps(tt.logpdf(torch.from_numpy(x)).numpy(),
                 np.asarray(tj.logpdf(jnp.asarray(x))))
    np.testing.assert_allclose(tt.cdf(torch.from_numpy(x)).numpy(),
                               np.asarray(tj.cdf(jnp.asarray(x))), atol=4e-6)


def test_hypergeometric_closed_form_matches_its_table():
    """The closed form that the generic kernels' prior entry compiles
    equals the pmf table at every integer of the support, and is -inf
    outside it, as the table is."""
    for s, f, n in ((7, 5, 6), (30, 20, 12), (3, 40, 10)):
        d = kt.Hypergeometric(s, f, n)
        x = torch.arange(-2, n + 3, dtype=torch.float32)
        want, got = d.logpdf(x), d.logpdf_closed(x)
        fin = torch.isfinite(want)
        assert torch.equal(torch.isfinite(got), fin)
        assert (got[fin] - want[fin]).abs().max() < 1e-5 * max(
            1.0, float(want[fin].abs().max()))


def test_vonmises_table_is_scipys():
    """The port's VonMises table equals scipy's ``ppf`` in float32 at 85
    interior points (the ends are mu -/+ pi, as the JAX package sets)."""
    d = kt.VonMises(0.5, 2.0)
    idx = np.arange(1, d._TAB - 1, 97)
    want = stats.vonmises(2.0, loc=0.5).ppf(
        np.linspace(0.0, 1.0, d._TAB)[idx]).astype(np.float32)
    assert np.array_equal(d._tab[idx], want)
    assert d._tab[0] == np.float32(0.5 - np.pi)
    assert d._tab[-1] == np.float32(0.5 + np.pi)
