"""Distributions.jl's functional statistics surface for the port:
``mean(d)``, ``var(d)``, ``std(d)``, ``mode(d)``, ``entropy(d)``,
``insupport(d, x)``, ``minimum(d)``/``maximum(d)``, ``cov(d)``,
``params(d)`` and the pointwise ``cdf``/``ccdf``/``logcdf``/
``logccdf``/``pdf``/``logpdf``/``quantile``/``cquantile``; the
counterpart of ``kissabc_tpu/statistics.py``, with the same dispatch.

The reference re-exports all of Distributions.jl, so its users call
these free functions on priors (``mean(prior)``, ``std(d)``,
``insupport(d, x)``). Scalar statistics are host floats from numpy and
scipy (derived constants of the host parameters); the pointwise
functions take a tensor ``x`` and return tensors on its device.
``rand(d, shape, key=...)`` draws from a ``torch.Generator`` seeded by
``key`` on the device the caller names.

Dispatch: an override table for the families scipy lacks (or whose
scipy conventions differ from Distributions.jl's), then the scipy
frozen twin (``_twin``, the one registry: ``Truncated``'s host cdf and
survival function reach it too). Kurtosis is EXCESS kurtosis (both
Distributions.jl and scipy 'k').

The vector and matrix families (``MvNormal``, ``Dirichlet``,
``Product``, ``Multinomial``, ``MvLogNormal``, ``MvTDist``, ``Wishart``,
``InverseWishart``, ``LKJ``) have the JAX package's branches: host numpy
moments, ``insupport`` on tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import distributions as D
from .particles import Particles
from .utils.device import resolve_device
from .utils.rng import as_generator

__all__ = [
    "mean", "var", "std", "median", "mode", "skewness", "kurtosis",
    "entropy", "minimum", "maximum", "insupport", "cov", "params",
    "cdf", "ccdf", "logcdf", "logccdf", "pdf", "logpdf",
    "quantile", "cquantile", "fit", "fit_mle",
    "support", "truncated", "product_distribution", "cor",
    "loglikelihood", "rand",
]


# --------------------------------------------------------------------------
# scipy frozen twins (host): the continuous chain and the discrete table
# TruncatedDiscrete tabulates from (distributions._host_frozen)
# --------------------------------------------------------------------------

def _twin(d):
    """scipy.stats frozen twin of a univariate family, or None."""
    from scipy import stats as st
    if isinstance(d, D.Normal):
        return st.norm(float(d.mu), float(d.sigma))
    if isinstance(d, D.Uniform):
        return st.uniform(float(d.a), float(d.b) - float(d.a))
    if isinstance(d, D.Exponential):
        return st.expon(scale=float(d.theta))
    if isinstance(d, D.Beta):
        return st.beta(float(d.alpha), float(d.beta))
    if isinstance(d, D.Gamma):
        return st.gamma(float(d.alpha), scale=float(d.theta))
    if isinstance(d, D.LogNormal):
        return st.lognorm(float(d.sigma), scale=math.exp(float(d.mu)))
    if isinstance(d, D.Laplace):
        return st.laplace(float(d.mu), float(d.sigma))
    if isinstance(d, D.Cauchy):
        return st.cauchy(float(d.mu), float(d.sigma))
    if isinstance(d, D.StudentT):
        return st.t(float(d.nu))
    if isinstance(d, D.Weibull):
        return st.weibull_min(float(d.alpha), scale=float(d.theta))
    if isinstance(d, D.Chisq):
        return st.chi2(float(d.nu))
    if isinstance(d, D.Chi):
        return st.chi(float(d.nu))
    if isinstance(d, D.NoncentralChisq):
        return st.ncx2(float(d.nu), float(d.lam))
    if isinstance(d, D.FDist):
        return st.f(float(d.nu1), float(d.nu2))
    if isinstance(d, D.Logistic):
        return st.logistic(float(d.mu), float(d.theta))
    if isinstance(d, D.Rayleigh):
        return st.rayleigh(scale=float(d.sigma))
    if isinstance(d, D.Pareto):
        return st.pareto(float(d.alpha), scale=float(d.theta))
    if isinstance(d, D.GeneralizedPareto):
        return st.genpareto(float(d.xi), loc=float(d.mu),
                            scale=float(d.sigma))
    if isinstance(d, D.GeneralizedExtremeValue):
        return st.genextreme(-float(d.xi), loc=float(d.mu),
                             scale=float(d.sigma))
    if isinstance(d, D.InverseGamma):
        return st.invgamma(float(d.alpha), scale=float(d.theta))
    if isinstance(d, D.InverseGaussian):
        return st.invgauss(float(d.mu) / float(d.lam), scale=float(d.lam))
    if isinstance(d, D.Gumbel):
        return st.gumbel_r(float(d.mu), float(d.theta))
    if isinstance(d, D.TriangularDist):
        a, b, c = float(d.a), float(d.b), float(d.c)
        return st.triang((c - a) / (b - a), loc=a, scale=b - a)
    if isinstance(d, D.SymTriangularDist):
        mu, s = float(d.mu), float(d.sigma)
        return st.triang(0.5, loc=mu - s, scale=2.0 * s)
    if isinstance(d, D.Cosine):
        return st.cosine(loc=float(d.mu), scale=float(d.sigma) / math.pi)
    if isinstance(d, D.Arcsine):
        return st.arcsine(loc=float(d.a), scale=float(d.b) - float(d.a))
    if isinstance(d, D.Semicircle):
        return st.semicircular(scale=float(d.r))
    if isinstance(d, D.Frechet):
        return st.invweibull(float(d.alpha), scale=float(d.theta))
    if isinstance(d, D.Levy):
        return st.levy(float(d.mu), float(d.sigma))
    if isinstance(d, D.LogUniform):
        return st.loguniform(float(d.a), float(d.b))
    if isinstance(d, D.JohnsonSU):
        return st.johnsonsu(float(d.gamma), float(d.delta),
                            loc=float(d.xi), scale=float(d.lam))
    if isinstance(d, D.BetaPrime):
        return st.betaprime(float(d.alpha), float(d.beta))
    if isinstance(d, D.PGeneralizedGaussian):
        return st.gennorm(float(d.p), loc=float(d.mu),
                          scale=float(d.alpha))
    if isinstance(d, D.Rician):
        sg = float(d.sigma)
        return st.rice(float(d.nu) / sg, scale=sg)
    if isinstance(d, D.VonMises):
        # mean/var/median/mode/entropy/min/max have circular overrides
        # that shadow this twin; it serves Truncated's host normalizer
        # and the other twin-backed statistics
        return st.vonmises(float(d.kappa), loc=float(d.mu))
    if isinstance(d, D.Categorical):
        p = np.asarray(d.p, np.float64)
        return st.rv_discrete(values=(np.arange(p.shape[0]), p / p.sum()))
    if isinstance(d, D.Poisson):
        return st.poisson(float(d.lam))
    try:   # the discrete table TruncatedDiscrete already keeps
        return D._host_frozen(d)
    except TypeError:
        return None


# --------------------------------------------------------------------------
# override helpers for families scipy lacks
# --------------------------------------------------------------------------

def _kuma_raw(d, k):
    from scipy import special as sp
    a, b = float(d.a), float(d.b)
    return b * sp.beta(1.0 + k / a, b)


def _lindley_moments(d):
    th = float(d.theta)
    m1 = (th + 2.0) / (th * (th + 1.0))
    m2 = 2.0 * (th + 3.0) / (th * th * (th + 1.0))
    return m1, m2 - m1 * m1


def _logitnormal_raw(d, k):
    from scipy import integrate, special as sp, stats as st
    mu, sg = float(d.mu), float(d.sigma)

    def f(z):
        return sp.expit(mu + sg * z) ** k * st.norm.pdf(z)

    return integrate.quad(f, -np.inf, np.inf)[0]


def _vm_i_ratio(d):
    from scipy import special as sp
    k = float(d.kappa)
    return float(sp.i1e(k) / sp.i0e(k))


def _atoms(d):
    """(atoms, probs) in float64 for finite-support discrete families."""
    if isinstance(d, D.TruncatedDiscrete):
        ks = np.arange(d._klo, d._khi + 1, dtype=np.float64)
        p = np.exp(np.asarray(d._logpmf, np.float64))
    elif isinstance(d, D.DiscreteNonParametric):
        ks = np.asarray(d.xs, np.float64)
        p = np.asarray(d.ps, np.float64)
    elif isinstance(d, D.PoissonBinomial):
        p = np.exp(np.asarray(d._lpmf, np.float64))
        ks = np.arange(p.shape[0], dtype=np.float64)
    elif isinstance(d, D.Categorical):
        p = np.asarray(d.p, np.float64)
        ks = np.arange(p.shape[0], dtype=np.float64)
    else:
        raise TypeError(type(d).__name__)
    return ks, p / p.sum()


_ATOMIC = (D.TruncatedDiscrete, D.DiscreteNonParametric, D.PoissonBinomial)


def _atom_stat(d, which):
    ks, p = _atoms(d)
    m = float(np.sum(ks * p))
    if which == "mean":
        return m
    if which == "var":
        return float(np.sum((ks - m) ** 2 * p))
    if which == "median":
        return float(ks[np.searchsorted(np.cumsum(p), 0.5)])
    if which == "mode":
        return float(ks[int(np.argmax(p))])
    if which == "entropy":
        pz = p[p > 0]
        return float(-np.sum(pz * np.log(pz)))
    if which == "minimum":
        return float(ks[0])
    if which == "maximum":
        return float(ks[-1])
    raise KeyError(which)


def _trunc_window(d):
    """Integration window of a continuous Truncated: the user's [lo, hi]
    intersected with the base support. Only an infinite endpoint is
    replaced (by the 1e-13 effective quantile, where that drops a
    negligible share of the window's own mass), so far-tail windows like
    Truncated(Normal(0,1), 8, 9) stay exact; the window mass takes the
    tail form that keeps float64 precision (sf differences in the upper
    tail, as ``Truncated.__init__``)."""
    t = _twin(d.base)
    if t is None:
        raise NotImplementedError(
            f"statistics of Truncated({type(d.base).__name__}, ...) need "
            "a scipy twin of the base")
    lo, hi = float(d.lo), float(d.hi)
    slo, shi = t.support()
    if np.isfinite(slo):
        lo = max(lo, slo)
    if np.isfinite(shi):
        hi = min(hi, shi)
    clo = float(t.cdf(lo))
    mass = (float(t.sf(lo) - t.sf(hi)) if clo > 0.5
            else float(t.cdf(hi) - clo))
    if not mass > 0.0:
        raise ValueError(
            f"statistics of {d!r}: the truncation window has zero "
            "probability mass in float64")
    # a very wide window starves Gauss-Kronrod (its first nodes all land
    # where the pdf is 0): shrink a side to the 1e-13 quantile only when
    # that drops a negligible share of the window's own mass
    glo, ghi = lo, hi
    qlo, qhi = float(t.ppf(1e-13)), float(t.isf(1e-13))
    if qlo > lo and float(t.cdf(qlo)) - clo < 1e-9 * mass:
        glo = qlo
    if qhi < hi and float(t.sf(qhi) - t.sf(hi)) < 1e-9 * mass:
        ghi = qhi
    return t, glo, ghi, mass, clo


def _trunc_quad(d, g):
    from scipy import integrate
    t, lo, hi, mass, _ = _trunc_window(d)
    val = integrate.quad(lambda x: g(x) * t.pdf(x), lo, hi, limit=200)[0]
    return val / mass


def _trunc_entropy(d):
    from scipy import integrate
    t, lo, hi, mass, _ = _trunc_window(d)

    def h(x):
        f = t.pdf(x) / mass
        return -f * np.log(np.maximum(f, 1e-300))

    return float(integrate.quad(h, lo, hi, limit=200)[0])


def _mix_mean_var(d):
    w = np.asarray(d.weights, np.float64)
    ms = np.array([mean(c) for c in d.components])
    vs = np.array([var(c) for c in d.components])
    m = float(np.sum(w * ms))
    return m, float(np.sum(w * (vs + ms * ms)) - m * m)


def _poly_m(d):
    return {D.Epanechnikov: 1, D.Biweight: 2, D.Triweight: 3}[type(d)]


def _mvn_entropy(cov):
    c = np.asarray(cov, np.float64)
    k = c.shape[0]
    _, ld = np.linalg.slogdet(c)
    return float(0.5 * (k * (1.0 + math.log(2.0 * math.pi)) + ld))


def _dirichlet_cov(d):
    a = np.asarray(d.alpha, np.float64)
    a0 = a.sum()
    ab = a / a0
    return (np.diag(ab) - np.outer(ab, ab)) / (a0 + 1.0)


# --------------------------------------------------------------------------
# the functional surface
# --------------------------------------------------------------------------

def _is_cloud(d):
    return isinstance(d, (Particles, np.ndarray, list, tuple)) and \
        not isinstance(d, D.Distribution)


def _particles_list(d):
    """A tuple/list of Particles is a multivariate cloud (what the
    samplers return for d > 1): statistics map per component."""
    return (isinstance(d, (tuple, list)) and len(d) > 0
            and all(isinstance(p, Particles) for p in d))


def mean(d):
    """Distributions.jl ``mean(d)`` (also of a Particles cloud; a
    tuple/list of Particles gives the per-component mean vector)."""
    if isinstance(d, Particles):
        return d.mean()
    if _particles_list(d):
        return np.array([p.mean() for p in d])
    if _is_cloud(d):
        return float(np.mean(np.asarray(d)))
    if isinstance(d, D.Factored):
        return tuple(mean(m) for m in d.p)
    if isinstance(d, D.Product):
        return np.array([mean(m) for m in d.dists])
    if isinstance(d, D.MvNormal):
        return np.asarray(d.mean, np.float64)
    if isinstance(d, D.MvLogNormal):
        n = d.normal
        mu = np.asarray(n.mean, np.float64)
        s2 = np.diag(np.asarray(n.cov, np.float64))
        return np.exp(mu + 0.5 * s2)
    if isinstance(d, D.MvTDist):
        mu = np.asarray(d.mean, np.float64)
        return mu if float(d.df) > 1 else np.full_like(mu, np.nan)
    if isinstance(d, D.Dirichlet):
        a = np.asarray(d.alpha, np.float64)
        return a / a.sum()
    if isinstance(d, D.Multinomial):
        return float(d.n) * np.asarray(d.p, np.float64)
    if isinstance(d, D.Wishart):
        return float(d.df) * np.asarray(d.S, np.float64)
    if isinstance(d, D.InverseWishart):
        psi = np.asarray(d.Psi, np.float64)
        den = float(d.df) - psi.shape[0] - 1.0
        if den > 0:
            return psi / den
        raise NotImplementedError("mean(InverseWishart) needs df > d + 1")
    if isinstance(d, D.LKJ):
        return np.eye(int(d.d))
    if isinstance(d, D.Dirac):
        return float(d.value)
    if isinstance(d, D.Mixture):
        return _mix_mean_var(d)[0]
    if isinstance(d, D.Affine):
        return float(d.loc) + float(d.scale) * mean(d.base)
    if isinstance(d, D.Truncated):
        return _trunc_quad(d, lambda x: x)
    if isinstance(d, _ATOMIC):
        return _atom_stat(d, "mean")
    if isinstance(d, D.Kumaraswamy):
        return _kuma_raw(d, 1.0)
    if isinstance(d, D.Lindley):
        return _lindley_moments(d)[0]
    if isinstance(d, D.LogitNormal):
        return _logitnormal_raw(d, 1.0)
    if isinstance(d, (D.VonMises, D._PolyKernel)):
        return float(d.mu)
    t = _twin(d)
    if t is not None:
        return float(t.mean())
    raise NotImplementedError(f"mean({type(d).__name__})")


def var(d):
    """Distributions.jl ``var(d)``. VonMises gives the circular variance
    1 - I1(k)/I0(k) (Distributions.jl semantics)."""
    if isinstance(d, Particles):
        return d.std() ** 2
    if _particles_list(d):
        return np.array([p.std() ** 2 for p in d])
    if _is_cloud(d):
        return float(np.var(np.asarray(d), ddof=1))
    if isinstance(d, D.Factored):
        return tuple(var(m) for m in d.p)
    if isinstance(d, D.Product):
        return np.array([var(m) for m in d.dists])
    if isinstance(d, (D.MvNormal, D.MvLogNormal, D.MvTDist, D.Dirichlet,
                      D.Multinomial)):
        return np.diag(cov(d)).copy()
    if isinstance(d, D.Dirac):
        return 0.0
    if isinstance(d, D.Mixture):
        return _mix_mean_var(d)[1]
    if isinstance(d, D.Affine):
        return float(d.scale) ** 2 * var(d.base)
    if isinstance(d, D.Truncated):
        m = _trunc_quad(d, lambda x: x)
        return _trunc_quad(d, lambda x: (x - m) ** 2)
    if isinstance(d, _ATOMIC):
        return _atom_stat(d, "var")
    if isinstance(d, D.Kumaraswamy):
        m1 = _kuma_raw(d, 1.0)
        return _kuma_raw(d, 2.0) - m1 * m1
    if isinstance(d, D.Lindley):
        return _lindley_moments(d)[1]
    if isinstance(d, D.LogitNormal):
        m1 = _logitnormal_raw(d, 1.0)
        return _logitnormal_raw(d, 2.0) - m1 * m1
    if isinstance(d, D.VonMises):
        return 1.0 - _vm_i_ratio(d)
    if isinstance(d, D._PolyKernel):
        return float(d.sigma) ** 2 / (2.0 * _poly_m(d) + 3.0)
    t = _twin(d)
    if t is not None:
        return float(t.var())
    raise NotImplementedError(f"var({type(d).__name__})")


def std(d):
    v = var(d)
    if isinstance(v, tuple):
        return tuple(math.sqrt(x) for x in v)
    return np.sqrt(v)


def cov(d):
    """Covariance matrix of a vector-variate distribution (also of a
    Particles tuple/list, through ``particles.pcov``)."""
    if _particles_list(d):
        from .particles import pcov
        return pcov(d)
    if isinstance(d, D.MvNormal):
        return np.asarray(d.cov, np.float64)
    if isinstance(d, D.MvLogNormal):
        sig = np.asarray(d.normal.cov, np.float64)
        m = mean(d)
        return np.outer(m, m) * np.expm1(sig)
    if isinstance(d, D.MvTDist):
        df = float(d.df)
        if df <= 2:
            raise NotImplementedError("cov(MvTDist) needs df > 2")
        return df / (df - 2.0) * np.asarray(d.cov, np.float64)
    if isinstance(d, D.Dirichlet):
        return _dirichlet_cov(d)
    if isinstance(d, D.Multinomial):
        p = np.asarray(d.p, np.float64)
        return float(d.n) * (np.diag(p) - np.outer(p, p))
    if isinstance(d, D.Product):
        return np.diag([var(m) for m in d.dists])
    raise NotImplementedError(f"cov({type(d).__name__})")


def median(d):
    if isinstance(d, Particles):
        return d.median()
    if _particles_list(d):
        return np.array([p.median() for p in d])
    if _is_cloud(d):
        return float(np.median(np.asarray(d)))
    if isinstance(d, D.Factored):
        return tuple(median(m) for m in d.p)
    if isinstance(d, D.Dirac):
        return float(d.value)
    if isinstance(d, D.Affine):
        return float(d.loc) + float(d.scale) * median(d.base)
    if isinstance(d, D.Truncated):
        t, lo, hi, mass, clo = _trunc_window(d)
        if clo > 0.5:   # a far-upper window: invert in sf space
            return float(t.isf(float(t.sf(lo)) - 0.5 * mass))
        return float(t.ppf(clo + 0.5 * mass))
    if isinstance(d, _ATOMIC):
        return _atom_stat(d, "median")
    if isinstance(d, D.Kumaraswamy):
        a, b = float(d.a), float(d.b)
        return (1.0 - 2.0 ** (-1.0 / b)) ** (1.0 / a)
    if isinstance(d, D.LogitNormal):
        return 1.0 / (1.0 + math.exp(-float(d.mu)))
    if isinstance(d, (D.VonMises, D._PolyKernel)):
        return float(d.mu)
    t = _twin(d)
    if t is not None:
        return float(t.median())
    raise NotImplementedError(f"median({type(d).__name__})")


_MODES = {
    D.Normal: lambda d: float(d.mu),
    D.LogNormal: lambda d: math.exp(float(d.mu) - float(d.sigma) ** 2),
    D.Exponential: lambda d: 0.0,
    D.Cauchy: lambda d: float(d.mu),
    D.Laplace: lambda d: float(d.mu),
    D.Logistic: lambda d: float(d.mu),
    D.StudentT: lambda d: 0.0,
    D.Gumbel: lambda d: float(d.mu),
    D.Rayleigh: lambda d: float(d.sigma),
    D.Pareto: lambda d: float(d.theta),
    D.TriangularDist: lambda d: float(d.c),
    D.SymTriangularDist: lambda d: float(d.mu),
    D.Cosine: lambda d: float(d.mu),
    D.VonMises: lambda d: float(d.mu),
    D.Levy: lambda d: float(d.mu) + float(d.sigma) / 3.0,
    D.Semicircle: lambda d: 0.0,
    D.Poisson: lambda d: float(math.floor(float(d.lam))),
    D.Dirac: lambda d: float(d.value),
}


def mode(d):
    f = _MODES.get(type(d))
    if f is not None:
        return f(d)
    if isinstance(d, D._PolyKernel):
        return float(d.mu)
    if isinstance(d, D.Gamma):
        a, th = float(d.alpha), float(d.theta)
        return (a - 1.0) * th if a >= 1 else 0.0
    if isinstance(d, D.Beta):
        a, b = float(d.alpha), float(d.beta)
        if a > 1 and b > 1:
            return (a - 1.0) / (a + b - 2.0)
        raise NotImplementedError("mode(Beta) needs alpha, beta > 1")
    if isinstance(d, D.Weibull):
        a, th = float(d.alpha), float(d.theta)
        return th * ((a - 1.0) / a) ** (1.0 / a) if a > 1 else 0.0
    if isinstance(d, D.Frechet):
        a, th = float(d.alpha), float(d.theta)
        return th * (a / (1.0 + a)) ** (1.0 / a)
    if isinstance(d, D.Binomial):
        return float(math.floor((float(d.n) + 1) * float(d.p)))
    if isinstance(d, D.Kumaraswamy):
        a, b = float(d.a), float(d.b)
        if a >= 1 and b >= 1 and (a > 1 or b > 1):
            return ((a - 1.0) / (a * b - 1.0)) ** (1.0 / a)
        raise NotImplementedError("mode(Kumaraswamy) needs a, b >= 1")
    if isinstance(d, D.Lindley):
        th = float(d.theta)
        return (1.0 - th) / th if th < 1 else 0.0
    if isinstance(d, D.Affine):
        return float(d.loc) + float(d.scale) * mode(d.base)
    if isinstance(d, _ATOMIC + (D.Categorical,)):
        return _atom_stat(d, "mode")
    if isinstance(d, D.MvNormal):
        return np.asarray(d.mean, np.float64)
    if isinstance(d, D.Dirichlet):
        a = np.asarray(d.alpha, np.float64)
        if np.all(a > 1):
            return (a - 1.0) / (a.sum() - a.shape[0])
        raise NotImplementedError("mode(Dirichlet) needs all alpha > 1")
    if isinstance(d, D.Wishart):
        den = float(d.df) - np.asarray(d.S).shape[0] - 1.0
        if den >= 0:
            return den * np.asarray(d.S, np.float64)
        raise NotImplementedError("mode(Wishart) needs df >= d + 1")
    if isinstance(d, D.InverseWishart):
        psi = np.asarray(d.Psi, np.float64)
        return psi / (float(d.df) + psi.shape[0] + 1.0)
    raise NotImplementedError(f"mode({type(d).__name__})")


def _atom_moment(d, k):
    ks, p = _atoms(d)
    m = np.sum(ks * p)
    s2 = np.sum((ks - m) ** 2 * p)
    return float(np.sum((ks - m) ** k * p) / s2 ** (k / 2))


def skewness(d):
    if isinstance(d, D.Frechet) and float(d.alpha) <= 3.0:
        # scipy's invweibull evaluates Gamma(1 - 3/a) blindly, a finite
        # number where the 3rd moment diverges
        return np.inf
    if isinstance(d, D.Affine):
        return math.copysign(1.0, float(d.scale)) * skewness(d.base)
    if isinstance(d, (D._PolyKernel, D.SymTriangularDist, D.Cosine,
                      D.Dirac)):
        return 0.0
    if isinstance(d, _ATOMIC):
        return _atom_moment(d, 3)
    t = _twin(d)
    if t is not None:
        return float(t.stats(moments="s"))
    raise NotImplementedError(f"skewness({type(d).__name__})")


def kurtosis(d):
    """EXCESS kurtosis (Distributions.jl and scipy convention)."""
    if isinstance(d, D.Frechet) and float(d.alpha) <= 4.0:
        return np.inf   # the 4th moment diverges; see skewness
    if isinstance(d, D.Affine):
        return kurtosis(d.base)
    if isinstance(d, D.Dirac):
        return 0.0
    if isinstance(d, _ATOMIC):
        return _atom_moment(d, 4) - 3.0
    t = _twin(d)
    if t is not None:
        return float(t.stats(moments="k"))
    raise NotImplementedError(f"kurtosis({type(d).__name__})")


def entropy(d):
    """Differential entropy in nats (Shannon entropy for discrete)."""
    if isinstance(d, D.Factored):
        return float(sum(entropy(m) for m in d.p))
    if isinstance(d, D.Product):
        return float(sum(entropy(m) for m in d.dists))
    if isinstance(d, D.MvNormal):
        return _mvn_entropy(d.cov)
    if isinstance(d, D.Dirac):
        return 0.0
    if isinstance(d, D.Affine):
        return entropy(d.base) + math.log(abs(float(d.scale)))
    if isinstance(d, D.Truncated):
        return _trunc_entropy(d)
    if isinstance(d, _ATOMIC + (D.Categorical,)):
        return _atom_stat(d, "entropy")
    if isinstance(d, D.VonMises):
        from scipy import special as sp
        k = float(d.kappa)
        l2pi0 = math.log(2.0 * math.pi * sp.i0e(k)) + k
        return l2pi0 - k * _vm_i_ratio(d)
    t = _twin(d)
    if t is not None:
        return float(t.entropy())
    raise NotImplementedError(f"entropy({type(d).__name__})")


def minimum(d):
    """Lower end of the support (Distributions.jl ``minimum(d)``)."""
    if isinstance(d, D.Factored):
        return tuple(minimum(m) for m in d.p)
    if isinstance(d, D.Dirac):
        return float(d.value)
    if isinstance(d, D.Affine):
        s = float(d.scale)
        lo, hi = minimum(d.base), maximum(d.base)
        return float(d.loc) + s * (lo if s > 0 else hi)
    if isinstance(d, D.Truncated):
        t = _twin(d.base)
        slo = float(t.support()[0]) if t is not None else -np.inf
        return max(float(d.lo), slo)
    if isinstance(d, _ATOMIC + (D.Categorical,)):
        return _atom_stat(d, "minimum")
    if isinstance(d, D.Mixture):
        return min(minimum(c) for c in d.components)
    if isinstance(d, (D.Kumaraswamy, D.LogitNormal, D.Lindley)):
        return 0.0
    if isinstance(d, D.VonMises):
        return float(d.mu) - math.pi
    if isinstance(d, D._PolyKernel):
        return float(d.mu) - float(d.sigma)
    t = _twin(d)
    if t is not None:
        return float(t.support()[0])
    raise NotImplementedError(f"minimum({type(d).__name__})")


def maximum(d):
    """Upper end of the support (Distributions.jl ``maximum(d)``)."""
    if isinstance(d, D.Factored):
        return tuple(maximum(m) for m in d.p)
    if isinstance(d, D.Dirac):
        return float(d.value)
    if isinstance(d, D.Affine):
        s = float(d.scale)
        lo, hi = minimum(d.base), maximum(d.base)
        return float(d.loc) + s * (hi if s > 0 else lo)
    if isinstance(d, D.Truncated):
        t = _twin(d.base)
        shi = float(t.support()[1]) if t is not None else np.inf
        return min(float(d.hi), shi)
    if isinstance(d, _ATOMIC + (D.Categorical,)):
        return _atom_stat(d, "maximum")
    if isinstance(d, D.Mixture):
        return max(maximum(c) for c in d.components)
    if isinstance(d, (D.Kumaraswamy, D.LogitNormal)):
        return 1.0
    if isinstance(d, D.Lindley):
        return np.inf
    if isinstance(d, D.VonMises):
        return float(d.mu) + math.pi
    if isinstance(d, D._PolyKernel):
        return float(d.mu) + float(d.sigma)
    t = _twin(d)
    if t is not None:
        return float(t.support()[1])
    raise NotImplementedError(f"maximum({type(d).__name__})")


def _f32_tensor(x):
    return torch.as_tensor(x).to(torch.float32)


def insupport(d, x):
    """Distributions.jl ``insupport(d, x)``: a boolean tensor on ``x``'s
    device. Interval semantics (closed support bounds); a discrete family
    also needs ``x`` to hit an atom."""
    if isinstance(d, D.Factored):
        out = None
        for m, xi in zip(d.p, x):
            f = insupport(m, xi)
            out = f if out is None else out & f
        return out
    if isinstance(d, D.Product):
        out = None
        for i, m in enumerate(d.dists):
            f = insupport(m, x[..., i])
            out = f if out is None else out & f
        return out
    if isinstance(d, (D.MvNormal, D.MvTDist)):
        return torch.all(torch.isfinite(_f32_tensor(x)), dim=-1)
    if isinstance(d, D.MvLogNormal):
        return torch.all(_f32_tensor(x) > 0, dim=-1)
    if isinstance(d, D.Dirichlet):
        xf = _f32_tensor(x)
        return (torch.all(xf > 0, dim=-1)
                & (torch.abs(torch.sum(xf, dim=-1) - 1.0) < 1e-5))
    if isinstance(d, D.Dirac):
        return _f32_tensor(x) == float(np.float32(d.value))
    if isinstance(d, D.DiscreteNonParametric):
        xf = _f32_tensor(x)
        xs = d._host("xs", xf)
        idx = torch.clamp(torch.searchsorted(xs, xf.reshape(-1)), 0,
                          len(d.xs) - 1).reshape(xf.shape)
        return xs[idx] == xf
    xf = _f32_tensor(x)
    ok = ((xf >= float(np.float32(minimum(d))))
          & (xf <= float(np.float32(maximum(d)))))
    if getattr(d, "discrete", False):
        ok = ok & (xf == torch.round(xf))
    return ok


def params(d):
    """Distributions.jl ``params(d)``: the parameter tuple."""
    if isinstance(d, D.MvNormal):
        return (np.asarray(d.mean, np.float64),
                np.asarray(d.cov, np.float64))
    if isinstance(d, D.MvTDist):
        return (float(d.df), np.asarray(d.mean, np.float64),
                np.asarray(d.cov, np.float64))
    if isinstance(d, D.Dirichlet):
        return (np.asarray(d.alpha, np.float64),)
    if isinstance(d, D.Multinomial):
        return (int(d.n), np.asarray(d.p, np.float64))
    if isinstance(d, D.Categorical):
        return (np.asarray(d.p, np.float64),)
    if isinstance(d, (D.Truncated, D.TruncatedDiscrete)):
        return (d.base, float(d.lo), float(d.hi))
    if isinstance(d, D.Affine):
        return (float(d.loc), float(d.scale), d.base)
    if isinstance(d, D.Mixture):
        return (tuple(d.components), np.asarray(d.weights, np.float64))
    if isinstance(d, D.Factored):
        return tuple(d.p)
    if isinstance(d, D.Dirac):
        return (float(d.value),)
    if isinstance(d, D.Hypergeometric):
        return (int(d.s), int(d.f), int(d.n))
    fields = getattr(type(d), "_fields", None)
    if fields:
        return tuple(float(getattr(d, f)) for f in fields)
    raise NotImplementedError(f"params({type(d).__name__})")


# --- pointwise functions (tensors on x's device) -------------------------

def pdf(d, x):
    return d.pdf(x)


def logpdf(d, x):
    return d.logpdf(x)


def cdf(d, x):
    return d.cdf(x)


def ccdf(d, x):
    """1 - cdf (Distributions.jl ``ccdf``), through ``d.sf``: the
    families with a stable survival form (Normal, Exponential, Weibull,
    LogNormal, Logistic, Cauchy, Pareto, Gumbel, Frechet, Rayleigh,
    Laplace) stay accurate in the tail, the others take the float32
    complement."""
    return d.sf(_f32_tensor(x))


def logcdf(d, x):
    return torch.log(torch.clamp(d.cdf(_f32_tensor(x)), min=1e-37))


def logccdf(d, x):
    """log(1 - cdf), through ``d.logsf``: unbounded (tail-exact) for the
    families listed under ``ccdf``; the generic fallback floors at
    log(1e-37) ~ -85.2."""
    return d.logsf(_f32_tensor(x))


def quantile(d, q):
    return d.quantile(_f32_tensor(q))


def cquantile(d, q):
    """quantile(d, 1 - q) (Distributions.jl ``cquantile``)."""
    return d.quantile(1.0 - _f32_tensor(q))


# --------------------------------------------------------------------------
# fit / fit_mle (Distributions.jl's ``fit(D, x)``, on the host)
# --------------------------------------------------------------------------

def fit_mle(cls, x):
    """Maximum-likelihood fit of family ``cls`` to samples ``x`` (a
    tensor, array or list): Distributions.jl's ``fit_mle(D, x)``. Returns
    a distribution. Closed forms where they exist, scipy's numeric MLE
    otherwise."""
    from scipy import stats as st
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    x = (np.asarray(x, np.float64) if cls is D.MvNormal
         else np.asarray(x, np.float64).reshape(-1))
    if cls is D.Normal:
        return D.Normal(x.mean(), x.std())
    if cls is D.LogNormal:
        lx = np.log(x)
        return D.LogNormal(lx.mean(), lx.std())
    if cls is D.Exponential:
        return D.Exponential(x.mean())
    if cls is D.Uniform:
        return D.Uniform(x.min(), x.max())
    if cls is D.Laplace:
        mu = np.median(x)
        return D.Laplace(mu, np.abs(x - mu).mean())
    if cls is D.Rayleigh:
        return D.Rayleigh(np.sqrt(0.5 * (x * x).mean()))
    if cls is D.Pareto:
        theta = x.min()
        return D.Pareto(x.size / np.sum(np.log(x / theta)), theta)
    if cls is D.Poisson:
        return D.Poisson(x.mean())
    if cls is D.Bernoulli:
        return D.Bernoulli(x.mean())
    if cls is D.Geometric:
        return D.Geometric(1.0 / (1.0 + x.mean()))
    if cls is D.Categorical:
        k = int(x.max()) + 1
        return D.Categorical(np.bincount(x.astype(np.int64),
                                         minlength=k) / x.size)
    if cls is D.Gamma:
        a, _, scale = st.gamma.fit(x, floc=0.0)
        return D.Gamma(a, scale)
    if cls is D.Weibull:
        c, _, scale = st.weibull_min.fit(x, floc=0.0)
        return D.Weibull(c, scale)
    if cls is D.Beta:
        a, b, _, _ = st.beta.fit(x, floc=0.0, fscale=1.0)
        return D.Beta(a, b)
    if cls is D.Cauchy:
        loc, scale = st.cauchy.fit(x)
        return D.Cauchy(loc, scale)
    if cls is D.Logistic:
        loc, scale = st.logistic.fit(x)
        return D.Logistic(loc, scale)
    if cls is D.Gumbel:
        loc, scale = st.gumbel_r.fit(x)
        return D.Gumbel(loc, scale)
    if cls is D.InverseGaussian:
        mu = x.mean()
        lam = 1.0 / np.mean(1.0 / x - 1.0 / mu)
        return D.InverseGaussian(mu, lam)
    if cls is D.MvNormal:
        if x.ndim != 2:
            raise ValueError("fit_mle(MvNormal, x) needs [n, d] samples")
        return D.MvNormal(x.mean(axis=0), np.cov(x.T, ddof=0))
    raise NotImplementedError(f"fit_mle({cls.__name__})")


fit = fit_mle   # Distributions.jl's ``fit`` falls back to fit_mle


# --------------------------------------------------------------------------
# the other Distributions.jl conveniences
# --------------------------------------------------------------------------

def support(d):
    """Distributions.jl ``support(d)``: the (minimum, maximum) pair."""
    return (minimum(d), maximum(d))


def truncated(d, lo=None, hi=None, *, lower=None, upper=None):
    """Distributions.jl's ``truncated(d; lower, upper)`` (positional
    lo/hi also taken). A missing side is unbounded."""
    if lower is not None:
        lo = lower
    if upper is not None:
        hi = upper
    lo = -np.inf if lo is None else lo
    hi = np.inf if hi is None else hi
    return D.Truncated(d, lo, hi)


def product_distribution(dists):
    """Distributions.jl ``product_distribution([...])``: homogeneous
    univariate marginals give a vector-valued ``Product``; mixed
    continuous/discrete packs and vector or matrix entries give the
    tuple-tree ``Factored``."""
    dists = list(dists)
    univariate = all(getattr(m, "event_dim", 0) == 0 for m in dists)
    if univariate and len({bool(m.discrete) for m in dists}) == 1:
        return D.Product(dists)
    return D.Factored(*dists)


def cor(d):
    """Correlation matrix of a vector-variate distribution
    (Distributions.jl ``cor``)."""
    c = np.asarray(cov(d), np.float64)
    s = np.sqrt(np.diag(c))
    return c / np.outer(s, s)


def loglikelihood(d, x):
    """Distributions.jl ``loglikelihood(d, x)``: the sum of logpdf over
    the observations (a tensor on ``x``'s device)."""
    return torch.sum(d.logpdf(_f32_tensor(x)))


def rand(d, shape=(), *, key=0, device=None):
    """Julia-style ``rand(d, n)``: draws from ``d`` with a
    ``torch.Generator`` seeded by ``key`` (an int, or a generator) on
    ``device`` (``None``: CUDA, which raises without a card; pass
    ``"cpu"`` for the CPU). ``shape`` is an int or a tuple; a
    ``Factored`` prior gives a tuple of ``shape`` tensors, one per
    marginal. Inside a sampler use ``d.sample(gen, shape)``."""
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(shape)
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = as_generator(int(key), resolve_device(device))
    if isinstance(d, D.Factored):
        n = int(np.prod(shape)) if shape else 1
        draws = d.sample_tree(gen, n)
        return tuple(v.reshape(shape + v.shape[1:]) for v in draws)
    return d.sample(gen, shape)
