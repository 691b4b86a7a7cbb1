"""Distributions: the PyTorch counterpart of ``kissabc_tpu/distributions.py``.

- every univariate family of the JAX package, continuous (``Uniform``,
  ``Normal``/``NormalCanon``, ``Exponential``, ``Gamma``/``Erlang``,
  ``Beta``, ``LogNormal``, ``LogUniform``, ``BetaPrime``, ``StudentT``/
  ``TDist``, ``Laplace``, ``Cauchy``, ``Weibull``, ``Chisq``, ``Chi``,
  ``NoncentralChisq``, ``FDist``, ``Logistic``, ``Rayleigh``, ``Pareto``,
  ``InverseGamma``, ``Gumbel``, ``TriangularDist``, ``SymTriangularDist``,
  ``Arcsine``, ``Semicircle``, ``Frechet``, ``Levy``, ``GeneralizedPareto``,
  ``GeneralizedExtremeValue``, ``Kumaraswamy``, ``VonMises``, ``Cosine``,
  ``Epanechnikov``, ``Biweight``, ``Triweight``, ``JohnsonSU``,
  ``InverseGaussian``, ``PGeneralizedGaussian``, ``Rician``, ``Lindley``,
  ``LogitNormal``) and discrete (``DiscreteUniform``, ``Poisson``,
  ``Bernoulli``, ``Binomial``, ``Geometric``, ``BetaBinomial``,
  ``Hypergeometric``, ``Skellam``, ``NegativeBinomial``, ``Categorical``,
  ``Dirac``, ``PoissonBinomial``, ``DiscreteNonParametric``);
- ``Truncated`` over any base with a ``quantile`` (a discrete base gives
  a ``TruncatedDiscrete``), ``TruncatedNormal``, ``Mixture``/
  ``MixtureModel``, ``Affine`` and the operators ``+ - *`` and unary
  ``-`` that build it (``2.0 - 3.0 * Exponential(1.0)``);
- the vector families ``MvNormal``/``MultivariateNormal``, ``Dirichlet``,
  ``Product``/``IID``, ``Multinomial``, ``MvLogNormal`` and ``MvTDist``
  (``[n, d]`` leaves), the matrix families ``Wishart``,
  ``InverseWishart``, ``LKJ`` and ``LKJCholesky`` (``[n, d, d]`` leaves,
  ``push`` a projection onto the support; a non-SPD leaf has logpdf
  -inf, through ``torch.linalg.cholesky_ex``, so a batch never raises),
  and ``Factored``, whose marginals may be any of them.

As in the JAX package, parameters and every derived constant are host
numpy float32 values computed once in ``__init__``; only the sampled and
evaluated values are tensors. Sampling draws from an explicit
``torch.Generator`` on the device of the run (never the global one).
Log-densities, cdfs and quantiles repeat the JAX package's float32
formulas, so both give the same values to a few ulps on the same points;
``betainc`` is the JAX package's continued fraction, written here in
float32 PyTorch with a number of terms fixed on the host.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from scipy import special as sps
from scipy import stats as sst

_f32 = np.float32
_NEG_INF = float("-inf")
_LOG_2PI = math.log(2 * math.pi)
_TINY32 = float(np.finfo(np.float32).tiny)


def _full(x, value):
    return torch.full_like(x, value, dtype=torch.float32)


def _as_f32(x):
    return torch.as_tensor(x).to(torch.float32)


class Distribution:
    """Base univariate distribution and the prior-tree protocol.

    ``discrete`` drives the push policy (types.jl:27-32): a discrete
    value evolves in float and is rounded half to even when evaluated.
    """

    discrete: bool = False
    event_dim: int = 0

    @property
    def nparams(self) -> int:
        return 1

    def sample_tree(self, gen, n):
        """``n`` draws as one ``[n]`` tensor on the generator's device."""
        return self.sample(gen, (n,))

    def logpdf_tree(self, theta):
        return self.logpdf(theta)

    def push_tree(self, theta):
        return self.push(theta)

    def push(self, x):
        """Snap a float-evolved value onto the support dtype:
        continuous -> float32, discrete -> round half to even, int32."""
        if self.discrete:
            return torch.round(x).to(torch.int32)
        return x.to(torch.float32)

    def pdf(self, x):
        return torch.exp(self.logpdf(x))

    def sf(self, x):
        """Survival function 1 - cdf: this generic fallback takes the
        complement in float32 (the upper tail saturates once the cdf
        rounds to 1); families with a stable survival form override it."""
        return 1.0 - self.cdf(x)

    def logsf(self, x):
        """log survival; the generic fallback floors at log(1e-37)."""
        return torch.log(torch.clamp(self.sf(x), min=1e-37))

    def _host(self, name, where):
        """The host array ``name`` as a tensor on the device of ``where``
        (a tensor, a generator or a device), copied there once."""
        dev = torch.device(getattr(where, "device", where))
        cache = self.__dict__.setdefault("_dev", {})
        if (name, dev) not in cache:
            cache[(name, dev)] = torch.as_tensor(getattr(self, name),
                                                 device=dev)
        return cache[(name, dev)]

    def __repr__(self):
        inner = ", ".join(f"{f}={getattr(self, f)}" for f in self._fields)
        return f"{type(self).__name__}({inner})"


def _uniform(gen, shape, lo, hi):
    u = torch.rand(shape, generator=gen, device=gen.device)
    return torch.clamp(u * (hi - lo) + lo, min=float(lo))


def _std_gamma(gen, alpha, shape):
    """Standard Gamma(alpha) draws (float32) from ``gen``."""
    a = torch.full(tuple(shape), float(alpha), dtype=torch.float32,
                   device=gen.device)
    return torch._standard_gamma(a, generator=gen)


def _bisect_quantile(cdf, lo, hi, q, iters=60):
    """Invert a monotone cdf on [lo, hi] by fixed-iteration bisection —
    the JAX package's ``_bisect_quantile``, with no host read."""
    q = _as_f32(q)
    lo = torch.full_like(q, float(np.float32(lo)))
    hi = torch.full_like(q, float(np.float32(hi)))
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = cdf(mid) < q
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


# float32 constants of the continued fraction (jax/_src/lax/special.py)
_CF_SMALL = float(np.finfo(np.float32).eps / 2)
_CF_TINY2 = float(np.finfo(np.float32).tiny * 2)


def betainc_terms(a, b) -> int:
    """Terms of ``betainc``'s continued fraction for host parameters a, b:
    in float32 the fraction settles (every factor exactly 1) within 57
    terms for a, b up to 1000 (a grid of x in (0, 1)); this keeps a
    margin of 40 plus 2 sqrt(a + b), at most the JAX package's 200."""
    return min(200, 40 + int(2.0 * math.sqrt(float(a) + float(b))))


def betainc(a, b, x):
    """The regularized incomplete beta function I_x(a, b) in float32: the
    JAX package's ``jax.scipy.special.betainc`` (the modified Lentz
    continued fraction of DLMF 8.17.22, on the side of x where it
    converges fast, DLMF 8.17.4), with a number of terms fixed on the
    host instead of a loop until every element has settled; an element
    stops changing once its factor is exactly 1, where JAX's loop stops.
    ``a`` and ``b`` are numbers or tensors broadcastable with ``x``."""
    x = _as_f32(x)
    terms = (200 if torch.is_tensor(a) or torch.is_tensor(b)
             else betainc_terms(a, b))
    a = torch.broadcast_to(_as_f32(a).to(x.device), x.shape)
    b = torch.broadcast_to(_as_f32(b).to(x.device), x.shape)
    one = torch.ones_like(x)
    a_zero = (a == 0) | (b == math.inf)
    b_zero = (b == 0) | (a == math.inf)
    is_nan = torch.isnan(a) | torch.isnan(b) | torch.isnan(x)
    res_zero = (b_zero & (x != 1)) | (a_zero & (x == 0))
    res_one = (a_zero & (x != 0)) | (b_zero & (x == 1))
    res_nan = (a < 0) | (b < 0) | (x < 0) | (x > 1) | (a_zero & b_zero) \
        | is_nan
    fast = x < (a + 1.0) / (a + b + 2.0)
    a, b, x = (torch.where(fast, a, b), torch.where(fast, b, a),
               torch.where(fast, x, 1.0 - x))
    small = torch.full_like(x, _CF_SMALL)
    h = small.clone()
    c_prev, d_prev = h, torch.zeros_like(x)
    live = torch.ones_like(x, dtype=torch.bool)
    for n in range(1, terms + 1):
        if n == 1:
            num = one
        else:
            m = float((n - 1) // 2)
            if n % 2 == 0:
                num = (-(a + b) * x / (a + 1.0) if m == 0 else
                       -(a + m) * (a + b + m) * x
                       / ((a + 2.0 * m) * (a + 2.0 * m + 1.0)))
            else:
                num = m * (b - m) * x / ((a + 2.0 * m - 1.0)
                                         * (a + 2.0 * m))
        c = 1.0 + num / c_prev
        c = torch.where(torch.abs(c) < _CF_SMALL, small, c)
        d = 1.0 + num * d_prev
        d = torch.where(torch.abs(d) < _CF_SMALL, small, d)
        d = torch.reciprocal(d)
        delta = c * d
        h = torch.where(live, h * delta, h)
        live = live & (torch.abs(delta - 1.0) >= _CF_SMALL)
        c_prev, d_prev = c, d
    lb_small = torch.lgamma(b) - torch.lgamma(a + b)
    lb = torch.lgamma(a) + lb_small
    factor = torch.where(
        a < _CF_TINY2, torch.exp(torch.log1p(-x) * b - lb_small),
        torch.exp(torch.log(x) * a + torch.log1p(-x) * b - lb) / a)
    out = h * factor
    out = torch.where(fast, out, 1.0 - out)
    out = torch.where(res_zero, torch.zeros_like(out), out)
    out = torch.where(res_one, torch.ones_like(out), out)
    return torch.where(res_nan, torch.full_like(out, math.nan), out)


# the Chebyshev coefficients of jax.scipy.special.i0e in float32
# (jax/_src/lax/special.py _i0e_impl32, Cephes)
_I0E_A = np.array([
    -1.30002500998624804212E-8, 6.04699502254191894932E-8,
    -2.67079385394061173391E-7, 1.11738753912010371815E-6,
    -4.41673835845875056359E-6, 1.64484480707288970893E-5,
    -5.75419501008210370398E-5, 1.88502885095841655729E-4,
    -5.76375574538582365885E-4, 1.63947561694133579842E-3,
    -4.32430999505057594430E-3, 1.05464603945949983183E-2,
    -2.37374148058994688156E-2, 4.93052842396707084878E-2,
    -9.49010970480476444210E-2, 1.71620901522208775349E-1,
    -3.04682672343198398683E-1, 6.76795274409476084995E-1], _f32)
_I0E_B = np.array([
    3.39623202570838634515E-9, 2.26666899049817806459E-8,
    2.04891858946906374183E-7, 2.89137052083475648297E-6,
    6.88975834691682398426E-5, 3.36911647825569408990E-3,
    8.04490411014108831608E-1], _f32)


def _chebyshev(y, coeffs):
    b0 = b1 = b2 = torch.zeros_like(y)
    for c in coeffs:
        b2, b1 = b1, b0
        b0 = y * b1 - b2 + float(c)
    return 0.5 * (b0 - b2)


def i0e(x):
    """The exponentially scaled Bessel function exp(-|x|) I0(x) in
    float32, JAX's computation (``jax.scipy.special.i0e``): the plain
    counterpart of ``csrc/common.cuh`` ``kt_i0e``, which the generic
    kernels' prior table calls for a traced value."""
    if not torch.is_tensor(x):   # a value traced by ops/codegen.py
        return x.i0e()
    x = torch.abs(_as_f32(x))
    le8 = _chebyshev(0.5 * x - 2.0, _I0E_A)
    gt8 = torch.div(_chebyshev(torch.div(torch.full_like(x, 32.0), x) - 2.0,
                               _I0E_B), torch.sqrt(x))
    return torch.where(x <= 8.0, le8, gt8)


# --------------------------------------------------------------------------
# Continuous univariate
# --------------------------------------------------------------------------

class Uniform(Distribution):
    _fields = ("a", "b")

    def __init__(self, a, b):
        self.a, self.b = _f32(a), _f32(b)
        self._nll = _f32(np.log(self.b - self.a))

    def sample(self, gen, shape=()):
        return _uniform(gen, shape, self.a, self.b)

    def logpdf(self, x):
        inside = (x >= float(self.a)) & (x <= float(self.b))
        return torch.where(inside, _full(x, -self._nll), _full(x, _NEG_INF))

    def cdf(self, x):
        return torch.clamp((x - float(self.a)) / float(self.b - self.a),
                           0.0, 1.0)

    def quantile(self, q):
        return float(self.a) + q * float(self.b - self.a)


class Normal(Distribution):
    _fields = ("mu", "sigma")

    def __init__(self, mu, sigma):
        self.mu, self.sigma = _f32(mu), _f32(sigma)
        self._lnorm = _f32(np.log(self.sigma) + 0.5 * _LOG_2PI)

    def sample(self, gen, shape=()):
        z = torch.randn(shape, generator=gen, device=gen.device)
        return float(self.mu) + float(self.sigma) * z

    def logpdf(self, x):
        z = (x - float(self.mu)) / float(self.sigma)
        return -0.5 * z * z - float(self._lnorm)

    def cdf(self, x):
        return torch.special.ndtr((x - float(self.mu)) / float(self.sigma))

    def sf(self, x):
        return torch.special.ndtr(-(_as_f32(x) - float(self.mu))
                                  / float(self.sigma))

    def logsf(self, x):
        return torch.special.log_ndtr(-(_as_f32(x) - float(self.mu))
                                      / float(self.sigma))

    def quantile(self, q):
        return float(self.mu) + float(self.sigma) * torch.special.ndtri(q)


class Exponential(Distribution):
    """Scale parameterization: mean = theta (Distributions.jl
    convention)."""

    _fields = ("theta",)

    def __init__(self, theta):
        self.theta = _f32(theta)
        self._ltheta = _f32(np.log(self.theta))

    def sample(self, gen, shape=()):
        e = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
        return float(self.theta) * e.exponential_(generator=gen)

    def logpdf(self, x):
        return torch.where(x >= 0, -x / float(self.theta)
                           - float(self._ltheta), _full(x, _NEG_INF))

    def cdf(self, x):
        return torch.where(x >= 0, 1.0 - torch.exp(-x / float(self.theta)),
                           _full(x, 0.0))

    def sf(self, x):
        return torch.exp(-torch.clamp(_as_f32(x), min=0.0)
                         / float(self.theta))

    def logsf(self, x):
        return -torch.clamp(_as_f32(x), min=0.0) / float(self.theta)

    def quantile(self, q):
        return -float(self.theta) * torch.log1p(-_as_f32(q))


class Gamma(Distribution):
    """Shape ``alpha``, scale ``theta``."""

    _fields = ("alpha", "theta")

    def __init__(self, alpha, theta):
        self.alpha, self.theta = _f32(alpha), _f32(theta)
        self._lnorm = _f32(sps.gammaln(self.alpha)
                           + self.alpha * np.log(self.theta))

    def sample(self, gen, shape=()):
        return float(self.theta) * _std_gamma(gen, self.alpha, shape)

    def logpdf(self, x):
        ok = x > 0
        xs = torch.where(ok, x, _full(x, 1.0))
        lp = (float(self.alpha - 1) * torch.log(xs) - xs / float(self.theta)
              - float(self._lnorm))
        return torch.where(ok, lp, _full(x, _NEG_INF))

    def cdf(self, x):
        z = torch.clamp(_as_f32(x), min=0.0) / float(self.theta)
        return torch.special.gammainc(torch.full_like(z, float(self.alpha)),
                                      z)

    def quantile(self, q):
        hi = self.theta * (self.alpha + _f32(1.0)
                           + _f32(12.0) * np.sqrt(self.alpha) + _f32(12.0))
        return _bisect_quantile(self.cdf, 0.0, hi, q)


class LogUniform(Distribution):
    """LogUniform(a, b), 0 < a < b (Distributions.jl ``LogUniform``):
    log X ~ Uniform(log a, log b)."""

    _fields = ("a", "b")

    def __init__(self, a, b):
        self.a, self.b = _f32(a), _f32(b)
        a, b = float(self.a), float(self.b)
        if not (0 < a < b):
            raise ValueError("LogUniform needs 0 < a < b")
        self._la = _f32(math.log(a))
        self._lr = _f32(math.log(b) - math.log(a))
        self._llr = _f32(math.log(math.log(b) - math.log(a)))

    def sample(self, gen, shape=()):
        u = torch.rand(shape, generator=gen, device=gen.device)
        return torch.exp(float(self._la) + u * float(self._lr))

    def logpdf(self, x):
        inside = (x >= float(self.a)) & (x <= float(self.b))
        xs = torch.where(inside, x, _full(x, 1.0))
        return torch.where(inside, -torch.log(xs) - float(self._llr),
                           _full(x, _NEG_INF))

    def cdf(self, x):
        xc = torch.clamp(x, float(self.a), float(self.b))
        return (torch.log(xc) - float(self._la)) / float(self._lr)

    def quantile(self, q):
        return torch.exp(float(self._la) + _as_f32(q) * float(self._lr))


class BetaPrime(Distribution):
    """Beta prime (Distributions.jl ``BetaPrime(alpha, beta)``):
    X = Y/(1-Y) with Y ~ Beta(alpha, beta), Y drawn as a ratio of two
    Gamma draws."""

    _fields = ("alpha", "beta")

    def __init__(self, alpha, beta):
        self.alpha, self.beta = _f32(alpha), _f32(beta)
        a, b = float(self.alpha), float(self.beta)
        if not (a > 0 and b > 0):
            raise ValueError("BetaPrime needs alpha > 0 and beta > 0")
        self._lbeta = _f32(sps.betaln(a, b))
        self._qhi = _f32(float(sst.betaprime(a, b).ppf(1 - 1e-7)))

    def sample(self, gen, shape=()):
        ga = _std_gamma(gen, self.alpha, shape)
        gb = _std_gamma(gen, self.beta, shape)
        y = torch.clamp(ga / (ga + gb), 1e-7, 1.0 - 1e-7)
        return y / (1.0 - y)

    def logpdf(self, x):
        ok = x > 0
        xs = torch.where(ok, x, _full(x, 1.0))
        lp = (float(self.alpha - _f32(1.0)) * torch.log(xs)
              - float(self.alpha + self.beta) * torch.log1p(xs)
              - float(self._lbeta))
        return torch.where(ok, lp, _full(x, _NEG_INF))

    def cdf(self, x):
        xs = torch.clamp(_as_f32(x), min=0.0)
        return betainc(self.alpha, self.beta, xs / (1.0 + xs))

    def quantile(self, q):
        return _bisect_quantile(self.cdf, 0.0, self._qhi, q)


class StudentT(Distribution):
    """Standard Student t with nu degrees of freedom, drawn as
    ``z * sqrt((nu/2) / g)`` with z ~ N(0,1), g ~ Gamma(nu/2), as
    ``jax.random.t`` does."""

    _fields = ("nu",)

    def __init__(self, nu):
        self.nu = _f32(nu)
        nu = float(self.nu)
        self._lnorm = _f32(sps.gammaln((nu + 1) / 2) - sps.gammaln(nu / 2)
                           - 0.5 * np.log(nu * np.pi))
        self._qhi = float(sst.t(nu).ppf(1.0 - 1e-7))

    def sample(self, gen, shape=()):
        z = torch.randn(shape, generator=gen, device=gen.device)
        half = float(self.nu / _f32(2))
        return z * torch.sqrt(half / _std_gamma(gen, half, shape))

    def logpdf(self, x):
        nu = float(self.nu)
        return float(self._lnorm) - float((self.nu + 1) / 2) * torch.log1p(
            x * x / nu)

    def cdf(self, x):
        # F(t) = 1 - I_{nu/(nu+t^2)}(nu/2, 1/2) / 2 for t >= 0, symmetric
        x = _as_f32(x)
        z = float(self.nu) / (float(self.nu) + x * x)
        tail = 0.5 * betainc(self.nu / 2, _f32(0.5), z)
        return torch.where(x >= 0, 1.0 - tail, tail)

    def quantile(self, q):
        return _bisect_quantile(self.cdf, -self._qhi, self._qhi, q)


# Distributions.jl's name for the standard Student t
TDist = StudentT


def Erlang(k, theta=1.0):
    """Erlang(k, theta) == Gamma with integer shape
    (Distributions.jl ``Erlang``)."""
    ki = int(k)
    if ki != k or ki < 1:
        raise ValueError("Erlang needs integer k >= 1")
    return Gamma(ki, theta)


def NormalCanon(eta, lam):
    """Canonical-form normal (Distributions.jl ``NormalCanon(eta,
    lambda)``): precision ``lam``, potential ``eta``; equals
    Normal(eta/lam, 1/sqrt(lam))."""
    lam = float(lam)
    if not lam > 0:
        raise ValueError("NormalCanon needs lambda > 0")
    return Normal(float(eta) / lam, lam ** -0.5)


class Beta(Distribution):
    """Beta(alpha, beta), drawn as a ratio of two Gamma draws."""

    _fields = ("alpha", "beta")

    def __init__(self, alpha, beta):
        self.alpha, self.beta = _f32(alpha), _f32(beta)
        self._lbeta = _f32(sps.betaln(self.alpha, self.beta))

    def sample(self, gen, shape=()):
        ga = _std_gamma(gen, self.alpha, shape)
        gb = _std_gamma(gen, self.beta, shape)
        return ga / (ga + gb)

    def logpdf(self, x):
        inside = (x >= 0) & (x <= 1)
        lx = torch.where(inside, torch.clamp(x, 1e-37, 1.0), 0.5)
        l1x = torch.where(inside, torch.clamp(1.0 - x, 1e-37, 1.0), 0.5)
        lp = (float(self.alpha - 1) * torch.log(lx)
              + float(self.beta - 1) * torch.log(l1x) - float(self._lbeta))
        return torch.where(inside, lp, _NEG_INF)

    def cdf(self, x):
        return betainc(self.alpha, self.beta, torch.clamp(_as_f32(x), 0.0,
                                                          1.0))

    def quantile(self, q):
        return _bisect_quantile(self.cdf, 0.0, 1.0, q)


class LogNormal(Distribution):
    _fields = ("mu", "sigma")

    def __init__(self, mu, sigma):
        self.mu, self.sigma = _f32(mu), _f32(sigma)
        self._lnorm = _f32(np.log(self.sigma) + 0.5 * _LOG_2PI)

    def sample(self, gen, shape=()):
        z = torch.randn(shape, generator=gen, device=gen.device)
        return torch.exp(float(self.mu) + float(self.sigma) * z)

    def _z(self, x):
        ok = x > 0
        xs = torch.where(ok, x, 1.0)
        return ok, xs, (torch.log(xs) - float(self.mu)) / float(self.sigma)

    def logpdf(self, x):
        ok, xs, z = self._z(x)
        return torch.where(ok, -0.5 * z * z - torch.log(xs)
                           - float(self._lnorm), _NEG_INF)

    def cdf(self, x):
        ok, _, z = self._z(_as_f32(x))
        return torch.where(ok, torch.special.ndtr(z), 0.0)

    def sf(self, x):
        ok, _, z = self._z(_as_f32(x))
        return torch.where(ok, torch.special.ndtr(-z), 1.0)

    def logsf(self, x):
        ok, _, z = self._z(_as_f32(x))
        return torch.where(ok, torch.special.log_ndtr(-z), 0.0)

    def quantile(self, q):
        return torch.exp(float(self.mu) + float(self.sigma)
                         * torch.special.ndtri(_as_f32(q)))


class Laplace(Distribution):
    _fields = ("mu", "sigma")

    def __init__(self, mu, sigma):
        self.mu, self.sigma = _f32(mu), _f32(sigma)
        self._lnorm = _f32(np.log(2 * self.sigma))

    def sample(self, gen, shape=()):
        # the difference of two Exp(1) draws is Laplace(0, 1)
        e = torch.empty((2,) + tuple(shape), dtype=torch.float32,
                        device=gen.device).exponential_(generator=gen)
        return float(self.mu) + float(self.sigma) * (e[0] - e[1])

    def _zf(self, x):
        return (_as_f32(x) - float(self.mu)) / float(self.sigma)

    def logpdf(self, x):
        return (-torch.abs(x - float(self.mu)) / float(self.sigma)
                - float(self._lnorm))

    def cdf(self, x):
        z = self._zf(x)
        return torch.where(z < 0, 0.5 * torch.exp(z), 1 - 0.5 * torch.exp(-z))

    def sf(self, x):
        z = self._zf(x)
        return torch.where(z < 0, 1 - 0.5 * torch.exp(z), 0.5 * torch.exp(-z))

    def logsf(self, x):
        z = self._zf(x)
        zs = torch.clamp(z, max=0.0)
        return torch.where(z < 0, torch.log1p(-0.5 * torch.exp(zs)),
                           float(_f32(np.log(0.5))) - z)

    def quantile(self, q):
        q = _as_f32(q)
        return float(self.mu) - float(self.sigma) * torch.sign(
            q - 0.5) * torch.log1p(-2 * torch.abs(q - 0.5))


class Cauchy(Distribution):
    _fields = ("mu", "sigma")

    def __init__(self, mu, sigma):
        self.mu, self.sigma = _f32(mu), _f32(sigma)
        self._lnorm = _f32(np.log(np.pi * self.sigma))

    def sample(self, gen, shape=()):
        c = torch.empty(tuple(shape), dtype=torch.float32,
                        device=gen.device).cauchy_(generator=gen)
        return float(self.mu) + float(self.sigma) * c

    def logpdf(self, x):
        z = (x - float(self.mu)) / float(self.sigma)
        return -torch.log1p(z * z) - float(self._lnorm)

    def cdf(self, x):
        return 0.5 + torch.atan((_as_f32(x) - float(self.mu))
                                / float(self.sigma)) / math.pi

    def sf(self, x):
        z = (_as_f32(x) - float(self.mu)) / float(self.sigma)
        # upper tail via arctan(1/z)/pi (exact identity for z > 0):
        # 0.5 - arctan(z)/pi cancels for large z
        zs = torch.where(z > 0, z, 1.0)
        return torch.where(z > 0, torch.atan(1.0 / zs) / math.pi,
                           0.5 - torch.atan(z) / math.pi)

    def logsf(self, x):
        return torch.log(self.sf(x))

    def quantile(self, q):
        return float(self.mu) + float(self.sigma) * torch.tan(
            math.pi * (_as_f32(q) - 0.5))


class Weibull(Distribution):
    """Shape ``alpha``, scale ``theta``."""

    _fields = ("alpha", "theta")

    def __init__(self, alpha, theta):
        self.alpha, self.theta = _f32(alpha), _f32(theta)
        self._lnorm = _f32(np.log(self.alpha)
                           - self.alpha * np.log(self.theta))
        self._inv_a = _f32(1.0 / self.alpha)

    def sample(self, gen, shape=()):
        u = torch.rand(shape, generator=gen, device=gen.device)
        return self.quantile(u)

    def logpdf(self, x):
        ok = x > 0
        xs = torch.where(ok, x, 1.0)
        lp = (float(self._lnorm) + float(self.alpha - 1) * torch.log(xs)
              - (xs / float(self.theta)) ** float(self.alpha))
        return torch.where(ok, lp, _NEG_INF)

    def cdf(self, x):
        x = _as_f32(x)
        return torch.where(x > 0, -torch.expm1(
            -(torch.clamp(x, min=0) / float(self.theta))
            ** float(self.alpha)), 0.0)

    def sf(self, x):
        return torch.exp(self.logsf(x))

    def logsf(self, x):
        return -(torch.clamp(_as_f32(x), min=0.0) / float(self.theta)) \
            ** float(self.alpha)

    def quantile(self, q):
        return float(self.theta) * (-torch.log1p(-_as_f32(q))) \
            ** float(self._inv_a)


class Chisq(Distribution):
    """Chi-squared with ``nu`` degrees of freedom (= Gamma(nu/2, 2))."""

    _fields = ("nu",)

    def __init__(self, nu):
        self.nu = _f32(nu)
        nu = float(self.nu)
        self._lnorm = _f32(sps.gammaln(nu / 2) + (nu / 2) * np.log(2.0))
        self._c1 = _f32(self.nu / 2 - 1)

    def sample(self, gen, shape=()):
        return 2.0 * _std_gamma(gen, self.nu / 2, shape)

    def logpdf(self, x):
        ok = x > 0
        xs = torch.where(ok, x, 1.0)
        lp = float(self._c1) * torch.log(xs) - xs / 2 - float(self._lnorm)
        return torch.where(ok, lp, _NEG_INF)

    def cdf(self, x):
        z = torch.clamp(_as_f32(x), min=0.0) / 2
        return torch.special.gammainc(torch.full_like(z, float(self.nu / 2)),
                                      z)

    def quantile(self, q):
        hi = float(self.nu + 12 * np.sqrt(2 * float(self.nu)) + 12)
        return _bisect_quantile(self.cdf, 0.0, hi, q)


class FDist(Distribution):
    """Fisher-Snedecor F(nu1, nu2)."""

    _fields = ("nu1", "nu2")

    def __init__(self, nu1, nu2):
        self.nu1, self.nu2 = _f32(nu1), _f32(nu2)
        n1, n2 = float(self.nu1), float(self.nu2)
        self._lnorm = _f32(sps.betaln(n1 / 2, n2 / 2)
                           - (n1 / 2) * np.log(n1 / n2))
        self._qhi = float(sst.f(n1, n2).ppf(1.0 - 1e-7))
        self._c1 = _f32(self.nu1 / 2 - 1)
        self._c2 = _f32((self.nu1 + self.nu2) / 2)

    def sample(self, gen, shape=()):
        c1 = 2.0 * _std_gamma(gen, self.nu1 / 2, shape)
        c2 = 2.0 * _std_gamma(gen, self.nu2 / 2, shape)
        return (c1 / float(self.nu1)) / (c2 / float(self.nu2))

    def logpdf(self, x):
        ok = x > 0
        xs = torch.where(ok, x, 1.0)
        lp = (float(self._c1) * torch.log(xs)
              - float(self._c2) * torch.log1p(float(self.nu1) * xs
                                              / float(self.nu2))
              - float(self._lnorm))
        return torch.where(ok, lp, _NEG_INF)

    def cdf(self, x):
        xs = torch.clamp(_as_f32(x), min=0.0)
        z = float(self.nu1) * xs / (float(self.nu1) * xs + float(self.nu2))
        return betainc(self.nu1 / 2, self.nu2 / 2, z)

    def quantile(self, q):
        return _bisect_quantile(self.cdf, 0.0, self._qhi, q)


class Logistic(Distribution):
    """Location ``mu``, scale ``theta``."""

    _fields = ("mu", "theta")

    def __init__(self, mu, theta):
        self.mu, self.theta = _f32(mu), _f32(theta)
        self._ltheta = _f32(np.log(self.theta))

    def sample(self, gen, shape=()):
        u = torch.clamp(torch.rand(shape, generator=gen, device=gen.device),
                        min=_TINY32)
        return float(self.mu) + float(self.theta) * (torch.log(u)
                                                     - torch.log1p(-u))

    def _zf(self, x):
        return (_as_f32(x) - float(self.mu)) / float(self.theta)

    def logpdf(self, x):
        z = (x - float(self.mu)) / float(self.theta)
        az = torch.abs(z)
        return -az - 2.0 * torch.log1p(torch.exp(-az)) - float(self._ltheta)

    def cdf(self, x):
        return torch.sigmoid(self._zf(x))

    def sf(self, x):
        return torch.sigmoid(-self._zf(x))

    def logsf(self, x):
        return torch.nn.functional.logsigmoid(-self._zf(x))

    def quantile(self, q):
        q = _as_f32(q)
        return float(self.mu) + float(self.theta) * (torch.log(q)
                                                     - torch.log1p(-q))


class Rayleigh(Distribution):
    _fields = ("sigma",)

    def __init__(self, sigma):
        self.sigma = _f32(sigma)
        self._l2s = _f32(2.0 * np.log(self.sigma))
        self._s2 = _f32(self.sigma * self.sigma)

    def sample(self, gen, shape=()):
        return self.quantile(torch.rand(shape, generator=gen,
                                        device=gen.device))

    def logpdf(self, x):
        ok = x > 0
        xs = torch.where(ok, x, 1.0)
        z2 = (xs * xs) / float(self._s2)
        return torch.where(ok, torch.log(xs) - float(self._l2s) - 0.5 * z2,
                           _NEG_INF)

    def cdf(self, x):
        xs = torch.clamp(_as_f32(x), min=0.0)
        return -torch.expm1(-0.5 * (xs / float(self.sigma)) ** 2)

    def sf(self, x):
        return torch.exp(self.logsf(x))

    def logsf(self, x):
        xs = torch.clamp(_as_f32(x), min=0.0)
        return -0.5 * (xs / float(self.sigma)) ** 2

    def quantile(self, q):
        return float(self.sigma) * torch.sqrt(-2.0 * torch.log1p(-_as_f32(q)))


class Pareto(Distribution):
    """Shape ``alpha``, scale (left edge) ``theta``; support x >= theta."""

    _fields = ("alpha", "theta")

    def __init__(self, alpha, theta):
        self.alpha, self.theta = _f32(alpha), _f32(theta)
        a, t = float(self.alpha), float(self.theta)
        self._lnorm = _f32(np.log(a) + a * np.log(t))
        self._ltheta = _f32(np.log(t))

    def sample(self, gen, shape=()):
        return self.quantile(torch.rand(shape, generator=gen,
                                        device=gen.device))

    def logpdf(self, x):
        ok = x >= float(self.theta)
        xs = torch.where(ok, x, float(self.theta))
        return torch.where(ok, float(self._lnorm) - float(self.alpha + 1)
                           * torch.log(xs), _NEG_INF)

    def cdf(self, x):
        xs = torch.clamp(_as_f32(x), min=float(self.theta))
        return 1.0 - (float(self.theta) / xs) ** float(self.alpha)

    def sf(self, x):
        xs = torch.clamp(_as_f32(x), min=float(self.theta))
        return (float(self.theta) / xs) ** float(self.alpha)

    def logsf(self, x):
        xs = torch.clamp(_as_f32(x), min=float(self.theta))
        return float(self.alpha) * (float(self._ltheta) - torch.log(xs))

    def quantile(self, q):
        return float(self.theta) * torch.exp(-torch.log1p(-_as_f32(q))
                                             / float(self.alpha))


class InverseGamma(Distribution):
    """Shape ``alpha``, scale ``theta``: X = theta / Gamma(alpha, 1)."""

    _fields = ("alpha", "theta")

    def __init__(self, alpha, theta):
        self.alpha, self.theta = _f32(alpha), _f32(theta)
        a, t = float(self.alpha), float(self.theta)
        self._lnorm = _f32(sps.gammaln(a) - a * np.log(t))
        self._qhi = float(sst.invgamma(a, scale=t).ppf(1.0 - 1e-7))
        self._nap1 = _f32(-(self.alpha + 1))

    def sample(self, gen, shape=()):
        return float(self.theta) / _std_gamma(gen, self.alpha, shape)

    def logpdf(self, x):
        ok = x > 0
        xs = torch.where(ok, x, 1.0)
        lp = (float(self._nap1) * torch.log(xs) - float(self.theta) / xs
              - float(self._lnorm))
        return torch.where(ok, lp, _NEG_INF)

    def cdf(self, x):
        z = float(self.theta) / torch.clamp(_as_f32(x), min=1e-37)
        return torch.special.gammaincc(
            torch.full_like(z, float(self.alpha)), z)

    def quantile(self, q):
        return _bisect_quantile(self.cdf, 0.0, self._qhi, q)


class Gumbel(Distribution):
    """Gumbel (max) with location ``mu`` and scale ``theta``
    (Distributions.jl's ``Gumbel(mu, theta)``)."""

    _fields = ("mu", "theta")

    def __init__(self, mu, theta):
        self.mu, self.theta = _f32(mu), _f32(theta)
        self._lth = _f32(np.log(self.theta))

    def sample(self, gen, shape=()):
        u = _uniform(gen, shape, _f32(1e-7), _f32(1.0))
        return float(self.mu) - float(self.theta) * torch.log(-torch.log(u))

    def _zf(self, x):
        return (_as_f32(x) - float(self.mu)) / float(self.theta)

    def logpdf(self, x):
        z = (x - float(self.mu)) / float(self.theta)
        return -(z + torch.exp(-z)) - float(self._lth)

    def cdf(self, x):
        return torch.exp(-torch.exp(-self._zf(x)))

    def sf(self, x):
        # -expm1(-t) ~ t for small t: the upper tail stays exact
        return -torch.expm1(-torch.exp(-self._zf(x)))

    def logsf(self, x):
        z = self._zf(x)
        t = torch.exp(-z)
        exact = torch.log(torch.clamp(-torch.expm1(-t), min=1e-37))
        return torch.where(t < float(_f32(1e-4)), -z - 0.5 * t, exact)

    def quantile(self, q):
        return float(self.mu) - float(self.theta) * torch.log(
            -torch.log(_as_f32(q)))


class TriangularDist(Distribution):
    """Triangular on [a, b] with mode ``c`` (Distributions.jl argument
    order: lower, upper, mode)."""

    _fields = ("a", "b", "c")

    def __init__(self, a, b, c):
        self.a, self.b, self.c = _f32(a), _f32(b), _f32(c)
        a, b, c = float(self.a), float(self.b), float(self.c)
        if not a <= c <= b:
            raise ValueError("TriangularDist needs a <= c <= b")
        self._fc = _f32((c - a) / (b - a))
        self._l2ba = np.float32(2.0 * np.log(self.b - self.a))
        self._dl = _f32((self.b - self.a) * (self.c - self.a))
        self._dr = _f32((self.b - self.a) * (self.b - self.c))

    def sample(self, gen, shape=()):
        return self.quantile(torch.rand(shape, generator=gen,
                                        device=gen.device))

    def logpdf(self, x):
        a, b, c = float(self.a), float(self.b), float(self.c)
        l2 = float(np.float32(np.log(2.0)))
        ok = (x >= a) & (x <= b)
        # a, b, c are host values: a mode at an end branches here, so no
        # 0/0 reaches the computation
        if c == a or c == b:
            num = torch.where(ok, b - x if c == a else x - a, 1.0)
            lp = l2 + torch.log(num) - float(self._l2ba)
            return torch.where(ok, lp, _NEG_INF)
        left = (x >= a) & (x <= c)
        right = (x > c) & (x <= b)
        num = torch.where(left, x - a, torch.where(right, b - x, 1.0))
        den = torch.where(left, float(self._dl),
                          torch.where(right, float(self._dr), 1.0))
        lp = l2 + torch.log(num) - torch.log(den)
        return torch.where(left | right, lp, _NEG_INF)

    def cdf(self, x):
        a, b, c = float(self.a), float(self.b), float(self.c)
        x = _as_f32(x)
        xl = torch.clamp(x, a, c)
        xr = torch.clamp(x, c, b)
        low = ((xl - a) ** 2 / float(self._dl) if c > a
               else torch.zeros_like(xl))
        high = (1.0 - (b - xr) ** 2 / float(self._dr) if b > c
                else torch.ones_like(xr))
        return torch.where(x < c, low, high)

    def quantile(self, q):
        a, b, c = float(self.a), float(self.b), float(self.c)
        q = _as_f32(q)
        lo = a + torch.sqrt(torch.clamp(q, min=0.0) * float(self.b - self.a)
                            * float(self.c - self.a))
        hi = b - torch.sqrt(torch.clamp(1.0 - q, min=0.0)
                            * float(self.b - self.a) * float(self.b - self.c))
        return torch.where(q < float(self._fc), lo, hi)


class Arcsine(Distribution):
    """Arcsine on [a, b] (Distributions.jl ``Arcsine(a, b)``): the Beta
    (1/2, 1/2) law rescaled, density 1/(pi*sqrt((x-a)(b-x)))."""

    _fields = ("a", "b")

    def __init__(self, a, b):
        self.a, self.b = _f32(a), _f32(b)
        if not float(self.a) < float(self.b):
            raise ValueError("Arcsine needs a < b")
        self._lpi = _f32(math.log(math.pi))
        self._w = _f32(float(self.b) - float(self.a))

    def sample(self, gen, shape=()):
        return self.quantile(torch.rand(shape, generator=gen,
                                        device=gen.device))

    def logpdf(self, x):
        a, b = float(self.a), float(self.b)
        inside = (x > a) & (x < b)
        num = torch.where(inside, (x - a) * (b - x), 1.0)
        return torch.where(inside, -float(self._lpi) - 0.5 * torch.log(num),
                           _NEG_INF)

    def cdf(self, x):
        z = torch.clamp((_as_f32(x) - float(self.a)) / float(self._w), 0.0,
                        1.0)
        return float(np.float32(2.0 / math.pi)) * torch.asin(torch.sqrt(z))

    def quantile(self, q):
        s = torch.sin(float(np.float32(math.pi / 2.0)) * _as_f32(q))
        return float(self.a) + float(self._w) * s * s


class Semicircle(Distribution):
    """Wigner semicircle with radius ``r`` on [-r, r]
    (Distributions.jl ``Semicircle(r)``)."""

    _fields = ("r",)

    def __init__(self, r):
        self.r = _f32(r)
        r = float(self.r)
        if not r > 0:
            raise ValueError("Semicircle needs r > 0")
        self._lc = _f32(math.log(2.0) - math.log(math.pi) - 2.0 * math.log(r))
        self._r2 = _f32(self.r * self.r)

    def sample(self, gen, shape=()):
        # X = r (2B - 1) with B ~ Beta(3/2, 3/2)
        b = Beta(1.5, 1.5).sample(gen, shape)
        return float(self.r) * (2.0 * b - 1.0)

    def logpdf(self, x):
        inside = torch.abs(x) < float(self.r)
        num = torch.where(inside, float(self._r2) - x * x, 1.0)
        return torch.where(inside, float(self._lc) + 0.5 * torch.log(num),
                           _NEG_INF)

    def cdf(self, x):
        r = float(self.r)
        xc = torch.clamp(_as_f32(x), -r, r)
        z = xc / r
        return (0.5 + (xc * torch.sqrt(float(self._r2) - xc * xc))
                * float(np.float32(1.0 / math.pi)) / float(self._r2)
                + torch.asin(z) * float(np.float32(1.0 / math.pi)))

    def quantile(self, q):
        return _bisect_quantile(self.cdf, -float(self.r), float(self.r), q)


class Frechet(Distribution):
    """Frechet (inverse Weibull) with shape ``alpha`` and scale ``theta``
    (Distributions.jl ``Frechet(alpha, theta)``): cdf exp(-(x/theta)^-a)."""

    _fields = ("alpha", "theta")

    def __init__(self, alpha, theta):
        self.alpha, self.theta = _f32(alpha), _f32(theta)
        a, th = float(self.alpha), float(self.theta)
        if not (a > 0 and th > 0):
            raise ValueError("Frechet needs alpha > 0 and theta > 0")
        self._lc = _f32(math.log(a) - math.log(th))

    def sample(self, gen, shape=()):
        return self.quantile(_uniform(gen, shape, _f32(1e-7), _f32(1.0)))

    def _zf(self, x):
        x = _as_f32(x)
        ok = x > 0
        return ok, torch.where(ok, x / float(self.theta), 1.0)

    def logpdf(self, x):
        ok = x > 0
        z = torch.where(ok, x / float(self.theta), 1.0)
        lz = torch.log(z)
        return torch.where(ok, float(self._lc) - float(self.alpha + 1.0) * lz
                           - torch.exp(float(-self.alpha) * lz), _NEG_INF)

    def cdf(self, x):
        ok, z = self._zf(x)
        return torch.where(ok, torch.exp(-z ** float(-self.alpha)), 0.0)

    def sf(self, x):
        ok, z = self._zf(x)
        return torch.where(ok, -torch.expm1(-z ** float(-self.alpha)), 1.0)

    def logsf(self, x):
        ok, z = self._zf(x)
        t = z ** float(-self.alpha)
        exact = torch.log(torch.clamp(-torch.expm1(-t), min=1e-37))
        # the small-t series keeps the far upper tail exact
        lsf = torch.where(t < float(_f32(1e-4)),
                          float(-self.alpha) * torch.log(z) - 0.5 * t, exact)
        return torch.where(ok, lsf, 0.0)

    def quantile(self, q):
        return float(self.theta) * (-torch.log(_as_f32(q))) ** float(
            np.float32(-1.0 / float(self.alpha)))


class Levy(Distribution):
    """Levy with location ``mu`` and scale ``sigma``
    (Distributions.jl ``Levy(mu, sigma)``): the stable(1/2) law on
    (mu, inf)."""

    _fields = ("mu", "sigma")

    def __init__(self, mu, sigma):
        self.mu, self.sigma = _f32(mu), _f32(sigma)
        if not float(self.sigma) > 0:
            raise ValueError("Levy needs sigma > 0")
        self._lc = _f32(0.5 * (math.log(float(self.sigma)) - _LOG_2PI))
        self._hs = _f32(0.5 * self.sigma)

    def sample(self, gen, shape=()):
        # X = mu + sigma / Z^2 with Z ~ N(0,1)
        z = torch.randn(shape, generator=gen, device=gen.device)
        return float(self.mu) + float(self.sigma) / (z * z)

    def logpdf(self, x):
        ok = x > float(self.mu)
        d = torch.where(ok, x - float(self.mu), 1.0)
        return torch.where(ok, float(self._lc) - 1.5 * torch.log(d)
                           - float(self._hs) / d, _NEG_INF)

    def cdf(self, x):
        x = _as_f32(x)
        ok = x > float(self.mu)
        d = torch.where(ok, x - float(self.mu), 1.0)
        return torch.where(ok, torch.special.erfc(torch.sqrt(
            float(self._hs) / d)), 0.0)

    def quantile(self, q):
        e = torch.erfinv(1.0 - _as_f32(q))   # erfcinv(q)
        return float(self.mu) + float(self._hs) / (e * e)


class GeneralizedPareto(Distribution):
    """GPD with location ``mu``, scale ``sigma``, shape ``xi``
    (Distributions.jl ``GeneralizedPareto(mu, sigma, xi)``); the xi == 0
    (exponential tail) case branches on the host constant."""

    _fields = ("mu", "sigma", "xi")

    def __init__(self, mu, sigma, xi):
        if not float(sigma) > 0:
            raise ValueError("GeneralizedPareto needs sigma > 0")
        self.mu, self.sigma, self.xi = _f32(mu), _f32(sigma), _f32(xi)
        self._lsg = _f32(math.log(float(self.sigma)))
        xi = float(self.xi)
        # upper support bound in z-space: inf for xi >= 0, -1/xi below
        self._zhi = np.float32(np.inf) if xi >= 0 else _f32(-1.0 / xi)

    def sample(self, gen, shape=()):
        return self.quantile(_uniform(gen, shape, _f32(0.0),
                                      _f32(1.0 - 1e-7)))

    def logpdf(self, x):
        z = (x - float(self.mu)) / float(self.sigma)
        inside = (z >= 0) & (z < float(self._zhi))
        zs = torch.where(inside, z, 0.0)
        if float(self.xi) == 0.0:
            lp = -zs - float(self._lsg)
        else:
            lp = (float(-(1.0 / self.xi + 1.0))
                  * torch.log1p(float(self.xi) * zs) - float(self._lsg))
        return torch.where(inside, lp, _NEG_INF)

    def cdf(self, x):
        z = torch.clamp((_as_f32(x) - float(self.mu)) / float(self.sigma),
                        0.0, float(self._zhi))
        if float(self.xi) == 0.0:
            return 1.0 - torch.exp(-z)
        return 1.0 - torch.exp(float(np.float32(-1.0 / float(self.xi)))
                               * torch.log1p(float(self.xi) * z))

    def quantile(self, q):
        q = _as_f32(q)
        if float(self.xi) == 0.0:
            return float(self.mu) - float(self.sigma) * torch.log1p(-q)
        return float(self.mu) + float(self.sigma) * torch.expm1(
            float(np.float32(-float(self.xi))) * torch.log1p(-q)) \
            / float(self.xi)


class Kumaraswamy(Distribution):
    """Kumaraswamy on (0, 1) with shapes ``a``, ``b``
    (Distributions.jl ``Kumaraswamy(a, b)``): cdf 1 - (1 - x^a)^b."""

    _fields = ("a", "b")

    def __init__(self, a, b):
        self.a, self.b = _f32(a), _f32(b)
        a, b = float(self.a), float(self.b)
        if not (a > 0 and b > 0):
            raise ValueError("Kumaraswamy needs a > 0 and b > 0")
        self._lab = _f32(math.log(a) + math.log(b))

    def sample(self, gen, shape=()):
        return self.quantile(_uniform(gen, shape, _f32(1e-7),
                                      _f32(1.0 - 1e-7)))

    def logpdf(self, x):
        inside = (x > 0) & (x < 1)
        xs = torch.where(inside, x, 0.5)
        lp = (float(self._lab) + float(self.a - 1.0) * torch.log(xs)
              + float(self.b - 1.0) * torch.log1p(-xs ** float(self.a)))
        return torch.where(inside, lp, _NEG_INF)

    def cdf(self, x):
        xc = torch.clamp(_as_f32(x), 0.0, 1.0)
        return 1.0 - torch.exp(float(self.b)
                               * torch.log1p(-xc ** float(self.a)))

    def quantile(self, q):
        inv_b = float(np.float32(1.0 / float(self.b)))
        inv_a = float(np.float32(1.0 / float(self.a)))
        return (-torch.expm1(inv_b * torch.log1p(-_as_f32(q)))) ** inv_a


@functools.lru_cache(maxsize=64)
def _vonmises_table(mu, kappa, n):
    """scipy's VonMises quantile at n points of [0, 1] in float32, ends
    at mu -/+ pi, as the JAX package's table: each point by 80 float64
    bisections of scipy's cdf on [mu - pi, mu + pi] (the true root to
    within 1e-22, where scipy's ``ppf`` root-finds each point to 1e-14,
    about 4 ms a point), so both round to the same float32 but where a
    root lies within 1e-14 of a rounding boundary."""
    qs = np.linspace(0.0, 1.0, n)
    cdf = sst.vonmises(kappa, loc=mu).cdf
    lo = np.full(n, mu - math.pi)
    hi = np.full(n, mu + math.pi)
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        below = cdf(mid) < qs
        lo, hi = np.where(below, mid, lo), np.where(below, hi, mid)
    tab = 0.5 * (lo + hi)
    tab[0], tab[-1] = mu - math.pi, mu + math.pi
    tab = tab.astype(_f32)
    tab.setflags(write=False)
    return tab


class VonMises(Distribution):
    """von Mises on [mu - pi, mu + pi] with concentration ``kappa``
    (Distributions.jl ``VonMises(mu, kappa)``). The logpdf is exact (the
    I0(kappa) normalizer is a host constant); sampling and the quantile
    interpolate linearly in a host table of scipy's quantile at 8193
    points, as the JAX package does, so equal uniforms give equal
    draws."""

    _fields = ("mu", "kappa")
    _TAB = 8193

    def __init__(self, mu, kappa):
        if not float(kappa) > 0:
            raise ValueError("VonMises needs kappa > 0")
        self.mu, self.kappa = _f32(mu), _f32(kappa)
        self._lnorm = _f32(_LOG_2PI + math.log(float(sps.i0e(self.kappa)))
                           + float(self.kappa))
        self._tab = _vonmises_table(float(self.mu), float(self.kappa),
                                    self._TAB).copy()

    def sample(self, gen, shape=()):
        return self.quantile(torch.rand(shape, generator=gen,
                                        device=gen.device))

    def logpdf(self, x):
        inside = torch.abs(x - float(self.mu)) <= float(np.float32(math.pi))
        return torch.where(inside, float(self.kappa) * torch.cos(
            x - float(self.mu)) - float(self._lnorm), _NEG_INF)

    def quantile(self, q):
        t = _as_f32(q) * float(self._TAB - 1)
        i = torch.clamp(t.to(torch.int32), 0, self._TAB - 2).to(torch.int64)
        f = t - i
        tab = self._host("_tab", t)
        lo, hi = tab[i], tab[i + 1]
        return lo + f * (hi - lo)

    def cdf(self, x):
        # the inverse of the monotone table (searchsorted, linear)
        xf = _as_f32(x)
        tab = self._host("_tab", xf)
        xc = torch.clamp(xf, float(self._tab[0]), float(self._tab[-1]))
        i = torch.clamp(torch.searchsorted(tab, xc.reshape(-1), right=True)
                        .reshape(xc.shape) - 1, 0, self._TAB - 2)
        lo, hi = tab[i], tab[i + 1]
        f = torch.where(hi > lo, (xc - lo) / (hi - lo), 0.0)
        return (i + f) / float(self._TAB - 1)


class SymTriangularDist(Distribution):
    """Symmetric triangular on [mu - sigma, mu + sigma]
    (Distributions.jl ``SymTriangularDist(mu, sigma)``)."""

    _fields = ("mu", "sigma")

    def __init__(self, mu, sigma):
        self.mu, self.sigma = _f32(mu), _f32(sigma)
        if not float(self.sigma) > 0:
            raise ValueError("SymTriangularDist needs sigma > 0")
        self._ls = _f32(math.log(float(self.sigma)))

    def sample(self, gen, shape=()):
        # the difference of two uniforms is symmetric triangular on [-1, 1]
        u = torch.rand((2,) + tuple(shape), generator=gen, device=gen.device)
        return float(self.mu) + float(self.sigma) * (u[0] - u[1])

    def logpdf(self, x):
        z = torch.abs(x - float(self.mu)) / float(self.sigma)
        inside = z <= 1.0
        zs = torch.where(inside, torch.clamp(z, max=float(_f32(1 - 1e-7))),
                         0.0)
        return torch.where(inside, torch.log1p(-zs) - float(self._ls),
                           _NEG_INF)

    def cdf(self, x):
        z = torch.clamp((_as_f32(x) - float(self.mu)) / float(self.sigma),
                        -1.0, 1.0)
        lower = 0.5 * (1.0 + z) ** 2
        upper = 1.0 - 0.5 * (1.0 - z) ** 2
        return torch.where(z < 0, lower, upper)

    def quantile(self, q):
        q = _as_f32(q)
        z = torch.where(q < 0.5, torch.sqrt(2.0 * q) - 1.0,
                        1.0 - torch.sqrt(2.0 * torch.clamp(1.0 - q,
                                                           min=0.0)))
        return float(self.mu) + float(self.sigma) * z


class Cosine(Distribution):
    """Raised cosine on [mu - sigma, mu + sigma]
    (Distributions.jl ``Cosine(mu, sigma)``): pdf (1 + cos(pi z)) / (2
    sigma)."""

    _fields = ("mu", "sigma")

    def __init__(self, mu, sigma):
        self.mu, self.sigma = _f32(mu), _f32(sigma)
        if not float(self.sigma) > 0:
            raise ValueError("Cosine needs sigma > 0")
        self._l2s = _f32(math.log(2.0 * float(self.sigma)))

    def sample(self, gen, shape=()):
        return self.quantile(torch.rand(shape, generator=gen,
                                        device=gen.device))

    def logpdf(self, x):
        z = (x - float(self.mu)) / float(self.sigma)
        inside = torch.abs(z) <= 1.0
        zs = torch.where(inside, z, 0.0)
        p1 = torch.clamp(1.0 + torch.cos(float(np.float32(math.pi)) * zs),
                         min=1e-37)
        return torch.where(inside, torch.log(p1) - float(self._l2s),
                           _NEG_INF)

    def cdf(self, x):
        pi = float(np.float32(math.pi))
        z = torch.clamp((_as_f32(x) - float(self.mu)) / float(self.sigma),
                        -1.0, 1.0)
        return 0.5 * (1.0 + z + torch.sin(pi * z) / pi)

    def quantile(self, q):
        return _bisect_quantile(self.cdf, _f32(self.mu - self.sigma),
                                _f32(self.mu + self.sigma), q)


class _PolyKernel(Distribution):
    """The polynomial smoothing-kernel distributions (Epanechnikov,
    Biweight, Triweight; Distributions.jl names) on [mu - sigma, mu +
    sigma]: pdf c/sigma * (1 - z^2)^m."""

    _fields = ("mu", "sigma")
    _m = 1       # exponent
    _c = 0.75    # normalizer of (1-z^2)^m on [-1, 1]

    def __init__(self, mu, sigma):
        self.mu, self.sigma = _f32(mu), _f32(sigma)
        if not float(self.sigma) > 0:
            raise ValueError(f"{type(self).__name__} needs sigma > 0")
        self._lc = _f32(math.log(self._c) - math.log(float(self.sigma)))

    def sample(self, gen, shape=()):
        return self.quantile(torch.rand(shape, generator=gen,
                                        device=gen.device))

    def logpdf(self, x):
        z = (x - float(self.mu)) / float(self.sigma)
        inside = torch.abs(z) <= 1.0
        zs = torch.where(inside, z, 0.0)
        base = torch.clamp(1.0 - zs * zs, min=1e-37)
        return torch.where(inside, float(self._lc) + float(self._m)
                           * torch.log(base), _NEG_INF)

    def cdf(self, x):
        z = torch.clamp((_as_f32(x) - float(self.mu)) / float(self.sigma),
                        -1.0, 1.0)
        return self._cdf_z(z)

    def quantile(self, q):
        return _bisect_quantile(self.cdf, _f32(self.mu - self.sigma),
                                _f32(self.mu + self.sigma), q)


class Epanechnikov(_PolyKernel):
    """Epanechnikov kernel: pdf 3/(4 sigma) (1 - z^2)."""

    _m, _c = 1, 0.75

    def _cdf_z(self, z):
        return 0.5 + 0.25 * (3.0 * z - z ** 3)

    def sample(self, gen, shape=()):
        # exact: the median of three iid U(-1, 1) is Epanechnikov
        u = _uniform(gen, tuple(shape) + (3,), _f32(-1.0), _f32(1.0))
        return float(self.mu) + float(self.sigma) * torch.median(
            u, dim=-1).values


class Biweight(_PolyKernel):
    """Biweight (quartic) kernel: pdf 15/(16 sigma) (1 - z^2)^2."""

    _m, _c = 2, 15.0 / 16.0

    def _cdf_z(self, z):
        return 0.5 + float(np.float32(15.0 / 16.0)) * (
            z - 2.0 * z ** 3 / 3.0 + z ** 5 / 5.0)


class Triweight(_PolyKernel):
    """Triweight kernel: pdf 35/(32 sigma) (1 - z^2)^3."""

    _m, _c = 3, 35.0 / 32.0

    def _cdf_z(self, z):
        return 0.5 + float(np.float32(35.0 / 32.0)) * (
            z - z ** 3 + 3.0 * z ** 5 / 5.0 - z ** 7 / 7.0)


class JohnsonSU(Distribution):
    """Johnson S_U (Distributions.jl ``JohnsonSU(xi, lambda, gamma,
    delta)``): X = xi + lambda * sinh((Z - gamma) / delta), Z ~ N(0,1)."""

    _fields = ("xi", "lam", "gamma", "delta")

    def __init__(self, xi, lam, gamma, delta):
        self.xi, self.lam = _f32(xi), _f32(lam)
        self.gamma, self.delta = _f32(gamma), _f32(delta)
        lam, dl = float(self.lam), float(self.delta)
        if not (lam > 0 and dl > 0):
            raise ValueError("JohnsonSU needs lambda > 0 and delta > 0")
        self._lc = _f32(math.log(dl) - math.log(lam) - 0.5 * _LOG_2PI)

    def sample(self, gen, shape=()):
        z = torch.randn(shape, generator=gen, device=gen.device)
        return float(self.xi) + float(self.lam) * torch.sinh(
            (z - float(self.gamma)) / float(self.delta))

    def _r(self, x):
        z = (x - float(self.xi)) / float(self.lam)
        return z, float(self.gamma) + float(self.delta) * torch.asinh(z)

    def logpdf(self, x):
        z, r = self._r(x)
        return float(self._lc) - 0.5 * torch.log1p(z * z) - 0.5 * r * r

    def cdf(self, x):
        return torch.special.ndtr(self._r(_as_f32(x))[1])

    def quantile(self, q):
        z = torch.special.ndtri(_as_f32(q))
        return float(self.xi) + float(self.lam) * torch.sinh(
            (z - float(self.gamma)) / float(self.delta))


class GeneralizedExtremeValue(Distribution):
    """GEV with location ``mu``, scale ``sigma``, shape ``xi``
    (Distributions.jl ``GeneralizedExtremeValue(mu, sigma, xi)``); the
    xi == 0 (Gumbel) case branches on the host constant."""

    _fields = ("mu", "sigma", "xi")

    def __init__(self, mu, sigma, xi):
        if not float(sigma) > 0:
            raise ValueError("GeneralizedExtremeValue needs sigma > 0")
        self.mu, self.sigma, self.xi = _f32(mu), _f32(sigma), _f32(xi)
        self._lsg = _f32(math.log(float(self.sigma)))

    def _inside(self, z):
        xi = float(self.xi)
        if xi == 0.0:
            return None
        return z > float(_f32(-1.0 / xi)) if xi > 0 \
            else z < float(_f32(-1.0 / xi))

    def sample(self, gen, shape=()):
        return self.quantile(_uniform(gen, shape, _f32(1e-7),
                                      _f32(1.0 - 1e-7)))

    def logpdf(self, x):
        z = (x - float(self.mu)) / float(self.sigma)
        inside = self._inside(z)
        if inside is None:   # xi == 0: every real is inside
            return -z - torch.exp(-z) - float(self._lsg)
        zs = torch.where(inside, z, 0.0)
        # log t = -(1/xi) log1p(xi z); log pdf = (xi+1) log t - t - log s
        lt = float(np.float32(-1.0 / float(self.xi))) * torch.log1p(
            float(self.xi) * zs)
        lp = float(self.xi + 1.0) * lt - torch.exp(lt) - float(self._lsg)
        return torch.where(inside, lp, _NEG_INF)

    def cdf(self, x):
        z = (_as_f32(x) - float(self.mu)) / float(self.sigma)
        if float(self.xi) == 0.0:
            return torch.exp(-torch.exp(-z))
        inside = self._inside(z)
        zs = torch.where(inside, z, 0.0)
        t = torch.exp(float(np.float32(-1.0 / float(self.xi)))
                      * torch.log1p(float(self.xi) * zs))
        return torch.where(inside, torch.exp(-t),
                           0.0 if float(self.xi) > 0 else 1.0)

    def quantile(self, q):
        q = _as_f32(q)
        if float(self.xi) == 0.0:
            return float(self.mu) - float(self.sigma) * torch.log(
                -torch.log(q))
        return float(self.mu) + float(self.sigma) * torch.expm1(
            float(np.float32(-float(self.xi))) * torch.log(-torch.log(q))) \
            / float(self.xi)


class InverseGaussian(Distribution):
    """Inverse Gaussian (Wald) with mean ``mu`` and shape ``lam``
    (Distributions.jl ``InverseGaussian(mu, lambda)``)."""

    _fields = ("mu", "lam")

    def __init__(self, mu, lam):
        self.mu, self.lam = _f32(mu), _f32(lam)
        mu, lam = float(self.mu), float(self.lam)
        if not (mu > 0 and lam > 0):
            raise ValueError("InverseGaussian needs mu > 0 and lambda > 0")
        self._lc = _f32(0.5 * (math.log(lam) - _LOG_2PI))
        self._qhi = _f32(float(sst.invgauss(mu / lam, scale=lam).ppf(
            1 - 1e-9)))
        self._c2 = _f32(2.0 * self.mu ** 2)
        self._tlm = _f32(2.0 * self.lam / self.mu)

    def sample(self, gen, shape=()):
        # Michael-Schucany-Haas: exact, no rejection loop
        nu = torch.randn(shape, generator=gen, device=gen.device) ** 2
        mu, lam = float(self.mu), float(self.lam)
        x1 = (mu + float(_f32(self.mu * self.mu)) * nu / float(
            _f32(2.0 * self.lam)) - float(_f32(self.mu / (2.0 * self.lam)))
            * torch.sqrt(float(_f32(4.0 * self.mu * self.lam)) * nu
                         + (mu * nu) ** 2))
        x1 = torch.clamp(x1, min=1e-30)   # float32 cancellation guard
        u = torch.rand(shape, generator=gen, device=gen.device)
        return torch.where(u < mu / (mu + x1), x1, mu * mu / x1)

    def logpdf(self, x):
        ok = x > 0
        xs = torch.where(ok, x, 1.0)
        lp = (float(self._lc) - 1.5 * torch.log(xs)
              - float(self.lam) * (xs - float(self.mu)) ** 2
              / (float(self._c2) * xs))
        return torch.where(ok, lp, _NEG_INF)

    def cdf(self, x):
        x = _as_f32(x)
        ok = x > 0
        xs = torch.where(ok, x, 1.0)
        r = torch.sqrt(float(self.lam) / xs)
        a = torch.special.ndtr(r * (xs / float(self.mu) - 1.0))
        # exp(2 lam/mu) overflows alone: fold it into the log-cdf term
        b = torch.exp(float(self._tlm) + torch.special.log_ndtr(
            -r * (xs / float(self.mu) + 1.0)))
        return torch.where(ok, a + b, 0.0)

    def quantile(self, q):
        return _bisect_quantile(self.cdf, 0.0, self._qhi, q)


class Chi(Distribution):
    """Chi distribution with ``nu`` degrees of freedom
    (Distributions.jl ``Chi(nu)``): the square root of a Chisq(nu)."""

    _fields = ("nu",)

    def __init__(self, nu):
        self.nu = _f32(nu)
        nu = float(self.nu)
        if not nu > 0:
            raise ValueError("Chi needs nu > 0")
        self._lc = _f32(-(0.5 * nu - 1.0) * math.log(2.0)
                        - sps.gammaln(0.5 * nu))
        self._qhi = _f32(float(sst.chi(nu).ppf(1 - 1e-9)))
        self._half = np.float32(0.5 * nu)

    def sample(self, gen, shape=()):
        return torch.sqrt(2.0 * _std_gamma(gen, self._half, shape))

    def logpdf(self, x):
        ok = x > 0
        xs = torch.where(ok, x, 1.0)
        lp = (float(self.nu - 1.0) * torch.log(xs) - 0.5 * xs * xs
              + float(self._lc))
        return torch.where(ok, lp, _NEG_INF)

    def cdf(self, x):
        xs = torch.clamp(_as_f32(x), min=0.0)
        z = 0.5 * xs * xs
        return torch.special.gammainc(torch.full_like(z, float(self._half)),
                                      z)

    def quantile(self, q):
        return _bisect_quantile(self.cdf, 0.0, self._qhi, q)


class PGeneralizedGaussian(Distribution):
    """p-generalized Gaussian (exponential power)
    (Distributions.jl ``PGeneralizedGaussian(mu, alpha, p)``):
    pdf p/(2 alpha Gamma(1/p)) exp(-|z|^p)."""

    _fields = ("mu", "alpha", "p")

    def __init__(self, mu, alpha, p):
        self.mu, self.alpha, self.p = _f32(mu), _f32(alpha), _f32(p)
        a, p = float(self.alpha), float(self.p)
        if not (a > 0 and p > 0):
            raise ValueError("PGeneralizedGaussian needs alpha > 0, p > 0")
        self._lc = _f32(math.log(p) - math.log(2.0 * a) - sps.gammaln(1.0 / p))
        self._inv_p = _f32(1.0 / p)
        self._zhi = _f32(float(sst.gennorm(p).ppf(1 - 1e-9)))

    def sample(self, gen, shape=()):
        g = _std_gamma(gen, self._inv_p, shape)
        s = 2.0 * torch.randint(0, 2, tuple(shape), generator=gen,
                                device=gen.device).to(torch.float32) - 1.0
        return float(self.mu) + float(self.alpha) * s \
            * g ** float(self._inv_p)

    def logpdf(self, x):
        z = torch.abs((x - float(self.mu)) / float(self.alpha))
        return float(self._lc) - z ** float(self.p)

    def cdf(self, x):
        z = (_as_f32(x) - float(self.mu)) / float(self.alpha)
        t = torch.abs(z) ** float(self.p)
        half_tail = 0.5 * torch.special.gammainc(
            torch.full_like(t, float(self._inv_p)), t)
        return 0.5 + torch.sign(z) * half_tail

    def quantile(self, q):
        lo = _f32(self.mu - self.alpha * self._zhi)
        hi = _f32(self.mu + self.alpha * self._zhi)
        return _bisect_quantile(self.cdf, lo, hi, q)


class Rician(Distribution):
    """Rician (Distributions.jl ``Rician(nu, sigma)``): the norm of a 2-D
    normal with mean radius ``nu``. The logpdf uses the exponentially
    scaled Bessel i0e, so it is stable at large x*nu/sigma^2."""

    _fields = ("nu", "sigma")

    def __init__(self, nu, sigma):
        self.nu, self.sigma = _f32(nu), _f32(sigma)
        nu, sg = float(self.nu), float(self.sigma)
        if not (nu >= 0 and sg > 0):
            raise ValueError("Rician needs nu >= 0 and sigma > 0")
        self._l2sg = _f32(2.0 * math.log(sg))
        # cdf through X^2/sigma^2 ~ NoncentralChisq(2, nu^2/sigma^2): a
        # Poisson mixture series, host weights cut at 1e-12 tail mass
        half = nu * nu / (2.0 * sg * sg)
        kmax = int(sst.poisson(half).ppf(1 - 1e-12)) + 3 if half > 0 else 1
        ks = np.arange(kmax)
        lw = sst.poisson(half).logpmf(ks) if half > 0 else np.zeros(1)
        self._w = np.exp(lw).astype(_f32)
        self._shapes = (1.0 + ks).astype(_f32)
        self._qhi = _f32(float(sst.rice(nu / sg, scale=sg).ppf(1 - 1e-9))
                         if nu > 0 else
                         float(sst.rayleigh(scale=sg).ppf(1 - 1e-9)))
        self._s2 = _f32(self.sigma ** 2)
        self._nu2 = _f32(self.nu ** 2)
        self._2s2 = _f32(2.0 * self._s2)

    def sample(self, gen, shape=()):
        z = torch.randn((2,) + tuple(shape), generator=gen, device=gen.device)
        sg = float(self.sigma)
        return torch.sqrt((float(self.nu) + sg * z[0]) ** 2
                          + (sg * z[1]) ** 2)

    def logpdf(self, x):
        ok = x > 0
        xs = torch.where(ok, x, 1.0)
        t = xs * float(self.nu) / float(self._s2)
        # log I0(t) = log i0e(t) + t
        lp = (torch.log(xs) - float(self._l2sg)
              - (xs * xs + float(self._nu2)) / float(self._2s2)
              + torch.log(i0e(t)) + t)
        return torch.where(ok, lp, _NEG_INF)

    def cdf(self, x):
        xs = torch.clamp(_as_f32(x), min=0.0)
        z = (xs * xs / float(self._2s2))[..., None]
        shapes = self._host("_shapes", z)
        g = torch.special.gammainc(shapes.expand(z.shape[:-1] + shapes.shape),
                                   z.expand(z.shape[:-1] + shapes.shape))
        return torch.sum(self._host("_w", z) * g, dim=-1)

    def quantile(self, q):
        return _bisect_quantile(self.cdf, 0.0, self._qhi, q)


class Lindley(Distribution):
    """Lindley (Distributions.jl ``Lindley(theta)``): the mixture
    theta/(1+theta) Exp(1/theta) + 1/(1+theta) Gamma(2, 1/theta); pdf
    theta^2/(1+theta) (1+x) exp(-theta x)."""

    _fields = ("theta",)

    def __init__(self, theta):
        self.theta = _f32(theta)
        th = float(self.theta)
        if not th > 0:
            raise ValueError("Lindley needs theta > 0")
        self._lc = _f32(2.0 * math.log(th) - math.log1p(th))
        self._wexp = _f32(th / (1.0 + th))
        self._qhi = _f32(60.0 / th)
        self._1pt = _f32(1.0 + self.theta)

    def sample(self, gen, shape=()):
        e = torch.empty((2,) + tuple(shape), dtype=torch.float32,
                        device=gen.device).exponential_(generator=gen)
        u = torch.rand(shape, generator=gen, device=gen.device)
        # Exp(1)/theta w.p. theta/(1+theta), else (Exp+Exp)/theta
        extra = torch.where(u < float(self._wexp), 0.0, e[1])
        return (e[0] + extra) / float(self.theta)

    def logpdf(self, x):
        ok = x >= 0
        xs = torch.where(ok, x, 0.0)
        return torch.where(ok, float(self._lc) + torch.log1p(xs)
                           - float(self.theta) * xs, _NEG_INF)

    def cdf(self, x):
        xs = torch.clamp(_as_f32(x), min=0.0)
        th = float(self.theta)
        return 1.0 - (1.0 + th * xs / float(self._1pt)) * torch.exp(-th * xs)

    def quantile(self, q):
        return _bisect_quantile(self.cdf, 0.0, self._qhi, q)


class LogitNormal(Distribution):
    """Logit-normal on (0, 1) (Distributions.jl ``LogitNormal(mu,
    sigma)``): logit(X) ~ Normal(mu, sigma)."""

    _fields = ("mu", "sigma")

    def __init__(self, mu, sigma):
        self.mu, self.sigma = _f32(mu), _f32(sigma)
        if not float(self.sigma) > 0:
            raise ValueError("LogitNormal needs sigma > 0")
        self._lnorm = _f32(math.log(float(self.sigma)) + 0.5 * _LOG_2PI)

    def sample(self, gen, shape=()):
        z = torch.randn(shape, generator=gen, device=gen.device)
        return torch.sigmoid(float(self.mu) + float(self.sigma) * z)

    def logpdf(self, x):
        inside = (x > 0) & (x < 1)
        xs = torch.where(inside, torch.clamp(x, 1e-7, 1.0 - 1e-7), 0.5)
        lgt = torch.log(xs) - torch.log1p(-xs)
        z = (lgt - float(self.mu)) / float(self.sigma)
        lp = (-0.5 * z * z - float(self._lnorm) - torch.log(xs)
              - torch.log1p(-xs))
        return torch.where(inside, lp, _NEG_INF)

    def cdf(self, x):
        x = _as_f32(x)
        xc = torch.clamp(x, 1e-7, 1.0 - 1e-7)
        lgt = torch.log(xc) - torch.log1p(-xc)
        c = torch.special.ndtr((lgt - float(self.mu)) / float(self.sigma))
        return torch.where(x <= 0, 0.0, torch.where(x >= 1, 1.0, c))

    def quantile(self, q):
        return torch.sigmoid(float(self.mu) + float(self.sigma)
                             * torch.special.ndtri(_as_f32(q)))


class NoncentralChisq(Distribution):
    """Noncentral chi-squared (Distributions.jl ``NoncentralChisq(nu,
    lambda)``). Sampling is exact through the Poisson-Gamma mixture X =
    2 Gamma(nu/2 + K), K ~ Poisson(lambda/2); logpdf and cdf sum the
    Poisson mixture series with host weights cut at 1e-12 tail mass."""

    _fields = ("nu", "lam")

    def __init__(self, nu, lam):
        self.nu, self.lam = _f32(nu), _f32(lam)
        nu, lam = float(self.nu), float(self.lam)
        if not (nu > 0 and lam >= 0):
            raise ValueError("NoncentralChisq needs nu > 0, lambda >= 0")
        half = lam / 2.0
        kmax = int(sst.poisson(half).ppf(1 - 1e-12)) + 3 if half > 0 else 1
        ks = np.arange(kmax)
        lw = sst.poisson(half).logpmf(ks) if half > 0 else np.zeros(1)
        shapes = nu / 2.0 + ks
        # log w_k - a_k log 2 - lgamma(a_k): everything but the x terms
        self._ck = (lw - shapes * math.log(2.0)
                    - sps.gammaln(shapes)).astype(_f32)
        self._shapes = shapes.astype(_f32)
        self._lw = lw.astype(_f32)
        self._qhi = _f32(float(sst.ncx2(nu, lam).ppf(1 - 1e-9)) if lam > 0
                         else float(sst.chi2(nu).ppf(1 - 1e-9)))

    def sample(self, gen, shape=()):
        shape = tuple(shape)
        if float(self.lam) > 0:
            rate = torch.full(shape, float(np.float32(float(self.lam) / 2.0)),
                              device=gen.device)
            k = torch.poisson(rate, generator=gen)
        else:
            k = torch.zeros(shape, device=gen.device)
        a = float(np.float32(float(self.nu) / 2.0)) + k
        return 2.0 * torch._standard_gamma(a, generator=gen)

    def logpdf(self, x):
        ok = x > 0
        xs = torch.where(ok, x, 1.0)
        lx = torch.log(xs)[..., None]
        terms = self._host("_ck", lx) + (self._host("_shapes", lx) - 1.0) * lx
        lp = torch.logsumexp(terms, dim=-1) - 0.5 * xs
        return torch.where(ok, lp, _NEG_INF)

    def cdf(self, x):
        xs = torch.clamp(_as_f32(x), min=0.0)[..., None]
        shapes = self._host("_shapes", xs)
        full = xs.shape[:-1] + shapes.shape
        g = torch.special.gammainc(shapes.expand(full),
                                   (0.5 * xs).expand(full))
        return torch.sum(torch.exp(self._host("_lw", xs)) * g, dim=-1)

    def quantile(self, q):
        return _bisect_quantile(self.cdf, 0.0, self._qhi, q)


# --------------------------------------------------------------------------
# Discrete univariate
# --------------------------------------------------------------------------

class DiscreteUniform(Distribution):
    """Integers ``a..b`` with equal mass. Samples are int32, as in the
    JAX package; the population evolves them in float32 and ``push``
    rounds half to even to int32, as the JAX package's discrete push
    does."""

    _fields = ("a", "b")
    discrete = True

    def __init__(self, a=0, b=1):
        self.a, self.b = _f32(a), _f32(b)
        self._lpmf = _f32(np.log(self.b - self.a + 1))

    def sample(self, gen, shape=()):
        # an int64 draw cast to int32: the values and the generator's
        # stream are those of the int64 draw
        return torch.randint(int(self.a), int(self.b) + 1, shape,
                             generator=gen, device=gen.device).to(torch.int32)

    def logpdf(self, x):
        inside = (x >= float(self.a)) & (x <= float(self.b))
        return torch.where(inside, _full(x, -self._lpmf), _full(x, _NEG_INF))


class Poisson(Distribution):
    """Poisson(lam); samples are int32, as in the JAX package."""

    _fields = ("lam",)
    discrete = True

    def __init__(self, lam):
        self.lam = _f32(lam)
        self._llam = _f32(np.log(self.lam))

    def sample(self, gen, shape=()):
        rate = torch.full(tuple(shape), float(self.lam), dtype=torch.float32,
                          device=gen.device)
        return torch.poisson(rate, generator=gen).to(torch.int32)

    def logpdf(self, x):
        xf = x.to(torch.float32)
        ok = xf >= 0
        xs = torch.where(ok, xf, _full(xf, 0.0))
        return torch.where(ok, xs * float(self._llam) - float(self.lam)
                           - torch.lgamma(xs + 1.0), _full(xf, _NEG_INF))


def _categorical(gen, cum, shape):
    """Indices with P(i) = cum[i] - cum[i-1] by inverse cdf on a float32
    cumulative table (a tensor on the generator's device)."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    idx = torch.searchsorted(cum, u.reshape(-1), right=True)
    return torch.clamp(idx, max=cum.shape[0] - 1).reshape(u.shape)


class DiscreteNonParametric(Distribution):
    """Arbitrary finite-support discrete distribution
    (Distributions.jl ``DiscreteNonParametric(xs, ps)``): atom ``xs[i]``
    with probability ``ps[i]``. Atoms may be non-integer; ``push`` snaps
    a float-evolved value to the NEAREST atom."""

    discrete = True

    def __init__(self, xs, ps):
        xs = np.asarray(xs, _f32)
        ps = np.asarray(ps, np.float64)
        if xs.ndim != 1 or xs.shape != ps.shape:
            raise ValueError("DiscreteNonParametric needs 1-D xs, ps of "
                             "equal length")
        if np.any(ps < 0) or not np.isclose(ps.sum(), 1.0, atol=1e-6):
            raise ValueError("DiscreteNonParametric weights must be "
                             "nonnegative and sum to 1")
        # merge duplicate atoms so logpdf and sample agree on the pmf
        uxs, inv = np.unique(xs, return_inverse=True)
        ups = np.zeros(uxs.shape, np.float64)
        np.add.at(ups, inv, ps)
        self.xs, self.ps = uxs, ups.astype(_f32)
        p64 = np.asarray(self.ps, np.float64)
        self._logp = np.log(np.clip(p64, np.finfo(np.float64).tiny,
                                    None)).astype(_f32)
        self._cum = np.cumsum(p64).astype(_f32)
        self._cum0 = np.concatenate([np.zeros(1, _f32), self._cum])
        x64 = np.asarray(self.xs, np.float64)
        self._isint = bool(np.all(x64 == np.round(x64)))
        # midpoints between consecutive atoms drive nearest-atom push
        self._mids = (0.5 * (x64[1:] + x64[:-1])).astype(_f32)

    def _out(self, v):
        return v.to(torch.int32) if self._isint else v.to(torch.float32)

    def sample(self, gen, shape=()):
        xs = self._host("xs", gen)
        return self._out(xs[_categorical(gen, self._host("_cum", xs),
                                         shape)])

    def push(self, x):
        xf = x.to(torch.float32)
        mids = self._host("_mids", xf)
        idx = torch.searchsorted(mids, xf.reshape(-1)).reshape(xf.shape)
        return self._out(self._host("xs", xf)[idx])

    def logpdf(self, x):
        xf = x.to(torch.float32)
        xs = self._host("xs", xf)
        idx = torch.clamp(torch.searchsorted(xs, xf.reshape(-1)),
                          0, len(self.xs) - 1).reshape(xf.shape)
        hit = (xs[idx] == xf) & (self._host("ps", xf)[idx] > 0)
        return torch.where(hit, self._host("_logp", xf)[idx],
                           _full(xf, _NEG_INF))

    def cdf(self, x):
        xf = x.to(torch.float32)
        idx = torch.searchsorted(self._host("xs", xf), xf.reshape(-1),
                                 right=True).reshape(xf.shape)
        return self._host("_cum0", xf)[idx]

    def quantile(self, q):
        q = _as_f32(q)
        idx = torch.clamp(torch.searchsorted(self._host("_cum", q),
                                             q.reshape(-1)),
                          0, len(self.xs) - 1).reshape(q.shape)
        return self._out(self._host("xs", q)[idx])

    def __repr__(self):
        return f"DiscreteNonParametric(xs={self.xs}, ps={self.ps})"


class Bernoulli(Distribution):
    """Bernoulli success probability ``p`` (support {0, 1})."""

    _fields = ("p",)
    discrete = True

    def __init__(self, p):
        self.p = _f32(p)
        # no clamps: Bernoulli(0) and Bernoulli(1) give exactly -inf to
        # the impossible outcome
        p = float(self.p)
        self._lp = _f32(np.log(p)) if p > 0 else _f32(-np.inf)
        self._l1p = _f32(np.log1p(-p)) if p < 1 else _f32(-np.inf)

    def sample(self, gen, shape=()):
        u = torch.rand(shape, generator=gen, device=gen.device)
        return (u < float(self.p)).to(torch.int32)

    def logpdf(self, x):
        xf = x.to(torch.float32)
        ok = (xf == 0) | (xf == 1)
        return torch.where(ok, torch.where(xf > 0.5, float(self._lp),
                                           float(self._l1p)), _NEG_INF)


def _binomial(gen, n, p, shape):
    """Binomial(n, p) counts as float32 (``p`` a number or a tensor of
    ``shape``)."""
    count = torch.full(tuple(shape), float(n), device=gen.device)
    prob = p if torch.is_tensor(p) else torch.full_like(count, float(p))
    return torch.binomial(count, prob, generator=gen)


class Binomial(Distribution):
    _fields = ("n", "p")
    discrete = True

    def __init__(self, n, p):
        self.n, self.p = _f32(n), _f32(p)
        self._lgn1 = _f32(sps.gammaln(self.n + 1))
        self._lp = _f32(np.log(max(self.p, 1e-37)))
        self._l1p = _f32(np.log1p(-min(self.p, 1 - 1e-7)))

    def sample(self, gen, shape=()):
        return _binomial(gen, self.n, self.p, shape).to(torch.int32)

    def logpdf(self, x):
        xf = x.to(torch.float32)
        n = float(self.n)
        inside = (xf >= 0) & (xf <= n)
        xs = torch.where(inside, xf, 0.0)
        lp = (float(self._lgn1) - torch.lgamma(xs + 1)
              - torch.lgamma(n - xs + 1) + xs * float(self._lp)
              + (n - xs) * float(self._l1p))
        return torch.where(inside, lp, _NEG_INF)


class Geometric(Distribution):
    """Number of failures before the first success: P(X=k) = p(1-p)^k."""

    _fields = ("p",)
    discrete = True

    def __init__(self, p):
        self.p = _f32(p)
        self._lp = _f32(np.log(self.p))
        self._l1p = _f32(np.log1p(-self.p))

    def sample(self, gen, shape=()):
        u = torch.rand(shape, generator=gen, device=gen.device)
        return torch.floor(torch.log1p(-u) / float(self._l1p)).to(
            torch.int32)

    def logpdf(self, x):
        xf = x.to(torch.float32)
        ok = xf >= 0
        xs = torch.where(ok, xf, 0.0)
        return torch.where(ok, float(self._lp) + xs * float(self._l1p),
                           _NEG_INF)


class BetaBinomial(Distribution):
    """Beta-binomial: Binomial(n, p) with p ~ Beta(alpha, beta)
    (Distributions.jl ``BetaBinomial(n, alpha, beta)``)."""

    _fields = ("n", "alpha", "beta")
    discrete = True

    def __init__(self, n, alpha, beta):
        self.n, self.alpha, self.beta = _f32(n), _f32(alpha), _f32(beta)
        n, a, b = float(self.n), float(self.alpha), float(self.beta)
        if not (n == int(n) and n >= 0 and a > 0 and b > 0):
            raise ValueError(
                "BetaBinomial needs integer n >= 0, alpha > 0, beta > 0")
        # log C(n,x) + betaln(x+a, n-x+b) - betaln(a, b): every
        # x-independent gammaln folds into one host constant
        self._lc = _f32(sps.gammaln(n + 1) - sps.betaln(a, b)
                        - sps.gammaln(n + a + b))

    def sample(self, gen, shape=()):
        p = Beta(self.alpha, self.beta).sample(gen, shape)
        return _binomial(gen, self.n, p, shape).to(torch.int32)

    def logpdf(self, x):
        xf = x.to(torch.float32)
        n = float(self.n)
        inside = (xf >= 0) & (xf <= n)
        xs = torch.where(inside, xf, 0.0)
        lp = (float(self._lc) - torch.lgamma(xs + 1)
              - torch.lgamma(n - xs + 1) + torch.lgamma(xs + float(self.alpha))
              + torch.lgamma(n - xs + float(self.beta)))
        return torch.where(inside, lp, _NEG_INF)


class Hypergeometric(Distribution):
    """Hypergeometric(s, f, n): successes in ``n`` draws without
    replacement from ``s`` successes and ``f`` failures
    (Distributions.jl ``Hypergeometric(s, f, n)``). The pmf is a host
    table of scipy's (its support is finite); sampling inverts its
    cumulative table."""

    discrete = True

    def __init__(self, s, f, n):
        s, f, n = int(s), int(f), int(n)
        if s < 0 or f < 0 or not 0 <= n <= s + f:
            raise ValueError(
                "Hypergeometric needs s, f >= 0 and 0 <= n <= s + f")
        self.s, self.f, self.n = s, f, n
        kmin, kmax = max(0, n - f), min(n, s)
        ks = np.arange(kmin, kmax + 1)
        frozen = sst.hypergeom(s + f, s, n)
        self._kmin, self._kmax = kmin, kmax
        self._logpmf = frozen.logpmf(ks).astype(_f32)
        pmf = frozen.pmf(ks)
        self._cum = np.cumsum(pmf / pmf.sum()).astype(_f32)
        # the pmf's closed form, every x-independent lgamma in one host
        # constant (float64): the generic kernels' prior entry
        self._lc = _f32(sps.gammaln(s + 1) + sps.gammaln(f + 1)
                        + sps.gammaln(n + 1) + sps.gammaln(s + f - n + 1)
                        - sps.gammaln(s + f + 1))

    def sample(self, gen, shape=()):
        idx = _categorical(gen, self._host("_cum", gen), shape)
        return (idx + self._kmin).to(torch.int32)

    def logpdf(self, x):
        xf = x.to(torch.float32)
        inside = (xf >= self._kmin) & (xf <= self._kmax)
        xi = torch.clamp(x.to(torch.int32).to(torch.int64) - self._kmin, 0,
                         self._kmax - self._kmin)
        return torch.where(inside, self._host("_logpmf", xf)[xi], _NEG_INF)

    def logpdf_closed(self, x):
        """The logpdf at the integers by its closed form (the kernels'
        entry; off the integers it differs from the table's)."""
        xf = x.to(torch.float32)
        inside = (xf >= self._kmin) & (xf <= self._kmax)
        xs = torch.where(inside, xf, float(self._kmin))
        lp = (float(self._lc) - torch.lgamma(xs + 1)
              - torch.lgamma(self.s - xs + 1) - torch.lgamma(self.n - xs + 1)
              - torch.lgamma(xs + (self.f - self.n + 1)))
        return torch.where(inside, lp, _NEG_INF)

    def __repr__(self):
        return f"Hypergeometric(s={self.s}, f={self.f}, n={self.n})"


class Skellam(Distribution):
    """Skellam: X1 - X2 of independent Poissons mu1, mu2
    (Distributions.jl ``Skellam(mu1, mu2)``); support all integers. The
    logpdf sums log I_|k|(2 sqrt(mu1 mu2)) as a log-sum-exp series of a
    host-fixed length (K = z + 12 sqrt(z) + 30 terms, as the JAX
    package)."""

    _fields = ("mu1", "mu2")
    discrete = True

    def __init__(self, mu1, mu2):
        self.mu1, self.mu2 = _f32(mu1), _f32(mu2)
        m1, m2 = float(self.mu1), float(self.mu2)
        if not (m1 > 0 and m2 > 0):
            raise ValueError("Skellam needs mu1 > 0 and mu2 > 0")
        z = 2.0 * math.sqrt(m1 * m2)
        K = int(z + 12.0 * math.sqrt(z) + 30.0)
        j = np.arange(K, dtype=np.float64)
        self._lzh = _f32(math.log(z / 2.0))
        self._j2lzh_mlgj = (2.0 * j * math.log(z / 2.0)
                            - sps.gammaln(j + 1)).astype(_f32)
        self._jgrid = j.astype(_f32)
        self._lrat = _f32(0.5 * (math.log(m1) - math.log(m2)))
        self._msum = _f32(m1 + m2)

    def sample(self, gen, shape=()):
        r1 = torch.full(tuple(shape), float(self.mu1), device=gen.device)
        r2 = torch.full(tuple(shape), float(self.mu2), device=gen.device)
        return (torch.poisson(r1, generator=gen)
                - torch.poisson(r2, generator=gen)).to(torch.int32)

    def logpdf(self, x):
        xf = x.to(torch.float32)
        v = torch.abs(xf)[..., None]
        # log I_v(z) = logsumexp_j [(2j+v) log(z/2) - lgamma(j+1)
        #                           - lgamma(j+v+1)]
        lt = (self._host("_j2lzh_mlgj", xf) + v * float(self._lzh)
              - torch.lgamma(self._host("_jgrid", xf) + v + 1.0))
        log_iv = torch.logsumexp(lt, dim=-1)
        return xf * float(self._lrat) - float(self._msum) + log_iv


class NegativeBinomial(Distribution):
    """P(X=k) = C(k+r-1, k) p^r (1-p)^k, the failures before the r-th
    success (Distributions.jl convention; the reference's socks model);
    drawn as Poisson(Gamma(r) (1-p)/p)."""

    _fields = ("r", "p")
    discrete = True

    def __init__(self, r, p):
        self.r, self.p = _f32(r), _f32(p)
        self._lgr = _f32(sps.gammaln(self.r))
        self._rlp = _f32(self.r * np.log(self.p))
        self._l1p = _f32(np.log1p(-self.p))
        self._odds = _f32(1 - self.p)

    def sample(self, gen, shape=()):
        lam = _std_gamma(gen, self.r, shape) * float(self._odds) \
            / float(self.p)
        return torch.poisson(lam, generator=gen).to(torch.int32)

    def logpdf(self, x):
        xf = x.to(torch.float32)
        ok = xf >= 0
        xs = torch.where(ok, xf, 0.0)
        lp = (torch.lgamma(xs + float(self.r)) - float(self._lgr)
              - torch.lgamma(xs + 1) + float(self._rlp)
              + xs * float(self._l1p))
        return torch.where(ok, lp, _NEG_INF)


class Categorical(Distribution):
    """0-indexed categorical over ``len(p)`` classes (the Julia
    reference's Categorical is 1-indexed)."""

    discrete = True

    def __init__(self, p):
        self.p = np.asarray(p, _f32)
        self._logp = np.log(np.clip(self.p, np.finfo(_f32).tiny,
                                    None)).astype(_f32)
        p64 = np.asarray(self.p, np.float64)
        self._cum = np.cumsum(p64 / p64.sum()).astype(_f32)

    def sample(self, gen, shape=()):
        return _categorical(gen, self._host("_cum", gen), shape).to(
            torch.int32)

    def logpdf(self, x):
        k = self.p.shape[-1]
        xi = torch.clamp(x.to(torch.int32).to(torch.int64), 0, k - 1)
        xf = x.to(torch.float32)
        inside = (xf >= 0) & (xf <= k - 1)
        lp = self._host("_logp", xf)[xi]
        pos = self._host("p", xf)[xi] > 0
        return torch.where(inside & pos, lp, _NEG_INF)

    def __repr__(self):
        return f"Categorical(p={self.p})"


class Dirac(Distribution):
    """Point mass at ``value`` (Distributions.jl ``Dirac``). ``push``
    snaps any float-evolved proposal back onto the atom, int32 for an
    integer atom, else float32."""

    discrete = True

    def __init__(self, value):
        self.value = float(value)
        self._isint = float(self.value).is_integer()
        self._dtype = torch.int32 if self._isint else torch.float32

    def sample(self, gen, shape=()):
        return torch.full(tuple(shape), self.value, dtype=self._dtype,
                          device=gen.device)

    def push(self, x):
        return torch.full_like(x, self.value, dtype=self._dtype)

    def logpdf(self, x):
        hit = x.to(torch.float32) == float(_f32(self.value))
        return torch.where(hit, 0.0, _NEG_INF)

    def cdf(self, x):
        return torch.where(_as_f32(x) >= float(_f32(self.value)), 1.0, 0.0)

    def quantile(self, q):
        return torch.full_like(_as_f32(q), float(_f32(self.value)))

    def __repr__(self):
        return f"Dirac({self.value})"


class PoissonBinomial(Distribution):
    """The sum of independent non-identical Bernoullis
    (Distributions.jl ``PoissonBinomial(ps)``). The pmf is an exact host
    convolution (float64, length n+1); a draw sums n Bernoulli draws."""

    discrete = True

    def __init__(self, ps):
        ps = np.asarray(ps, np.float64)
        if ps.ndim != 1 or np.any(ps < 0) or np.any(ps > 1):
            raise ValueError("PoissonBinomial needs a 1-D vector of "
                             "probabilities in [0, 1]")
        self.ps = ps.astype(_f32)
        pmf = np.ones(1)
        for p in np.asarray(self.ps, np.float64):
            nxt = np.zeros(pmf.shape[0] + 1)
            nxt[:-1] += pmf * (1 - p)
            nxt[1:] += pmf * p
            pmf = nxt
        self._lpmf = np.log(np.clip(pmf, 1e-300, None)).astype(_f32)
        self._cum = np.cumsum(pmf).astype(_f32)
        self._cum0 = np.concatenate([np.zeros(1, _f32), self._cum])

    def sample(self, gen, shape=()):
        n = self.ps.shape[0]
        u = torch.rand(tuple(shape) + (n,), generator=gen, device=gen.device)
        return torch.sum(u < self._host("ps", u), dim=-1).to(torch.int32)

    def logpdf(self, x):
        n = self.ps.shape[0]
        xi = torch.clamp(x.to(torch.int32).to(torch.int64), 0, n)
        xf = x.to(torch.float32)
        inside = (xf >= 0) & (xf <= n) & (xf == torch.round(xf))
        return torch.where(inside, self._host("_lpmf", xf)[xi], _NEG_INF)

    def cdf(self, x):
        n = self.ps.shape[0]
        xi = torch.clamp(torch.floor(_as_f32(x)), -1, n).to(torch.int64)
        return self._host("_cum0", xi)[xi + 1]

    def __repr__(self):
        return f"PoissonBinomial(n={self.ps.shape[0]})"


# --------------------------------------------------------------------------
# Truncation
# --------------------------------------------------------------------------

def _host_cdf(base, x):
    """Host cdf of the truncation bounds (numpy/scipy only)."""
    x = float(x)
    if isinstance(base, Normal):
        return float(sps.ndtr((x - float(base.mu)) / float(base.sigma)))
    if isinstance(base, Uniform):
        return float(np.clip((x - base.a) / (base.b - base.a), 0.0, 1.0))
    if isinstance(base, Exponential):
        return float(-np.expm1(-max(x, 0.0) / base.theta))
    if isinstance(base, LogNormal):
        if x <= 0:
            return 0.0
        return float(sps.ndtr((np.log(x) - base.mu) / base.sigma))
    if isinstance(base, Gamma):
        return float(sps.gammainc(base.alpha, max(x, 0.0) / base.theta))
    if isinstance(base, Beta):
        return float(sps.betainc(base.alpha, base.beta,
                                 min(max(x, 0.0), 1.0)))
    # every other univariate family: the scipy twin registry of
    # statistics.py (a lazy import: statistics imports this module)
    from .statistics import _twin
    t = _twin(base)
    if t is not None and getattr(base, "event_dim", 0) == 0:
        return float(t.cdf(x))
    raise TypeError(f"Truncated: no host cdf for {type(base).__name__}")


def _host_sf(base, x):
    """Host survival function 1-cdf, computed without cancellation."""
    x = float(x)
    if isinstance(base, Normal):
        return float(sps.ndtr(-(x - float(base.mu)) / float(base.sigma)))
    if isinstance(base, Uniform):
        return float(np.clip((base.b - x) / (base.b - base.a), 0.0, 1.0))
    if isinstance(base, Exponential):
        return float(np.exp(-max(x, 0.0) / base.theta))
    if isinstance(base, LogNormal):
        if x <= 0:
            return 1.0
        return float(sps.ndtr(-(np.log(x) - base.mu) / base.sigma))
    if isinstance(base, Gamma):
        return float(sps.gammaincc(base.alpha, max(x, 0.0) / base.theta))
    if isinstance(base, Beta):
        return float(1.0 - sps.betainc(base.alpha, base.beta,
                                       min(max(x, 0.0), 1.0)))
    from .statistics import _twin
    t = _twin(base)
    if t is not None and getattr(base, "event_dim", 0) == 0:
        return float(t.sf(x))
    raise TypeError(f"Truncated: no host sf for {type(base).__name__}")


def _host_frozen(base):
    """scipy frozen equivalent of a discrete base: the host pmf and tails
    ``TruncatedDiscrete`` tabulates."""
    if isinstance(base, Poisson):
        return sst.poisson(float(base.lam))
    if isinstance(base, Binomial):
        return sst.binom(int(base.n), float(base.p))
    if isinstance(base, Geometric):   # failures before success: loc=-1
        return sst.geom(float(base.p), loc=-1)
    if isinstance(base, NegativeBinomial):
        return sst.nbinom(float(base.r), float(base.p))
    if isinstance(base, Bernoulli):
        return sst.bernoulli(float(base.p))
    if isinstance(base, DiscreteUniform):
        return sst.randint(int(base.a), int(base.b) + 1)
    if isinstance(base, BetaBinomial):
        return sst.betabinom(int(base.n), float(base.alpha),
                             float(base.beta))
    if isinstance(base, Hypergeometric):
        return sst.hypergeom(base.s + base.f, base.s, base.n)
    if isinstance(base, Skellam):
        return sst.skellam(float(base.mu1), float(base.mu2))
    raise TypeError(
        f"Truncated: no host pmf for discrete {type(base).__name__}")


class TruncatedDiscrete(Distribution):
    """Truncation of a discrete base to the integers in [lo, hi]
    (inclusive, like Distributions.jl's ``truncated``). The support is
    tabulated on the host from the scipy twin of the base; an unbounded
    side is capped where the base's tail mass drops below 1e-12."""

    discrete = True

    def __init__(self, base, lo, hi):
        self.base, self.lo, self.hi = base, float(lo), float(hi)
        frozen = _host_frozen(base)
        klo = (int(np.ceil(self.lo)) if np.isfinite(self.lo)
               else int(frozen.ppf(1e-12)))
        khi = (int(np.floor(self.hi)) if np.isfinite(self.hi)
               else int(frozen.isf(1e-12)))
        if khi < klo:
            raise ValueError(
                f"TruncatedDiscrete({base!r}, {self.lo}, {self.hi}): "
                "empty integer support.")
        pmf = frozen.pmf(np.arange(klo, khi + 1))
        mass = float(pmf.sum())
        if not mass > 0.0:
            raise ValueError(
                f"TruncatedDiscrete({base!r}, {self.lo}, {self.hi}): "
                "the truncation window has zero probability mass.")
        with np.errstate(divide="ignore"):
            self._logpmf = np.log(pmf / mass).astype(_f32)
        self._klo, self._khi = klo, khi
        self._cdf_tab = np.cumsum(pmf / mass).astype(_f32)
        self._cdf0 = np.concatenate([np.zeros(1, _f32), self._cdf_tab])

    def sample(self, gen, shape=()):
        cum = self._host("_cdf_tab", gen)
        return (_categorical(gen, cum, shape) + self._klo).to(torch.int32)

    def logpdf(self, x):
        xf = x.to(torch.float32)
        xr = torch.round(xf)
        # pmf only on the integer atoms; round pairs the index with the
        # right atom for negative supports too
        inside = (xr >= self._klo) & (xr <= self._khi) & (xf == xr)
        xi = torch.clamp(xr.to(torch.int64) - self._klo, 0,
                         self._khi - self._klo)
        return torch.where(inside, self._host("_logpmf", xf)[xi],
                           _full(xf, _NEG_INF))

    def cdf(self, x):
        xf = _as_f32(x)
        xi = torch.clamp(torch.floor(xf).to(torch.int64) - self._klo, -1,
                         self._khi - self._klo)
        return self._host("_cdf0", xf)[xi + 1]

    def quantile(self, q):
        q = _as_f32(q)
        idx = torch.searchsorted(self._host("_cdf_tab", q),
                                 q.reshape(-1)).reshape(q.shape)
        return (torch.clamp(idx, 0, self._khi - self._klo)
                + self._klo).to(torch.int32)

    def __repr__(self):
        return f"Truncated({self.base!r}, {self.lo}, {self.hi})"


class Truncated(Distribution):
    """A base distribution with a ``quantile`` truncated to [lo, hi];
    normalizing constants are precomputed on the host. A discrete base
    gives a ``TruncatedDiscrete`` (host-tabulated integer support), as
    the JAX package's ``Truncated.__new__`` does."""

    _fields = ("base", "lo", "hi")

    def __new__(cls, base=None, lo=None, hi=None):
        if cls is Truncated and getattr(base, "discrete", False):
            return TruncatedDiscrete(base, lo, hi)
        return object.__new__(cls)

    def __init__(self, base, lo, hi):
        if not hasattr(base, "quantile"):
            raise TypeError(
                f"Truncated({type(base).__name__}, ...): the base needs a "
                "device-side quantile for inverse-cdf window sampling")
        self.base, self.lo, self.hi = base, _f32(lo), _f32(hi)
        clo, chi = _host_cdf(base, self.lo), _host_cdf(base, self.hi)
        slo, shi = _host_sf(base, self.lo), _host_sf(base, self.hi)
        # the window mass from whichever tail keeps f64 precision
        mass = (slo - shi) if clo > 0.5 else (chi - clo)
        if not mass > 0.0:
            raise ValueError(
                f"Truncated({base!r}, {self.lo}, {self.hi}): the "
                "truncation window has zero probability mass (underflow); "
                "widen the window or reparameterize.")
        self._clo, self._chi = _f32(clo), _f32(chi)
        self._slo, self._shi = _f32(slo), _f32(shi)
        self._mass = _f32(mass)
        self._lz = _f32(np.log(mass))
        # far upper-tail windows collapse in cdf space but stay exact in
        # survival space
        self._use_sf = bool(_f32(chi) == _f32(clo))

    def sample(self, gen, shape=()):
        lo, hi = float(self.lo), float(self.hi)
        if self._use_sf:
            if self._shi == self._slo or not isinstance(self.base, Normal):
                raise ValueError(
                    f"{self!r}: truncation window is degenerate in float32 "
                    "for inverse-cdf sampling; widen the window.")
            u = _uniform(gen, shape, self._shi, self._slo)
            x = float(self.base.mu) - float(self.base.sigma) \
                * torch.special.ndtri(u)
            return torch.clamp(x, lo, hi)
        u = _uniform(gen, shape, self._clo, self._chi)
        return torch.clamp(self.base.quantile(u), lo, hi)

    def logpdf(self, x):
        inside = (x >= float(self.lo)) & (x <= float(self.hi))
        return torch.where(inside, self.base.logpdf(x) - float(self._lz),
                           _full(x, _NEG_INF))

    def _check_sf(self, what):
        if not isinstance(self.base, Normal):
            raise ValueError(
                f"{self!r}: far-tail window {what} needs a precise "
                "survival function (available for Normal bases).")

    def cdf(self, x):
        xc = torch.clamp(_as_f32(x), float(self.lo), float(self.hi))
        if self._use_sf:
            # cdf space is degenerate here: (S(lo) - S(x)) / mass
            self._check_sf("cdf")
            z = (xc - float(self.base.mu)) / float(self.base.sigma)
            sf = 0.5 * torch.special.erfc(z / float(np.float32(np.sqrt(2.0))))
            return torch.clamp((float(self._slo) - sf) / float(self._mass),
                               0.0, 1.0)
        return torch.clamp((self.base.cdf(xc) - float(self._clo))
                           / float(self._mass), 0.0, 1.0)

    def quantile(self, q):
        q = _as_f32(q)
        if self._use_sf:
            # S(x) = slo - q*mass, x = mu - sigma*ndtri(S(x))
            self._check_sf("quantile")
            u = float(self._slo) - q * float(self._mass)
            x = float(self.base.mu) - float(self.base.sigma) \
                * torch.special.ndtri(u)
        else:
            x = self.base.quantile(float(self._clo) + q * float(self._mass))
        return torch.clamp(x, float(self.lo), float(self.hi))

    def __repr__(self):
        return f"Truncated({self.base!r}, {self.lo}, {self.hi})"


def TruncatedNormal(mu, sigma, lo, hi):
    return Truncated(Normal(mu, sigma), lo, hi)


# --------------------------------------------------------------------------
# Mixtures and affine transforms
# --------------------------------------------------------------------------

class Mixture(Distribution):
    """Finite mixture of same-kind univariate components
    (Distributions.jl's ``MixtureModel(components, weights)``; alias
    ``MixtureModel``). All components must agree on ``discrete``;
    weights default to uniform and are renormalized. Sampling draws a
    component index by inverse cdf, then every component once, and
    selects."""

    def __init__(self, components, weights=None):
        components = tuple(components)
        if not components:
            raise ValueError("Mixture needs at least one component")
        if len({bool(c.discrete) for c in components}) != 1:
            raise ValueError(
                "Mixture components must all be discrete or all continuous")
        if any(getattr(c, "event_dim", 0) != 0 for c in components):
            raise ValueError(
                "Mixture supports univariate components only (the "
                "select-sampling reshape assumes scalar events)")
        if weights is None:
            weights = np.full(len(components), 1.0 / len(components))
        w = np.asarray(weights, np.float64)
        if w.shape != (len(components),) or (w < 0).any() or w.sum() <= 0:
            raise ValueError("Mixture weights must be nonnegative, one per "
                             "component, with positive sum")
        self.components = components
        self.weights = (w / w.sum()).astype(_f32)
        self.discrete = bool(components[0].discrete)
        with np.errstate(divide="ignore"):
            self._logw = np.log(self.weights).astype(_f32)
        self._cum = np.cumsum(np.asarray(self.weights,
                                         np.float64)).astype(_f32)
        self._qbounds = None

    def sample(self, gen, shape=()):
        cum = self._host("_cum", gen)
        idx = _categorical(gen, cum, shape)
        draws = torch.stack([c.sample(gen, shape).to(torch.float32)
                             for c in self.components])
        out = torch.gather(draws.reshape(len(self.components), -1), 0,
                           idx.reshape(1, -1)).reshape(idx.shape)
        return out.to(torch.int32) if self.discrete else out

    def logpdf(self, x):
        # torch.logsumexp's max-shifted sum, written out term by term so
        # that the generic kernels' prior table can trace it: an infinite
        # maximum shifts by 0
        lps = [float(lw) + c.logpdf(x)
               for lw, c in zip(self._logw, self.components)]
        m = lps[0]
        for lp in lps[1:]:
            m = torch.maximum(m, lp)
        m = torch.where(torch.abs(m) == math.inf, 0.0, m)
        s = torch.exp(lps[0] - m)
        for lp in lps[1:]:
            s = s + torch.exp(lp - m)
        return torch.log(s) + m

    def cdf(self, x):
        return sum(float(w) * c.cdf(x)
                   for w, c in zip(self.weights, self.components))

    def quantile(self, q):
        if self.discrete:
            raise NotImplementedError(
                "Mixture.quantile is available for continuous mixtures")
        if self._qbounds is None:   # host constants, computed once
            los = [float(c.quantile(torch.tensor(np.float32(1e-6))))
                   for c in self.components]
            his = [float(c.quantile(torch.tensor(np.float32(1.0 - 1e-6))))
                   for c in self.components]
            self._qbounds = (min(los), max(his))
        lo, hi = self._qbounds
        return _bisect_quantile(self.cdf, lo, hi, q)

    def __repr__(self):
        return (f"Mixture({list(self.components)!r}, "
                f"weights={self.weights})")


MixtureModel = Mixture


class Affine(Distribution):
    """loc + scale * base for a continuous univariate base —
    Distributions.jl's location-scale idiom ``a + b * dist``, also built
    by the operators: ``2 + 3 * Exponential(1.0)``. ``scale`` may be
    negative (the support flips)."""

    def __init__(self, loc, scale, base):
        if getattr(base, "discrete", False):
            raise ValueError("Affine supports continuous bases only")
        if getattr(base, "event_dim", 0) != 0:
            raise ValueError("Affine supports univariate bases only")
        if float(scale) == 0.0:
            raise ValueError("Affine needs scale != 0")
        self.loc, self.scale, self.base = _f32(loc), _f32(scale), base
        self._labs = _f32(np.log(abs(float(self.scale))))

    def _z(self, x):
        return (x - float(self.loc)) / float(self.scale)

    def sample(self, gen, shape=()):
        return float(self.loc) + float(self.scale) * self.base.sample(
            gen, shape)

    def logpdf(self, x):
        return self.base.logpdf(self._z(x)) - float(self._labs)

    def cdf(self, x):
        c = self.base.cdf(self._z(x))
        return c if float(self.scale) > 0 else 1.0 - c

    def quantile(self, q):
        q = q if float(self.scale) > 0 else 1.0 - _as_f32(q)
        return float(self.loc) + float(self.scale) * self.base.quantile(q)

    def __repr__(self):
        return f"({self.loc} + {self.scale} * {self.base!r})"


def _affine_of(base, loc=0.0, scale=1.0):
    """Compose affine transforms without nesting Affine-of-Affine."""
    if isinstance(base, Affine):
        return Affine(loc + scale * float(base.loc),
                      scale * float(base.scale), base.base)
    return Affine(loc, scale, base)


def _dist_add(self, other):
    return _affine_of(self, loc=float(other))


def _dist_mul(self, other):
    return _affine_of(self, scale=float(other))


def _dist_neg(self):
    return _affine_of(self, scale=-1.0)


def _dist_sub(self, other):      # dist - c
    return _affine_of(self, loc=-float(other))


def _dist_rsub(self, other):     # c - dist
    return _affine_of(self, loc=float(other), scale=-1.0)


Distribution.__add__ = _dist_add
Distribution.__radd__ = _dist_add
Distribution.__mul__ = _dist_mul
Distribution.__rmul__ = _dist_mul
Distribution.__neg__ = _dist_neg
Distribution.__sub__ = _dist_sub
Distribution.__rsub__ = _dist_rsub


# --------------------------------------------------------------------------
# Vector leaves and products
# --------------------------------------------------------------------------

class MvNormal(Distribution):
    """Multivariate normal with a ``[d]`` vector leaf, so a population is
    one ``[n, d]`` tensor. ``MvNormal(d, sigma)`` is the zero-mean
    isotropic form; else a mean vector and a scalar sigma, a vector of
    sigmas or a full covariance. The Cholesky factor, its inverse and
    the log-determinant are computed once on the host in float64."""

    event_dim = 1

    def __init__(self, mean_or_dim, sigma_or_cov=1.0):
        if isinstance(mean_or_dim, (int, np.integer)):
            mean = np.zeros((int(mean_or_dim),), _f32)
        else:
            mean = np.asarray(mean_or_dim, _f32)
        cov = np.asarray(sigma_or_cov, np.float64)
        if cov.ndim == 0:
            cov = cov ** 2 * np.eye(mean.shape[0])
        elif cov.ndim == 1:
            cov = np.diag(cov ** 2)
        self.mean, self.cov = mean, cov.astype(_f32)
        chol = np.linalg.cholesky(np.asarray(self.cov, np.float64))
        self.chol = chol.astype(_f32)
        self._cholinv = np.linalg.inv(chol).astype(_f32)
        self._logdet = _f32(2.0 * np.sum(np.log(np.diag(chol))))

    @property
    def nparams(self):
        return self.mean.shape[0]

    def sample(self, gen, shape=()):
        d = self.mean.shape[0]
        z = torch.randn(tuple(shape) + (d,), generator=gen, device=gen.device)
        return self._host("mean", z) + z @ self._host("chol", z).T

    def logpdf(self, x):
        d = self.mean.shape[0]
        diff = x - self._host("mean", x)
        sol = torch.einsum("ij,...j->...i", self._host("_cholinv", x), diff)
        maha = torch.sum(sol * sol, dim=-1)
        return -0.5 * (maha + float(self._logdet) + d * _LOG_2PI)

    def __repr__(self):
        return f"MvNormal(d={self.mean.shape[0]})"


MultivariateNormal = MvNormal


class Dirichlet(Distribution):
    """Dirichlet over the (k-1)-simplex; ``alpha`` is a host vector and a
    population one ``[n, k]`` tensor. A draw normalizes k Gamma draws;
    ``logpdf`` is -inf off the simplex (a coordinate <= 0, or a sum off 1
    by 1e-4 or more), which keeps a float-evolved population on it."""

    event_dim = 1

    def __init__(self, alpha):
        a = np.asarray(alpha, _f32)
        if a.ndim == 0:
            raise ValueError("Dirichlet needs a concentration vector")
        self.alpha = a
        a64 = np.asarray(a, np.float64)
        self._lnorm = _f32(np.sum(sps.gammaln(a64))
                           - sps.gammaln(np.sum(a64)))

    @property
    def nparams(self):
        return self.alpha.shape[0]

    def sample(self, gen, shape=()):
        a = self._host("alpha", gen)
        g = torch._standard_gamma(a.expand(tuple(shape) + a.shape).contiguous(),
                                  generator=gen)
        return g / torch.sum(g, dim=-1, keepdim=True)

    def logpdf(self, x):
        inside = torch.all(x > 0, dim=-1) & (
            torch.abs(torch.sum(x, dim=-1) - 1.0) < float(np.float32(1e-4)))
        xs = torch.clamp(x, float(np.float32(1e-37)), 1.0)
        lp = torch.sum((self._host("alpha", x) - 1.0) * torch.log(xs),
                       dim=-1) - float(self._lnorm)
        return torch.where(inside, lp, _full(lp, _NEG_INF))

    def __repr__(self):
        return f"Dirichlet(alpha={self.alpha})"


class Product(Distribution):
    """Vector of independent univariate marginals of homogeneous support
    (all continuous or all discrete), sampled and evaluated as one
    ``[..., d]`` leaf: Distributions.jl's ``Product`` (runtests.jl:30)."""

    event_dim = 1

    def __init__(self, dists):
        ds = tuple(dists)
        if len({d.discrete for d in ds}) != 1:
            raise ValueError(
                "Product requires homogeneous support; use Factored for "
                "mixed continuous/discrete parameter packs.")
        self.dists = ds

    @property
    def discrete(self):
        return self.dists[0].discrete

    @property
    def nparams(self):
        return len(self.dists)

    def sample(self, gen, shape=()):
        return torch.stack([d.sample(gen, shape) for d in self.dists], -1)

    def logpdf(self, x):
        return sum(d.logpdf(x[..., i]) for i, d in enumerate(self.dists))

    def __repr__(self):
        return f"Product({list(self.dists)!r})"


def IID(d: Distribution, n: int) -> Product:
    return Product([d] * n)


class Multinomial(Distribution):
    """Multinomial(n, p): counts over ``len(p)`` classes that sum to n. A
    float-evolved count vector is pushed component-wise (half to even);
    one whose sum is off n by 0.5 or more, or with a count in a class of
    p = 0, has logpdf -inf, so the prior gate rejects it. A draw is k - 1
    conditional binomials (float32 counts, as the JAX package's)."""

    discrete = True
    event_dim = 1

    def __init__(self, n, p):
        self.n = int(n)
        self.p = np.asarray(p, _f32)
        p64 = np.asarray(self.p, np.float64)
        p64 = p64 / p64.sum()
        logp = np.full(p64.shape, -np.inf)
        np.log(p64, out=logp, where=p64 > 0)
        self._p64 = p64
        self._pnorm = p64.astype(_f32)
        self._logp = logp.astype(_f32)
        self._lgn1 = _f32(sps.gammaln(self.n + 1))

    @property
    def nparams(self):
        return self.p.shape[0]

    def sample(self, gen, shape=()):
        left = torch.full(tuple(shape), float(self.n), device=gen.device)
        counts, rest = [], 1.0
        for pi in self._p64[:-1]:
            q = min(float(pi) / rest, 1.0) if rest > 0 else 0.0
            c = torch.binomial(left, torch.full_like(left, q), generator=gen)
            counts.append(c)
            left = left - c
            rest -= float(pi)
        return torch.stack(counts + [left], -1)

    def logpdf(self, x):
        xf = x.to(torch.float32)
        pn = self._host("_pnorm", xf)
        ok = (torch.all(xf >= 0, dim=-1)
              & (torch.abs(torch.sum(xf, dim=-1) - self.n) < 0.5)
              & torch.all((pn > 0) | (xf == 0), dim=-1))
        xs = torch.clamp(xf, min=0.0)
        logp = torch.where(pn > 0, self._host("_logp", xf), 0.0)
        lp = (float(self._lgn1) - torch.sum(torch.lgamma(xs + 1.0), dim=-1)
              + torch.sum(xs * logp, dim=-1))
        return torch.where(ok, lp, _full(lp, _NEG_INF))

    def __repr__(self):
        return f"Multinomial(n={self.n}, p={self.p})"


class MvLogNormal(Distribution):
    """Multivariate log-normal: log X ~ MvNormal(mean, cov), with
    ``MvNormal``'s constructor forms."""

    event_dim = 1

    def __init__(self, mean_or_dim, sigma_or_cov=1.0):
        self.normal = MvNormal(mean_or_dim, sigma_or_cov)

    @property
    def nparams(self):
        return self.normal.nparams

    def sample(self, gen, shape=()):
        return torch.exp(self.normal.sample(gen, shape))

    def logpdf(self, x):
        ok = torch.all(x > 0, dim=-1)
        lx = torch.log(torch.where(x > 0, x, 1.0))
        lp = self.normal.logpdf(lx) - torch.sum(lx, dim=-1)
        return torch.where(ok, lp, _full(lp, _NEG_INF))

    def __repr__(self):
        return f"MvLogNormal(d={self.normal.mean.shape[0]})"


class MvTDist(Distribution):
    """Multivariate Student t (Distributions.jl ``MvTDist(df, mu,
    Sigma)``) with scale matrix ``Sigma`` (the covariance is
    df/(df-2) Sigma). The Cholesky factor, its inverse and the log
    normalizer come from float64 on the host; a draw is a correlated
    normal over the square root of a chi-square / df."""

    event_dim = 1

    def __init__(self, df, mean, cov):
        df = float(df)
        if not df > 0:
            raise ValueError("MvTDist needs df > 0")
        mean = np.asarray(mean, _f32)
        cov = np.asarray(cov, np.float64)
        if cov.ndim == 0:
            cov = cov ** 2 * np.eye(mean.shape[0])
        self.df, self.mean, self.cov = _f32(df), mean, cov.astype(_f32)
        d = mean.shape[0]
        chol = np.linalg.cholesky(np.asarray(self.cov, np.float64))
        self.chol = chol.astype(_f32)
        self._cholinv = np.linalg.inv(chol).astype(_f32)
        logdet = 2.0 * np.sum(np.log(np.diag(chol)))
        self._lc = _f32(sps.gammaln((df + d) / 2.0) - sps.gammaln(df / 2.0)
                        - 0.5 * d * math.log(df * math.pi) - 0.5 * logdet)

    @property
    def nparams(self):
        return self.mean.shape[0]

    def sample(self, gen, shape=()):
        d = self.mean.shape[0]
        z = torch.randn(tuple(shape) + (d,), generator=gen,
                        device=gen.device) @ self._host("chol", gen).T
        chisq = 2.0 * _std_gamma(gen, 0.5 * float(self.df),
                                 tuple(shape) + (1,))
        return self._host("mean", gen) + z * torch.sqrt(float(self.df)
                                                        / chisq)

    def logpdf(self, x):
        diff = x - self._host("mean", x)
        sol = torch.einsum("ij,...j->...i", self._host("_cholinv", x), diff)
        maha = torch.sum(sol * sol, dim=-1)
        d = self.mean.shape[0]
        df = float(self.df)
        return float(self._lc) - 0.5 * (df + d) * torch.log1p(maha / df)

    def __repr__(self):
        return f"MvTDist(df={self.df}, d={self.mean.shape[0]})"


def _tri_logdet(m):
    """log |det| from a (batched) Cholesky factor."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(m, dim1=-2, dim2=-1)),
                           dim=-1)


def _symmetrize(x):
    x = x.to(torch.float32)
    return 0.5 * (x + x.transpose(-1, -2))


def _cholesky(x):
    """(factor, ok) of the symmetrized ``x`` (JAX's ``cholesky`` reads
    (x + x^T) / 2): ``ok`` marks the matrices that factor, so a batch
    with a non-SPD matrix gives -inf there and raises nothing (JAX's
    factor is NaN there)."""
    cl, info = torch.linalg.cholesky_ex(_symmetrize(x))
    return cl, info == 0


def _spd_only(lp, ok):
    """-inf where the factorization failed or ``lp`` is not finite, as
    the JAX package's ``where(isfinite(lp), lp, -inf)``."""
    return torch.where(ok & torch.isfinite(lp), lp, _full(lp, _NEG_INF))


class Wishart(Distribution):
    """Wishart(df, S) over d x d SPD matrices, one ``[..., d, d]`` leaf.
    A draw is the Bartlett decomposition (one batched normal and one
    batched Gamma); ``logpdf`` uses tr(S^-1 X) = ||L^-1 chol(X)||_F^2 with
    L = chol(S) from the host. ``push`` symmetrizes a float-evolved leaf
    (the continuous analogue of the discrete round); a non-SPD one has
    logpdf -inf."""

    event_dim = 2

    def __init__(self, df, S):
        S = np.asarray(S, np.float64)
        if S.ndim != 2 or S.shape[0] != S.shape[1]:
            raise ValueError("Wishart needs a square scale matrix")
        d = S.shape[0]
        df = float(df)
        if not df > d - 1:
            raise ValueError("Wishart needs df > d - 1")
        self.df, self.S = _f32(df), S.astype(_f32)
        S = np.asarray(self.S, np.float64)
        L = np.linalg.cholesky(S)
        self._L = L.astype(_f32)
        self._Linv = np.linalg.inv(L).astype(_f32)
        logdet_s = 2.0 * np.sum(np.log(np.diag(L)))
        self._lnorm = _f32(0.5 * df * d * math.log(2.0) + 0.5 * df * logdet_s
                           + float(sps.multigammaln(0.5 * df, d)))
        # the Bartlett diagonal's Gamma shapes (df - i) / 2, i = 0..d-1
        self._bshapes = ((df - np.arange(d)) / 2.0).astype(_f32)

    @property
    def nparams(self):
        return self.S.shape[0] * self.S.shape[1]

    def sample(self, gen, shape=()):
        d = self.S.shape[0]
        shape = tuple(shape)
        z = torch.randn(shape + (d, d), generator=gen, device=gen.device)
        c = torch._standard_gamma(
            self._host("_bshapes", gen).expand(shape + (d,)).contiguous(),
            generator=gen)
        a = torch.tril(z, -1) + torch.diag_embed(torch.sqrt(2.0 * c))
        la = torch.einsum("ij,...jk->...ik", self._host("_L", gen), a)
        return la @ la.transpose(-1, -2)

    def push(self, x):
        return _symmetrize(x)

    def logpdf(self, x):
        d = self.S.shape[0]
        cl, ok = _cholesky(x)
        m = torch.einsum("ij,...jk->...ik", self._host("_Linv", cl), cl)
        tr = torch.sum(m * m, dim=(-2, -1))
        lp = (0.5 * (float(self.df) - d - 1.0) * _tri_logdet(cl) - 0.5 * tr
              - float(self._lnorm))
        return _spd_only(lp, ok)

    def __repr__(self):
        return f"Wishart(df={self.df}, d={self.S.shape[0]})"


class InverseWishart(Distribution):
    """InverseWishart(df, Psi) over d x d SPD matrices: X^-1 ~
    Wishart(df, Psi^-1). ``push`` symmetrizes; a non-SPD leaf has logpdf
    -inf."""

    event_dim = 2

    def __init__(self, df, Psi):
        Psi = np.asarray(Psi, np.float64)
        if Psi.ndim != 2 or Psi.shape[0] != Psi.shape[1]:
            raise ValueError("InverseWishart needs a square scale matrix")
        d = Psi.shape[0]
        df = float(df)
        if not df > d - 1:
            raise ValueError("InverseWishart needs df > d - 1")
        self.df, self.Psi = _f32(df), Psi.astype(_f32)
        Psi = np.asarray(self.Psi, np.float64)
        self._wis = Wishart(df, np.linalg.inv(Psi))
        LP = np.linalg.cholesky(Psi)
        self._LP = LP.astype(_f32)
        logdet_p = 2.0 * np.sum(np.log(np.diag(LP)))
        self._lnorm = _f32(0.5 * df * d * math.log(2.0) - 0.5 * df * logdet_p
                           + float(sps.multigammaln(0.5 * df, d)))

    @property
    def nparams(self):
        return self.Psi.shape[0] * self.Psi.shape[1]

    def sample(self, gen, shape=()):
        w = self._wis.sample(gen, shape)
        cw, _ = torch.linalg.cholesky_ex(w)
        d = self.Psi.shape[0]
        eye = torch.eye(d, device=w.device).expand(w.shape)
        inv_cw = torch.linalg.solve_triangular(cw, eye, upper=False)
        return inv_cw.transpose(-1, -2) @ inv_cw

    def push(self, x):
        return _symmetrize(x)

    def logpdf(self, x):
        d = self.Psi.shape[0]
        cl, ok = _cholesky(x)
        # tr(Psi X^-1) = ||cl^-1 L_Psi||_F^2 with cl = chol(X); a failed
        # factor is made the identity so the solve stays finite
        eye = torch.eye(d, device=cl.device)
        cl_safe = torch.where(ok[..., None, None], cl, eye)
        m = torch.linalg.solve_triangular(
            cl_safe, self._host("_LP", cl).expand(cl.shape), upper=False)
        tr = torch.sum(m * m, dim=(-2, -1))
        lp = (-0.5 * (float(self.df) + d + 1.0) * _tri_logdet(cl_safe)
              - 0.5 * tr - float(self._lnorm))
        return _spd_only(lp, ok)

    def __repr__(self):
        return f"InverseWishart(df={self.df}, d={self.Psi.shape[0]})"


class LKJCholesky(Distribution):
    """LKJ over Cholesky factors of d x d correlation matrices
    (Distributions.jl ``LKJCholesky(d, eta)``): lower triangular L with
    unit-norm rows, density over L's free entries

        log p(L) = sum_m (2 eta - 2 + d - 1 - m) log L_mm - log Z

    (rows m = 1..d-1), the normalizer from per-row Beta and sphere-area
    constants on the host. A draw is the onion method: one Beta and one
    normal per row, unrolled over the host-known d. ``push`` projects a
    float-evolved leaf onto lower-triangular unit-norm rows."""

    event_dim = 2

    def __init__(self, d, eta=1.0):
        d, eta = int(d), float(eta)
        if d < 2 or eta <= 0:
            raise ValueError("LKJCholesky needs d >= 2 and eta > 0")
        self.d, self.eta = d, _f32(eta)
        eta = float(self.eta)
        lz, betas = 0.0, []
        for m in range(1, d):
            a, b = m / 2.0, eta + (d - 1 - m) / 2.0
            betas.append((_f32(a), _f32(b)))
            log_sphere = (math.log(2.0) + 0.5 * m * math.log(math.pi)
                          - sps.gammaln(0.5 * m))
            lz += sps.betaln(a, b) + log_sphere - math.log(2.0)
        self._betas = tuple(betas)
        self._lz = _f32(lz)
        # diagonal exponents 2 eta - 2 + d - 1 - m, m = 0..d-1 (row 0 unused)
        self._dexp = (2.0 * eta - 2.0 + d - 1 - np.arange(d)).astype(_f32)

    @property
    def nparams(self):
        return self.d * self.d

    def sample(self, gen, shape=()):
        d, shape = self.d, tuple(shape)
        first = torch.zeros(shape + (d,), device=gen.device)
        first[..., 0] = 1.0
        rows = [first]
        for m in range(1, d):
            a, b = self._betas[m - 1]
            ga, gb = _std_gamma(gen, a, shape), _std_gamma(gen, b, shape)
            y = ga / (ga + gb)
            z = torch.randn(shape + (m,), generator=gen, device=gen.device)
            u = z / torch.linalg.norm(z, dim=-1, keepdim=True)
            w = torch.sqrt(y)[..., None] * u
            lmm = torch.sqrt(torch.clamp(1.0 - y, min=1e-30))[..., None]
            pad = torch.zeros(shape + (d - 1 - m,), device=gen.device)
            rows.append(torch.cat([w, lmm, pad], dim=-1))
        return torch.stack(rows, dim=-2)

    def push(self, x):
        x = torch.tril(x.to(torch.float32))
        nrm = torch.linalg.norm(x, dim=-1, keepdim=True)
        return x / torch.clamp(nrm, min=1e-30)

    def logpdf(self, L):
        diag = torch.diagonal(L, dim1=-2, dim2=-1)
        ok = torch.all(diag > 0, dim=-1)
        ds = torch.where(diag > 0, diag, 1.0)
        lp = torch.sum(self._host("_dexp", L)[1:] * torch.log(ds[..., 1:]),
                       dim=-1)
        return torch.where(ok, lp - float(self._lz), _full(lp, _NEG_INF))

    def __repr__(self):
        return f"LKJCholesky(d={self.d}, eta={self.eta})"


class LKJ(Distribution):
    """LKJ over d x d correlation matrices (Distributions.jl ``LKJ(d,
    eta)``): density det(R)^(eta-1) / c_d(eta) with the
    Lewandowski-Kurowicka-Joe normalizer

        c_d(eta) = 2^{sum_k (2 eta - 2 + d - k)(d - k)}
                   prod_k B(eta + (d-k-1)/2, eta + (d-k-1)/2)^{d-k}

    (k = 1..d-1). A draw is an ``LKJCholesky`` L, returned as L L^T;
    ``push`` symmetrizes and pins the unit diagonal; a non-PD leaf has
    logpdf -inf."""

    event_dim = 2

    def __init__(self, d, eta=1.0):
        d, eta = int(d), float(eta)
        if d < 2 or eta <= 0:
            raise ValueError("LKJ needs d >= 2 and eta > 0")
        self.d, self.eta = d, _f32(eta)
        eta = float(self.eta)
        self._chol = LKJCholesky(d, eta)
        lc = 0.0
        for k in range(1, d):
            lc += (2.0 * eta - 2.0 + d - k) * (d - k) * math.log(2.0)
            lc += (d - k) * sps.betaln(eta + (d - k - 1) / 2.0,
                                       eta + (d - k - 1) / 2.0)
        self._lc = _f32(lc)

    @property
    def nparams(self):
        return self.d * self.d

    def sample(self, gen, shape=()):
        L = self._chol.sample(gen, shape)
        return L @ L.transpose(-1, -2)

    def push(self, x):
        eye = torch.eye(self.d, device=x.device)
        return _symmetrize(x) * (1.0 - eye) + eye

    def logpdf(self, R):
        cl, ok = _cholesky(R)
        lp = (float(self.eta) - 1.0) * _tri_logdet(cl) - float(self._lc)
        return _spd_only(lp, ok)

    def __repr__(self):
        return f"LKJ(d={self.d}, eta={self.eta})"


class Factored(Distribution):
    """Product of independent marginals (priors.jl:10-49), each
    continuous or discrete, scalar, vector or matrix. A population is a
    tuple of ``[n]`` (``[n, d]``, ``[n, d, d]``) tensors, one per
    marginal."""

    def __init__(self, *dists: Distribution):
        self.p = tuple(dists)

    @property
    def nparams(self):
        return len(self.p)

    def rand(self, gen):
        """One draw: a tuple with one value per marginal."""
        return self.sample(gen)

    def sample(self, gen, shape=()):
        """A tuple with one array of ``shape`` per marginal, each in its
        marginal's dtype (``shape=()``: one value per marginal)."""
        return tuple(d.sample(gen, shape) for d in self.p)

    def sample_tree(self, gen, n):
        return self.sample(gen, (n,))

    def logpdf(self, x):
        return sum(d.logpdf(xi) for d, xi in zip(self.p, x))

    def logpdf_tree(self, theta):
        return self.logpdf(theta)

    def push_tree(self, theta):
        return tuple(d.push(xi) for d, xi in zip(self.p, theta))

    push = push_tree

    def __len__(self):
        return len(self.p)

    def __repr__(self):
        return f"Factored{self.p!r}"
