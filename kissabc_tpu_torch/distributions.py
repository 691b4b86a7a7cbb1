"""Distributions — the PyTorch counterpart of the families of
``kissabc_tpu/distributions.py`` that the port has so far:

- ``Uniform``, ``Normal``, ``Exponential``, ``Gamma``, ``LogUniform``,
  ``BetaPrime``, ``StudentT``/``TDist`` (continuous);
- ``DiscreteUniform``, ``Poisson``, ``DiscreteNonParametric``
  (discrete);
- ``Truncated`` over any base with a ``quantile`` (a discrete base gives
  a ``TruncatedDiscrete``), ``TruncatedNormal``, ``Mixture``/
  ``MixtureModel``, ``Affine`` and the operators ``+ - *`` and unary
  ``-`` that build it (``2.0 - 3.0 * Exponential(1.0)``);
- ``MvNormal``, ``Dirichlet`` (vector leaves) and ``Factored``.

The other families come in later slices.

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

import math

import numpy as np
import torch
from scipy import special as sps
from scipy import stats as sst

_f32 = np.float32
_NEG_INF = float("-inf")
_LOG_2PI = math.log(2 * math.pi)


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


# --------------------------------------------------------------------------
# Discrete univariate
# --------------------------------------------------------------------------

class DiscreteUniform(Distribution):
    """Integers ``a..b`` with equal mass. Samples are int64; the
    population evolves them in float32 and ``push`` rounds half to even
    to int32, as the JAX package's discrete push does."""

    _fields = ("a", "b")
    discrete = True

    def __init__(self, a=0, b=1):
        self.a, self.b = _f32(a), _f32(b)
        self._lpmf = _f32(np.log(self.b - self.a + 1))

    def sample(self, gen, shape=()):
        return torch.randint(int(self.a), int(self.b) + 1, shape,
                             generator=gen, device=gen.device)

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


# --------------------------------------------------------------------------
# Truncation
# --------------------------------------------------------------------------

def _twin(base):
    """scipy frozen twin of a continuous base, for the host cdf/sf of the
    truncation bounds (the JAX package's ``statistics._twin`` for the
    families ported so far), or None."""
    if isinstance(base, StudentT):
        return sst.t(float(base.nu))
    if isinstance(base, LogUniform):
        return sst.loguniform(float(base.a), float(base.b))
    if isinstance(base, BetaPrime):
        return sst.betaprime(float(base.alpha), float(base.beta))
    return None


def _host_cdf(base, x):
    """Host cdf of the truncation bounds (numpy/scipy only)."""
    x = float(x)
    if isinstance(base, Normal):
        return float(sps.ndtr((x - float(base.mu)) / float(base.sigma)))
    if isinstance(base, Uniform):
        return float(np.clip((x - base.a) / (base.b - base.a), 0.0, 1.0))
    if isinstance(base, Exponential):
        return float(-np.expm1(-max(x, 0.0) / base.theta))
    if isinstance(base, Gamma):
        return float(sps.gammainc(base.alpha, max(x, 0.0) / base.theta))
    t = _twin(base)
    if t is not None:
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
    if isinstance(base, Gamma):
        return float(sps.gammaincc(base.alpha, max(x, 0.0) / base.theta))
    t = _twin(base)
    if t is not None:
        return float(t.sf(x))
    raise TypeError(f"Truncated: no host sf for {type(base).__name__}")


def _host_frozen(base):
    """scipy frozen equivalent of a discrete base: the host pmf and tails
    ``TruncatedDiscrete`` tabulates."""
    if isinstance(base, Poisson):
        return sst.poisson(float(base.lam))
    if isinstance(base, DiscreteUniform):
        return sst.randint(int(base.a), int(base.b) + 1)
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
        lps = torch.stack([float(lw) + c.logpdf(x)
                           for lw, c in zip(self._logw, self.components)])
        return torch.logsumexp(lps, dim=0)

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


class Factored(Distribution):
    """Product of independent univariate marginals (priors.jl:10-49).
    A population is a tuple of ``[n]`` tensors, one per marginal."""

    def __init__(self, *dists: Distribution):
        self.p = tuple(dists)

    @property
    def nparams(self):
        return len(self.p)

    def sample_tree(self, gen, n):
        return tuple(d.sample(gen, (n,)) for d in self.p)

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
