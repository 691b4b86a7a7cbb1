"""The distributions on the main path — the PyTorch counterpart of the
``Uniform``, ``Normal``, ``Truncated``/``TruncatedNormal``,
``DiscreteUniform``, ``MvNormal`` and ``Factored`` of
``kissabc_tpu/distributions.py``; the other families come in a later
slice.

As in the JAX package, parameters and every derived constant are host
numpy float32 values computed once in ``__init__``; only the sampled and
evaluated values are tensors. Sampling draws from an explicit
``torch.Generator`` on the device of the run. Log-densities repeat the
JAX package's float32 formulas, so both give the same values to a few
ulps on the same points.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import special as sps

_f32 = np.float32
_NEG_INF = float("-inf")
_LOG_2PI = math.log(2 * math.pi)


def _full(x, value):
    return torch.full_like(x, value, dtype=torch.float32)


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

    def __repr__(self):
        inner = ", ".join(f"{f}={getattr(self, f)}" for f in self._fields)
        return f"{type(self).__name__}({inner})"


def _uniform(gen, shape, lo, hi):
    u = torch.rand(shape, generator=gen, device=gen.device)
    return torch.clamp(u * (hi - lo) + lo, min=float(lo))


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

    def quantile(self, q):
        return float(self.mu) + float(self.sigma) * torch.special.ndtri(q)


def _host_cdf(base, x):
    """Host cdf of the truncation bounds (numpy/scipy only)."""
    x = float(x)
    if isinstance(base, Normal):
        return float(sps.ndtr((x - float(base.mu)) / float(base.sigma)))
    if isinstance(base, Uniform):
        return float(np.clip((x - base.a) / (base.b - base.a), 0.0, 1.0))
    raise NotImplementedError(
        f"Truncated({type(base).__name__}, ...) is not ported yet: the "
        "port has Normal and Uniform bases; the other families come in a "
        "later slice")


def _host_sf(base, x):
    """Host survival function 1-cdf, computed without cancellation."""
    x = float(x)
    if isinstance(base, Normal):
        return float(sps.ndtr(-(x - float(base.mu)) / float(base.sigma)))
    if isinstance(base, Uniform):
        return float(np.clip((base.b - x) / (base.b - base.a), 0.0, 1.0))
    return 1.0 - _host_cdf(base, x)


class Truncated(Distribution):
    """A base distribution with a ``quantile`` truncated to [lo, hi];
    normalizing constants are precomputed on the host."""

    _fields = ("base", "lo", "hi")

    def __init__(self, base, lo, hi):
        if getattr(base, "discrete", False):
            raise NotImplementedError(
                "Truncated over a discrete base is not ported yet")
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


def TruncatedNormal(mu, sigma, lo, hi):
    return Truncated(Normal(mu, sigma), lo, hi)


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
        self._dev = {}

    @property
    def nparams(self):
        return self.mean.shape[0]

    def _host(self, name, like):
        """The host constant ``name`` as a tensor on ``like``'s device,
        copied there once."""
        key = (name, like.device)
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(getattr(self, name),
                                             device=like.device)
        return self._dev[key]

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
