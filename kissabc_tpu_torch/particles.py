"""``Particles`` — the posterior-sample result type; the port's own
numpy copy of ``kissabc_tpu/particles.py``: ``Particles`` (a cloud of
posterior draws with summary statistics, elementwise algebra and the
statistical ``approx`` of MonteCarloMeasurements.jl),
``particles_from_tree``, ``hpdi`` and the MonteCarloMeasurements-style
helpers ``chainsstack``, ``pmap_apply``, ``pmean``, ``pstd``,
``pmedian``, ``pquantile``, ``pcov``, ``pcor``, ``sigmapoints`` and
``pm``/``plus_minus``. Numpy only: results are on the host.
"""

from __future__ import annotations

import itertools

import numpy as np


def _as_np(x):
    return np.asarray(x)


_AUTO_SEED = itertools.count(0x5EED)


def _next_auto_seed():
    """Per-process deterministic sequence of distinct seeds for
    default-keyed ``Particles(N)`` constructions."""
    return next(_AUTO_SEED)


class Particles:
    """A 1-D cloud of samples for one scalar quantity.

    Construct from an array of samples — ``Particles(samples)`` — or,
    MonteCarloMeasurements-style: ``Particles(2000, Normal(0, 1),
    key=0)`` (MCM's ``Particles(N, dist)``), ``Particles(2000)``
    (systematic standard normal, MCM's ``Particles(N)``), or
    ``Particles(matrix)`` (rows = particles, columns = quantities —
    returns a LIST of clouds, MCM's ``Particles(::Matrix)``)."""

    __array_priority__ = 100  # beat ndarray in mixed binary ops

    def __new__(cls, x=None, dist=None, key=None):
        # MCM's Particles(::Matrix): rows are particles, columns are
        # quantities -> a LIST of per-column clouds. This is the shape
        # sigmapoints() returns, so the reference workflow
        # `Particles(sigmapoints(mean(R), cov(R)))` (smc.jl:234,269)
        # ports verbatim. (x defaults to None so pickle/deepcopy's
        # bare cls.__new__(cls) works; __init__ rejects x=None for
        # direct construction.)
        if x is not None and dist is None \
                and not isinstance(x, (int, np.integer)):
            arr = np.asarray(x)
            if arr.ndim == 2:
                return [cls(col) for col in arr.T]
        return super().__new__(cls)

    def __init__(self, x=None, dist=None, key=None):
        if x is None:
            raise TypeError(
                "Particles() needs samples, a count N, or (N, dist)")
        if dist is None and isinstance(x, (int, np.integer)):
            # MCM's Particles(N): N standard-normal SYSTEMATIC samples
            # (exact midpoint quantiles, permuted). key=None (default)
            # draws a FRESH permutation per construction from a
            # process-global counter, like MCM's global-RNG behavior —
            # otherwise independently built clouds would be perfectly
            # correlated and e.g. (pm(1,.1)+pm(2,.2)).std() would add
            # linearly instead of in quadrature. Pass an explicit key
            # for a reproducible (but shared!) permutation.
            from scipy.special import ndtri
            n = int(x)
            z = ndtri((np.arange(n) + 0.5) / n)
            seed = _next_auto_seed() if key is None else int(key)
            self.particles = np.random.default_rng(seed).permutation(z)
            return
        if dist is not None:
            from .utils.rng import as_generator
            if getattr(dist, "event_dim", 0) != 0:
                raise ValueError(
                    "Particles(N, dist) needs a univariate (scalar-event) "
                    "distribution")
            n = int(x)
            gen = as_generator(0 if key is None else key, "cpu")
            x = dist.sample(gen, (n,)).numpy()
        x = _as_np(x).reshape(-1)
        self.particles = x

    # --- statistics -------------------------------------------------------
    def mean(self):
        return float(np.mean(self.particles))

    def std(self):
        return float(np.std(self.particles, ddof=1))

    def median(self):
        return float(np.median(self.particles))

    def quantile(self, q):
        return np.quantile(self.particles, q)

    def __len__(self):
        return self.particles.shape[0]

    def __array__(self, dtype=None, copy=None):
        a = self.particles
        return a.astype(dtype) if dtype is not None else a

    # --- display ----------------------------------------------------------
    def __repr__(self):
        return f"{self.mean():.4g} ± {self.std():.3g}"

    # --- statistical approx (the reference tests' ``≈``) ------------------
    def approx(self, other, nsig=2.0, atol=0.0):
        """MonteCarloMeasurements' ``isapprox``: two-sided in std —
        |mean(a) - mean(b)| <= nsig * max(std(a), std(b)) (+ atol), and
        nsig * std(self) against a plain number (cf. reference
        test/runtests.jl:84,110 usage)."""
        if isinstance(other, Particles):
            om, osd = other.mean(), other.std()
        else:
            om, osd = float(other), 0.0
        return abs(self.mean() - om) <= nsig * max(self.std(), osd) + atol

    # --- elementwise algebra / function propagation -----------------------
    def map(self, f):
        """Push every particle through ``f`` (vectorized over the cloud)."""
        return Particles(np.asarray(f(self.particles)))

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        """Propagate numpy ufuncs through the cloud: ``np.sin(p)``,
        ``np.exp(p) + q``, ``np.maximum(p, 0)`` all return ``Particles``
        (MonteCarloMeasurements registers the Base math functions on
        ``Particles``; ``__array__`` alone would silently demote to a bare
        ndarray). Reductions (``np.add.reduce`` etc.) run on the raw
        sample arrays and come back as plain Python scalars (matching
        ``Particles.mean()``/``std()``); ``out=`` is unsupported."""
        if kwargs.get("out") is not None:
            return NotImplemented
        arrays = [x.particles if isinstance(x, Particles) else x
                  for x in inputs]
        result = getattr(ufunc, method)(*arrays, **kwargs)
        def wrap(r):
            r = np.asarray(r)
            if r.ndim == 1 and r.shape[0] == len(self):
                return Particles(r)
            # reductions (np.max(p), np.add.reduce(p)) come back 0-d;
            # return a plain scalar like Particles.mean()/std() do
            return r.item() if r.ndim == 0 else r
        if isinstance(result, tuple):  # e.g. divmod, modf
            return tuple(wrap(r) for r in result)
        return wrap(result)

    def _binop(self, other, f):
        if isinstance(other, Particles):
            return Particles(f(self.particles, other.particles))
        return Particles(f(self.particles, _as_np(other)))

    def __add__(self, o):
        return self._binop(o, np.add)

    def __radd__(self, o):
        return self._binop(o, np.add)

    def __sub__(self, o):
        return self._binop(o, np.subtract)

    def __rsub__(self, o):
        return self._binop(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._binop(o, np.multiply)

    def __rmul__(self, o):
        return self._binop(o, np.multiply)

    def __truediv__(self, o):
        return self._binop(o, np.divide)

    def __rtruediv__(self, o):
        return self._binop(o, lambda a, b: b / a)

    def __pow__(self, o):
        return self._binop(o, np.power)

    def __rpow__(self, o):
        return self._binop(o, lambda a, b: np.power(b, a))

    def __mod__(self, o):
        return self._binop(o, np.mod)

    def __floordiv__(self, o):
        return self._binop(o, np.floor_divide)

    # comparisons return a boolean cloud: ``(p > 0).mean()`` is the Monte
    # Carlo estimate of P(p > 0) (MCM's ``mean(p > 0)`` idiom); == / !=
    # included so ``(p == 4).mean()`` works for discrete marginals —
    # numpy-style, with __bool__ raising on ambiguous truth values so a
    # cloud can't silently collapse to True inside `if`/`in`
    __hash__ = None

    def __eq__(self, o):
        return self._binop(o, np.equal)

    def __ne__(self, o):
        return self._binop(o, np.not_equal)

    def __bool__(self):
        if len(self) == 1:
            return bool(self.particles[0])
        raise ValueError(
            "The truth value of a Particles cloud is ambiguous — use "
            ".mean() for an acceptance fraction, or .approx() for the "
            "statistical ≈.")

    def __lt__(self, o):
        return self._binop(o, np.less)

    def __le__(self, o):
        return self._binop(o, np.less_equal)

    def __gt__(self, o):
        return self._binop(o, np.greater)

    def __ge__(self, o):
        return self._binop(o, np.greater_equal)

    def __neg__(self):
        return Particles(-self.particles)

    def __abs__(self):
        return Particles(np.abs(self.particles))


def particles_from_tree(tree_of_columns):
    """Convert a posterior (a tuple of ``[n]`` / ``[n, d]`` arrays, or one
    array) into the reference's output convention: a list of
    per-dimension ``Particles``, unwrapped when there is exactly one
    (KissABC.jl:90-93, smc.jl:202-204)."""
    leaves = list(tree_of_columns) \
        if isinstance(tree_of_columns, (tuple, list)) else [tree_of_columns]
    cols = []
    for leaf in leaves:
        a = _as_np(leaf)
        if a.ndim == 1:
            cols.append(Particles(a))
        else:
            flat = a.reshape(a.shape[0], -1)
            for j in range(flat.shape[1]):
                cols.append(Particles(flat[:, j]))
    if len(cols) == 1:
        return cols[0]
    return cols


def hpdi(p, alpha=0.95):
    """Highest-posterior-density interval: the SHORTEST interval holding
    ``alpha`` of the cloud's mass (narrower than equal-tail quantiles for
    skewed posteriors — the interval summary ABC users typically report).
    Returns ``(lo, hi)`` floats."""
    if isinstance(p, (list, tuple)):
        # multi-parameter posterior (list of per-dimension Particles, the
        # particles_from_tree convention): one interval per parameter
        return [hpdi(q, alpha) for q in p]
    x = np.asarray(p.particles if isinstance(p, Particles) else _as_np(p))
    if x.ndim != 1:
        raise ValueError(
            f"hpdi needs a 1-D sample cloud, got shape {x.shape}; pass "
            "per-parameter Particles (or a list of them) — pooling "
            "parameters would give a meaningless interval")
    x = np.sort(x)
    m = len(x)
    if m == 0:
        raise ValueError("hpdi of an empty cloud")
    if m == 1:
        return float(x[0]), float(x[0])
    # include ceil(alpha*m) consecutive order statistics; pick the
    # narrowest such window
    k = max(1, min(m - 1, int(np.ceil(alpha * m)) - 1))
    widths = x[k:] - x[:m - k]
    i = int(np.argmin(widths))
    return float(x[i]), float(x[i + k])


def chainsstack(chains):
    """Concatenate per-chain results particle-wise (KissABC.jl:96-104)."""
    first = chains[0]
    if isinstance(first, Particles):
        return Particles(np.concatenate([c.particles for c in chains]))
    out = []
    for i in range(len(first)):
        out.append(Particles(np.concatenate([c[i].particles for c in chains])))
    return out


def pmap_apply(f, *ps):
    """Apply an elementwise (numpy-vectorized) function to one or more
    aligned Particles clouds — the function-propagation idiom of
    MonteCarloMeasurements (`sim(res)`, reference runtests.jl:84,102)."""
    arrays = [p.particles if isinstance(p, Particles) else _as_np(p)
              for p in ps]
    return Particles(np.asarray(f(*arrays)))


def pmean(p):
    """MCM-style free function: mean of a Particles cloud (or number)."""
    return p.mean() if isinstance(p, Particles) else float(np.mean(p))


def pstd(p):
    return p.std() if isinstance(p, Particles) else float(np.std(p, ddof=1))


def pmedian(p):
    return p.median() if isinstance(p, Particles) else float(np.median(p))


def pquantile(p, q):
    return p.quantile(q) if isinstance(p, Particles) else np.quantile(p, q)


def pcov(ps):
    """Covariance matrix across a list of aligned Particles clouds (the
    reference's commented `cov(R)` / sigmapoints usage, smc.jl:234)."""
    m = np.stack([p.particles for p in ps])
    return np.cov(m)


def pcor(ps):
    """Correlation matrix across aligned Particles clouds."""
    m = np.stack([p.particles for p in ps])
    return np.corrcoef(m)


def sigmapoints(m, S=None):
    """Unscented-transform sigma points from a mean vector and
    covariance matrix — MonteCarloMeasurements' ``sigmapoints(m, Σ)``,
    used in the reference's own workflow snippets
    (the reference's ``src/smc.jl:234,269``).

    Returns ``[2n+1, n]``: the mean row plus ``m ± columns of
    chol(n·Σ)``. The UNWEIGHTED sample mean/covariance (ddof=1) of the
    returned points reproduce ``m``/``S`` exactly, so
    ``Particles(sigmapoints(m, S))`` is a minimal cloud with the right
    first two moments. ``m`` may be a scalar with scalar variance
    (n = 1), or a tuple of Particles (mean/cov are taken from the
    cloud)."""
    if isinstance(m, (tuple, list)) and m and all(
            isinstance(p, Particles) for p in m):
        S = pcov(m)
        m = np.array([p.mean() for p in m])
    elif S is None:
        raise TypeError(
            "sigmapoints(m, S) needs the covariance S unless m is a "
            "tuple/list of Particles")
    m = np.atleast_1d(np.asarray(m, np.float64))
    n = m.shape[0]
    S = np.asarray(S, np.float64)
    if S.ndim == 0:
        S = S * np.eye(n)
    L = np.linalg.cholesky(n * S)
    return np.vstack([m[None, :], m + L.T, m - L.T])


def pm(mu, sigma, n=2000, key=None):
    """``mu ± sigma`` — MCM's ``±`` constructor sugar (Python has no ±
    operator): a systematic-normal cloud with exact mean ``mu`` and
    spread ``sigma``. ``plus_minus`` is the spelled-out alias.
    key=None (default) gives each call an independent permutation, so
    ``(pm(a, s1) + pm(b, s2)).std()`` combines in quadrature like
    independent quantities (MCM semantics)."""
    return mu + sigma * Particles(n, None, key)


plus_minus = pm
