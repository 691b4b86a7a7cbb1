"""The distribution families of the samplers' prior battery
(``tests/test_sampler_prior_battery.py``) in kissabc_tpu_torch, held
against the JAX package on the same numpy points:

- ``logpdf`` within 16 float32 ulps of max(1, |value|) (the gap is
  ``lgamma``/``log1p`` of the two libraries: at most 9 measured);
- ``cdf`` within 4e-6 and ``quantile`` within 4e-6 (absolute) of JAX;
  ``betainc`` within 5e-6 of ``scipy.special.betainc`` and 2e-5 of
  ``jax.scipy.special.betainc`` for a, b <= 50;
- sampling against scipy: mean within 5 standard errors and the
  Kolmogorov-Smirnov distance under its 0.1% critical value
  (1.95/sqrt(n)) for continuous families, the pmf within 5 standard
  errors for discrete ones;
- ``push`` dtypes and values, the ``Truncated`` -> ``TruncatedDiscrete``
  dispatch, the operators that build ``Affine``, and
  ``convert.prior_from_numpy`` building each family.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import betainc as jax_betainc
from scipy import special as sps
from scipy import stats

import kissabc_tpu as ka
import kissabc_tpu_torch as kt
from kissabc_tpu_torch import convert
from kissabc_tpu_torch import distributions as D
from torch_threads import one_torch_thread  # noqa: F401

EPS32 = float(np.finfo(np.float32).eps)


def _pair(name):
    """(JAX family, port family, numpy points) for each new family."""
    rng = np.random.default_rng(sum(map(ord, name)))
    u = lambda lo, hi: rng.uniform(lo, hi, 500)   # noqa: E731
    table = {
        "Exponential": (ka.Exponential(1.5), kt.Exponential(1.5),
                        u(-1, 8)),
        "Gamma": (ka.Gamma(2.5, 1.5), kt.Gamma(2.5, 1.5), u(-1, 15)),
        "LogUniform": (ka.LogUniform(0.1, 10.0), kt.LogUniform(0.1, 10.0),
                       u(0.05, 11)),
        "BetaPrime": (ka.BetaPrime(3.0, 5.0), kt.BetaPrime(3.0, 5.0),
                      u(-0.5, 6)),
        "StudentT": (ka.StudentT(4.0), kt.StudentT(4.0), u(-8, 8)),
        "Poisson": (ka.Poisson(6.0), kt.Poisson(6.0),
                    np.arange(-2, 40, dtype=np.float64)),
        "DiscreteNonParametric": (
            ka.DiscreteNonParametric([0.5, 1.5, 4.0], [0.3, 0.4, 0.3]),
            kt.DiscreteNonParametric([0.5, 1.5, 4.0], [0.3, 0.4, 0.3]),
            np.array([0.5, 1.5, 4.0, 1.0, 0.0, 5.0, -1.0, 0.49])),
        "TruncatedStudentT": (ka.Truncated(ka.StudentT(4.0), -1.0, 3.0),
                              kt.Truncated(kt.StudentT(4.0), -1.0, 3.0),
                              u(-2, 4)),
        "TruncatedPoisson": (ka.Truncated(ka.Poisson(6.0), 2, 12),
                             kt.Truncated(kt.Poisson(6.0), 2, 12),
                             np.arange(-1, 15, dtype=np.float64)),
        "Mixture": (ka.Mixture([ka.Normal(0.0, 0.5), ka.Normal(5.0, 0.5)],
                               [0.5, 0.5]),
                    kt.Mixture([kt.Normal(0.0, 0.5), kt.Normal(5.0, 0.5)],
                               [0.5, 0.5]), u(-3, 8)),
        "Affine": (2.0 - 3.0 * ka.Exponential(1.0),
                   2.0 - 3.0 * kt.Exponential(1.0), u(-10, 3)),
    }
    j, t, x = table[name]
    return j, t, x.astype(np.float32)


NAMES = ["Exponential", "Gamma", "LogUniform", "BetaPrime", "StudentT",
         "Poisson", "DiscreteNonParametric", "TruncatedStudentT",
         "TruncatedPoisson", "Mixture", "Affine"]


def _within_ulps(got, want, n=16):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(got[~fin], want[~fin])
    err = np.abs(got[fin] - want[fin])
    tol = n * EPS32 * np.maximum(1.0, np.abs(want[fin]))
    assert (err <= tol).all(), (err / tol).max()


@pytest.mark.parametrize("name", NAMES)
def test_logpdf_matches_jax(name):
    j, t, x = _pair(name)
    _within_ulps(t.logpdf(torch.from_numpy(x)).numpy(),
                 np.asarray(j.logpdf(jnp.asarray(x))))


@pytest.mark.parametrize("name", [n for n in NAMES if n != "Poisson"])
def test_cdf_and_quantile_match_jax(name):
    j, t, x = _pair(name)
    np.testing.assert_allclose(t.cdf(torch.from_numpy(x)).numpy(),
                               np.asarray(j.cdf(jnp.asarray(x))), atol=4e-6)
    q = np.linspace(0.01, 0.99, 99).astype(np.float32)
    got = t.quantile(torch.from_numpy(q)).numpy().astype(np.float64)
    if name == "Mixture":
        # the cdf is flat between the modes (density ~1e-6 at 2.5), so a
        # 6e-8 gap in cdf moves the quantile far: hold cdf(quantile(q))
        np.testing.assert_allclose(
            np.asarray(j.cdf(jnp.asarray(got, jnp.float32))), q, atol=4e-6)
    else:
        np.testing.assert_allclose(
            got, np.asarray(j.quantile(jnp.asarray(q)), np.float64),
            atol=4e-6)


@pytest.mark.parametrize("a,b", [(2.0, 0.5), (3.0, 5.0), (0.1, 0.5),
                                 (0.5, 0.5), (50.0, 3.0)])
def test_betainc_matches_scipy_and_jax(a, b):
    x = np.random.default_rng(0).uniform(0, 1, 2000).astype(np.float32)
    x[:4] = [0.0, 1.0, 1e-6, 1.0 - 1e-6]
    got = D.betainc(np.float32(a), np.float32(b),
                    torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, sps.betainc(a, b, x.astype(np.float64)),
                               atol=5e-6)
    np.testing.assert_allclose(
        got, np.asarray(jax_betainc(np.float32(a), np.float32(b), x)),
        atol=2e-5)
    assert D.betainc_terms(a, b) <= 200


def test_betainc_edges():
    x = torch.tensor([0.0, 1.0, -0.1, 1.1, float("nan")])
    got = D.betainc(2.0, 3.0, x)
    assert got[0] == 0 and got[1] == 1 and torch.isnan(got[2:]).all()


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


CONTINUOUS = [
    (kt.Exponential(1.5), stats.expon(scale=1.5)),
    (kt.Gamma(2.5, 1.5), stats.gamma(2.5, scale=1.5)),
    (kt.Gamma(0.4, 2.0), stats.gamma(0.4, scale=2.0)),
    (kt.LogUniform(0.1, 10.0), stats.loguniform(0.1, 10.0)),
    (kt.BetaPrime(3.0, 5.0), stats.betaprime(3.0, 5.0)),
    (kt.StudentT(4.0), stats.t(4.0)),
    (kt.Truncated(kt.StudentT(4.0), -1.0, 3.0), None),
    (kt.Mixture([kt.Normal(0.0, 0.5), kt.Normal(5.0, 0.5)], [0.3, 0.7]),
     None),
    (2.0 - 3.0 * kt.Exponential(1.0), None),
]


def _twin_cdf(dist, twin):
    """scipy cdf of a family (the mixture, affine and truncated forms
    written out from their parts)."""
    if twin is not None:
        return twin.cdf
    if isinstance(dist, kt.Mixture):
        return lambda v: (0.3 * stats.norm(0, 0.5).cdf(v)
                          + 0.7 * stats.norm(5, 0.5).cdf(v))
    if isinstance(dist, kt.Truncated):
        t = stats.t(4.0)
        return lambda v: np.clip((t.cdf(v) - t.cdf(-1.0))
                                 / (t.cdf(3.0) - t.cdf(-1.0)), 0, 1)
    return lambda v: stats.expon.sf((2.0 - v) / 3.0)   # 2 - 3 E


@pytest.mark.parametrize("k", range(len(CONTINUOUS)),
                         ids=[repr(c[0])[:40] for c in CONTINUOUS])
def test_continuous_sampling_against_scipy(k):
    dist, twin = CONTINUOUS[k]
    n = 20000
    x = dist.sample(_gen(k), (n,))
    assert x.dtype == torch.float32 and x.shape == (n,)
    x = x.numpy().astype(np.float64)
    cdf = _twin_cdf(dist, twin)
    d = stats.kstest(x, cdf).statistic
    assert d < 1.95 / np.sqrt(n), d
    if twin is not None and np.isfinite(twin.var()):
        assert abs(x.mean() - twin.mean()) < 5 * np.sqrt(twin.var() / n)


DISCRETE = [
    (kt.Poisson(6.0), stats.poisson(6.0).pmf, np.arange(0, 30)),
    (kt.DiscreteNonParametric([0.5, 1.5, 4.0], [0.3, 0.4, 0.3]),
     lambda v: np.select([v == 0.5, v == 1.5, v == 4.0], [0.3, 0.4, 0.3]),
     np.array([0.5, 1.5, 4.0])),
    (kt.Truncated(kt.Poisson(6.0), 2, 12),
     lambda v: stats.poisson(6.0).pmf(v) / (stats.poisson(6.0).cdf(12)
                                            - stats.poisson(6.0).cdf(1)),
     np.arange(2, 13)),
    (kt.Mixture([kt.Poisson(2.0), kt.Poisson(9.0)], [0.5, 0.5]),
     lambda v: 0.5 * stats.poisson(2.0).pmf(v) + 0.5 * stats.poisson(
         9.0).pmf(v), np.arange(0, 30)),
]


@pytest.mark.parametrize("k", range(len(DISCRETE)),
                         ids=[repr(c[0])[:40] for c in DISCRETE])
def test_discrete_sampling_against_scipy(k):
    dist, pmf, support = DISCRETE[k]
    n = 20000
    x = dist.sample(_gen(10 + k), (n,))
    want_dtype = (torch.float32 if isinstance(dist, kt.DiscreteNonParametric)
                  and not dist._isint else torch.int32)
    assert x.dtype == want_dtype
    x = x.numpy().astype(np.float64)
    assert np.isin(x, support).all()
    for v in support:
        p = pmf(v)
        assert abs(np.mean(x == v) - p) < 5 * np.sqrt(p * (1 - p) / n) + 1e-4


def test_dirichlet_sampling_logpdf_and_simplex():
    j, t = ka.Dirichlet(np.array([2.0, 2.0, 3.0])), kt.Dirichlet(
        np.array([2.0, 2.0, 3.0]))
    x = t.sample(_gen(3), (20000,))
    assert x.shape == (20000, 3) and t.nparams == 3
    xn = x.numpy().astype(np.float64)
    assert (xn > 0).all() and np.allclose(xn.sum(-1), 1.0, atol=1e-5)
    want = stats.dirichlet([2.0, 2.0, 3.0]).mean()
    assert np.allclose(xn.mean(0), want, atol=5 * np.sqrt(0.25 / 20000))
    pts = np.random.default_rng(1).dirichlet([2, 2, 3], 300).astype(
        np.float32)
    pts[:10] += 0.01     # off the simplex: -inf in both
    pts[10:15, 0] = -0.1
    _within_ulps(t.logpdf(torch.from_numpy(pts)).numpy(),
                 np.asarray(j.logpdf(jnp.asarray(pts))))
    assert np.isinf(t.logpdf(torch.from_numpy(pts[:15])).numpy()).all()


def test_push_dtypes_and_values():
    x = torch.tensor([-0.6, 0.49, 0.5, 0.99, 1.5, 2.5, 2.76, 3.9, 100.0])
    for jd, td in ((ka.Poisson(6.0), kt.Poisson(6.0)),
                   (ka.Truncated(ka.Poisson(6.0), 2, 12),
                    kt.Truncated(kt.Poisson(6.0), 2, 12)),
                   (ka.Mixture([ka.Poisson(2.0), ka.Poisson(9.0)]),
                    kt.Mixture([kt.Poisson(2.0), kt.Poisson(9.0)]))):
        got = td.push(x)
        assert got.dtype == torch.int32      # round half to even
        assert np.array_equal(got.numpy(),
                              np.asarray(jd.push(jnp.asarray(x.numpy()))))
    # nearest atom, float atoms stay float, integer atoms become int32
    for xs in ([0.5, 1.5, 4.0], [1.0, 3.0, 7.0]):
        jd = ka.DiscreteNonParametric(xs, [0.3, 0.4, 0.3])
        td = kt.DiscreteNonParametric(xs, [0.3, 0.4, 0.3])
        got = td.push(x)
        want = np.asarray(jd.push(jnp.asarray(x.numpy())))
        assert got.numpy().dtype == want.dtype
        assert np.array_equal(got.numpy(), want)
    assert kt.DiscreteNonParametric([0.5, 1.5, 4.0], [0.3, 0.4, 0.3]).push(
        torch.tensor([0.9, 1.1, 2.7, 2.8])).tolist() == [0.5, 1.5, 1.5, 4.0]
    for td in (kt.Exponential(1.0), kt.StudentT(4.0), kt.Dirichlet([2, 2]),
               kt.Mixture([kt.Normal(0, 1), kt.Normal(3, 1)]),
               2.0 - 3.0 * kt.Exponential(1.0)):
        assert td.push(x.to(torch.float64)).dtype == torch.float32


def test_truncated_dispatch():
    td = kt.Truncated(kt.Poisson(6.0), 2, 12)
    assert isinstance(td, kt.TruncatedDiscrete) and td.discrete
    assert (td._klo, td._khi) == (2, 12)
    assert not isinstance(kt.Truncated(kt.StudentT(4.0), -1, 3),
                          kt.TruncatedDiscrete)
    assert isinstance(kt.Truncated(kt.DiscreteUniform(0, 9), 2.5, 7),
                      kt.TruncatedDiscrete)
    jt = ka.Truncated(ka.Poisson(6.0), 2, 12)
    np.testing.assert_allclose(td._logpmf, jt._logpmf)
    with pytest.raises(TypeError, match="quantile"):
        kt.Truncated(kt.Dirichlet([2, 2]), 0, 1)
    with pytest.raises(TypeError, match="no host cdf"):
        kt.Truncated(kt.Mixture([kt.Normal(0, 1)]), 0, 1)
    with pytest.raises(ValueError, match="empty integer support"):
        kt.Truncated(kt.Poisson(6.0), 3.2, 3.8)
    # the host window mass of the new continuous bases, as in JAX
    for jb, tb in ((ka.Exponential(2.0), kt.Exponential(2.0)),
                   (ka.Gamma(2.0, 1.0), kt.Gamma(2.0, 1.0)),
                   (ka.LogUniform(0.1, 10.0), kt.LogUniform(0.1, 10.0)),
                   (ka.BetaPrime(3.0, 5.0), kt.BetaPrime(3.0, 5.0))):
        j, t = ka.Truncated(jb, 0.5, 3.0), kt.Truncated(tb, 0.5, 3.0)
        assert (t._clo, t._chi, t._mass, t._lz) == (j._clo, j._chi,
                                                    j._mass, j._lz)


def test_operators_build_affine():
    e = kt.Exponential(1.0)
    a = 2.0 - 3.0 * e
    assert isinstance(a, kt.Affine) and a.base is e
    assert (float(a.loc), float(a.scale)) == (2.0, -3.0)
    for got, loc, scale in ((e + 1.5, 1.5, 1.0), (1.5 + e, 1.5, 1.0),
                            (e * 2.0, 0.0, 2.0), (-e, 0.0, -1.0),
                            (e - 1.0, -1.0, 1.0), (4.0 - 2.0 * e, 4.0, -2.0),
                            ((e + 1.0) * 2.0, 2.0, 2.0)):
        assert isinstance(got, kt.Affine) and got.base is e
        assert (float(got.loc), float(got.scale)) == (loc, scale)
    with pytest.raises(ValueError, match="continuous"):
        2.0 * kt.Poisson(3.0)
    with pytest.raises(ValueError, match="scale"):
        kt.Affine(0.0, 0.0, e)
    with pytest.raises(ValueError, match="discrete or all continuous"):
        kt.Mixture([kt.Poisson(2.0), kt.Normal(0, 1)])


SPECS = [
    (("Exponential", {"theta": 1.5}), kt.Exponential),
    (("Gamma", {"alpha": 2.0, "theta": 0.5}), kt.Gamma),
    (("LogUniform", {"a": 0.1, "b": 10.0}), kt.LogUniform),
    (("BetaPrime", {"alpha": 3.0, "beta": 5.0}), kt.BetaPrime),
    (("StudentT", {"nu": 4.0}), kt.StudentT),
    (("TDist", {"nu": 4.0}), kt.StudentT),
    (("Poisson", {"lam": 6.0}), kt.Poisson),
    (("DiscreteNonParametric", {"xs": [0.5, 1.5], "ps": [0.5, 0.5]}),
     kt.DiscreteNonParametric),
    (("Truncated", {"base": ("Poisson", {"lam": 6.0}), "lo": 2, "hi": 12}),
     kt.TruncatedDiscrete),
    (("Truncated", {"base": ("StudentT", {"nu": 4.0}), "lo": -1, "hi": 3}),
     kt.Truncated),
    (("Mixture", {"components": [("Normal", {"mu": 0, "sigma": 0.5}),
                                 ("Normal", {"mu": 5, "sigma": 0.5})],
                  "weights": [0.5, 0.5]}), kt.Mixture),
    (("MixtureModel", {"components": [("Poisson", {"lam": 2.0})]}),
     kt.Mixture),
    (("Affine", {"loc": 2.0, "scale": -3.0,
                 "base": ("Exponential", {"theta": 1.0})}), kt.Affine),
    (("Dirichlet", {"alpha": [2.0, 2.0, 2.0]}), kt.Dirichlet),
]


@pytest.mark.parametrize("spec,cls", SPECS, ids=[s[0][0] for s in SPECS])
def test_prior_from_numpy_builds_each_family(spec, cls):
    d = convert.prior_from_numpy(spec)
    assert type(d) is cls
    x = d.sample(_gen(), (8,))
    assert torch.isfinite(d.logpdf(d.push(x.to(torch.float32)))).all()


def test_prior_from_numpy_nested_matches_jax():
    spec = ("Factored", [
        ("Affine", {"loc": 2.0, "scale": -3.0,
                    "base": ("Exponential", {"theta": 1.0})}),
        ("Truncated", {"base": ("StudentT", {"nu": 4.0}), "lo": -1.0,
                       "hi": 3.0})])
    t = convert.prior_from_numpy(spec)
    j = ka.Factored(2.0 - 3.0 * ka.Exponential(1.0),
                    ka.Truncated(ka.StudentT(4.0), -1.0, 3.0))
    x = (np.linspace(-5, 1.9, 50, dtype=np.float32),
         np.linspace(-0.9, 2.9, 50, dtype=np.float32))
    _within_ulps(t.logpdf(tuple(torch.from_numpy(v) for v in x)).numpy(),
                 np.asarray(j.logpdf(tuple(jnp.asarray(v) for v in x))))


def test_draws_use_only_the_given_generator():
    """Every new family draws from the explicit generator: the same seed
    repeats, and the global generator's state does not move."""
    fams = [kt.Exponential(1.0), kt.Gamma(2.0, 1.0), kt.LogUniform(0.1, 10),
            kt.BetaPrime(3.0, 5.0), kt.StudentT(4.0), kt.Poisson(6.0),
            kt.DiscreteNonParametric([0.5, 1.5], [0.5, 0.5]),
            kt.Truncated(kt.Poisson(6.0), 2, 12),
            kt.Truncated(kt.StudentT(4.0), -1, 3),
            kt.Mixture([kt.Normal(0, 1), kt.Normal(5, 1)]),
            2.0 - 3.0 * kt.Exponential(1.0), kt.Dirichlet([2.0, 2.0])]
    state = torch.random.get_rng_state()
    for d in fams:
        a, b = d.sample(_gen(5), (64,)), d.sample(_gen(5), (64,))
        assert torch.equal(a, b), d
    assert torch.equal(state, torch.random.get_rng_state())
