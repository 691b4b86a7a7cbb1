"""The vector and matrix families of kissabc_tpu_torch (``Product``/``IID``,
``Multinomial``, ``MvLogNormal``, ``MvTDist``, ``Wishart``,
``InverseWishart``, ``LKJ``, ``LKJCholesky``) and their statistics
branches, held against the JAX package on the same numpy points:

- ``logpdf`` within rtol 1e-5, atol 1e-5 of JAX, -inf in the same places
  (a non-SPD or asymmetric-but-not-PD matrix, a count vector off the
  simplex, a count sum off n, a count in a class of p = 0, a negative
  coordinate of a log-normal, a negative diagonal of a Cholesky factor);
- ``push`` within 1e-6 of JAX (tests/test_distributions.py:1237-1256);
- the constructors' errors (:156, :1159);
- draws against the family's moments (``statistics.mean``/``cov``) at
  the tolerances of tests/test_distributions.py:1118-1260 (the random
  streams differ, so statistically), and the LKJ normalizer integral
  (:1206-1225);
- the multivariate statistics cases of tests/test_statistics.py
  (:186-235, :275, :380, :393-397, :441-447), each against the JAX
  package's own value;
- ``Factored`` of vector and matrix marginals (sample, push, logpdf) and
  ``convert.prior_from_numpy`` of each family.

~15 s on one CPU (``pytest --durations``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as st

import kissabc_tpu as ka
import kissabc_tpu_torch as kt
from kissabc_tpu_torch import convert
from kissabc_tpu_torch import statistics as kts

RTOL, ATOL = 1e-5, 1e-5   # logpdf, port against JAX
PUSH_ATOL = 1e-6


def _spd(rng, n, d, scale=1.0):
    a = rng.normal(size=(n, d, d)) * scale
    return a @ np.swapaxes(a, -1, -2) + 0.3 * np.eye(d)


def _corr(rng, n, d):
    c = _spd(rng, n, d)
    s = np.sqrt(np.diagonal(c, axis1=-2, axis2=-1))
    return c / (s[..., :, None] * s[..., None, :])


def _chol_factor(rng, n, d):
    return np.linalg.cholesky(_corr(rng, n, d))


def _cases():
    """name -> (JAX family, port family, numpy points [m, event...])."""
    rng = np.random.default_rng(16)
    S = np.array([[1.0, 0.3], [0.3, 0.8]])
    Psi = np.array([[2.0, 0.4], [0.4, 1.5]])
    mv_mean = np.array([1.0, -2.0, 0.5])
    mv_cov = np.array([[1.0, 0.3, 0.0], [0.3, 2.0, 0.5], [0.0, 0.5, 1.5]])
    ln_mean, ln_cov = np.array([0.2, -0.3]), np.array([[0.5, 0.2],
                                                       [0.2, 0.4]])
    bad2 = np.array([[[1.0, 0.0], [0.0, -1.0]], [[1.0, 2.0], [2.0, 1.0]],
                     [[1.0, 0.9], [-0.9, 1.0]],   # asymmetric, sym. part PD
                     [[0.0, 0.0], [0.0, 0.0]]])
    counts = rng.multinomial(10, [0.2, 0.5, 0.3], size=40).astype(float)
    counts = np.concatenate([counts, [[2, 5, 4], [-1, 8, 3], [3, 3, 3],
                                      [2.4, 5.3, 2.3], [2.6, 5.0, 2.6]]])
    lkj3 = _corr(rng, 30, 3)
    lkj3 = np.concatenate([lkj3, [np.full((3, 3), -0.9) + 1.9 * np.eye(3),
                                  np.ones((3, 3))]])
    lc = _chol_factor(rng, 30, 4)
    lc_bad = lc[:3].copy()
    lc_bad[:, 2, 2] *= -1.0
    lc_bad[1, 1, 1] = 0.0
    return {
        "Product": (ka.Product([ka.Normal(0, 1), ka.Normal(5, 2)]),
                    kt.Product([kt.Normal(0, 1), kt.Normal(5, 2)]),
                    rng.normal(2.0, 3.0, size=(50, 2))),
        "IID-Poisson": (ka.IID(ka.Poisson(3.0), 3),
                        kt.IID(kt.Poisson(3.0), 3),
                        rng.integers(-2, 9, size=(50, 3)).astype(float)),
        "Multinomial": (ka.Multinomial(10, [0.2, 0.5, 0.3]),
                        kt.Multinomial(10, [0.2, 0.5, 0.3]), counts),
        "Multinomial-p0": (ka.Multinomial(4, [0.5, 0.5, 0.0]),
                           kt.Multinomial(4, [0.5, 0.5, 0.0]),
                           np.array([[2.0, 1.0, 1.0], [3.0, 1.0, 0.0],
                                     [0.0, 4.0, 0.0], [4.0, 0.0, 0.0]])),
        "MvLogNormal": (ka.MvLogNormal(ln_mean, ln_cov),
                        kt.MvLogNormal(ln_mean, ln_cov),
                        np.concatenate([rng.lognormal(0.0, 0.7, (40, 2)),
                                        [[1.0, -0.5], [0.0, 1.0]]])),
        "MvTDist": (ka.MvTDist(5.0, mv_mean, mv_cov),
                    kt.MvTDist(5.0, mv_mean, mv_cov),
                    rng.normal(0.0, 2.0, size=(50, 3))),
        "MvTDist-scalar-cov": (ka.MvTDist(3.0, [0.0, 1.0], 2.0),
                               kt.MvTDist(3.0, [0.0, 1.0], 2.0),
                               rng.normal(0.0, 3.0, size=(20, 2))),
        "Wishart": (ka.Wishart(5.0, S), kt.Wishart(5.0, S),
                    np.concatenate([_spd(rng, 40, 2), bad2])),
        "Wishart-3": (ka.Wishart(4.5, np.eye(3)), kt.Wishart(4.5, np.eye(3)),
                      np.concatenate([_spd(rng, 30, 3, 0.7),
                                      [np.diag([1.0, -1.0, 1.0])]])),
        "InverseWishart": (ka.InverseWishart(6.0, Psi),
                           kt.InverseWishart(6.0, Psi),
                           np.concatenate([_spd(rng, 40, 2, 0.5), bad2])),
        "LKJCholesky": (ka.LKJCholesky(4, 2.5), kt.LKJCholesky(4, 2.5),
                        np.concatenate([lc, lc_bad])),
        "LKJ": (ka.LKJ(3, 1.8), kt.LKJ(3, 1.8), lkj3),
        "LKJ-2-uniform": (ka.LKJ(2, 1.0), kt.LKJ(2, 1.0),
                          np.concatenate([_corr(rng, 20, 2),
                                          [[[1.0, 1.0], [1.0, 1.0]],
                                           [[1.0, 1.2], [1.2, 1.0]]]])),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_logpdf_matches_jax(name):
    jd, td, pts = CASES[name]
    x = pts.astype(np.float32)
    want = np.asarray(jd.logpdf(jnp.asarray(x)), np.float64)
    got = td.logpdf(torch.from_numpy(x)).double().numpy()
    assert got.shape == want.shape == (x.shape[0],)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert (got[~fin] == -np.inf).all()
    assert 0 < fin.sum()
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


NEG_INF_CASES = {   # family name -> the points that must give -inf
    "Multinomial": [[2, 5, 4], [-1, 8, 3], [3, 3, 3]],
    "Multinomial-p0": [[2.0, 1.0, 1.0]],
    "MvLogNormal": [[1.0, -0.5], [0.0, 1.0]],
    "Wishart": [[[1.0, 0.0], [0.0, -1.0]], [[1.0, 2.0], [2.0, 1.0]],
                [[0.0, 0.0], [0.0, 0.0]]],
    "InverseWishart": [[[1.0, 0.0], [0.0, -1.0]], [[1.0, 2.0], [2.0, 1.0]]],
    "LKJ": [np.full((3, 3), -0.9) + 1.9 * np.eye(3), np.ones((3, 3))],
}


@pytest.mark.parametrize("name", sorted(NEG_INF_CASES))
def test_neg_inf_off_the_support(name):
    """Off the support the logpdf is -inf, in a batch with finite
    values too, and nothing raises (``cholesky_ex``, not ``cholesky``)."""
    jd, td, pts = CASES[name]
    bad = torch.tensor(np.asarray(NEG_INF_CASES[name]), dtype=torch.float32)
    x = pts.astype(np.float32)
    good = torch.from_numpy(x[np.isfinite(np.asarray(jd.logpdf(x)))][:3])
    lp = td.logpdf(torch.cat([good, bad]))
    assert torch.isfinite(lp[:3]).all()
    assert (lp[3:] == float("-inf")).all()


def test_push_matches_jax():
    x = np.random.default_rng(1).normal(size=(5, 3, 3)).astype(np.float32)
    for jd, td in ((ka.Wishart(5.0, np.eye(3)), kt.Wishart(5.0, np.eye(3))),
                   (ka.InverseWishart(5.0, np.eye(3)),
                    kt.InverseWishart(5.0, np.eye(3))),
                   (ka.LKJ(3, 2.0), kt.LKJ(3, 2.0)),
                   (ka.LKJCholesky(3, 2.0), kt.LKJCholesky(3, 2.0))):
        got = td.push(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jd.push(jnp.asarray(x))),
                                   rtol=0, atol=PUSH_ATOL)
    pw = kt.Wishart(5.0, np.eye(3)).push(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(pw, np.swapaxes(pw, -1, -2), atol=1e-6)
    pl = kt.LKJ(3, 2.0).push(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.diagonal(pl, axis1=-2, axis2=-1), 1.0)
    pc = kt.LKJCholesky(3, 2.0).push(torch.from_numpy(x)).numpy()
    assert (np.triu(pc, 1) == 0).all()
    np.testing.assert_allclose(np.linalg.norm(pc, axis=-1), 1.0, atol=1e-6)
    # the discrete vector families push component-wise, half to even
    c = torch.tensor([[0.5, 1.5, 2.5], [3.49, -0.5, 8.51]])
    for jd, td in ((ka.Multinomial(10, [0.2, 0.5, 0.3]),
                    kt.Multinomial(10, [0.2, 0.5, 0.3])),
                   (ka.IID(ka.Poisson(3.0), 3), kt.IID(kt.Poisson(3.0), 3))):
        got = td.push(c)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jd.push(jnp.asarray(
                                          c.numpy()))))
    # a continuous Product pushes to float32 (tests/test_factored_push.py:44)
    pr = kt.Product([kt.Normal(0, 1), kt.Normal(0, 1)])
    v = pr.push(torch.tensor([2, 1], dtype=torch.int32))
    assert v.dtype == torch.float32 and v.tolist() == [2.0, 1.0]


@pytest.mark.parametrize("make,match", [
    (lambda m: m.Product([m.Normal(0, 1), m.DiscreteUniform(0, 1)]),
     "homogeneous"),
    (lambda m: m.Wishart(0.5, np.eye(2)), "df"),
    (lambda m: m.Wishart(5.0, np.ones(3)), "square"),
    (lambda m: m.InverseWishart(1.0, np.eye(3)), "df"),
    (lambda m: m.MvTDist(0.0, [0.0], [[1.0]]), "df"),
    (lambda m: m.LKJ(1, 1.0), "d >= 2"),
    (lambda m: m.LKJCholesky(3, 0.0), "eta > 0"),
])
def test_constructor_errors_match_jax(make, match):
    for module in (ka, kt):
        with pytest.raises(ValueError, match=match):
            make(module)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_draws_match_the_moments():
    """tests/test_distributions.py:148-156, :316-343 and :1118-1200 on
    the port's draws (20000, or 4000/8000 for the matrix families)."""
    x = kt.Product([kt.Normal(0, 1), kt.Normal(5, 2)]).sample(
        _gen(1), (20_000,)).numpy()
    assert x.shape == (20_000, 2) and abs(x[:, 1].mean() - 5) < 0.05

    p = np.array([0.2, 0.5, 0.3])
    mn = kt.Multinomial(10, p)
    x = mn.sample(_gen(2), (5000,)).numpy()
    np.testing.assert_allclose(x.sum(-1), 10.0, atol=1e-5)
    np.testing.assert_allclose(x.mean(0), 10 * p, atol=0.15)
    np.testing.assert_allclose(np.cov(x.T), kts.cov(mn), atol=0.15)
    assert torch.isfinite(mn.logpdf(torch.from_numpy(x))).all()

    ml = kt.MvLogNormal([0.2, -0.3], [[0.5, 0.2], [0.2, 0.4]])
    x = ml.sample(_gen(3), (20_000,)).numpy().astype(np.float64)
    assert x.shape == (20_000, 2) and (x > 0).all()
    np.testing.assert_allclose(x.mean(0), kts.mean(ml), rtol=0.05)

    cov = np.array([[1.0, 0.3, 0.0], [0.3, 2.0, 0.5], [0.0, 0.5, 1.5]])
    mt = kt.MvTDist(5.0, [1.0, -2.0, 0.5], cov)
    x = mt.sample(_gen(4), (20_000,)).numpy().astype(np.float64)
    assert np.abs(x.mean(0) - [1.0, -2.0, 0.5]).max() < 0.1
    np.testing.assert_allclose(np.cov(x.T), kts.cov(mt), rtol=0.15,
                               atol=0.05)

    S = np.array([[1.0, 0.3], [0.3, 0.8]])
    x = kt.Wishart(5.0, S).sample(_gen(5), (4000,)).numpy()
    assert x.shape == (4000, 2, 2)
    np.testing.assert_allclose(x.mean(0), kts.mean(kt.Wishart(5.0, S)),
                               rtol=0.08)

    # the JAX test's 4000 draws, tenfold: at df = 6 the entries' fourth
    # moment is infinite, so the sample mean of 4000 strays past rtol 0.1
    # on some streams (0.157 against 0.133 off the diagonal, on this one;
    # 0.1322-0.1346 at 400000 on four streams, scipy's 0.1323)
    Psi = np.array([[2.0, 0.4], [0.4, 1.5]])
    iw = kt.InverseWishart(6.0, Psi)
    x = iw.sample(_gen(6), (40_000,)).numpy()
    np.testing.assert_allclose(x.mean(0), kts.mean(iw), rtol=0.1)
    assert (np.linalg.eigvalsh(x[:100]) > 0).all()


def test_lkj_cholesky_draws_and_logpdf():
    """tests/test_distributions.py:1178-1204: unit rows, the exact
    Beta marginal of each off-diagonal, and the logpdf against
    ``torch.distributions.LKJCholesky``."""
    d, eta = 4, 2.5
    dist = kt.LKJCholesky(d, eta)
    L = dist.sample(_gen(7), (8000,)).numpy()
    assert L.shape == (8000, 4, 4)
    R = L @ np.swapaxes(L, -1, -2)
    np.testing.assert_allclose(np.diagonal(R, axis1=-2, axis2=-1), 1.0,
                               atol=1e-5)
    a = eta - 1 + d / 2
    for (i, j) in [(1, 0), (2, 1), (3, 0), (3, 2)]:
        ks = st.kstest((R[:, i, j] + 1) / 2, st.beta(a, a).cdf)
        assert ks.pvalue > 1e-4, f"r[{i},{j}]: p={ks.pvalue}"
    L64 = L[:16].astype(np.float64)
    L64 /= np.linalg.norm(L64, axis=-1, keepdims=True)
    ref = torch.distributions.LKJCholesky(d, eta).log_prob(
        torch.from_numpy(L64)).numpy()
    np.testing.assert_allclose(dist.logpdf(torch.from_numpy(L[:16])).numpy(),
                               ref, rtol=1e-3, atol=1e-3)


def test_lkj_draws_and_normalizer():
    """tests/test_distributions.py:1206-1234: unit diagonal, symmetry,
    the Beta marginal, the normalizer integral over the 3x3 elliptope,
    and E[R] = I for eta = 1."""
    d, eta = 3, 1.8
    dist = kt.LKJ(d, eta)
    R = dist.sample(_gen(8), (8000,)).numpy()
    np.testing.assert_allclose(np.diagonal(R, axis1=-2, axis2=-1), 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(R, np.swapaxes(R, -1, -2), atol=1e-6)
    a = eta - 1 + d / 2
    assert st.kstest((R[:, 1, 0] + 1) / 2, st.beta(a, a).cdf).pvalue > 1e-4
    n = 120
    g = np.linspace(-1 + 1 / n, 1 - 1 / n, n)
    r12, r13, r23 = np.meshgrid(g, g, g, indexing="ij")
    det = 1 + 2 * r12 * r13 * r23 - r12 ** 2 - r13 ** 2 - r23 ** 2
    valid = det > 1e-12
    integrand = np.where(valid, np.exp((eta - 1) * np.log(
        np.where(valid, det, 1.0)) - float(dist._lc)), 0.0)
    assert abs(integrand.sum() * (2 / n) ** 3 - 1.0) < 0.01
    assert float(dist._lc) == float(ka.LKJ(d, eta)._lc)
    Ru = kt.LKJ(3, 1.0).sample(_gen(9), (8000,)).numpy()
    np.testing.assert_allclose(Ru.mean(0), kts.mean(kt.LKJ(3, 1.0)),
                               atol=0.03)


def test_factored_of_vector_and_matrix_marginals():
    """``Factored`` samples, pushes and evaluates vector and matrix
    marginals (the covariance example's prior and an MvNormal), as the
    JAX package's: one ``[n, d, d]`` / ``[n, d]`` leaf each."""
    prior = kt.Factored(kt.LKJ(2, 1.0), kt.LogUniform(0.1, 10.0),
                        kt.MvNormal(np.zeros(2), np.eye(2)))
    jprior = ka.Factored(ka.LKJ(2, 1.0), ka.LogUniform(0.1, 10.0),
                         ka.MvNormal(np.zeros(2), np.eye(2)))
    assert prior.nparams == 3
    th = prior.sample_tree(_gen(10), 64)
    assert [tuple(t.shape) for t in th] == [(64, 2, 2), (64,), (64, 2)]
    noisy = tuple(t + 0.01 * torch.randn(t.shape, generator=_gen(11))
                  for t in th)
    pushed = prior.push_tree(noisy)
    assert torch.equal(pushed[0].diagonal(dim1=-2, dim2=-1),
                       torch.ones(64, 2))
    lp = prior.logpdf_tree(pushed)
    want = jax.vmap(lambda *t: jprior.logpdf_tree(jprior.push_tree(t)))(
        *[jnp.asarray(t.numpy()) for t in noisy])
    np.testing.assert_allclose(lp.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    pd = kts.product_distribution([kt.MvNormal(np.zeros(2), np.eye(2)),
                                   kt.Normal(0.0, 1.0)])
    assert isinstance(pd, kt.Factored)
    s = pd.sample_tree(_gen(12), 5)
    assert s[0].shape == (5, 2) and s[1].shape == (5,)


SPECS = [
    ("Product", {"dists": [("Normal", {"mu": 0, "sigma": 1}),
                           ("Normal", {"mu": 5, "sigma": 2})]}),
    ("IID", {"d": ("Poisson", {"lam": 3.0}), "n": 3}),
    ("Multinomial", {"n": 10, "p": [0.2, 0.5, 0.3]}),
    ("MvLogNormal", {"mean_or_dim": [0.2, -0.3],
                     "sigma_or_cov": [[0.5, 0.2], [0.2, 0.4]]}),
    ("MvTDist", {"df": 5.0, "mean": [1.0, -2.0], "cov": [[1.0, 0.3],
                                                          [0.3, 2.0]]}),
    ("Wishart", {"df": 5.0, "S": [[1.0, 0.3], [0.3, 0.8]]}),
    ("InverseWishart", {"df": 6.0, "Psi": np.array([[2.0, 0.4],
                                                    [0.4, 1.5]])}),
    ("LKJ", {"d": 3, "eta": 1.8}),
    ("LKJCholesky", {"d": 4, "eta": 2.5}),
]


@pytest.mark.parametrize("spec", SPECS, ids=[s[0] for s in SPECS])
def test_prior_from_numpy_builds_each_family(spec):
    d = convert.prior_from_numpy(spec)
    assert type(d).__name__ == ("Product" if spec[0] == "IID" else spec[0])
    x = d.sample(_gen(13), (4,))
    assert torch.isfinite(d.logpdf(x)).all()
    f = convert.prior_from_numpy(("Factored", [spec, ("Uniform",
                                                      {"a": 0, "b": 1})]))
    assert isinstance(f.p[0], type(d))


# --- statistics (tests/test_statistics.py's multivariate cases) ----------

def test_multivariate_mean_cov_entropy():
    sig = np.array([[2.0, 0.5], [0.5, 1.0]])
    mn = kt.Multinomial(10, [0.2, 0.3, 0.5])
    assert np.allclose(kts.mean(mn), [2.0, 3.0, 5.0], atol=1e-6)
    p = np.array([0.2, 0.3, 0.5])
    assert np.allclose(kts.cov(mn), 10 * (np.diag(p) - np.outer(p, p)),
                       atol=1e-6)
    assert np.allclose(kts.var(mn), np.diag(kts.cov(mn)))
    ml = kt.MvLogNormal(np.array([0.1, -0.2]),
                        np.array([[0.3, 0.1], [0.1, 0.2]]))
    x = ml.sample(_gen(14), (400_000,)).numpy().astype(np.float64)
    assert np.allclose(x.mean(0), kts.mean(ml), rtol=0.01)
    assert np.allclose(np.cov(x.T), kts.cov(ml), rtol=0.05)
    mt = kt.MvTDist(6.0, np.array([1.0, 2.0]), sig)
    assert np.allclose(kts.mean(mt), [1.0, 2.0])
    assert np.allclose(kts.cov(mt), 6.0 / 4.0 * sig, atol=1e-6)
    assert np.isnan(kts.mean(kt.MvTDist(1.0, [0.0, 0.0], sig))).all()
    with pytest.raises(NotImplementedError, match="df > 2"):
        kts.cov(kt.MvTDist(2.0, [0.0, 0.0], sig))
    assert np.allclose(kts.mean(kt.Wishart(5.0, np.eye(2))), 5.0 * np.eye(2),
                       atol=1e-6)
    assert np.allclose(kts.mean(kt.InverseWishart(6.0, np.eye(2))),
                       np.eye(2) / 3.0, atol=1e-6)
    with pytest.raises(NotImplementedError, match="df > d"):
        kts.mean(kt.InverseWishart(2.5, np.eye(2)))
    assert np.allclose(kts.mean(kt.LKJ(3, 2.0)), np.eye(3))


def test_product_statistics():
    pr = kt.Product([kt.Normal(0.0, 1.0), kt.Normal(5.0, 2.0)])
    assert np.allclose(kts.mean(pr), [0.0, 5.0])
    assert np.allclose(kts.var(pr), [1.0, 4.0])
    assert np.allclose(kts.cov(pr), np.diag([1.0, 4.0]), atol=1e-6)
    assert np.isclose(kts.entropy(pr), st.norm(0, 1).entropy()
                      + st.norm(5, 2).entropy(), rtol=1e-6)
    ok = kts.insupport(kt.IID(kt.Poisson(3.0), 2),
                       torch.tensor([[1.0, 2.0], [1.5, 2.0], [-1.0, 0.0]]))
    assert ok.tolist() == [True, False, False]
    assert isinstance(kts.product_distribution(
        [kt.Normal(0, 1), kt.Normal(2, 3)]), kt.Product)
    assert isinstance(kts.product_distribution(
        [kt.Normal(0, 1), kt.Poisson(2.0)]), kt.Factored)
    assert isinstance(kts.product_distribution(
        [kt.Poisson(1.0), kt.Poisson(2.0)]), kt.Product)


def _jax_twin(td):
    """The JAX package's family of the same parameters."""
    for name, (jd, d, _) in CASES.items():
        if d is td:
            return jd
    raise KeyError(td)


STAT_FAMILIES = ["Product", "Multinomial", "MvLogNormal", "MvTDist",
                 "Wishart", "InverseWishart", "LKJ"]


@pytest.mark.parametrize("name", STAT_FAMILIES)
def test_statistics_match_jax(name):
    """mean, var, cov, mode, entropy, params and insupport of each new
    family equal the JAX package's (both raise where one raises)."""
    jd, td, pts = CASES[name]
    for fname in ("mean", "var", "cov", "mode", "entropy", "params"):
        try:
            want = getattr(ka, fname)(jd)
        except NotImplementedError:
            with pytest.raises(NotImplementedError):
                getattr(kts, fname)(td)
            continue
        got = getattr(kts, fname)(td)
        for g, w in zip(np.atleast_1d(np.asarray(got, dtype=object)),
                        np.atleast_1d(np.asarray(want, dtype=object))):
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64), rtol=1e-6)
    if name in ("Product", "MvLogNormal", "MvTDist"):
        x = pts.astype(np.float32)
        got = kts.insupport(td, torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            ka.insupport(jd, jnp.asarray(x))))
    cor = kts.cor(td) if name in ("MvTDist", "Multinomial") else None
    if cor is not None:
        np.testing.assert_allclose(cor, ka.cor(jd), rtol=1e-6)


def test_params_fit_and_pointwise():
    """tests/test_statistics.py:380 and :393-397, :441-447: ``fit`` of a
    matrix family raises; ``params`` of MvTDist and Multinomial; the
    pointwise ``logpdf``/``pdf`` and ``rand`` through the generic code."""
    with pytest.raises(NotImplementedError):
        kts.fit(kt.Wishart, np.zeros((10, 2, 2)))
    df, mu, cv = kts.params(kt.MvTDist(5.0, [1.0, 2.0], np.eye(2)))
    assert df == 5.0 and np.allclose(mu, [1.0, 2.0]) and np.allclose(cv,
                                                                      np.eye(2))
    n, p = kts.params(kt.Multinomial(10, [0.2, 0.8]))
    assert n == 10 and np.allclose(p, [0.2, 0.8])
    w = kt.Wishart(5.0, np.eye(2))
    x = torch.eye(2)[None] * torch.tensor([1.0, 2.0])[:, None, None]
    assert torch.allclose(kts.pdf(w, x), torch.exp(kts.logpdf(w, x)))
    r = kts.rand(kt.LKJ(3, 1.0), (4, 5), key=3, device="cpu")
    assert r.shape == (4, 5, 3, 3)
    f = kts.rand(kt.Factored(kt.Wishart(5.0, np.eye(2)), kt.Normal(0, 1)), 6,
                 key=1, device="cpu")
    assert f[0].shape == (6, 2, 2) and f[1].shape == (6,)
    assert np.allclose(kts.cor(kt.MvTDist(5.0, [0.0, 0.0],
                                          [[4.0, 1.0], [1.0, 1.0]])),
                       [[1.0, 0.5], [0.5, 1.0]], atol=1e-6)
