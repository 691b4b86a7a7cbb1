"""The ``Particles`` helpers of kissabc_tpu_torch (``chainsstack``,
``pmap_apply``, ``pmean``, ``pstd``, ``pmedian``, ``pquantile``,
``pcov``, ``pcor``, ``sigmapoints``, ``pm``/``plus_minus``) equal the
JAX package's on the same columns (both are numpy: exactly), and are
importable from the top level.
"""

import numpy as np
import pytest

import kissabc_tpu as ka
import kissabc_tpu_torch as kt
from torch_threads import one_torch_thread  # noqa: F401

HELPERS = ["chainsstack", "pmap_apply", "pmean", "pstd", "pmedian",
           "pquantile", "pcov", "pcor", "sigmapoints", "pm", "plus_minus"]

COLS = np.random.default_rng(0).normal(size=(3, 257)) * [[1.0], [2.0],
                                                        [0.5]]


def _pair(cols):
    return ([kt.Particles(c) for c in cols], [ka.Particles(c) for c in cols])


@pytest.mark.parametrize("name", HELPERS)
def test_exported(name):
    assert name in kt.__all__ and callable(getattr(kt, name))


@pytest.mark.parametrize("name", ["pmean", "pstd", "pmedian"])
def test_summaries_equal_jax(name):
    tp, jp = _pair(COLS)
    for t, j, c in zip(tp, jp, COLS):
        assert getattr(kt, name)(t) == getattr(ka, name)(j)
        assert getattr(kt, name)(c) == getattr(ka, name)(c)


def test_pquantile_pcov_pcor_equal_jax():
    tp, jp = _pair(COLS)
    q = [0.05, 0.5, 0.95]
    np.testing.assert_array_equal(kt.pquantile(tp[1], q),
                                  ka.pquantile(jp[1], q))
    np.testing.assert_array_equal(kt.pquantile(COLS[1], 0.3),
                                  ka.pquantile(COLS[1], 0.3))
    np.testing.assert_array_equal(kt.pcov(tp), ka.pcov(jp))
    np.testing.assert_array_equal(kt.pcor(tp), ka.pcor(jp))


def test_chainsstack_and_pmap_apply_equal_jax():
    tp, jp = _pair(COLS)
    tq, jq = _pair(COLS[::-1])
    got, want = kt.chainsstack([tp, tq]), ka.chainsstack([jp, jq])
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.particles, w.particles)
    one = kt.chainsstack([tp[0], tq[0]])
    assert isinstance(one, kt.Particles) and len(one) == 2 * 257
    got = kt.pmap_apply(lambda a, b: a * np.exp(b), tp[0], tp[1])
    want = ka.pmap_apply(lambda a, b: a * np.exp(b), jp[0], jp[1])
    assert isinstance(got, kt.Particles)
    np.testing.assert_array_equal(got.particles, want.particles)


def test_sigmapoints_equal_jax():
    m = np.array([1.0, -2.0, 0.5])
    S = np.array([[2.0, 0.3, 0.0], [0.3, 1.0, -0.2], [0.0, -0.2, 0.5]])
    np.testing.assert_array_equal(kt.sigmapoints(m, S),
                                  ka.sigmapoints(m, S))
    np.testing.assert_array_equal(kt.sigmapoints(2.0, 4.0),
                                  ka.sigmapoints(2.0, 4.0))
    tp, jp = _pair(COLS)
    X = kt.sigmapoints(tuple(tp))
    np.testing.assert_array_equal(X, ka.sigmapoints(tuple(jp)))
    np.testing.assert_allclose(np.cov(X.T, ddof=1), kt.pcov(tp), atol=1e-12)
    cloud = kt.Particles(X)
    assert isinstance(cloud, list) and len(cloud) == 3
    with pytest.raises(TypeError, match="covariance"):
        kt.sigmapoints([1.0, 2.0])


def test_pm_equal_jax_and_independent():
    for key in (0, 7):
        np.testing.assert_array_equal(kt.pm(3.0, 0.5, 2000, key=key)
                                      .particles,
                                      ka.pm(3.0, 0.5, 2000, key=key)
                                      .particles)
    assert kt.plus_minus is kt.pm
    q = kt.pm(3.0, 0.5, 2000)
    assert abs(q.mean() - 3.0) < 1e-9 and abs(q.std() - 0.5) < 1e-3
    s = (kt.pm(1.0, 0.1) + kt.pm(2.0, 0.2)).std()
    assert abs(s - np.hypot(0.1, 0.2)) < 0.02, s
