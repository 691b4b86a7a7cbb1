"""The cross-distribution consistency battery of
``tests/test_distribution_consistency.py`` on kissabc_tpu_torch, with its
families, legs, bounds and n: every family's quantile inverts its cdf,
its draws follow its cdf (KS) and have a finite logpdf, a discrete
family samples int32 with a pmf that matches its draws, and the declared
moments (``statistics.py``) match the draws. The generator is seeded
with the JAX test's key, 11.

Beside the battery:

- ``Arcsine(0, 1)``: its quantile ``a + w sin^2(pi/2 q)`` rounds to ``b``
  in float32 for q within about 1e-4 of 1, and ``logpdf(b)`` is -inf, in
  both packages (``kissabc_tpu/distributions.py:746-757``). So some
  draws have a non-finite logpdf; the JAX case passes at key 11 only
  because of its draws. The port's case is a strict ``xfail``, and
  ``test_arcsine_draws_on_b_alike_in_both_packages`` holds the shared
  behaviour: the rate of draws on ``b`` agrees at 10^5 draws within
  binomial bounds, and ``logpdf(b) == -inf`` in both;
- ``test_sample_dtype_matches_jax``: every family's sample dtype equals
  the JAX package's, over the battery, the vector and matrix families
  and the composites (``Truncated``, ``Mixture``, ``Product``,
  ``Affine``, ``Factored``). ``Multinomial`` samples float32 in both.

Each family is built from one spec in both packages, so the JAX twin of
every case is at hand: a case also holds that the port's family has the
cdf and quantile legs exactly where the JAX family has them. The JAX
dtype comes from ``jax.eval_shape`` (traced, not run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from battery_specs import CONTINUOUS, DISCRETE, OTHERS, build

import kissabc_tpu as ka
import kissabc_tpu_torch as kt
from torch_threads import one_torch_thread  # noqa: F401

SEED = 11
KEY = jax.random.key(SEED)

ARCSINE_REASON = (
    "quantile a + w sin^2(pi/2 q) rounds to b in float32 for q near 1 and "
    "logpdf(b) is -inf, in the JAX package too; its case passes at key 11 "
    "only because of its draws")

def jax_twin(spec):
    """The JAX package's family of ``spec``. The JAX ``VonMises``
    tabulates scipy's ppf when it is built (~23 s on the CPU); the
    port's table equals it in float32, so its twin takes the port's."""
    if spec[0] != "VonMises":
        return build(ka, spec)
    d = build(kt, spec)
    j = object.__new__(ka.VonMises)
    for f in ("mu", "kappa", "_lnorm", "_tab"):
        object.__setattr__(j, f, getattr(d, f))
    return j


def _gen():
    return torch.Generator().manual_seed(SEED)


def _id(spec):
    return repr(build(kt, spec))


def _case(spec):
    if spec[0] == "Arcsine":
        return pytest.param(spec, marks=pytest.mark.xfail(
            strict=True, reason=ARCSINE_REASON), id=_id(spec))
    return pytest.param(spec, id=_id(spec))


def _same_legs(d, j):
    for leg in ("cdf", "quantile"):
        assert hasattr(d, leg) == hasattr(j, leg), (
            f"{d!r}: {leg} in the port {hasattr(d, leg)}, "
            f"in the JAX package {hasattr(j, leg)}")


def _f32(v):
    return torch.as_tensor(np.asarray(v, np.float32))


@pytest.mark.parametrize("spec", [_case(s) for s in CONTINUOUS])
def test_continuous_consistency(spec):
    d, j = build(kt, spec), jax_twin(spec)
    _same_legs(d, j)
    n = 8000
    x = d.sample(_gen(), (n,)).numpy()
    assert x.shape == (n,) and np.isfinite(x).all()
    lp = d.logpdf(_f32(x)).numpy()
    assert np.isfinite(lp).all(), f"{d!r}: non-finite logpdf at samples"
    if hasattr(d, "cdf"):
        ks = st.kstest(x[:4000], lambda v: d.cdf(_f32(v)).numpy()
                       .astype(np.float64))
        assert ks.pvalue > 1e-4, f"{d!r}: KS p={ks.pvalue}"
    if hasattr(d, "cdf") and hasattr(d, "quantile"):
        qs = np.asarray([0.05, 0.25, 0.5, 0.75, 0.95], np.float32)
        xq = d.quantile(_f32(qs))
        back = d.cdf(xq).numpy()
        np.testing.assert_allclose(back, qs, atol=5e-3,
                                   err_msg=f"{d!r}: cdf(quantile(q)) != q")


@pytest.mark.parametrize("spec", [_case(s) for s in DISCRETE])
def test_discrete_consistency(spec):
    d, j = build(kt, spec), jax_twin(spec)
    _same_legs(d, j)
    n = 8000
    xt = d.sample(_gen(), (n,))
    assert xt.dtype == torch.int32, f"{d!r}: samples must be int32"
    x = xt.numpy()
    lp = d.logpdf(xt).numpy()
    assert np.isfinite(lp).all(), f"{d!r}: non-finite logpmf at samples"
    vals, counts = np.unique(x, return_counts=True)
    emp = counts / n
    model = np.exp(d.logpdf(torch.as_tensor(vals)).numpy())
    err = 5.0 * np.sqrt(np.maximum(model * (1 - model), 1e-12) / n)
    bad = np.abs(emp - model) > np.maximum(err, 0.01)
    assert not bad.any(), (
        f"{d!r}: pmf mismatch at {vals[bad]}: emp={emp[bad]} vs "
        f"model={model[bad]}")
    pushed = d.push(torch.as_tensor(x, dtype=torch.float32) + 0.3)
    assert pushed.dtype == torch.int32


@pytest.mark.parametrize("spec", [_case(s) if s[0] != "Arcsine"
                                  else pytest.param(s, id=_id(s))
                                  for s in CONTINUOUS + DISCRETE])
def test_declared_moments_match_empirical(spec):
    """kt.mean/kt.var/kt.kurtosis against the battery's own samplers."""
    d = build(kt, spec)
    if isinstance(d, kt.VonMises):
        pytest.skip("var(VonMises) is the CIRCULAR variance "
                    "(Distributions.jl semantics) — not comparable to "
                    "the empirical linear variance")
    n = 8000
    x = d.sample(_gen(), (n,)).numpy().astype(np.float64)
    try:
        m, v = kt.mean(d), kt.var(d)
    except NotImplementedError:
        pytest.skip("no declared moments")
    if not (np.isfinite(m) and np.isfinite(v)):
        pytest.skip("undefined moments (heavy tail)")
    se = np.sqrt(v / n)
    assert abs(x.mean() - m) < 6.0 * se + 1e-9, (
        f"{d!r}: mean {x.mean()} vs declared {m}")
    if v <= 0:
        return
    try:
        k = kt.kurtosis(d)
    except NotImplementedError:
        return
    if np.isfinite(k) and k < 50:
        tol = 6.0 * np.sqrt((k + 2.0) / (4.0 * n)) + 0.01
        rel = abs(x.std(ddof=1) - np.sqrt(v)) / np.sqrt(v)
        assert rel < tol, (
            f"{d!r}: std {x.std(ddof=1)} vs declared {np.sqrt(v)}")


def test_arcsine_draws_on_b_alike_in_both_packages():
    """The shared behaviour behind the ``Arcsine`` xfail: both packages
    put draws on ``b`` at rates that agree within binomial bounds (5
    sigma of the difference of two rates) at 10^5 draws, and both give
    ``logpdf(b) == -inf``."""
    n = 100_000
    d, j = kt.Arcsine(0.0, 1.0), ka.Arcsine(0.0, 1.0)
    on_t = int((d.sample(_gen(), (n,)) == 1.0).sum())
    on_j = int((np.asarray(j.sample(KEY, (n,))) == 1.0).sum())
    assert on_t > 0 and on_j > 0
    p = (on_t + on_j) / (2 * n)
    assert abs(on_t - on_j) / n <= 5.0 * np.sqrt(2 * p * (1 - p) / n), (
        on_t, on_j)
    assert float(d.logpdf(torch.tensor(1.0))) == -np.inf
    assert float(j.logpdf(jnp.float32(1.0))) == -np.inf


def _dtypes(x):
    if isinstance(x, (tuple, list)):
        return [_dtypes(v) for v in x]
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("spec", [pytest.param(s, id=_id(s))
                                  for s in CONTINUOUS + DISCRETE + OTHERS])
def test_sample_dtype_matches_jax(spec):
    d, j = build(kt, spec), jax_twin(spec)
    got = _dtypes(d.sample(_gen(), (4,)))
    want = _dtypes(jax.eval_shape(lambda k: j.sample(k, (4,)), KEY))
    assert got == want, f"{d!r}: port samples {got}, JAX {want}"
