"""kissabc_tpu_torch's adaptive tempered SMC (``core/tsmc.py``): the
tests of ``tests/test_tsmc.py`` on the port (CPU, the split
rejuvenation), with their tolerances (conjugate-normal posterior moments
within 0.02 and the evidence within 0.15 of the closed form); and
``ess_weights``, ``next_lambda`` and the evidence increment held against
the JAX arithmetic of ``kissabc_tpu/core/tsmc.py:112-139,198-201`` on the
same float32 inputs: ``dlam`` and the ESS within rel 1e-6 at tsmc's
default ``alpha = 0.5`` (at ``alpha = 0.9`` within rel 1e-5: the ESS is
flat near that target, so a float32 rounding of its sum, summed in
another order, moves a late bisection step; 2.1e-6 seen), the increment
``m + log(mean(...))`` within 4 float32 ulps of ``max(1, |m|)`` (XLA's
CPU ``exp`` and PyTorch's differ by an ulp, and the mean is summed in
another order, which a small increment does not scale down).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from kissabc_tpu.ops.quantile import ess_weights as jax_ess
import kissabc_tpu_torch as kt
from kissabc_tpu_torch import convert
from kissabc_tpu_torch.core import tsmc as TS
from kissabc_tpu_torch.ops.quantile import ess_weights
from torch_threads import one_torch_thread  # noqa: F401

Y = np.array([1.2, 0.8, 1.5, 0.9, 1.1, 1.3, 0.7, 1.0], dtype=np.float32)
K = len(Y)
YT = torch.from_numpy(Y)


def _loglike(theta):
    return -0.5 * torch.sum((YT - theta) ** 2) - K / 2 * np.log(2 * np.pi)


def _truth():
    post_mean = Y.sum() / (K + 1)
    post_sd = 1.0 / np.sqrt(K + 1)
    cov = np.eye(K) + np.ones((K, K))
    logz = st.multivariate_normal(np.zeros(K), cov).logpdf(Y)
    return post_mean, post_sd, logz


def test_tsmc_conjugate_normal():
    res = kt.tsmc(kt.Normal(0, 1), _loglike, nparticles=4000,
                  mcmc_steps=5, key=1, device="cpu")
    m, sd, logz = _truth()
    assert res.lam == 1.0
    assert abs(res.P.mean() - m) < 0.02
    assert abs(res.P.std() - sd) < 0.02
    assert abs(res.log_evidence - logz) < 0.15, (res.log_evidence, logz)


def test_tsmc_factored_prior_2d():
    def ll(theta):
        a, b = theta
        return (-0.5 * torch.sum((YT - a) ** 2)
                - 0.5 * torch.sum((YT[:4] - b) ** 2))

    prior = kt.Factored(kt.Normal(0, 1), kt.Normal(0, 1))
    res = kt.tsmc(prior, ll, nparticles=4000, mcmc_steps=5, key=2,
                  device="cpu")
    a_post, b_post = res.P
    assert abs(a_post.mean() - Y.sum() / (K + 1)) < 0.03
    assert abs(b_post.mean() - Y[:4].sum() / 5) < 0.03


def test_tsmc_vectorized_loglike():
    """``loglike_vectorized`` takes the whole pushed batch and gives the
    same conjugate posterior and evidence."""
    def ll_vec(thetas, gen):
        return (-0.5 * torch.sum((YT[None, :] - thetas[:, None]) ** 2, dim=1)
                - K / 2 * np.log(2 * np.pi))

    res = kt.tsmc(kt.Normal(0, 1), ll_vec, nparticles=4000, mcmc_steps=5,
                  loglike_vectorized=True, key=3, device="cpu")
    m, sd, logz = _truth()
    assert res.lam == 1.0
    assert abs(res.P.mean() - m) < 0.02
    assert abs(res.P.std() - sd) < 0.02
    assert abs(res.log_evidence - logz) < 0.15


def test_tsmc_validation():
    with pytest.raises(ValueError):
        kt.tsmc(kt.Normal(0, 1), _loglike, alpha=1.5, device="cpu")
    with pytest.raises(ValueError, match="SAME mesh"):
        sw = kt.make_fused_tempered_sweep(kt.Normal(0, 1),
                                          lambda th: -0.5 * th * th)
        kt.tsmc(kt.Normal(0, 1), _loglike, sweep_fused=sw, mesh=object(),
                device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        kt.tsmc(kt.Normal(0, 1), _loglike, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            kt.tsmc(kt.Normal(0, 1), _loglike)


# ---------------------------------------------------------------------------
# the temperature step and the evidence, against the JAX arithmetic
# ---------------------------------------------------------------------------

def _jax_next_lambda(lam, ll, alpha, n):
    """kissabc_tpu/core/tsmc.py:112-134, written out."""
    target = alpha * n

    def ess_at(dlam):
        lw = dlam * ll
        lw = lw - jnp.max(lw)
        return jax_ess(jnp.exp(lw))

    full = 1.0 - lam

    def body(_, c):
        lo, hi = c
        mid = 0.5 * (lo + hi)
        too_low = ess_at(mid) < target
        return jnp.where(too_low, lo, mid), jnp.where(too_low, mid, hi)

    lo, hi = jax.lax.fori_loop(0, 40, body,
                               (jnp.asarray(0.0, jnp.float32), full))
    dlam = 0.5 * (lo + hi)
    return jnp.where(ess_at(full) >= target, full, dlam)


def _jax_increment(dlam, ll):
    """kissabc_tpu/core/tsmc.py:198-204, written out."""
    m = jnp.max(dlam * ll)
    inc = m + jnp.log(jnp.mean(jnp.exp(dlam * ll - m)))
    return inc, jax_ess(jnp.exp(dlam * ll - m))


def _seeded_ll(n, rng):
    ll = (-0.5 * rng.chisquare(3, n) * 40.0).astype(np.float32)
    ll[7] = -np.inf       # a walker of zero likelihood
    ll[11] = ll[12]       # a tie
    return ll


def test_ess_weights_matches_jax():
    rng = np.random.default_rng(0)
    for n in (10, 1000, 4096):
        w = rng.exponential(size=n).astype(np.float32)
        w[::17] = 0.0
        got = float(ess_weights(torch.from_numpy(w)))
        want = float(jax_ess(jnp.asarray(w)))
        assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("lam", [0.0, 0.25, 0.9, 0.999])
@pytest.mark.parametrize("alpha", [0.5, 0.9])
def test_next_lambda_and_increment_match_jax(lam, alpha):
    n = 4096
    ll = _seeded_ll(n, np.random.default_rng(int(lam * 1000) + 7))
    _, _, pll, plam = convert.tsmc_state_from_numpy(
        np.zeros(n), np.zeros(n), ll, lam)
    got = TS.next_lambda(plam, pll, alpha, n)
    want = _jax_next_lambda(jnp.float32(lam), jnp.asarray(ll), alpha, n)
    assert 0.0 < float(got) <= 1.0 - lam + 1e-7
    rtol = 1e-6 if alpha == 0.5 else 1e-5
    assert abs(float(got) - float(want)) <= rtol * abs(float(want))
    inc, w = TS.evidence_increment(got, pll)
    winc, wess = _jax_increment(jnp.asarray(float(got), jnp.float32),
                                jnp.asarray(ll))
    m = float((got * pll).max())
    ulp = float(np.finfo(np.float32).eps)
    assert abs(float(inc) - float(winc)) <= 4 * ulp * max(1.0, abs(m))
    assert abs(float(ess_weights(w)) - float(wess)) <= 1e-6 * float(wess)
    assert float(w[7]) == 0.0   # -inf keeps no weight
    # the step keeps the ESS at the target unless it jumps to lam = 1
    if float(got) < float(1.0 - plam):
        assert abs(float(ess_weights(w)) - alpha * n) < 1e-2 * alpha * n
