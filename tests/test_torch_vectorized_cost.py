"""The batched-cost tests of ``tests/test_vectorized_cost.py`` on
kissabc_tpu_torch, on the CPU, with the JAX tests' settings, keys and
bands: ``smc(cost_vectorized=True)``, the density models'
``cost_vectorized``/``lpi_vectorized``, a stochastic batched cost that
draws from the run's generator, and ``host_cost`` (the counterpart of
the JAX test's ``pure_callback`` simulator). One band differs, set from
the spread of both packages over 20 keys: ``MEAN_BAND``.
"""

import numpy as np
import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.utils.host_sim import host_cost


def _scalar_cost(x, gen):
    return torch.abs(x * x + 1 - 1.5)


def _batched_cost(xs, gen):
    return torch.abs(xs * xs + 1 - 1.5)


def test_smc_vectorized_matches_scalar():
    pri = kt.Normal(1, 0.2)
    a = kt.smc(pri, _scalar_cost, epstol=0.1, key=5, device="cpu")
    b = kt.smc(pri, _batched_cost, epstol=0.1, cost_vectorized=True, key=5,
               device="cpu")
    # the same generator stream (same key; the cost is deterministic)
    np.testing.assert_allclose(a.P.particles, b.P.particles, rtol=1e-6)
    assert a.iterations == b.iterations


def test_ais_vectorized_kernelized():
    pri = kt.Normal(1, 0.2)
    model = kt.ApproxKernelizedPosterior(
        pri, _batched_cost, 0.001, cost_vectorized=True)
    res = kt.sample(model, kt.AIS(12), 500, discard_initial=1000, key=6,
                    device="cpu")
    assert res.map(lambda m: m * m + 1).approx(1.5)


def test_ais_vectorized_hard_threshold():
    pri = kt.Normal(0, 1)
    model = kt.ApproxPosterior(
        pri, lambda xs, gen: torch.abs(xs - 1.5), 0.01, cost_vectorized=True)
    res = kt.sample(model, kt.AIS(20), 100, discard_initial=2000, key=7,
                    device="cpu")
    assert res.approx(1.5, atol=0.05)


def test_stochastic_batched_cost():
    """A batched cost gets the run's generator and makes its own
    draws."""
    pri = kt.Uniform(-10, 10)

    def bcost(xs, gen):
        noise = torch.randn(xs.shape, generator=gen, device=gen.device)
        return torch.abs(xs + 0.1 * noise)

    res = kt.smc(pri, bcost, epstol=0.2, cost_vectorized=True, key=8,
                 device="cpu")
    assert res.P.approx(0.0, atol=0.3)


# The band of the two means in ``test_common_logdensity_vectorized``: 4
# sd of their spread over keys 0-19, the larger of the two packages'
# (``tools/logdensity_band_spread.py``: sd 0.0662 in the JAX package,
# 0.0647 in the port). The JAX test's 0.15 is 2.3 sd: at key 9 the port's
# x mean is 0.173, and the JAX package's own x mean at key 8 is 0.155.
MEAN_BAND = 0.265


def test_common_logdensity_vectorized():
    """CommonLogDensity with a log-density batched over the walkers, at
    the JAX test's key 9; the means within ``MEAN_BAND``, the std within
    the JAX test's 0.15."""
    D = kt.CommonLogDensity(
        2, lambda g: torch.randn(2, generator=g, device=g.device),
        lambda xs, gen: -0.5 * torch.sum(xs * xs, dim=-1),
        lpi_vectorized=True)
    res = kt.sample(D, kt.AIS(32), 500, ntransitions=5,
                    discard_initial=500, key=9, device="cpu")
    x, y = res
    assert abs(x.mean()) < MEAN_BAND and abs(y.mean()) < MEAN_BAND
    assert abs(x.std() - 1.0) < 0.15


def test_host_cost_numpy_simulator():
    """A numpy-only black-box simulator driven through ``host_cost``
    inside the smc loop."""
    def black_box(thetas, seeds):
        x = np.asarray(thetas)
        rngs = [np.random.default_rng(int(s)) for s in seeds]
        noise = np.array([r.normal() * 0.05 for r in rngs])
        return np.abs(x - 1.5 + noise)

    cost = host_cost(black_box)
    res = kt.smc(kt.Normal(0, 1), cost, epstol=0.1, cost_vectorized=True,
                 key=11, device="cpu")
    assert res.P.approx(1.5, atol=0.15)
