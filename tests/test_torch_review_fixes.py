"""The review-finding regressions of ``tests/test_review_fixes.py`` on
kissabc_tpu_torch, on the CPU, with the JAX tests' settings, keys and
bands. The fifteenth, ``test_chains_with_2d_mesh``, is held in
``tests/test_torch_parallel_samplers.py`` (AIS with ``chains=2`` on a
``(chain=2, walker=4)`` mesh of CPU shards).
"""

import numpy as np
import pytest
import scipy.stats as st
import torch

import kissabc_tpu_torch as kt


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_ais_with_vectorized_cost_init():
    """The initial ensemble of a ``cost_vectorized`` model."""
    pri = kt.Normal(1, 0.2)
    model = kt.ApproxKernelizedPosterior(
        pri, lambda xs, gen: torch.abs(xs * xs + 1 - 1.5), 0.001,
        cost_vectorized=True)
    res = kt.sample(model, kt.AIS(16), 100, discard_initial=200, key=1,
                    device="cpu")
    assert res.map(lambda m: m * m + 1).approx(1.5)


def test_truncated_gamma_beta_lognormal():
    """Truncated Gamma, Beta and LogNormal sample inside their window
    with the truncated mean, and run through a sampler."""
    for base, lo, hi, ref in [
        (kt.Gamma(2.0, 1.0), 0.0, 5.0, st.gamma(2)),
        (kt.Beta(2.0, 3.0), 0.2, 0.8, st.beta(2, 3)),
        (kt.LogNormal(0.0, 0.5), 0.5, 3.0, st.lognorm(0.5)),
    ]:
        t = kt.Truncated(base, lo, hi)
        x = t.sample(_gen(0), (8000,)).numpy()
        assert x.min() >= lo - 1e-5 and x.max() <= hi + 1e-5
        want = ref.expect(lambda v: v, lb=lo, ub=hi, conditional=True)
        assert abs(x.mean() - want) < 0.03, (base, x.mean(), want)

    prior = kt.Truncated(kt.Gamma(2.0, 1.0), 0.0, 5.0)
    res = kt.smc(prior, lambda x: torch.abs(x - 1.5), epstol=0.2, key=2,
                 device="cpu")
    assert res.P.approx(1.5, atol=0.3)


def test_density_accept_wrapper():
    """The one-walker ``accept``: equal ld, cost within the threshold."""
    m = kt.ApproxPosterior(kt.Normal(0, 1), lambda x: torch.abs(x), 0.1)
    old = (torch.tensor(-0.5), torch.tensor(0.05))
    new = (torch.tensor(-0.5), torch.tensor(0.05))
    out = m.accept(_gen(0), old, new, torch.tensor(0.0))
    assert bool(out)


def test_smc_stepped_validates_knobs():
    pri = kt.Normal(0, 1)

    def cost(x):
        return torch.abs(x)

    with pytest.raises(ValueError):
        kt.smc_stepped(pri, cost, mcmc_retrys=-1, device="cpu")
    with pytest.raises(ValueError):
        kt.smc_stepped(pri, cost, alpha=1.2, device="cpu")


def test_string_knob_validation():
    """A mistyped string knob raises instead of taking another branch."""
    pri = kt.Normal(0, 1)

    def cost(x):
        return torch.abs(x)

    with pytest.raises(ValueError):
        kt.smc(pri, cost, resample="replicated", device="cpu")
    with pytest.raises(ValueError):
        kt.smc(pri, cost, partner_scheme="rolls", device="cpu")


def test_partner_scheme_forwarded_single_chain():
    """``partner_scheme`` reaches the single-chain path: 'gather' and
    'roll' at one key give other streams, both right."""
    pri = kt.Normal(1, 0.2)
    abc = kt.ApproxKernelizedPosterior(
        pri, lambda x: torch.abs(x * x + 1 - 1.5), 0.005)
    a = kt.sample(abc, kt.AIS(64), 128, partner_scheme="roll", key=5,
                  device="cpu")
    b = kt.sample(abc, kt.AIS(64), 128, partner_scheme="gather", key=5,
                  device="cpu")
    assert not np.allclose(a.particles, b.particles)
    assert a.map(lambda m: m * m + 1).approx(1.5, atol=0.05)
    assert b.map(lambda m: m * m + 1).approx(1.5, atol=0.05)


def test_sequential_schedule_with_chains_raises():
    pri = kt.Normal(1, 0.2)
    abc = kt.ApproxKernelizedPosterior(
        pri, lambda x: torch.abs(x * x + 1 - 1.5), 0.005)
    with pytest.raises(ValueError, match="sequential"):
        kt.sample(abc, kt.AIS(16), 20, chains=2, schedule="sequential",
                  device="cpu")


def test_sequential_schedule_rejects_ignored_knobs():
    pri = kt.Normal(0.0, 1.0)
    mdl = kt.ApproxKernelizedPosterior(
        pri, lambda x, gen: torch.abs(x), 0.5)
    with pytest.raises(ValueError, match="partner_scheme"):
        kt.sample(mdl, kt.AIS(8), 4, schedule="sequential",
                  partner_scheme="gather", device="cpu")
    with pytest.raises(ValueError, match="progress"):
        kt.sample(mdl, kt.AIS(8), 4, schedule="sequential",
                  progress=True, device="cpu")


def test_particles_sampling_ctor_rejects_multivariate():
    with pytest.raises(ValueError, match="univariate"):
        kt.Particles(64, kt.MvNormal(np.zeros(2), np.eye(2)), key=0)


def test_particles_sampling_ctor_numpy_key():
    a = kt.Particles(256, kt.Normal(0.0, 1.0), key=np.int64(3))
    b = kt.Particles(256, kt.Normal(0.0, 1.0), key=3)
    assert np.allclose(a.particles, b.particles)


def test_discrete_nonparametric_merges_duplicate_atoms():
    d = kt.DiscreteNonParametric([1.0, 1.0, 2.0], [0.25, 0.25, 0.5])
    assert d.xs.shape == (2,)
    assert np.isclose(float(d.logpdf(torch.tensor(1.0))), np.log(0.5),
                      rtol=1e-6)
    assert np.isclose(float(d.cdf(torch.tensor(1.0))), 0.5, rtol=1e-6)


def test_mixture_rejects_multivariate_components():
    with pytest.raises(ValueError, match="univariate"):
        kt.Mixture([kt.MvNormal(np.zeros(2), np.eye(2)),
                    kt.MvNormal(np.ones(2), np.eye(2))])


def test_mixture_quantile_bounds_memoized():
    """The quantile's bracket is computed once, as host floats."""
    m = kt.Mixture([kt.Normal(0.0, 1.0), kt.Normal(5.0, 2.0)], [0.3, 0.7])
    q = float(m.quantile(torch.tensor(0.5)))
    assert abs(float(m.cdf(torch.tensor(q))) - 0.5) < 1e-4
    assert hasattr(m, "_qbounds")
    lo, hi = m._qbounds
    assert isinstance(lo, float) and isinstance(hi, float)


def test_truncated_discrete_integrality_and_negative_atoms():
    td = kt.Truncated(kt.Poisson(3.0), 1, 5)
    assert float(td.logpdf(torch.tensor(2.5))) == -np.inf
    assert np.isfinite(float(td.logpdf(torch.tensor(2.0))))
    sk = kt.Truncated(kt.Skellam(2.0, 3.0), -5, 5)
    ref = st.skellam(2, 3)
    mass = ref.cdf(5) - ref.cdf(-6)
    assert np.isclose(float(torch.exp(sk.logpdf(torch.tensor(-3.0)))),
                      ref.pmf(-3) / mass, rtol=1e-5)
    assert float(sk.logpdf(torch.tensor(-2.7))) == -np.inf
