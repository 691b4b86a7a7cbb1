"""kissabc_tpu_torch's smc with a per-walker cost, the JAX default form
``cost(theta, gen)`` / ``cost(theta)``, mirroring tests/test_smc.py on
the CPU: the README model, the Dirac delta, the mixed prior with
``DiscreteUniform``, the banana with infinite costs, the ``MvNormal``
vector prior, the analytic evidence and the determinism given a key,
each against the same oracle and tolerance as the JAX test; the
adapter's parameter count against the JAX package's; and the errors of
costs the walker map cannot take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kissabc_tpu as ka
from kissabc_tpu.core.density import _adapt_cost as jax_adapt_cost
import kissabc_tpu_torch as kt
from kissabc_tpu_torch import models
from kissabc_tpu_torch.core.density import _adapt_cost
from kissabc_tpu_torch.core.smc import per_walker_cost


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def _readme_cost(theta, gen):
    mu, sigma = theta
    x = mu + sigma * _randn(gen, 1000)
    return torch.hypot(x.mean() - 2.0,
                       (x.std(correction=0) - 0.04) * 50)


def test_readme_normal_model():
    """tests/test_smc.py:11-27: posterior mu=2.0+-0.0062,
    sigma=0.0401+-0.00081, eps < 0.02 at 200 particles."""
    pri = kt.Factored(kt.Uniform(1, 3), kt.TruncatedNormal(0, 0.05, 0, 100))
    res = kt.smc(pri, _readme_cost, nparticles=200, key=1, device="cpu")
    mu_p, sig_p = res.P
    assert res.eps < 0.02
    assert abs(mu_p.mean() - 2.0) < 0.02
    assert abs(sig_p.mean() - 0.0401) < 0.004


def _dirac(x):
    return torch.abs(x * x + 1 - 1.5)


def test_dirac_delta_smc():
    """tests/test_smc.py:30-35 (runtests.jl:85): P ~= 0.707; the JAX
    package on the same problem lands within the same tolerance."""
    res = kt.smc(kt.Normal(1, 0.2), _dirac, epstol=0.1, key=2, device="cpu")
    assert res.P.approx(0.707, atol=0.05)
    jres = ka.smc(ka.Normal(1, 0.2), lambda x: jnp.abs(x * x + 1 - 1.5),
                  epstol=0.1, key=2)
    assert abs(res.P.mean() - jres.P.mean()) < 0.05
    assert res.eps <= 0.1 and jres.eps <= 0.1


def test_mixed_prior_smc():
    """tests/test_smc.py:38-50 (runtests.jl:113): the DiscreteUniform
    marginal's posterior ~= 5 and its particles are integers."""
    pri = kt.Factored(kt.Normal(1, 0.5), kt.DiscreteUniform(1, 10))

    def cost(theta, gen):
        n, du = theta
        sim = (n * n + du) * (n + _randn(gen) * 0.01)
        return torch.abs(sim - 5.5)

    res = kt.smc(pri, cost, key=3, device="cpu")
    du_post = res.P[1]
    assert du_post.approx(5, atol=1.0)
    assert np.allclose(du_post.particles, np.round(du_post.particles))


def test_discrete_push_rounds_half_to_even_as_jax():
    x = np.array([0.5, 1.5, 2.5, -0.5, 3.49, 3.51, 10.5], np.float32)
    got = kt.DiscreteUniform(1, 10).push(torch.from_numpy(x))
    want = ka.DiscreteUniform(1, 10).push(jnp.asarray(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lp = kt.DiscreteUniform(1, 10).logpdf(got)
    jlp = ka.DiscreteUniform(1, 10).logpdf(want)
    np.testing.assert_array_equal(lp.numpy(), np.asarray(jlp))


def _banana(theta, gen):
    x, y = theta
    return (50 * (x + _randn(gen) * 0.01 - y ** 2) ** 2
            + (y - 1 + _randn(gen) * 0.01) ** 2)


def test_banana_smc_and_inf_costs():
    """tests/test_smc.py:53-76 (runtests.jl:240-254): the banana cost,
    and the variant whose cost is inf half the time."""
    pp = kt.Factored(kt.Normal(0, 5), kt.Normal(0, 5))
    r = kt.smc(pp, _banana, alpha=0.9, nparticles=500, epstol=0.01, key=4,
               device="cpu").P
    assert r[0].approx(1, atol=0.1)
    assert r[1].approx(1, atol=0.05)

    def banana_inf(theta, gen):
        base = _banana(theta, gen)
        flip = torch.rand((), generator=gen, device=gen.device) < 0.5
        return torch.where(flip, torch.full_like(base, float("inf")), base)

    r2 = kt.smc(pp, banana_inf, alpha=0.9, nparticles=1000, epstol=0.01,
                key=5, device="cpu").P
    assert r2[0].approx(1, atol=0.1)
    assert r2[1].approx(1, atol=0.05)


def test_smc_vector_prior():
    """tests/test_smc.py:130-140: an MvNormal prior, one [n, 2] leaf;
    the partner moves and the resampling carry the trailing axis."""
    pri = kt.MvNormal(2, 1.0)
    res = kt.smc(pri, lambda x: torch.abs(torch.sqrt(torch.sum(x * x)) - 1.0),
                 nparticles=500, epstol=0.05, key=8, device="cpu")
    x, y = res.P
    radii = np.sqrt(x.particles ** 2 + y.particles ** 2)
    assert np.abs(radii - 1.0).mean() < 0.05


def test_mvnormal_logpdf_matches_jax():
    cov = np.array([[1.0, 0.3], [0.3, 0.5]])
    x = np.random.default_rng(2).normal(size=(64, 2)).astype(np.float32)
    for args in ((2, 1.0), ([0.5, -1.0], 2.0), ([0.5, -1.0], cov)):
        got = kt.MvNormal(*args).logpdf(torch.from_numpy(x)).numpy()
        want = np.asarray(ka.MvNormal(*args).logpdf(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert kt.MvNormal(3, 1.0).nparams == 3
    s = kt.MvNormal([0.5, -1.0], cov).sample(torch.Generator().manual_seed(0),
                                             (20000,))
    assert s.shape == (20000, 2)
    np.testing.assert_allclose(np.cov(s.numpy().T), cov, atol=0.03)


def test_convert_builds_the_new_families():
    from kissabc_tpu_torch import convert

    p = convert.prior_from_numpy(("Factored", [
        ("DiscreteUniform", {"a": 1, "b": 10}),
        ("MvNormal", {"mean_or_dim": [0.5, -1.0], "sigma_or_cov": 2.0})]))
    du, mvn = p.p
    assert du.discrete and float(du.b) == 10.0
    assert mvn.nparams == 2 and mvn.event_dim == 1
    st = convert.state_from_numpy(
        (np.arange(4.0), np.zeros((4, 2))), np.arange(4), np.zeros(4),
        np.ones(4, bool), 0.5, 0.0, 1)
    assert st.thetas[1].shape == (4, 2)


def test_smc_log_evidence_matches_analytic():
    """tests/test_smc.py:143-160: exp(log_evidence) = P(cost < eps):
    eps for |x| under Uniform(-1, 1), eps^2 for max(|x|, |y|)."""
    res = kt.smc(kt.Uniform(-1.0, 1.0), lambda x, gen: torch.abs(x),
                 nparticles=4096, epstol=0.05, key=5, device="cpu")
    assert np.isclose(np.exp(res.log_evidence), res.eps, rtol=0.12)

    prior2 = kt.Factored(kt.Uniform(-1, 1), kt.Uniform(-1, 1))
    res2 = kt.smc(prior2,
                  lambda th, gen: torch.maximum(torch.abs(th[0]),
                                                torch.abs(th[1])),
                  nparticles=4096, epstol=0.1, key=6, device="cpu")
    assert np.isclose(np.exp(res2.log_evidence), res2.eps ** 2, rtol=0.15)


def test_smc_deterministic_given_key():
    """tests/test_smc.py:118-124, with a stochastic cost too: the draws
    come from the run's generator, so the key fixes them."""
    pri = kt.Normal(1, 0.2)
    a = kt.smc(pri, _dirac, epstol=0.1, key=7, device="cpu")
    b = kt.smc(pri, _dirac, epstol=0.1, key=7, device="cpu")
    np.testing.assert_array_equal(a.P.particles, b.P.particles)
    assert a.eps == b.eps

    def noisy(x, gen):
        return _dirac(x) + 0.01 * _randn(gen).abs()

    c = kt.smc(pri, noisy, epstol=0.1, key=7, device="cpu")
    d = kt.smc(pri, noisy, epstol=0.1, key=7, device="cpu")
    e = kt.smc(pri, noisy, epstol=0.1, key=8, device="cpu")
    np.testing.assert_array_equal(c.C, d.C)
    assert not np.array_equal(c.C, e.C)


def test_each_walker_gets_its_own_draws():
    cost = per_walker_cost(lambda th, gen: th + _randn(gen))
    gen = torch.Generator().manual_seed(0)
    out = cost(torch.zeros(64), gen)
    assert out.shape == (64,) and len(set(out.tolist())) == 64
    gen.manual_seed(0)
    assert torch.equal(out, cost(torch.zeros(64), gen))


# ---------------------------------------------------------------------------
# the adapter and the costs the walker map cannot take
# ---------------------------------------------------------------------------

def _two(theta, gen):
    return theta


def _one(theta):
    return theta


def _default(theta, gen=None):
    return theta


def _star(*args):
    return args[0]


class _Callable:
    def __call__(self, theta, key):
        return theta


@pytest.mark.parametrize("cost", [_two, _one, _default, _star, _Callable(),
                                  lambda th, k: th, lambda th: th, abs])
def test_adapt_cost_counts_parameters_as_jax(cost):
    adapted = _adapt_cost(cost)
    assert (adapted is cost) == (jax_adapt_cost(cost) is cost)
    if adapted is not cost:   # (theta, gen) -> cost(theta)
        assert adapted(torch.tensor(-2.0), None) == cost(torch.tensor(-2.0))


def test_one_argument_cost_that_draws_raises():
    """A one-argument cost is deterministic in JAX (it has no key); a
    draw inside it raises rather than sharing one draw across walkers."""
    def cost(x):
        return torch.abs(x + torch.randn(()))

    with pytest.raises(RuntimeError, match="randomness"):
        kt.smc(kt.Normal(1, 0.2), cost, nparticles=64, device="cpu")


def test_cost_the_map_cannot_take_raises_with_a_hint():
    def cost(x, gen):
        return torch.tensor(abs(x.item() - 1.0))

    with pytest.raises(RuntimeError, match="item") as err:
        kt.smc(kt.Normal(1, 0.2), cost, nparticles=64, device="cpu")
    assert "cost_vectorized=True" in str(err.value)

    def branchy(x, gen):
        return x if x > 1.0 else -x

    with pytest.raises(RuntimeError, match="cost_vectorized=True"):
        kt.smc(kt.Normal(1, 0.2), branchy, nparticles=64, device="cpu")


def test_per_walker_cost_with_a_fused_sweep_runs():
    """The per-walker cost drives the init; the fused sweep the moves."""
    prior, draw, reduce_cost = models.flagship()
    sweep = kt.make_fused_smc_sweep(prior, draw, reduce_cost, ndraws=200)

    def cost(theta, gen):
        mu, sg = theta
        x = mu + sg * _randn(gen, 200)
        return reduce_cost(theta, (x.mean(), (x * x).mean()))

    res = kt.smc(prior, cost, sweep_fused=sweep, nparticles=128,
                 epstol=0.3, key=3, device="cpu")
    assert res.eps <= 0.3 and res.C.shape == (128,)


def test_jax_key_is_not_a_generator():
    with pytest.raises(TypeError, match="torch.Generator"):
        kt.smc(kt.Normal(1, 0.2), _dirac, key=jax.random.key(0),
               device="cpu")
