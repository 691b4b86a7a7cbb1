"""kissabc_tpu_torch's AIS sampler (``core/ais.py``) and density models
(``core/density.py``) on the CPU: the accept rules against the JAX
package's on the same draws, the init's bounded retry, the known-answer
problems of ``tests/test_ais.py`` with their tolerances and costs
written in PyTorch, and the README model through ``sample`` on the
per-walker cost and on the plain versions of the batched kernels.

The random streams differ between the packages (threefry against
PyTorch's generator), so the samplers are held to the same statistical
tolerances as the JAX tests; the accept rules, pure functions of their
inputs, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kissabc_tpu as ka
from kissabc_tpu.utils.diagnostics import ess
import kissabc_tpu_torch as kt
from kissabc_tpu_torch import convert, models
from kissabc_tpu_torch.core import ais as PA
from torch_threads import one_torch_thread  # noqa: F401

CPU = dict(device="cpu")


def _randn(gen, shape=()):
    return torch.randn(shape, generator=gen, device=gen.device)


# ---------------------------------------------------------------------------
# the accept rules, bit for bit
# ---------------------------------------------------------------------------

def _lds(rng, n, kind):
    if kind == "scalar":
        x = rng.normal(size=n).astype(np.float32) * 5
        x[::7] = -np.inf
        return x
    lp = rng.normal(size=n).astype(np.float32)
    lp[::5] = -np.inf
    second = (rng.uniform(0, 0.1, n) if kind == "cost"
              else -rng.exponential(3, n)).astype(np.float32)
    return lp, second


@pytest.mark.parametrize("kind", ["kernelized", "hard", "common"])
def test_accept_lu_matches_jax(kind):
    rng = np.random.default_rng(0)
    n = 4096
    pri_j, pri_p = ka.Normal(0, 1), kt.Normal(0, 1)
    if kind == "kernelized":
        jm = ka.ApproxKernelizedPosterior(pri_j, lambda x: x, 0.1)
        pm = kt.ApproxKernelizedPosterior(pri_p, lambda x: x, 0.1)
        shape = "pair"
    elif kind == "hard":
        jm = ka.ApproxPosterior(pri_j, lambda x: x, 0.05)
        pm = kt.ApproxPosterior(pri_p, lambda x: x, 0.05)
        shape = "cost"
    else:
        jm = ka.CommonLogDensity(1, lambda k: 0.0, lambda x: x)
        pm = kt.CommonLogDensity(1, lambda g: 0.0, lambda x: x)
        shape = "scalar"
    old, new = _lds(rng, n, shape), _lds(rng, n, shape)
    lu = -rng.exponential(size=n).astype(np.float32)
    corr = rng.normal(size=n).astype(np.float32)

    def jx(t):
        return tuple(map(jnp.asarray, t)) if isinstance(t, tuple) \
            else jnp.asarray(t)

    def tx(t):
        return tuple(map(torch.as_tensor, t)) if isinstance(t, tuple) \
            else torch.as_tensor(t)

    want = np.asarray(jax.vmap(jm.accept_lu)(jnp.asarray(lu), jx(old),
                                             jx(new), jnp.asarray(corr)))
    got = pm.accept_lu(torch.as_tensor(lu), tx(old), tx(new),
                       torch.as_tensor(corr)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < n


def test_loglike_batch_matches_jax_on_a_deterministic_cost():
    """Both ABC densities' ``ld`` from the same pushed population and a
    deterministic cost: the same (lp, ll) and (lp, cost) within 1 ulp."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1.5, 512).astype(np.float32)
    for jcls, pcls, arg in ((ka.ApproxKernelizedPosterior,
                             kt.ApproxKernelizedPosterior, 0.3),
                            (ka.ApproxPosterior, kt.ApproxPosterior, 0.1)):
        jm = jcls(ka.Truncated(ka.Normal(0, 1), -2, 2),
                  lambda t: jnp.abs(t - 0.5), arg)
        pm = pcls(kt.Truncated(kt.Normal(0, 1), -2, 2),
                  lambda t: torch.abs(t - 0.5), arg)
        want = jm.loglike_batch(jnp.asarray(x), jax.random.key(0))
        got = pm.loglike_batch(torch.as_tensor(x), torch.Generator())
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-7,
                                       atol=0)


# ---------------------------------------------------------------------------
# the init and its retry
# ---------------------------------------------------------------------------

def _disc_model():
    """Valid on the unit disc, sampled on [-1, 1] x [0, 1]: a quarter of
    the box lies outside the disc (tests/test_ais.py:102-112)."""
    return kt.CommonLogDensity(
        2, lambda g: torch.rand(2, generator=g) * torch.tensor([2.0, 1.0])
        - torch.tensor([1.0, 0.0]),
        lambda x: torch.where(torch.sum(x * x) <= 1, 0.0, float("-inf")))


def test_init_ensemble_retries_invalid_walkers():
    model = _disc_model()
    g = torch.Generator().manual_seed(0)
    th, ld, valid = PA._init_ensemble(model, g, 400, 0)
    assert not bool(valid.all())   # no retry: some start outside
    g.manual_seed(0)
    th, ld, valid = PA._init_ensemble(model, g, 400, 100)
    assert bool(valid.all()) and bool(torch.isfinite(ld).all())
    assert bool(((th * th).sum(1) <= 1).all())


def test_always_invalid_density_raises():
    d2 = kt.CommonLogDensity(2, lambda g: torch.rand(2, generator=g),
                             lambda x: torch.tensor(float("-inf")))
    with pytest.raises(RuntimeError, match="retry_sampling"):
        kt.sample(d2, kt.AIS(50), 10, retry_sampling=5, key=9, **CPU)


# ---------------------------------------------------------------------------
# the known-answer problems of tests/test_ais.py
# ---------------------------------------------------------------------------

def _dirac_cost(x):
    return torch.abs((x * x + 1) - 1.5)


def test_dirac_delta_kernelized():
    abc = kt.ApproxKernelizedPosterior(kt.Normal(1, 0.2), _dirac_cost, 0.001)
    res = kt.sample(abc, kt.AIS(12), 500, discard_initial=1000, key=3, **CPU)
    assert res.map(lambda m: m * m + 1).approx(1.5)
    assert abs(res.mean() - np.sqrt(0.5)) < 0.01


def test_dirac_delta_multichain():
    abc = kt.ApproxKernelizedPosterior(kt.Normal(1, 0.2), _dirac_cost, 0.001)
    res = kt.sample(abc, kt.AIS(12), 100, chains=8, discard_initial=600,
                    key=11, **CPU)
    assert len(res) == 8 * 100
    assert res.map(lambda m: m * m + 1).approx(1.5)


def test_hard_threshold_issue10():
    plan = kt.ApproxPosterior(kt.Normal(0, 1), lambda x: torch.abs(x - 1.5),
                              0.01)
    res = kt.sample(plan, kt.AIS(20), 100, discard_initial=2000, key=5, **CPU)
    assert res.approx(1.5, atol=0.05)


def test_mixed_discrete_continuous():
    pri = kt.Factored(kt.Normal(1, 0.5), kt.DiscreteUniform(1, 10))

    def cost(theta, gen):
        n, du = theta
        sim = (n * n + du) * (n + _randn(gen) * 0.01)
        return torch.abs(sim - 5.5)

    model = kt.ApproxPosterior(pri, cost, 0.01)
    n_post, du_post = kt.sample(model, kt.AIS(100), 1000,
                                discard_initial=10_000, key=6, **CPU)
    assert np.allclose(du_post.particles, np.round(du_post.particles))
    sim_vals = (n_post.particles ** 2 + du_post.particles) * n_post.particles
    assert abs(np.mean(sim_vals) - 5.5) < 0.2


def test_rosenbrock_banana():
    model = kt.CommonLogDensity(
        2, lambda g: _randn(g, (2,)),
        lambda x: -100 * (x[0] - x[1] ** 2) ** 2 - (x[1] - 1) ** 2)
    assert model.nparams == 2
    x, y = kt.sample(model, kt.AIS(50), 1000, ntransitions=100,
                     discard_initial=2000, key=7, **CPU)
    lpi = -100 * (x.particles - y.particles ** 2) ** 2 \
        - (y.particles - 1) ** 2
    assert np.quantile(lpi, 0.97) > -0.69


def test_infinite_cost_disc():
    x, y = kt.sample(_disc_model(), kt.AIS(50), 500, ntransitions=10,
                     discard_initial=1000, key=8, **CPU)
    assert np.all(x.particles ** 2 + y.particles ** 2 <= 1 + 1e-6)


def test_nparticles_validation():
    model = kt.CommonLogDensity(2, lambda g: _randn(g, (2,)),
                                lambda x: torch.tensor(0.0))
    with pytest.raises(ValueError, match="at least to 7"):
        kt.sample(model, kt.AIS(6), 10, **CPU)


def test_sequential_schedule():
    plan = kt.ApproxPosterior(kt.Normal(0, 1), lambda x: torch.abs(x - 1.5),
                              0.01)
    res = kt.sample(plan, kt.AIS(20), 300, ntransitions=3,
                    discard_initial=2000, schedule="sequential", key=21,
                    **CPU)
    assert res.approx(1.5, atol=0.05)
    assert res.std() < 0.05
    with pytest.raises(ValueError, match="schedule"):
        kt.sample(plan, kt.AIS(12), 10, schedule="zigzag", **CPU)
    with pytest.raises(ValueError, match="partner_scheme"):
        kt.sample(plan, kt.AIS(12), 10, schedule="sequential",
                  partner_scheme="roll", **CPU)


def test_thinning_reduces_autocorrelation():
    pri = kt.Normal(0.0, 1.0)
    mdl = kt.CommonLogDensity(1, lambda g: pri.sample(g),
                              lambda x: -0.5 * x * x)
    n, ns = 16, 640

    def walker_chains(thinning):
        flat, _ = kt.sample_raw(mdl, kt.AIS(n), ns, ntransitions=1,
                                thinning=thinning, key=3, **CPU)
        return flat.double().numpy().reshape(-1, n).T

    e8, e1 = ess(walker_chains(8)), ess(walker_chains(1))
    assert e8 > 1.5 * e1, (e8, e1)
    a = kt.sample(mdl, kt.AIS(n), ns, ntransitions=1, thinning=8, key=3,
                  **CPU)
    assert a.approx(0.0, atol=0.2) and abs(a.std() - 1.0) < 0.25
    c = kt.sample(mdl, kt.AIS(8), 12, schedule="sequential", thinning=3,
                  discard_initial=4, key=4, **CPU)
    assert len(c) == 12
    with pytest.raises(ValueError, match="thinning"):
        kt.sample(mdl, kt.AIS(8), 10, thinning=0, **CPU)


def test_positional_mcmcthreads_marker():
    model = kt.CommonLogDensity(1, lambda g: _randn(g, (1,)),
                                lambda x, gen: -0.5 * (x[0] ** 2))
    r = kt.sample(model, kt.AIS(16), kt.MCMCThreads(), 64, 2, key=1, **CPU)
    rk = kt.sample(model, kt.AIS(16), 64, chains=2, key=1, **CPU)
    np.testing.assert_array_equal(r.particles, rk.particles)
    assert len(r) == 128
    r2 = kt.sample(model, kt.AIS(16), kt.MCMCDistributed, 64, 2, key=1,
                   **CPU)
    np.testing.assert_array_equal(r2.particles, rk.particles)
    with pytest.raises(TypeError, match="not both"):
        kt.sample(model, kt.AIS(16), kt.MCMCThreads(), 64, 2, chains=3,
                  **CPU)
    with pytest.raises(TypeError, match="unexpected positional"):
        kt.sample(model, kt.AIS(16), 64, 2, **CPU)


def test_device_mesh_and_key_contract():
    model = kt.CommonLogDensity(1, lambda g: _randn(g, (1,)),
                                lambda x: -0.5 * (x[0] ** 2))
    with pytest.raises(TypeError, match="Mesh"):
        kt.sample(model, kt.AIS(16), 16, mesh=object(), **CPU)
    if not torch.cuda.is_available():   # CUDA by default, no fallback
        with pytest.raises(RuntimeError, match="CUDA"):
            kt.sample(model, kt.AIS(16), 16)
    a = kt.sample(model, kt.AIS(16), 64, key=5, **CPU)
    b = kt.sample(model, kt.AIS(16), 64, key=torch.Generator().manual_seed(5),
                  **CPU)
    np.testing.assert_array_equal(a.particles, b.particles)


# ---------------------------------------------------------------------------
# the README model through sample
# ---------------------------------------------------------------------------

PRIOR = kt.Factored(kt.Uniform(1, 3), kt.TruncatedNormal(0, 0.05, 0, 100))


def _readme_cost(theta, gen):   # __graft_entry__.py:17-22, per walker
    mu, sigma = theta
    x = mu + sigma * _randn(gen, (1000,))
    return torch.hypot(x.mean() - 2.0, (x.std(correction=0) - 0.04) * 50)


def _check_readme(post, tol_mu, tol_sg):
    mu, sg = post
    assert abs(mu.mean() - 2.0) < tol_mu, mu.mean()
    assert abs(sg.mean() - 0.04) < tol_sg, sg.mean()


def test_readme_model_per_walker_cost():
    """The README's AIS call with the per-walker cost, cut to 200 samples
    of 50 sweeps each (the README's 1000 x 100 is the chip's run)."""
    post = kt.sample(kt.ApproxKernelizedPosterior(PRIOR, _readme_cost, 0.005),
                     kt.AIS(10), 200, ntransitions=50, key=3, **CPU)
    _check_readme(post, 0.02, 0.01)


@pytest.mark.parametrize("which", ["flagship-kernel", "streaming"])
def test_readme_model_batched_plain_costs(which):
    """The split sweep with the plain versions of kernel #1
    (``make_flagship_cost_batched``) and kernel #4
    (``make_streaming_moment_cost``) on the CPU: 64 walkers, 100 draws,
    scale 0.02, 60 sweeps."""
    if which == "flagship-kernel":
        cost = kt.make_flagship_cost_batched(ndraws=100)
    else:
        _, draw, reduce_cost = models.flagship()
        cost = kt.make_streaming_moment_cost(draw, reduce_cost, ndraws=100,
                                             block=128, chunk=128)
    model = kt.ApproxKernelizedPosterior(PRIOR, cost, 0.02,
                                         cost_vectorized=True)
    post = kt.sample(model, kt.AIS(64), 64, ntransitions=60, key=0, **CPU)
    _check_readme(post, 0.03, 0.01)


def test_ais_state_from_numpy():
    rng = np.random.default_rng(0)
    th = (rng.normal(size=8).astype(np.float32),
          rng.normal(size=8).astype(np.float32))
    lds = (np.zeros(8, np.float32), np.ones(8, np.float32))
    t, ld = convert.ais_state_from_numpy(th, lds)
    assert t[0].dtype == torch.float32 and ld[1].shape == (8,)
    (ta, tb), (la, lb) = convert.ais_state_from_numpy(th, lds, halves=True)
    assert ta[0].shape == (4,) and torch.equal(tb[1], torch.as_tensor(th[1][4:]))
    assert torch.equal(lb[1], torch.ones(4))
    s, sl = convert.ais_state_from_numpy(th[0], lds[0], halves=True)
    assert s[0].shape == (4,) and sl[1].shape == (4,)
