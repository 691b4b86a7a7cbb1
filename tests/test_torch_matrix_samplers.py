"""The samplers of kissabc_tpu_torch on vector and matrix leaves, on the
CPU through the per-walker cost (``torch.func.vmap``), and the fused
kernels' refusal of such leaves:

- ``smc`` on ``LKJ(2, 1.0)`` at the settings and checks of
  tests/test_distributions.py:1259-1280 (128 particles, epstol 0.05,
  max_iters 150, key 5); the posterior's components come row-major,
  ``[R00, R01, R10, R11]``;
- ``smc`` on the covariance example's prior, simulator and cost
  (examples/example_covariance.py:30-74, uncut: 256 particles, 2000
  observations, max_iters 400, key 11) and its three asserts;
- ``smc`` on a ``Product`` prior and on a discrete ``IID`` one;
- ``sample(ApproxKernelizedPosterior(...), AIS(32), ...)`` on ``LKJ``
  and ``Wishart`` priors: the posterior stays on the support, and AIS
  counts ``nparams = d * d``;
- the fused sweeps #3, #6, #9 and #10 refuse a vector leaf (``MvNormal``,
  ``Dirichlet``, ``Wishart``) when they are built, with the codegen
  message, and the streaming costs #4 and #5 when they are called, with
  "per-walker scalar", as the JAX kernels refuse them
  (pallas_kernels.py:1462, :1775, :2100, :2422, :2761, :3051).

A user cost factors a matrix leaf with ``torch.linalg.cholesky_ex``: the
proposals a sweep evaluates may leave the support, where
``torch.linalg.cholesky`` would raise (JAX's gives NaN).

~15 s on one CPU (``pytest --durations``).
"""

import numpy as np
import pytest
import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.core import ais as AI


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _corr_cost(obs):
    def cost(R, gen):
        cl, _ = torch.linalg.cholesky_ex(R)
        z = torch.randn((500, 2), generator=gen, device=gen.device) @ cl.T
        r = torch.mean(z[:, 0] * z[:, 1]) / (
            torch.std(z[:, 0], correction=0) * torch.std(z[:, 1],
                                                         correction=0))
        return torch.abs(r - obs)
    return cost


def test_lkj_prior_smc_end_to_end():
    res = kt.smc(kt.LKJ(2, 1.0), _corr_cost(0.6), nparticles=128,
                 epstol=0.05, max_iters=150, key=5, device="cpu")
    P = res.P   # row-major components [R00, R01, R10, R11]
    assert len(P) == 4
    assert P[0].approx(1.0) and P[0].std() == 0.0
    assert abs(P[1].mean() - 0.6) < 0.08
    assert P[1].particles.max() <= 1.0 + 1e-6
    assert np.array_equal(P[1].particles, P[2].particles)
    assert float(res.eps) <= 0.05


def test_covariance_example_on_the_port():
    true_r, true_s, nobs = 0.6, (1.5, 0.7), 2000
    true_cov = np.diag(true_s) @ np.array(
        [[1.0, true_r], [true_r, 1.0]]) @ np.diag(true_s)
    obs = np.random.default_rng(1).multivariate_normal([0.0, 0.0], true_cov,
                                                       size=nobs)
    obs_s1, obs_s2 = np.std(obs, axis=0)
    obs_r = np.corrcoef(obs.T)[0, 1]
    prior = kt.Factored(kt.LKJ(2, 1.0), kt.LogUniform(0.1, 10.0),
                        kt.LogUniform(0.1, 10.0))
    o1, o2, orr = (float(np.float32(v)) for v in (obs_s1, obs_s2, obs_r))

    def cost(theta, gen):
        R, s1, s2 = theta
        cl, _ = torch.linalg.cholesky_ex(R)
        x = (torch.randn((nobs, 2), generator=gen, device=gen.device)
             @ cl.T) * torch.stack([s1, s2])
        sd = torch.std(x, dim=0, correction=0)
        r = torch.mean(x[:, 0] * x[:, 1]) / (sd[0] * sd[1])
        return (torch.abs(sd[0] - o1) / o1 + torch.abs(sd[1] - o2) / o2
                + torch.abs(r - orr))

    res = kt.smc(prior, cost, nparticles=256, max_iters=400, key=11,
                 device="cpu")
    r_post, s1_post, s2_post = res.P[1], res.P[4], res.P[5]
    assert abs(r_post.mean() - obs_r) < 0.1
    assert abs(s1_post.mean() - obs_s1) < 0.15
    assert abs(s2_post.mean() - obs_s2) < 0.1


def test_product_prior_smc():
    prior = kt.Product([kt.Normal(0.0, 2.0), kt.Normal(0.0, 2.0),
                        kt.Normal(0.0, 2.0)])
    target = torch.tensor([1.0, -1.0, 0.5])

    def cost(x):
        return torch.linalg.norm(x - target)

    with pytest.warns(RuntimeWarning, match="max_iters"):
        res = kt.smc(prior, cost, nparticles=256, max_iters=30, key=12,
                     device="cpu")
    med = [p.median() for p in res.P]
    assert np.allclose(med, [1.0, -1.0, 0.5], atol=0.5), med


def test_discrete_iid_prior_smc():
    prior = kt.IID(kt.Poisson(6.0), 2)
    target = torch.tensor([4.0, 8.0])

    def cost(x):
        return torch.linalg.norm(x.to(torch.float32) - target)

    res = kt.smc(prior, cost, nparticles=256, max_iters=25, key=13,
                 device="cpu")
    for p, t in zip(res.P, (4.0, 8.0)):
        assert np.array_equal(p.particles, np.round(p.particles))
        assert abs(p.median() - t) <= 1.0


def test_ais_on_matrix_priors():
    res = kt.sample(kt.ApproxKernelizedPosterior(kt.LKJ(2, 1.0),
                                                 _corr_cost(0.6), 0.05),
                    kt.AIS(32), 256, ntransitions=4, discard_initial=256,
                    key=14, device="cpu")
    assert len(res) == 4
    assert (res[0].particles == 1.0).all() and (res[3].particles == 1.0).all()
    assert np.array_equal(res[1].particles, res[2].particles)
    assert np.abs(res[1].particles).max() < 1.0
    assert abs(res[1].mean() - 0.6) < 0.15

    def wcost(X, gen):
        return (torch.abs(X[0, 0] - 3.0) + torch.abs(X[1, 1] - 2.0)
                + torch.abs(X[0, 1] - 0.5))

    res = kt.sample(kt.ApproxKernelizedPosterior(
        kt.Wishart(5.0, np.eye(2)), wcost, 0.2), kt.AIS(32), 256,
        ntransitions=4, key=15, device="cpu")
    x = np.stack([p.particles for p in res], -1).reshape(-1, 2, 2)
    assert np.array_equal(x, np.swapaxes(x, -1, -2))
    assert (np.linalg.eigvalsh(x) > 0).all()
    # AIS needs nparams + 5 walkers: d * d + 5 for a d x d leaf
    with pytest.raises(ValueError, match="9"):
        AI.sample(kt.ApproxKernelizedPosterior(kt.LKJ(2, 1.0),
                                               _corr_cost(0.6), 0.05),
                  kt.AIS(8), 16, key=0, device="cpu")


def _draw(th, eps):
    return th[1] + 0.1 * eps


def _reduce(th, m):
    return torch.abs(m[0] - 1.0)


SWEEPS = {   # kernel: build the sweep on a prior
    "#3": lambda p: kt.make_fused_smc_sweep(p, _draw, _reduce),
    "#6": lambda p: kt.make_fused_ais_sweep(p, _draw, _reduce, scale=0.1),
    "#9": lambda p: kt.make_fused_tempered_sweep(
        p, lambda th: -0.5 * torch.square(th[1] - 1.0)),
    "#10": lambda p: kt.make_fused_abcde_generation(p, _draw, _reduce,
                                                    gamma=1.0),
}
VECTOR_MARGINALS = [kt.MvNormal(np.zeros(2), np.eye(2)),
                    kt.Dirichlet([2.0, 2.0, 2.0]), kt.Wishart(5.0, np.eye(2))]


@pytest.mark.parametrize("dist", VECTOR_MARGINALS,
                         ids=[type(d).__name__ for d in VECTOR_MARGINALS])
@pytest.mark.parametrize("kernel", sorted(SWEEPS))
def test_fused_sweeps_refuse_vector_leaves(kernel, dist):
    """At build time, by ``codegen.emit_prior``: the marginal is named
    and the message says the kernels take per-walker scalars only."""
    prior = kt.Factored(dist, kt.Uniform(0.0, 1.0))
    with pytest.raises(NotImplementedError,
                       match="per-walker scalar parameters") as err:
        SWEEPS[kernel](prior)
    assert type(dist).__name__ in str(err.value)


def test_streaming_costs_refuse_vector_leaves():
    """#4 and #5 take any theta at build time and refuse a leaf that is
    not ``[n]`` when called."""
    gen = torch.Generator().manual_seed(0)
    thetas = (torch.ones(8, 2), torch.ones(8))
    cost4 = kt.make_streaming_moment_cost(_draw, _reduce, ndraws=10)
    with pytest.raises(ValueError, match="per-walker scalar"):
        cost4(thetas, gen)
    cost5 = kt.make_streaming_scan_cost(
        lambda th, x, eps, t: 0.5 * x + th[1] + eps, lambda th: th[1],
        lambda th, m: m[0], nsteps=8)
    with pytest.raises(ValueError, match="per-walker scalar"):
        cost5(thetas, gen)
