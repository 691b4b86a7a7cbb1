"""``tests/test_sampler_prior_battery.py`` mirrored on kissabc_tpu_torch:
every family of the battery as a prior inside the port's ``smc``
(sampled at init, float-evolved by the proposals, pushed back onto its
support, its logpdf consulted by the prior gate) and the AIS ``sample``,
with the same costs, sizes, keys and checks. Also: the generic kernels'
prior table has entries for the scalar families (continuous, and the
integer discrete ones where a sweep pushes), so each fused sweep builds
on them and its traced entry evaluates to the family's logpdf; the
families still without an entry (tables, atom pushes, vector leaves)
make each fused sweep refuse them with ``NotImplementedError`` naming the
family.
"""

import numpy as np
import pytest
import torch

import kissabc_tpu_torch as kt
from torch_threads import one_torch_thread  # noqa: F401


def _scalar_cost(target):
    def cost(x, gen):
        return torch.abs(x.to(torch.float32) - target)
    return cost


# (prior, cost, check(posterior particles)): the battery's CASES
CASES = [
    (kt.LogUniform(0.1, 10.0), _scalar_cost(2.0),
     lambda P: abs(P.median() - 2.0) < 0.5),
    (kt.BetaPrime(3.0, 5.0), _scalar_cost(0.5),
     lambda P: abs(P.median() - 0.5) < 0.3),
    (kt.Poisson(6.0), _scalar_cost(4.0),
     lambda P: np.all(P.particles == np.round(P.particles))
     and abs(P.median() - 4.0) <= 1.0),
    (kt.Truncated(kt.Poisson(6.0), 2, 12), _scalar_cost(4.0),
     lambda P: P.particles.min() >= 2 and P.particles.max() <= 12),
    (kt.DiscreteNonParametric([0.5, 1.5, 4.0], [0.3, 0.4, 0.3]),
     _scalar_cost(1.5),
     lambda P: set(np.unique(P.particles)) <= {0.5, 1.5, 4.0}
     and abs(P.median() - 1.5) < 1e-6),
    (kt.Truncated(kt.StudentT(4.0), -1.0, 3.0), _scalar_cost(1.0),
     lambda P: P.particles.min() >= -1.0 - 1e-5
     and P.particles.max() <= 3.0 + 1e-5
     and abs(P.median() - 1.0) < 0.5),
    (kt.Mixture([kt.Normal(0.0, 0.5), kt.Normal(5.0, 0.5)], [0.5, 0.5]),
     _scalar_cost(5.0), lambda P: abs(P.median() - 5.0) < 0.5),
    (2.0 - 3.0 * kt.Exponential(1.0), _scalar_cost(0.0),
     lambda P: P.particles.max() <= 2.0 + 1e-5
     and abs(P.median()) < 0.5),
]


@pytest.mark.parametrize(
    "prior,cost,check", CASES, ids=[repr(c[0])[:48] for c in CASES])
@pytest.mark.filterwarnings(
    "ignore:smc. stopped at the max_iters:RuntimeWarning")
def test_smc_on_prior(prior, cost, check):
    res = kt.smc(prior, cost, nparticles=128, max_iters=25, key=11,
                 device="cpu")
    P = res.P if not isinstance(res.P, (tuple, list)) else res.P[0]
    assert np.isfinite(P.particles).all()
    assert check(P), (repr(prior), P)


def test_smc_vector_prior_mvnormal():
    prior = kt.MvNormal(np.zeros(3), np.eye(3) * 4.0)
    target = torch.tensor([1.0, -1.0, 0.5])

    def cost(x, gen):
        return torch.linalg.norm(x - target)

    with pytest.warns(RuntimeWarning, match="max_iters"):
        res = kt.smc(prior, cost, nparticles=256, max_iters=30, key=12,
                     device="cpu")
    med = [p.median() for p in res.P]
    assert np.allclose(med, [1.0, -1.0, 0.5], atol=0.5), med


def test_smc_simplex_prior_dirichlet():
    prior = kt.Dirichlet(np.array([2.0, 2.0, 2.0]))
    target = torch.tensor([0.6, 0.3, 0.1])

    def cost(x, gen):
        return torch.linalg.norm(x - target)

    with pytest.warns(RuntimeWarning, match="max_iters"):
        res = kt.smc(prior, cost, nparticles=256, max_iters=30, key=13,
                     device="cpu")
    arr = np.stack([p.particles for p in res.P], axis=-1)
    assert (arr > 0).all() and np.allclose(arr.sum(-1), 1.0, atol=1e-4)
    med = np.median(arr, axis=0)
    assert np.allclose(med, [0.6, 0.3, 0.1], atol=0.2), med


def test_ais_on_discrete_and_mixture_priors():
    abc = kt.ApproxKernelizedPosterior(
        kt.Truncated(kt.Poisson(6.0), 2, 12),
        lambda x: torch.abs(x.to(torch.float32) - 4.0), 0.5)
    res = kt.sample(abc, kt.AIS(32), 256, ntransitions=4, key=14,
                    device="cpu")
    assert np.all(res.particles == np.round(res.particles))
    assert 2 <= res.particles.min() and res.particles.max() <= 12
    assert abs(res.median() - 4.0) <= 1.0

    abc2 = kt.ApproxKernelizedPosterior(
        kt.Mixture([kt.Normal(0.0, 0.5), kt.Normal(5.0, 0.5)]),
        lambda x: torch.abs(x - 5.0), 0.2)
    res2 = kt.sample(abc2, kt.AIS(32), 256, ntransitions=4, key=15,
                     device="cpu")
    assert abs(res2.median() - 5.0) < 0.5


NEW_FAMILIES = [
    kt.Exponential(1.0), kt.Gamma(2.0, 1.0), kt.LogUniform(0.1, 10.0),
    kt.BetaPrime(3.0, 5.0), kt.StudentT(4.0), kt.Poisson(6.0),
    kt.DiscreteNonParametric([0.5, 1.5], [0.5, 0.5]),
    kt.Truncated(kt.Poisson(6.0), 2, 12),
    kt.Truncated(kt.StudentT(4.0), -1.0, 3.0),
    kt.Mixture([kt.Normal(0.0, 1.0), kt.Normal(5.0, 1.0)]),
    2.0 - 3.0 * kt.Exponential(1.0), kt.Dirichlet([2.0, 2.0, 2.0])]


def _draw(th, eps):
    return th[0] + 0.1 * eps


def _reduce(th, m):
    return torch.abs(m[0] - 1.0)


def _loglike(th):
    return -0.5 * torch.square(th[0] - 1.0)


SWEEP_MAKERS = {
    "smc": lambda p: kt.make_fused_smc_sweep(p, _draw, _reduce),
    "ais": lambda p: kt.make_fused_ais_sweep(p, _draw, _reduce, scale=0.1),
    "abcde": lambda p: kt.make_fused_abcde_generation(p, _draw, _reduce,
                                                      gamma=1.0),
    "tempered": lambda p: kt.make_fused_tempered_sweep(p, _loglike),
}


def _refused(kind, dist):
    """The families every sweep still refuses: one without an entry (a
    table or an atom push: DiscreteNonParametric, TruncatedDiscrete) and
    a vector leaf (Dirichlet), which the JAX kernels refuse too. Every
    sweep, the smc one included, pushes a discrete marginal."""
    return isinstance(dist, (kt.DiscreteNonParametric, kt.TruncatedDiscrete,
                             kt.Dirichlet))


CASES_48 = [(kind, d) for d in NEW_FAMILIES for kind in sorted(SWEEP_MAKERS)]
REFUSED = [c for c in CASES_48 if _refused(*c)]
BUILT = [c for c in CASES_48 if not _refused(*c)]


@pytest.mark.parametrize("kind,dist", REFUSED,
                         ids=[f"{repr(d)[:32]}-{k}" for k, d in REFUSED])
def test_fused_sweeps_refuse_new_families(kind, dist):
    """A family without an entry in the prior table of
    ``ops/codegen.py`` (or a vector one) raises when the sweep is built,
    naming the family."""
    prior = kt.Factored(dist, kt.Uniform(0.0, 1.0))
    with pytest.raises(NotImplementedError) as err:
        SWEEP_MAKERS[kind](prior)
    msg = str(err.value)
    names = {type(dist).__name__, type(getattr(dist, "base", dist)).__name__}
    assert any(name in msg for name in names), msg


@pytest.mark.parametrize("kind,dist", BUILT,
                         ids=[f"{repr(d)[:32]}-{k}" for k, d in BUILT])
def test_fused_sweeps_build_new_families(kind, dist):
    """The families with an entry build every sweep; the entry compiled
    into the unit is the family's logpdf traced op for op: its graph, run on tensors, equals the
    logpdf bit for bit on a grid across the support (the compiled code
    against the logpdf: tests/test_torch_prior_table.py)."""
    from kissabc_tpu_torch.ops import codegen as C
    prior = kt.Factored(dist, kt.Uniform(0.0, 1.0))
    sw = SWEEP_MAKERS[kind](prior)
    assert "prior_logpdf" in sw.unit.source and "p0_" in sw.unit.source
    x = torch.linspace(-4.0, 16.0, 801)
    if dist.discrete:
        x = dist.push(x).to(torch.float32)
    got = C.evaluate(C.trace_marginal(dist, 0), {"theta": [x]})
    want = dist.logpdf(x)
    assert torch.equal(got, want)
    assert 0 < int(torch.isfinite(want).sum())
