"""``host_cost`` of kissabc_tpu_torch on the CPU: a numpy simulator of
the README model (1000 normals a walker from the given seeds) as the
batched cost of ``smc`` and ``abc_rejection``, the seeds drawn from the
run's generator, and the per-walker misuse error of the JAX package.
"""

import numpy as np
import pytest
import torch

import kissabc_tpu_torch as kt
from torch_threads import one_torch_thread  # noqa: F401


def readme_sim(thetas, seeds):
    """The README cost on the host: per walker x = mu + sigma z from 1000
    normals z of its own seed (a proposal may carry sigma < 0; the gate
    rejects it after the cost), then hypot(mean - 2, (std - 0.04) * 50)."""
    mu, sigma = thetas
    out = np.empty(len(mu))
    for i in range(len(mu)):
        z = np.random.default_rng(int(seeds[i])).standard_normal(1000)
        x = mu[i] + sigma[i] * z
        out[i] = np.hypot(x.mean() - 2.0, (x.std() - 0.04) * 50)
    return out


def _prior():
    return kt.Factored(kt.Uniform(1, 3), kt.TruncatedNormal(0, 0.05, 0, 100))


def test_host_cost_in_smc():
    res = kt.smc(_prior(), kt.host_cost(readme_sim), cost_vectorized=True,
                 nparticles=200, epstol=0.05, key=1, device="cpu")
    mu, sg = res.P
    assert res.eps <= 0.05
    assert abs(mu.mean() - 2.0) < 0.05 and abs(sg.mean() - 0.04) < 0.01


def test_host_cost_in_abc_rejection_both_modes():
    cost = kt.host_cost(readme_sim)
    a = kt.abc_rejection(_prior(), cost, 16, nsims=8192, batch=2048,
                         cost_vectorized=True, key=3, device="cpu")
    assert a.naccept == 16 and a.nsims == 8192
    assert abs(a.P[0].mean() - 2.0) < 0.1
    b = kt.abc_rejection(_prior(), cost, 8, eps=0.5, batch=2048,
                         cost_vectorized=True, key=3, device="cpu")
    assert b.naccept >= 8 and (b.C.particles <= 0.5).all()


def test_seeds_come_from_the_generator_and_repeat():
    seen = []

    def sim(thetas, seeds):
        assert isinstance(thetas, tuple) and isinstance(thetas[0],
                                                        np.ndarray)
        assert seeds.dtype == np.uint32 and seeds.shape == (5,)
        seen.append(seeds.copy())
        return thetas[0] * 0 + seeds.astype(np.float64) % 7

    cost = kt.host_cost(sim)
    th = (torch.ones(5), torch.zeros(5))
    outs = []
    for _ in range(2):
        g = torch.Generator()
        g.manual_seed(11)
        outs.append(cost(th, g))
    assert outs[0].dtype == torch.float32 and outs[0].device == th[0].device
    assert torch.equal(outs[0], outs[1])
    np.testing.assert_array_equal(seen[0], seen[1])
    g = torch.Generator()
    g.manual_seed(11)
    want = torch.randint(0, 1 << 32, (5,), generator=g, dtype=torch.int64)
    np.testing.assert_array_equal(seen[0], want.numpy().astype(np.uint32))
    assert cost(th, g).dtype == torch.float32
    assert kt.host_cost(sim, torch.float64)(th, g).dtype == torch.float64


def test_per_walker_use_raises():
    with pytest.raises(ValueError, match="BATCHED"):
        kt.smc(_prior(), kt.host_cost(readme_sim), nparticles=100, key=0,
               device="cpu")
    with pytest.raises(ValueError, match="cost_vectorized=True"):
        kt.host_cost(readme_sim)((torch.tensor(2.0), torch.tensor(0.04)),
                                 torch.Generator())
