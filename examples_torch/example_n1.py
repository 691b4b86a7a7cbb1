"""Usage guide — Normal(mu, sigma) inference walkthrough.

PyTorch counterpart of ``examples/example_n1.py`` (the reference's
``examples/example_n1.jl``). The ingredients of Approximate Bayesian
Computation:

1. a simulation depending on parameters, able to generate datasets
   similar to your target dataset when the parameters are right,
2. a prior distribution over the parameters,
3. a distance function comparing generated to observed data.

A stochastic simulator draws from the ``torch.Generator`` it is given,
on that generator's device; the samplers map the per-walker cost over
the walkers with ``torch.func.vmap``, so every walker draws its own
numbers and a run repeats from its ``key``.

    python examples_torch/example_n1.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.utils.device import resolve_device

prior = kt.Factored(kt.Uniform(1, 3), kt.TruncatedNormal(0, 0.1, 0, 100))


def observed(device):
    """The target dataset: Normal draws with unknown (mu, sigma) =
    (2, 0.04), from the generator seeded 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn(1000, generator=gen, device=device) * 0.04 + 2


def main(device=None, tdata=None):
    """Fits the model by AIS and by smc; returns both posteriors.
    ``tdata``: the observed data (default ``observed(device)``)."""
    dev = resolve_device(device)
    tdata = observed(dev) if tdata is None else torch.as_tensor(
        tdata, dtype=torch.float32, device=dev)

    def sim(theta, gen):
        mu, sigma = theta
        return torch.randn(1000, generator=gen, device=gen.device) * sigma + mu

    def dist(x, y):
        d1 = torch.mean(x) - torch.mean(y)
        d2 = torch.std(x, correction=0) - torch.std(y, correction=0)
        return torch.hypot(d1, d2 * 50)

    def cost(theta, gen):
        return dist(tdata, sim(theta, gen))

    # Affine-invariant ensemble MCMC over the ABC density
    approx_density = kt.ApproxPosterior(prior, cost, 0.01)
    res = kt.sample(approx_density, kt.AIS(50), 500, discard_initial=1000,
                    ntransitions=10, key=1, device=dev)
    print("AIS posterior:   ", res)

    # Sequential Monte Carlo: tighter CIs at lower simulator budget
    ressmc = kt.smc(prior, cost, nparticles=500, epstol=0.01, key=2,
                    device=dev)
    print("smc posterior:   ", ressmc.P, " eps =", round(ressmc.eps, 5))
    return res, ressmc


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
