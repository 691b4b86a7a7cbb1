"""A Gaussian mixture model — 5-parameter inference.

PyTorch counterpart of ``examples/example_n2.py`` (the reference's
``examples/example_n2.jl``): infer (mu1, mu2, sigma1, sigma2, prob) of a
two-component mixture from quantile summary statistics.

    python examples_torch/example_n2.py [--device cpu]
"""

import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.utils.device import resolve_device

N = 200
QUANTS = (0.1, 0.2, 0.45, 0.55, 0.8, 0.9)
PARAMETERS = (1.0, 0.0, 0.2, 2.0, 0.4)


def model(P, gen, n=N):
    mu1, mu2, sg1, sg2, prob = P
    r1 = torch.randn(n, generator=gen, device=gen.device)
    r2 = torch.rand(n, generator=gen, device=gen.device)
    d1 = r1 * sg1 + mu1
    d2 = r1 * sg2 + mu2
    ps = (1 + torch.sign(r2 - prob)) / 2
    return d1 + ps * (d2 - d1)


def quantiles(x, qs):
    """Type-7 quantiles of ``x`` at the fixed probabilities ``qs``
    (numpy's default, as ``jnp.quantile``), from one sort: vmap batches
    the sort, where it would run ``torch.quantile`` walker by walker."""
    xs = torch.sort(x).values
    out = []
    for q in qs:
        h = (x.shape[-1] - 1) * q
        lo = math.floor(h)
        hi = min(lo + 1, x.shape[-1] - 1)
        out.append(xs[lo] + (h - lo) * (xs[hi] - xs[lo]))
    return torch.stack(out)


def S(x):
    return quantiles(x, QUANTS)


prior = kt.Factored(
    kt.Uniform(0, 2),    # a peak between 0 and 2
    kt.Uniform(-1, 1),   # a smeared distribution centered around 0
    kt.Uniform(0, 1),    # peak width below 1
    kt.Uniform(0, 4),    # smeared width below 4
    kt.Beta(2, 2),       # favor balanced mixture slightly
)


def observed(device):
    """The summaries of 200 draws at ``PARAMETERS``, from the generator
    seeded 0."""
    return S(model(PARAMETERS, torch.Generator(device=device).manual_seed(0)))


def main(device=None, summ_data=None):
    """AIS and smc posteriors of the mixture; ``summ_data``: the observed
    quantiles (default ``observed(device)``)."""
    dev = resolve_device(device)
    summ_data = observed(dev) if summ_data is None else torch.as_tensor(
        summ_data, dtype=torch.float32, device=dev)

    def cost(P, gen):
        return torch.sqrt(torch.mean(torch.square(summ_data
                                                  - S(model(P, gen)))))

    approx_density = kt.ApproxPosterior(prior, cost, 0.032)
    res = kt.sample(approx_density, kt.AIS(100), 100,
                    discard_initial=4000, ntransitions=10, key=1,
                    device=dev)
    print("AIS posterior:", res)

    # SMC: tighter CIs, lower simulator budget
    ressmc = kt.smc(prior, cost, nparticles=1000, alpha=0.95, key=2,
                    device=dev)
    print("smc posterior:", ressmc.P)
    return res, ressmc


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
