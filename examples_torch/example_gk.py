"""g-and-k quantile-distribution inference — the classic hard ABC
benchmark.

PyTorch counterpart of ``examples/example_gk.py``: the g-and-k
distribution has no closed density, but trivial simulation via its
quantile function

    Q(z) = a + b * (1 + 0.8 * tanh(g*z/2)) * (1 + z^2)^k * z,  z ~ N(0,1)

so likelihood-free inference on (a, b, g, k) from octile summary
statistics is the canonical use-case. The cost is per walker (a sort of
its 1000 draws for the octiles), mapped over the walkers by vmap.

    python examples_torch/example_gk.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

import kissabc_tpu_torch as kt
from examples_torch.example_n2 import quantiles
from kissabc_tpu_torch.utils.device import resolve_device

TRUE = (3.0, 1.0, 2.0, 0.5)
NDRAWS = 1000
NPARTICLES = 4096
OCTILES = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875)


def gk_quantile(z, a, b, g, k):
    return a + b * (1 + 0.8 * torch.tanh(g * z / 2)) * (1 + z * z) ** k * z


def gk_sample(gen, theta, n=NDRAWS):
    a, b, g, k = theta
    z = torch.randn(n, generator=gen, device=gen.device)
    return gk_quantile(z, a, b, g, k)


def observed(device):
    """The octiles of 10000 draws at ``TRUE``, from the generator seeded
    0."""
    gen = torch.Generator(device=device).manual_seed(0)
    return quantiles(gk_sample(gen, TRUE, 10_000), OCTILES)


prior = kt.Factored(kt.Uniform(0, 10), kt.Uniform(0, 4),
                    kt.Uniform(0, 10), kt.Uniform(0, 4))


def main(device=None, data_summ=None):
    """smc on the g-and-k model; ``data_summ``: the observed octiles
    (default ``observed(device)``)."""
    dev = resolve_device(device)
    data_summ = observed(dev) if data_summ is None else torch.as_tensor(
        data_summ, dtype=torch.float32, device=dev)

    def cost(theta, gen):
        s = quantiles(gk_sample(gen, theta), OCTILES)
        return torch.sqrt(torch.mean(torch.square(s - data_summ)))

    res = kt.smc(prior, cost, nparticles=NPARTICLES, alpha=0.95,
                 epstol=0.05, key=1, device=dev)
    names = "abgk"
    for name, p in zip(names, res.P):
        print(f"  {name}: {p}   (true {TRUE[names.index(name)]})")
    print("eps:", round(res.eps, 4), " iterations:", res.iterations)
    return res


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
