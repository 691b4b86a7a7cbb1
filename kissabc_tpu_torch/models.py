"""Models written for the generic kernels (``make_streaming_moment_cost``,
``make_fused_smc_sweep``): the ones the JAX package's bench runs, in
PyTorch. ``chip_smoke.py``, ``tools/profile_torch_smc.py`` and the tests
drive them; they are also examples of a user model.

- ``flagship()``: the README Normal(mu, sigma) model (``bench.py:517-560``):
  prior ``Factored(Uniform(1, 3), TruncatedNormal(0, 0.05, 0, 100))``,
  draw ``mu + sigma * eps``, cost ``hypot(E[x] - 2, (sd(x) - 0.04) * 50)``
  from the raw moments E[x], E[x^2];
- ``g_and_k()``: the four-parameter g-and-k quantile model
  (``bench.py:362-370``): prior ``Uniform(0, 6), Uniform(0.1, 3),
  Uniform(-1, 5), Uniform(0, 0.9)``, draw
  ``a + b (1 + 0.8 tanh(g eps / 2)) eps exp(k log1p(eps^2))``.
"""

from __future__ import annotations

import numpy as np
import torch

from .distributions import Factored, TruncatedNormal, Uniform


def flagship():
    """(prior, draw, reduce_cost) of the README model."""
    prior = Factored(Uniform(1, 3), TruncatedNormal(0, 0.05, 0, 100))

    def draw(th, eps):
        mu, sg = th
        return mu + sg * eps

    def reduce_cost(th, m):
        var = torch.clamp(m[1] - m[0] * m[0], min=0.0)
        return torch.sqrt(torch.square(m[0] - 2.0)
                          + torch.square((torch.sqrt(var) - 0.04) * 50.0))

    return prior, draw, reduce_cost


def g_and_k():
    """(prior, draw, reduce_cost) of the g-and-k model; the cost matches
    the mean and standard deviation of the draws to those of 100000
    draws at a=3, b=1, g=2, k=0.5, made from numpy's seed 0 as the JAX
    bench makes them."""
    z = np.random.default_rng(0).normal(size=100000)
    x = 3.0 + 1.0 * (1 + 0.8 * np.tanh(z)) * z * np.exp(0.5 * np.log1p(z * z))
    t1, t2 = float(np.float32(x.mean())), float(np.float32(x.std()))
    prior = Factored(Uniform(0, 6), Uniform(0.1, 3), Uniform(-1, 5),
                     Uniform(0.0, 0.9))

    def draw(th, eps):
        a, b, g, k = th
        return a + b * (1.0 + 0.8 * torch.tanh(g * eps / 2.0)) * eps \
            * torch.exp(k * torch.log1p(eps * eps))

    def reduce_cost(th, m):
        var = torch.clamp(m[1] - m[0] * m[0], min=0.0)
        return torch.hypot(m[0] - t1, (torch.sqrt(var) - t2) * 0.3)

    return prior, draw, reduce_cost
