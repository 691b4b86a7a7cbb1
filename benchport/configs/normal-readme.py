"""normal-readme: the KissABC.jl README model. The prior is
``Factored(Uniform(1, 3), TruncatedNormal(0, 0.05, 0, 100))``, the draw
``mu + sigma * eps`` 1000 times a walker, the cost ``hypot(E[x] - 2,
(sd(x) - 0.04) * 50)`` from the raw moments E[x], E[x^2] (the README
call of ``__graft_entry__.py:14-26`` written as a user model). The sizes
are in ``normal-readme.json``.

``model(cfg, data)`` gives the model as the program takes it and as the
plain reference computes it (``ref_cost``), and the prior on each side
(``port_prior``, ``ref_prior``); the counts are frozen for the roofline
(``metrics/_counts.py``), a transcendental counted as one.
"""

from __future__ import annotations

import torch

from reference import priors

# per draw: the noise (27, as in gk-ecdf.py), the draw (2: sigma*z,
# mu+), the powers x, x*x (1) and their 2 sums
OPS_PER_DRAW = 27 + 2 + 1 + 2
# per simulated walker: 2 moments scaled, m1*m1, m2-, the clamp, sqrt,
# -0.04, *50, m1-2, 2 squares, +, sqrt
REDUCE_OPS = 13
# per walker: the support tests of both leaves (6), the truncated
# normal's square and scale (3), the sum (1)
PRIOR_OPS = 10
# the raw moments E[x], E[x^2] and the parameter leaves mu, sigma
NSTATS, NLEAVES = 2, 2


def make_data(cfg):
    return {}


class Model:
    def __init__(self, cfg, data):
        self.ndraws = int(cfg["ndraws"])
        self.mean, self.sd = float(cfg["target_mean"]), float(cfg["target_sd"])
        self.weight = float(cfg["sd_weight"])
        self.nmoments = 2
        self.stats = None
        # Factored(Uniform(lo, hi), TruncatedNormal(mu, sigma, lo, hi))
        (_, *self.mu_prior), (_, *self.sigma_prior) = cfg["prior"]
        self.ref_prior = [priors.Uniform(*self.mu_prior),
                          priors.TruncatedNormal(*self.sigma_prior)]

    def port_prior(self, kt):
        return kt.Factored(kt.Uniform(*self.mu_prior),
                           kt.TruncatedNormal(*self.sigma_prior))

    def draw(self, theta, z):
        mu, sg = theta
        return mu + sg * z

    def reduce(self, theta, m):
        var = torch.clamp(m[1] - m[0] * m[0], min=0.0)
        return torch.sqrt(torch.square(m[0] - self.mean)
                          + torch.square((torch.sqrt(var) - self.sd)
                                         * self.weight))

    def ref_cost(self, theta, z, dtype=torch.float64):
        """Each walker's cost from its draws' normals ``z`` (``[K,
        ndraws]``) in ``dtype``, twice (no indicator can flip here)."""
        x = self.draw([t.to(dtype)[:, None] for t in theta], z.to(dtype))
        m1 = x.sum(1) / self.ndraws
        m2 = (x * x).sum(1) / self.ndraws
        c = self.reduce(None, (m1, m2)).double()
        return c, c


def model(cfg, data):
    return Model(cfg, data)
