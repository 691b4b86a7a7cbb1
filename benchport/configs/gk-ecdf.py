"""gk-ecdf: the g-and-k quantile distribution (Allingham, King and
Mengersen 2009) at theta = (a, b, g, k) = (3, 1, 2, 0.5), c = 0.8, fitted
from 2000 draws a walker through 7 streamed ecdf indicators at the
octiles of the truth; cost the Euclidean distance of the ecdf at the
probes to (0.125, ..., 0.875). The sizes are in ``gk-ecdf.json``.

``model(cfg, data)`` gives the model as the program takes it (``draw``,
``stats``, ``reduce``: elementwise PyTorch that the port compiles into
its kernels) and as the plain reference computes it (``ref_cost``, in
float64, or in a lower precision for the control). ``make_data`` makes
the probe points. ``OPS_PER_DRAW``, ``REDUCE_OPS``
and ``PRIOR_OPS`` are the frozen operation counts of the roofline
(``metrics/_counts.py``), a transcendental counted as one.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import priors

# the float32 draw of the program lies within this share of 1 + |x| of
# the float64 draw: an indicator of a draw closer to its probe may go
# either way, and the reference gives the cost as an interval over both
AMBIGUOUS = 1e-5

# per draw: the noise (27: a quarter of a Philox4x32-10 call, 20; two
# mantissa tricks a pair, 3; Box-Muller with log1p, sqrt, sin and cos, 4),
# the draw (13: g*z, /2, tanh, *c, 1+, *b, *z, z*z, log1p, *k, exp, *,
# a+), the 7 indicators (7) and their 7 sums (7)
OPS_PER_DRAW = 27 + 13 + 7 + 7
# per simulated walker: the 7 moments scaled (7), 7 differences, 7
# squares, 6 additions and a square root
REDUCE_OPS = 7 + 7 + 7 + 6 + 1
# per walker: the support test of each of the 4 Uniform leaves (2
# compares and an and) and the sum of their constant log-densities
PRIOR_OPS = 4 * 3 + 4
# the streamed statistics (the indicators) and the parameter leaves
NSTATS, NLEAVES = 7, 4


def gk(theta, z, c):
    """The g-and-k quantile function at standard normals ``z``."""
    a, b, g, k = theta
    return a + b * (1.0 + c * torch.tanh(g * z / 2.0)) * z * torch.exp(
        k * torch.log1p(z * z))


def make_data(cfg):
    """The probe points: the octiles of ``probe_draws`` draws at the
    truth, from NumPy's generator seeded ``probe_seed``, as float32
    values. They are the observed data; the port compiles them into its
    kernels, so they stay fixed and every run finds its kernels built."""
    rng = np.random.default_rng(cfg["probe_seed"])
    z = rng.standard_normal(cfg["probe_draws"])
    a, b, g, k = cfg["theta_true"]
    x = a + b * (1.0 + cfg["c"] * np.tanh(g * z / 2.0)) * z * np.exp(
        k * np.log1p(z * z))
    q = np.quantile(x, cfg["octiles"])
    return {"probes": [float(np.float32(t)) for t in q]}


class Model:
    def __init__(self, cfg, data):
        self.c = float(cfg["c"])
        self.ndraws = int(cfg["ndraws"])
        self.probes = [float(t) for t in data["probes"]]
        self.targets = [float(o) for o in cfg["octiles"]]
        self.nmoments = len(self.probes)
        self.stats = [(lambda x, t=t: (x < t).to(torch.float32))
                      for t in self.probes]
        # every marginal Uniform(lo, hi)
        self.bounds = [(lo, hi) for _, lo, hi in cfg["prior"]]
        self.ref_prior = [priors.Uniform(lo, hi) for lo, hi in self.bounds]

    def port_prior(self, kt):
        return kt.Factored(*(kt.Uniform(lo, hi) for lo, hi in self.bounds))

    def draw(self, theta, z):
        return gk(theta, z, self.c)

    def reduce(self, theta, m):
        err = [mk - o for mk, o in zip(m, self.targets)]
        acc = err[0] * err[0]
        for e in err[1:]:
            acc = acc + e * e
        return torch.sqrt(acc)

    def ref_cost(self, theta, z, dtype=torch.float64):
        """(lo, hi) of each walker's cost from its draws' normals ``z``
        (``[K, ndraws]``): float64 gives the interval over the
        indicators that lie within ``AMBIGUOUS`` of their probe; another
        ``dtype`` gives that precision's point value twice."""
        x = gk([t.to(dtype)[:, None] for t in theta], z.to(dtype), self.c)
        exact = dtype == torch.float64
        lo_d, hi_d = [], []
        for t, o in zip(self.probes, self.targets):
            ind = x < t
            if exact:
                amb = (x - t).abs() <= AMBIGUOUS * (1.0 + x.abs())
                m_lo = (ind & ~amb).sum(1).double() / self.ndraws
                m_hi = (ind | amb).sum(1).double() / self.ndraws
                d_lo = torch.clamp(torch.maximum(m_lo - o, o - m_hi), min=0)
                d_hi = torch.maximum((m_lo - o).abs(), (m_hi - o).abs())
            else:
                m = ind.to(dtype).sum(1) / self.ndraws
                d_lo = d_hi = (m - o).abs()
            lo_d.append(d_lo)
            hi_d.append(d_hi)

        def norm(ds):
            acc = ds[0] * ds[0]
            for d in ds[1:]:
                acc = acc + d * d
            return torch.sqrt(acc).double()

        return norm(lo_d), norm(hi_d)


def model(cfg, data):
    return Model(cfg, data)
