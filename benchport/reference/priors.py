"""Plain marginals of a factored prior, one a parameter leaf, and the
support and log-density of their product. A marginal is any object with
``lo``, ``hi`` (its support) and ``logpdf(x)`` (finite inside): each
configuration builds its own (``configs/<name>.py``), from these or from
a class of its own, so nothing here lists the families a benchmark may
use."""

from __future__ import annotations

import math

import torch


class Uniform:
    def __init__(self, lo, hi):
        self.lo, self.hi = float(lo), float(hi)

    def logpdf(self, x):
        return torch.full_like(x, -math.log(self.hi - self.lo))


class TruncatedNormal:
    def __init__(self, mu, sigma, lo, hi):
        self.mu, self.sigma = float(mu), float(sigma)
        self.lo, self.hi = float(lo), float(hi)

    def _cdf(self, v):
        return 0.5 * (1.0 + math.erf((v - self.mu)
                                     / (self.sigma * math.sqrt(2.0))))

    def logpdf(self, x):
        const = (math.log(self.sigma * math.sqrt(2.0 * math.pi))
                 + math.log(self._cdf(self.hi) - self._cdf(self.lo)))
        return -0.5 * torch.square((x - self.mu) / self.sigma) - const


def logpdf(marginals, leaves):
    """The prior's log-density at the walkers (``leaves``: one tensor a
    marginal); -inf outside the support."""
    out = torch.zeros_like(leaves[0])
    for m, x in zip(marginals, leaves):
        inside = (x >= m.lo) & (x <= m.hi)
        out = out + torch.where(inside, m.logpdf(x),
                                torch.full_like(x, float("-inf")))
    return out


def support_margin(marginals, leaves):
    """Each walker's signed distance to the nearest edge of the support,
    as a share of that marginal's width: negative outside."""
    out = None
    for m, x in zip(marginals, leaves):
        d = torch.minimum(x - m.lo, m.hi - x) / (m.hi - m.lo)
        out = d if out is None else torch.minimum(out, d)
    return out
