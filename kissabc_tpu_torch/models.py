"""Models written for the generic kernels (``make_streaming_moment_cost``,
``make_fused_smc_sweep``, ``make_streaming_scan_cost``): the ones the
JAX package's bench and examples run, in PyTorch. ``chip_smoke.py``,
``tools/profile_torch_smc.py`` and the tests drive them; they are also
examples of a user model.

- ``flagship()``: the README Normal(mu, sigma) model (``bench.py:517-560``):
  prior ``Factored(Uniform(1, 3), TruncatedNormal(0, 0.05, 0, 100))``,
  draw ``mu + sigma * eps``, cost ``hypot(E[x] - 2, (sd(x) - 0.04) * 50)``
  from the raw moments E[x], E[x^2];
- ``mixed_discrete()``: the mixed discrete prior of
  ``tests/test_pallas.py:864-890``, ``Factored(DiscreteUniform(1, 10),
  Uniform(0.1, 1))``, draw ``m + s * eps``, cost ``hypot(E[x] - 3,
  sd(x) - 0.5)``: the fused sweeps push m (round half to even) for the
  prior and the simulator;
- ``g_and_k()``: the four-parameter g-and-k quantile model
  (``bench.py:362-370``): prior ``Uniform(0, 6), Uniform(0.1, 3),
  Uniform(-1, 5), Uniform(0, 0.9)``, draw
  ``a + b (1 + 0.8 tanh(g eps / 2)) eps exp(k log1p(eps^2))``;
- ``ar1()``: the AR(1) sequential simulator of ``bench.py:770-806``
  (``x_{t+1} = 0.8 x_t + 0.2 mu + s eps``), prior ``Uniform(0, 2),
  Uniform(0.3, 2)``, cost ``hypot(E[x] - 1, (var - v) / v)`` against the
  stationary mean 1 and variance ``v = 1 / (1 - 0.8^2)``;
- ``sir()``: the stochastic SIR epidemic of ``examples/example_sir.py``,
  each day folded into an infection and a recovery sub-step, matched to
  the deterministic curve at beta=0.3, gamma=0.1 through ``series``;
- ``conjugate_normal()``: tsmc's oracle (``bench.py:825-881``,
  ``tests/test_tsmc.py``): prior Normal(0, 1), eight data points of unit
  variance, the log-likelihood per walker (compiled into the tempered
  sweep) and batched, and the closed-form posterior and evidence;
- ``mixture_cost`` and ``dirac_cost``: the per-walker costs of the JAX
  bench's ``pfilter`` and ``abcde`` rows (``bench.py:884-938``);
- ``socks()``: the reference's socks problem (KissABC.jl's runtests, as
  ``tests/test_reference_parity.py:14-57``): prior
  ``Factored(NegativeBinomial(...), Beta(15, 2))``, a per-walker cost
  that picks 11 socks without replacement (``socks_sim``, its uniforms
  given) against the observed 0 pairs and 11 odd socks.
"""

from __future__ import annotations

import numpy as np
import torch

from .distributions import (Beta, DiscreteUniform, Factored,
                            NegativeBinomial, Normal, TruncatedNormal,
                            Uniform)


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


def mixed_discrete():
    """(prior, draw, reduce_cost) of the mixed discrete model."""
    prior = Factored(DiscreteUniform(1, 10), Uniform(0.1, 1.0))

    def draw(th, eps):
        m, s = th
        return m + s * eps

    def reduce_cost(th, mo):
        var = torch.maximum(mo[1] - mo[0] * mo[0], torch.zeros_like(mo[0]))
        return torch.hypot(mo[0] - 3.0, torch.sqrt(var) - 0.5)

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


AR1_A = np.float32(0.2)   # the AR(1) mean-reversion weight


def ar1():
    """(prior, step, init, reduce_cost) of the AR(1) model."""
    stat_var = 1.0 / (1.0 - (1.0 - float(AR1_A)) ** 2)
    prior = Factored(Uniform(0, 2), Uniform(0.3, 2.0))

    def step(th, x, eps, t):
        mu, s = th
        return (1 - AR1_A) * x + AR1_A * mu + s * eps

    def init(th):
        return th[0]

    def reduce_cost(th, m):
        var = torch.clamp(m[1] - m[0] * m[0], min=0.0)
        return torch.hypot(m[0] - 1.0, (var - stat_var) / stat_var)

    return prior, step, init, reduce_cost


SIR_POP, SIR_I0, SIR_DAYS = 1000.0, 10.0, 50


def sir_series():
    """The observed curve at beta=0.3, gamma=0.1 (the example's
    ``observed_curve``) on the recovery sub-steps, zeros between:
    ``2 * SIR_DAYS`` float32 values."""
    s, i, ys = SIR_POP - SIR_I0, SIR_I0, []
    for _ in range(SIR_DAYS):
        ninf = 0.3 * s * i / SIR_POP
        nrec = 0.1 * i
        s, i = s - ninf, i + ninf - nrec
        ys.append(i)
    series = np.zeros((2 * SIR_DAYS,), np.float32)
    series[1::2] = np.asarray(ys, np.float32)
    return series


def sir():
    """(prior, step, init, observe, reduce_cost, series) of the SIR
    model; ``nsteps = 2 * SIR_DAYS``."""
    prior = Factored(Uniform(0.05, 0.8), Uniform(0.02, 0.4))

    def step(th, state, eps, t):
        beta, gamma = th
        s, i = state
        even = (t % 2) == 0
        # infection sub-step flow on even t, recovery flow on odd t
        flow = torch.where(even, beta * s * i / SIR_POP, gamma * i)
        dn = flow + torch.sqrt(torch.clamp(flow, min=0.0)) * eps
        dn = torch.clamp(dn, torch.zeros_like(dn), torch.where(even, s, i))
        return torch.where(even, s - dn, s), torch.where(even, i + dn, i - dn)

    def init(th):
        return (SIR_POP - SIR_I0) + 0.0 * th[0], SIR_I0 + 0.0 * th[0]

    def observe(th, state, t, obs):
        # the day boundary is after the recovery sub-step (odd t); x2
        # restores the day-average normalization lost to the sub-steps
        _, i = state
        odd = (t % 2) == 1
        return (torch.where(odd, torch.abs(i - obs), 0.0) * 2.0 / SIR_POP,)

    def reduce_cost(th, m):
        return m[0]

    return prior, step, init, observe, reduce_cost, sir_series()


TSMC_Y = np.array([1.2, 0.8, 1.5, 0.9, 1.1, 1.3, 0.7, 1.0], np.float32)


def conjugate_normal():
    """(prior, loglike_elem, loglike_vec, truth) of the conjugate-normal
    oracle: ``loglike_elem(theta)`` is elementwise over walkers with the
    data as constants (a loop over the eight points, the form the
    tempered sweep compiles), ``loglike_vec(thetas, gen)`` the batched
    form for ``loglike_vectorized=True``; ``truth`` is the posterior
    mean and sd and the log-evidence ``log N(Y; 0, I + 11^T)``."""
    y, k = TSMC_Y, len(TSMC_Y)
    c = float(np.float32(k / 2 * np.log(2 * np.pi)))
    yt = torch.from_numpy(y)

    def loglike_elem(theta):
        s = 0.0
        for v in y:
            s = s + torch.square(float(v) - theta)
        return -0.5 * s - c

    def loglike_vec(thetas, gen):
        d = yt.to(thetas.device)[None, :] - thetas[:, None]
        return -0.5 * torch.sum(d * d, dim=1) - k / 2 * np.log(2 * np.pi)

    cov = np.eye(k) + np.ones((k, k))
    yd = y.astype(np.float64)
    logz = -0.5 * (yd @ np.linalg.solve(cov, yd)
                   + np.linalg.slogdet(cov)[1] + k * np.log(2 * np.pi))
    truth = (float(y.sum() / (k + 1)), float(1.0 / np.sqrt(k + 1)),
             float(logz))
    return Normal(0, 1), loglike_elem, loglike_vec, truth


def mixture_cost(x, gen):
    """The classical 0.1N+N mixture simulator (the reference's
    runtests.jl:144-146) per walker: ``|x + e|`` with ``e`` N(0, 0.1^2)
    or N(0, 1) with even odds."""
    def draw(f):
        return f((), generator=gen, device=gen.device)
    sim = x + torch.where(draw(torch.rand) < 0.5, draw(torch.randn) * 0.1,
                          draw(torch.randn))
    return torch.abs(sim)


def dirac_cost(x):
    """``|x^2 + 1 - 1.5|``: the posterior is a point mass at sqrt(0.5)."""
    return torch.abs(x * x + 1 - 1.5)


SOCKS_MAXN = 512   # the most socks a walker's drawer holds


def socks_sim(n_socks, prop_pairs, r):
    """Broman's socks simulator per walker, static shapes as the JAX
    test's: the drawer holds ``n_socks`` socks, ``round(prop_pairs *
    floor(n_socks / 2))`` pairs first; the ``min(n_socks, 11)`` socks
    with the smallest of the uniforms ``r`` ([SOCKS_MAXN]) are picked,
    and the picked pairs and odd socks counted by sorting their ids.
    Returns (pairs, odds) as int32."""
    n = n_socks.to(torch.int32)
    n_pairs = torch.round(prop_pairs * torch.floor(
        n.to(torch.float32) / 2)).to(torch.int32)
    idx = torch.arange(SOCKS_MAXN, dtype=torch.int32, device=r.device)
    ids = torch.where(idx < 2 * n_pairs, idx // 2,
                      n_pairs + (idx - 2 * n_pairs))
    order = torch.argsort(torch.where(idx < n, r, float("inf")))
    npicked = torch.clamp(n, max=11)
    lane = torch.arange(11, dtype=torch.int32, device=r.device)
    picked = torch.where(lane < npicked, torch.gather(ids, 0, order[:11]),
                         -(lane + 1))
    s = torch.sort(picked).values
    dup = torch.sum(s[1:] == s[:-1]).to(torch.int32)   # ids at most twice
    return dup, npicked - 2 * dup


def socks():
    """(prior, cost) of the socks problem: NegativeBinomial with mean 30
    and sd 15 socks, Beta(15, 2) pairs; the cost ``|pairs - 0| + |odds -
    11|`` of one simulated pick (``cost(theta, gen)``, the per-walker
    form)."""
    mu, sd = 30, 15
    size = -mu ** 2 / (mu - sd ** 2)
    prior = Factored(NegativeBinomial(size, size / (mu + size)), Beta(15, 2))

    def cost(theta, gen):
        n_socks, prop_pairs = theta
        r = torch.rand(SOCKS_MAXN, generator=gen, device=gen.device)
        pairs, odds = socks_sim(n_socks, prop_pairs, r)
        return torch.abs(pairs).to(torch.float32) + torch.abs(odds - 11)

    return prior, cost
