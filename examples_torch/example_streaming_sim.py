"""Streaming-simulator toolkit: Weibull inference from moments.

PyTorch counterpart of ``examples/example_streaming_sim.py``.
Demonstrates ``make_streaming_moment_cost`` — the bring-your-own-model
kernel: ``draw`` (elementwise PyTorch) is compiled into a CUDA kernel
(``kissabc_tpu_torch/csrc/generic.cuh``) that makes each walker's draws
from Philox on the card and streams their moments, so no simulated
sample is stored. On the CPU the same cost runs the kernel's plain
PyTorch version.

Model: lifetimes X ~ Weibull(shape k, scale lam), simulated by
inverse-CDF transform of uniforms (one elementwise expression, so it
runs INSIDE the kernel):

    x = lam * (-log(1 - u)) ** (1/k),   u ~ U[0,1)

Summaries: the first two raw moments of the simulated sample. The cost
compares them to the observed moments in relative error. With
"observed" data generated at (k=1.7, lam=2.0), smc recovers both
parameters. (EXACT order statistics — octiles, medians — cannot be
streamed, but Part 2 below streams the equivalent ecdf-probe summaries
for a 4-parameter g-and-k model; a per-walker cost remains the
exact-order-statistic option, cf. examples_torch/example_gk.py and
example_expmix.py.)

    python examples_torch/example_streaming_sim.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch
from scipy.special import gamma as _gamma

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.utils.device import resolve_device

TRUE_K, TRUE_LAM = 1.7, 2.0
NDRAWS = 4000
ALPHA = 0.95   # smc's survival fraction an iteration, both fits

# observed moments at the true parameters (exact, host-side):
# E[X^p] = lam^p * Gamma(1 + p/k)
OBS_M1 = float(TRUE_LAM * _gamma(1 + 1 / TRUE_K))
OBS_M2 = float(TRUE_LAM**2 * _gamma(1 + 2 / TRUE_K))


def draw(theta, u):
    """Elementwise inverse-CDF Weibull draw — runs inside the kernel."""
    k, lam = theta
    return lam * torch.exp(torch.log(-torch.log1p(-u)) / k)


def reduce_cost(theta, moments):
    m1, m2 = moments
    return torch.hypot((m1 - OBS_M1) / OBS_M1, (m2 - OBS_M2) / OBS_M2)


cost = kt.make_streaming_moment_cost(draw, reduce_cost, nmoments=2,
                                     ndraws=NDRAWS, noise="uniform")

prior = kt.Factored(kt.Uniform(0.5, 4.0), kt.Uniform(0.5, 5.0))

# ---------------------------------------------------------------------
# Part 2: g-and-k via streamed ecdf probes (stats=)
#
# Order-statistic summaries (the octiles of examples_torch/example_gk.py)
# cannot be streamed, but the SAME binned-distribution information can:
# probe the empirical CDF at fixed points t_j and match P(X < t_j).
# Each probe is an elementwise indicator, so the whole summary runs
# inside the kernel.
# ---------------------------------------------------------------------

GK_TRUE = (3.0, 1.0, 2.0, 0.5)
GK_OBS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875)


def gk_draw(theta, z):
    a, b, g, k = theta
    # (1+z^2)^k via exp/log1p: elementwise
    return a + b * (1.0 + 0.8 * torch.tanh(g * z / 2.0)) * z * torch.exp(
        k * torch.log1p(z * z))


def gk_probes(device):
    """The probe points: the octiles of 200000 draws of gk(GK_TRUE)
    from the generator seeded 0 (probing where the data mass is
    maximizes information)."""
    gen = torch.Generator(device=device).manual_seed(0)
    zo = torch.randn(200_000, generator=gen, device=device)
    q = torch.quantile(gk_draw(GK_TRUE, zo),
                       torch.tensor(GK_OBS, device=device))
    return tuple(float(t) for t in q)


def gk_reduce(theta, ecdf):
    err = [(m - o) for m, o in zip(ecdf, GK_OBS)]
    return torch.sqrt(sum(e * e for e in err))


def make_gk_cost(probes):
    """The g-and-k cost: the ecdf at each probe point, streamed."""
    return kt.make_streaming_moment_cost(
        gk_draw, gk_reduce,
        stats=[(lambda x, t=t: (x < t).to(torch.float32)) for t in probes],
        ndraws=2000)


gk_prior = kt.Factored(kt.Uniform(0, 10), kt.Uniform(0, 5),
                       kt.Uniform(0, 10), kt.Uniform(0, 2.5))


def main(device=None, probes=None):
    """The Weibull and the g-and-k fits; ``probes``: the g-and-k probe
    points (default ``gk_probes(device)``)."""
    dev = resolve_device(device)
    probes = gk_probes(dev) if probes is None else tuple(
        float(t) for t in probes)
    res = kt.smc(prior, cost, nparticles=1024, alpha=ALPHA, epstol=0.01,
                 cost_vectorized=True, key=7, device=dev)
    kp, lamp = res.P
    print("shape k:", kp, f"  (true {TRUE_K})")
    print("scale lam:", lamp, f"  (true {TRUE_LAM})")
    print(f"eps: {res.eps:.4f}")
    assert kp.approx(TRUE_K, atol=0.25), kp
    assert lamp.approx(TRUE_LAM, atol=0.3), lamp

    res2 = kt.smc(gk_prior, make_gk_cost(probes), nparticles=1024,
                  alpha=ALPHA, epstol=0.02, cost_vectorized=True, key=3,
                  device=dev)
    names = "abgk"
    for name, true, p in zip(names, GK_TRUE, res2.P):
        print(f"g-and-k {name}: {p}   (true {true})")
    a_p, b_p, g_p, k_p = res2.P
    # all four parameters identify from 7 ecdf probes
    assert a_p.approx(3.0, atol=0.3), a_p
    assert b_p.approx(1.0, atol=0.35), b_p
    assert g_p.approx(2.0, atol=0.7), g_p
    assert k_p.approx(0.5, atol=0.4), k_p
    return res, res2


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
