"""Exponential-mixture benchmark — the reference's commented-out heavy
benchmark (reference ``test/runtests.jl:256-274``).

PyTorch counterpart of ``examples/example_expmix.py``: infer (u1, p1) of
a two-scale exponential mixture from std+median summary statistics
computed on n = 10^6 simulated draws per cost call.

With the expected posterior concentrated at u1 ~ 0.49, p1 ~ 0.88
(the reference's recorded early-stop CI: u1 in [0.490, 0.495],
p1 in [0.880, 0.883]).

This is the heavy-simulator stress case: each cost call is 10^6
exponential + uniform draws and a median (a sort of the 10^6 draws).
Walkers are evaluated batched (vmap), so a 100-walker AIS sweep
simulates 10^8 draws per half-sweep — all on the card.

    python examples_torch/example_expmix.py [NDRAWS] [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.utils.device import resolve_device

NDRAWS = 10**6


def cost(theta, gen, n=NDRAWS):
    u1, p1 = theta
    u2 = (1.0 - u1 * p1) / (1.0 - p1)
    # standard exponential by inversion of U[0, 1), as jax.random does
    a = -torch.log1p(-torch.rand(n, generator=gen, device=gen.device))
    b = torch.rand(n, generator=gen, device=gen.device)
    x = a * torch.where(b < p1, u1, u2)
    # Julia std is corrected (ddof=1)
    sd = torch.std(x, correction=1)
    # the median as numpy's: the mean of the two middle order statistics
    xs = torch.sort(x).values
    med = 0.5 * (xs[(n - 1) // 2] + xs[n // 2])
    return torch.sqrt(((sd - 2.2) / 2.2) ** 2 + ((med - 0.4) / 0.4) ** 2)


prior = kt.Factored(kt.Uniform(0, 1), kt.Uniform(0.5, 1))


def main(device=None, ndraws=NDRAWS):
    """AIS(100), 100 samples after 2000 discarded sweeps, of the
    ``ndraws``-draw cost."""
    dev = resolve_device(device)
    plan = kt.ApproxPosterior(prior, lambda th, g: cost(th, g, ndraws), 0.01)
    res = kt.sample(plan, kt.AIS(100), 100, discard_initial=2000, key=1,
                    device=dev)
    u1p, p1p = res
    print("u1:", u1p, "  (reference CI [0.490, 0.495])")
    print("p1:", p1p, "  (reference CI [0.880, 0.883])")
    return res


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ndraws", nargs="?", type=int, default=NDRAWS,
                    help="draws per cost call (default 10^6)")
    ap.add_argument("--device", help="cuda (the default) or cpu")
    args = ap.parse_args()
    main(device=args.device, ndraws=args.ndraws)
