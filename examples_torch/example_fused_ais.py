"""Generic fused AIS sweep: bring your own model to the fast kernel.

PyTorch counterpart of ``examples/example_fused_ais.py``. Demonstrates
``make_fused_ais_sweep`` (no counterpart in the reference) — the WHOLE
AIS half-update fused into one CUDA kernel for an arbitrary user model
(``kissabc_tpu_torch/csrc/generic.cuh``): 4:2:1 stretch/DE/walk mixture
proposal, the prior's logpdf, a streaming elementwise simulator,
kernelized MH accept, and the commit, all compiled from the PyTorch
callables below.

On the CPU this script runs the SAME model through the split path
(``make_sweep_halves`` + ``make_streaming_moment_cost``'s plain
version), the portable route — the fused kernel is the card's fast path
with the same statistics (different streams).

Model: Normal location-scale inference from 1000-draw summaries (the
reference README model, README.md:70-84) written in the
bring-your-own-elementwise contract:

    draw(theta, eps)       = mu + sigma * eps
    reduce_cost(theta, m)  = hypot(m1 - 2.0, (sd - 0.04) * 50)

    python examples_torch/example_fused_ais.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.core.ais import _halves, _unhalves, make_sweep_halves
from kissabc_tpu_torch.utils.device import resolve_device


prior = kt.Factored(kt.Uniform(1, 3), kt.TruncatedNormal(0, 0.05, 0, 100))
SCALE = 0.01   # the kernelized density's target average cost


def draw(th, eps):
    mu, sg = th
    return mu + sg * eps


def reduce_cost(th, m):
    var = torch.clamp(m[1] - m[0] * m[0], min=0.0)
    return torch.sqrt(torch.square(m[0] - 2.0)
                      + torch.square((torch.sqrt(var) - 0.04) * 50.0))


def main(device=None):
    """60 AIS sweeps of 4096 walkers: through the fused kernel on CUDA,
    through the split path on the CPU. Returns the final (mu, sigma)."""
    dev = resolve_device(device)
    n, sweeps = 4096, 60
    scost = kt.make_streaming_moment_cost(draw, reduce_cost)
    model = kt.ApproxKernelizedPosterior(prior, scost, SCALE,
                                         cost_vectorized=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    thetas = model.init_batch(gen, n)
    lds = model.loglike_batch(model.push(thetas), gen)

    gen = torch.Generator(device=dev).manual_seed(2)
    if dev.type == "cuda":
        sweep = kt.make_fused_ais_sweep(prior, draw, reduce_cost,
                                        scale=SCALE)
        th, ld = thetas, lds
        for _ in range(sweeps):
            th, ld = sweep(gen, th, ld)
        mu, sg = th
        path = "fused one-kernel-per-half (CUDA)"
    else:
        sweep = make_sweep_halves(model, n)
        th, ld = _halves(thetas, n // 2), _halves(lds, n // 2)
        for _ in range(sweeps):
            th, ld = sweep(gen, th, ld)
        mu, sg = _unhalves(th)
        path = "split make_sweep_halves (portable)"

    mu, sg = mu.double().cpu(), sg.double().cpu()
    print(f"path: {path}")
    print(f"mu    = {mu.mean():.4f} +- {mu.std(correction=0):.4f}   "
          "(truth 2.0)")
    print(f"sigma = {sg.mean():.4f} +- {sg.std(correction=0):.4f}   "
          "(truth 0.04)")
    assert abs(mu.mean() - 2.0) < 0.05
    assert abs(sg.mean() - 0.04) < 0.01
    print("OK")
    return mu, sg


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
