"""Stochastic SIR epidemic ABC with the sequential-simulator kernel.

PyTorch counterpart of ``examples/example_sir.py``. The classic
epidemiology use of likelihood-free inference: infer the infection rate
beta and recovery rate gamma of a stochastic SIR model from an observed
daily infection curve. The likelihood of the jump process is
intractable; ABC matches simulated curves to the data.

Simulator: Euler–Maruyama diffusion approximation of the SIR CTMC with
demographic noise,

    dN_inf ~= (beta S I / N) dt + sqrt(beta S I / N dt) eps1
    dN_rec ~= (gamma I) dt     + sqrt(gamma I dt) eps2
    S -= dN_inf ; I += dN_inf - dN_rec

Each day needs TWO independent noises, but ``step`` receives ONE noise
per call — so each day is folded into two kernel sub-steps (infection on
even t, recovery on odd t), the pattern ``make_streaming_scan_cost``
prescribes for multi-noise transitions. The observed curve enters
through ``series=`` (zeros on infection sub-steps, the day's observed I
on recovery sub-steps) and the observation masks itself to odd t. The
state is the tuple (S, I). The model's ``step``, ``init`` and
``observe`` are ``kissabc_tpu_torch.models.sir()``'s; the cost runs in
the CUDA scan kernel (``csrc/scan.cuh``) on the card and in its plain
PyTorch version on the CPU.

    python examples_torch/example_sir.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import kissabc_tpu_torch as kt
from kissabc_tpu_torch import models
from kissabc_tpu_torch.utils.device import resolve_device

POP, I0, DAYS = models.SIR_POP, models.SIR_I0, models.SIR_DAYS
TRUE_BETA, TRUE_GAMMA = 0.3, 0.1   # R0 = 3


def main(device=None, series=None):
    """smc on the SIR model; ``series``: the observed curve on the
    recovery sub-steps, zeros between (default ``models.sir_series()``,
    the deterministic solution at the true parameters)."""
    dev = resolve_device(device)
    prior, step, init, observe, reduce_cost, observed = models.sir()
    series = observed if series is None else np.asarray(series, np.float32)
    cost = kt.make_streaming_scan_cost(
        step, init, reduce_cost, observe=observe, series=series,
        nsteps=2 * DAYS)
    res = kt.smc(prior, cost, nparticles=1024, cost_vectorized=True,
                 key=7, device=dev)
    beta_post, gamma_post = res.P
    r0 = beta_post.particles / gamma_post.particles
    print(f"beta : {beta_post.mean():.3f} ± {beta_post.std():.3f}"
          f"   (truth {TRUE_BETA})")
    print(f"gamma: {gamma_post.mean():.3f} ± {gamma_post.std():.3f}"
          f"   (truth {TRUE_GAMMA})")
    print(f"R0   : {float(np.mean(r0)):.2f}         (truth "
          f"{TRUE_BETA / TRUE_GAMMA:.1f})")
    assert abs(beta_post.mean() - TRUE_BETA) < 0.08
    assert abs(gamma_post.mean() - TRUE_GAMMA) < 0.05
    assert abs(float(np.mean(r0)) - 3.0) < 0.8
    return res


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
