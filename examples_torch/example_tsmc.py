"""Adaptive tempered SMC with evidence estimation (beyond the reference).

PyTorch counterpart of ``examples/example_tsmc.py``. Classical Bayesian
inference on a conjugate-normal model where posterior AND marginal
likelihood (evidence) have closed forms — tsmc recovers both, with the
temperature ladder chosen adaptively.

    python examples_torch/example_tsmc.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import scipy.stats as st
import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.utils.device import resolve_device

Y = np.array([1.2, 0.8, 1.5, 0.9, 1.1, 1.3, 0.7, 1.0], dtype=np.float32)
K = len(Y)


def loglike_elem(theta):
    """The log-likelihood as elementwise math with the data as
    constants: the form the fused tempered sweep compiles."""
    s = 0.0
    for v in Y:
        s = s + torch.square(float(v) - theta)
    return -0.5 * s - float(np.float32(K / 2 * np.log(2 * np.pi)))


def main(device=None):
    """tsmc split and through the fused tempered sweep; returns both
    results and the analytic log-evidence."""
    dev = resolve_device(device)
    y = torch.from_numpy(Y).to(dev)

    def loglike(theta):
        return -0.5 * torch.sum((y - theta) ** 2) - K / 2 * np.log(2 * np.pi)

    res = kt.tsmc(kt.Normal(0, 1), loglike, nparticles=4000, mcmc_steps=5,
                  device=dev)
    post_mean = Y.sum() / (K + 1)
    post_sd = 1 / np.sqrt(K + 1)
    logz = st.multivariate_normal(
        np.zeros(K), np.eye(K) + np.ones((K, K))).logpdf(Y)
    print(f"posterior:    {res.P}   "
          f"(analytic {post_mean:.4f} ± {post_sd:.4f})")
    print(f"log-evidence: {res.log_evidence:.3f}   (analytic {logz:.3f})")
    print(f"temperatures: {res.iterations} adaptive steps, "
          f"final ESS {res.ess:.0f}")

    # Fused tempered rejuvenation: the same likelihood as elementwise
    # math (loglike_elem), compiled into one CUDA kernel per red/black
    # half-update (csrc/tempered.cuh), the temperature read from device
    # memory. On the CPU the sweep runs the kernel's plain PyTorch
    # version.
    sweep = kt.make_fused_tempered_sweep(kt.Normal(0, 1), loglike_elem)
    resf = kt.tsmc(kt.Normal(0, 1), loglike, nparticles=4000, mcmc_steps=5,
                   sweep_fused=sweep, device=dev)
    print(f"fused:        {resf.P}   log-evidence {resf.log_evidence:.3f}")
    return res, resf, float(logz)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
