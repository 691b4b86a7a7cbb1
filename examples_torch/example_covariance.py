"""Covariance-matrix inference with matrix-variate priors.

PyTorch counterpart of ``examples/example_covariance.py``. Estimate the
full covariance of correlated bivariate data with a separation-strategy
prior (Barnard-McCulloch-Meng): a correlation matrix R ~ LKJ(2, eta=1)
and per-axis scales s_i ~ LogUniform, combined inside the cost as
Sigma = diag(s) R diag(s). Matrix leaves flow through the samplers like
any other parameter: proposals evolve the d x d leaf elementwise and
the push projects it back onto the correlation manifold (symmetrize +
unit diagonal), the matrix analogue of the reference's round-to-int
policy for discrete marginals (reference ``src/types.jl:27-32``).

The cost compares simulated summary statistics (per-axis std and the
correlation coefficient) to the observed ones — no likelihood needed.
Proposals can leave the manifold, so the cost factors R with
``torch.linalg.cholesky_ex``, which does not raise there. The observed
data come from numpy's generator seeded 1, as in the JAX example, so
both see the same data.

    python examples_torch/example_covariance.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.utils.device import resolve_device

TRUE_R = 0.6
TRUE_S = (1.5, 0.7)
NOBS = 2000


def simulate(gen, R, s1, s2, n=NOBS):
    cl, _ = torch.linalg.cholesky_ex(R)
    z = torch.randn((n, 2), generator=gen, device=gen.device) @ cl.T
    return z * torch.stack([s1, s2])


def summaries(x):
    sd = torch.std(x, dim=0, correction=0)
    r = torch.mean(x[:, 0] * x[:, 1]) / (sd[0] * sd[1])
    return sd[0], sd[1], r


def main(device=None):
    dev = resolve_device(device)
    true_cov = np.diag(TRUE_S) @ np.array(
        [[1.0, TRUE_R], [TRUE_R, 1.0]]) @ np.diag(TRUE_S)
    rng = np.random.default_rng(1)
    obs = rng.multivariate_normal([0.0, 0.0], true_cov, size=NOBS)
    obs_s1, obs_s2 = np.std(obs, axis=0)
    obs_r = np.corrcoef(obs.T)[0, 1]
    print(f"observed: s1={obs_s1:.3f} s2={obs_s2:.3f} r={obs_r:.3f}")

    prior = kt.Factored(kt.LKJ(2, 1.0),
                        kt.LogUniform(0.1, 10.0),
                        kt.LogUniform(0.1, 10.0))

    o1, o2, orr = (float(np.float32(v)) for v in (obs_s1, obs_s2, obs_r))

    def cost(theta, gen):
        R, s1, s2 = theta
        s1h, s2h, rh = summaries(simulate(gen, R, s1, s2))
        return (torch.abs(s1h - o1) / o1 + torch.abs(s2h - o2) / o2
                + torch.abs(rh - orr))

    # no epstol: let the reference's own eps-stall stopping rule fire;
    # max_iters stays as a pure safety backstop
    res = kt.smc(prior, cost, nparticles=256, max_iters=400, key=11,
                 device=dev)
    # P components row-major: [R00, R01, R10, R11, s1, s2]
    r_post, s1_post, s2_post = res.P[1], res.P[4], res.P[5]
    print(f"posterior: r = {r_post}, s1 = {s1_post}, s2 = {s2_post}, "
          f"eps = {float(res.eps):.4f}")
    assert abs(r_post.mean() - obs_r) < 0.1
    assert abs(s1_post.mean() - obs_s1) < 0.15
    assert abs(s2_post.mean() - obs_s2) < 0.1
    return res, (obs_r, obs_s1, obs_s2)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
