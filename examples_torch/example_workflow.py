"""End-to-end ABC workflow: pilot-data prior via fit_mle, smc inference,
convergence diagnostics, posterior predictive check.

PyTorch counterpart of ``examples/example_workflow.py``. Demonstrates
the Distributions.jl function surface the reference re-exports working
together with the samplers: ``fit_mle`` builds a prior from pilot data,
``mean/std/insupport`` interrogate it, ``smc`` infers, and
``ess``/``rhat`` + a ``pmap_apply`` posterior predictive close the loop.
The model is the README Normal(mu, sigma) problem (reference
``README.md:30-67``).

    python examples_torch/example_workflow.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.utils.device import resolve_device


def observed(device):
    """(tdata, pilot): 1000 observations at mu=2, sigma=0.04 from the
    generator seeded 0, and a noisy pilot run of 64 draws near 2.1 with
    spread 0.5 from the generator seeded 9."""
    g0 = torch.Generator(device=device).manual_seed(0)
    g9 = torch.Generator(device=device).manual_seed(9)
    return (torch.randn(1000, generator=g0, device=device) * 0.04 + 2.0,
            torch.randn(64, generator=g9, device=device) * 0.5 + 2.1)


def main(device=None, tdata=None, pilot=None):
    dev = resolve_device(device)
    t0, p0 = observed(dev)
    tdata = t0 if tdata is None else torch.as_tensor(
        tdata, dtype=torch.float32, device=dev)
    pilot = p0 if pilot is None else torch.as_tensor(
        pilot, dtype=torch.float32, device=dev)

    # --- prior from pilot data (fit_mle, Distributions.jl idiom) ------
    mu_prior = kt.fit_mle(kt.Normal, pilot)
    print("pilot prior for mu:", mu_prior,
          "| mean:", round(float(kt.mean(mu_prior)), 3),
          "std:", round(float(kt.std(mu_prior)), 3))
    prior = kt.Factored(mu_prior, kt.LogUniform(1e-3, 1.0))
    assert bool(np.all(np.asarray(kt.insupport(prior, (2.0, 0.04)))))

    # --- ABC ingredients ----------------------------------------------
    t_mean, t_std = torch.mean(tdata), torch.std(tdata, correction=0)

    def cost(theta, gen):
        mu, sigma = theta
        x = torch.randn(1000, generator=gen, device=gen.device) * sigma + mu
        return torch.hypot(torch.mean(x) - t_mean,
                           (torch.std(x, correction=0) - t_std) * 50.0)

    # --- inference -----------------------------------------------------
    res = kt.smc(prior, cost, nparticles=512, epstol=0.012, key=42,
                 device=dev)
    mu_post, sg_post = res.P
    print("posterior:", mu_post, sg_post, "| eps:", round(res.eps, 4))

    # --- convergence diagnostics on an AIS cross-check ------------------
    abc = kt.ApproxPosterior(prior, cost, 0.02)
    chains = 4
    ais = kt.sample(abc, kt.AIS(64), 512, ntransitions=4, chains=chains,
                    key=7, device=dev)
    mu_chainwise = np.asarray(ais[0].particles).reshape(chains, -1)
    print("AIS mu:", ais[0],
          "| ess:", round(kt.ess(mu_chainwise), 1),
          "rhat:", round(kt.rhat(mu_chainwise), 4))
    assert kt.rhat(mu_chainwise) < 1.2

    # --- posterior predictive check -------------------------------------
    def predictive_mean(mus, sigmas):
        gen = torch.Generator(device=dev).manual_seed(3)
        m = torch.as_tensor(mus, device=dev)[:, None]
        s = torch.as_tensor(sigmas, device=dev)[:, None]
        x = torch.randn((m.shape[0], 1000), generator=gen, device=dev)
        return torch.mean(x * s + m, dim=1).cpu().numpy()

    pp = kt.pmap_apply(predictive_mean, mu_post, sg_post)
    print("posterior predictive mean:", pp,
          "| data mean:", round(float(t_mean), 4))
    assert pp.approx(float(t_mean), atol=0.01)
    return res, ais, pp


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
