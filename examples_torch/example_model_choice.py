"""ABC model choice via acceptance-mass evidence.

PyTorch counterpart of ``examples/example_model_choice.py``. Two
candidate simulators for overdispersion-free count data (truth:
Poisson(4) — mean 4, variance 4):

- model A: Poisson(theta)            — can match both moments;
- model B: Geometric with mean theta — forces variance theta*(1+theta),
  so at mean 4 its variance is 20: structurally misspecified.

The ABC evidence for a model at threshold eps is the acceptance mass
``Z = P(cost <= eps | prior)`` (Didelot 2011; Del Moral 2012). This
package estimates it two independent ways, and this example checks they
agree before using them:

1. ``smc(...).log_evidence`` — telescoping product of per-iteration
   survival fractions along the adaptive eps ladder;
2. ``abc_rejection(..., eps=...).log_evidence`` — the direct Monte-Carlo
   estimate naccept/nsims at the same threshold.

The log Bayes factor log(Z_A/Z_B) at a common eps then quantifies how
decisively the data reject the misspecified simulator.

    python examples_torch/example_model_choice.py [--device cpu]
"""

import math
import os
import sys
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.utils.device import resolve_device

M = 200          # draws per simulated dataset
OBS_MEAN = 4.0   # observed summary statistics (truth: Poisson(4))
OBS_VAR = 4.0


def summaries_cost(mean_sim, var_sim):
    return torch.hypot(mean_sim - OBS_MEAN, (var_sim - OBS_VAR) / 2.0)


def cost_poisson(theta, gen):
    # smc simulates every proposal and masks after the prior gate, so a
    # rate below the prior's support is clamped (torch.poisson raises on
    # a negative rate); its walker is rejected all the same
    rate = torch.clamp(theta, min=0.0).expand(M)
    x = torch.poisson(rate, generator=gen)
    return summaries_cost(torch.mean(x), torch.var(x, correction=0))


def cost_geometric(theta, gen):
    # Geometric (number of failures) with mean theta: p = 1/(1+theta),
    # sampled by inversion k = floor(log U / log(1-p)), U in [1e-12, 1)
    p = 1.0 / (1.0 + theta)
    u = 1e-12 + (1.0 - 1e-12) * torch.rand(M, generator=gen,
                                             device=gen.device)
    x = torch.floor(torch.log(u) / torch.log1p(-p))
    return summaries_cost(torch.mean(x), torch.var(x, correction=0))


def main(device=None):
    dev = resolve_device(device)
    prior = kt.Uniform(0.0, 10.0)

    # --- fit model A with smc; its evidence comes for free ------------
    res_a = kt.smc(prior, cost_poisson, nparticles=1024, epstol=1.5, key=1,
                   device=dev)
    theta = res_a.P
    print(f"model A posterior: theta = {theta}  (truth 4.0), "
          f"eps = {res_a.eps:.3f}")
    assert theta.approx(4.0, atol=0.3)

    # --- cross-check the smc evidence against plain rejection ---------
    # at the SAME realized threshold: two independent estimators of
    # P(cost <= eps | prior)
    rej_a = kt.abc_rejection(prior, cost_poisson, 256, eps=res_a.eps,
                             batch=8192, max_sims=2**21, key=2, device=dev)
    print(f"log Z_A: smc telescoping = {res_a.log_evidence:.3f}, "
          f"rejection MC = {rej_a.log_evidence:.3f}")
    assert abs(res_a.log_evidence - rej_a.log_evidence) < 0.5

    # --- model B at the same threshold ---------------------------------
    # variance 20 vs observed 4 keeps its best-case cost ~2.2, so its
    # acceptance mass at the same eps collapses; it may not fill its
    # particle buffer within max_sims: that IS the finding
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="abc_rejection: only")
        rej_b = kt.abc_rejection(prior, cost_geometric, 256, eps=res_a.eps,
                                 batch=8192, max_sims=2**21, key=3,
                                 device=dev)
    if rej_b.naccept == 0:
        # zero acceptances in nsims draws: Z_B < 1/nsims w.h.p. — report
        # the resulting lower bound on the Bayes factor
        log_bf = rej_a.log_evidence + math.log(rej_b.nsims)
        print(f"log Z_B (rejection) < {-math.log(rej_b.nsims):.2f} "
              f"(0 acceptances in {rej_b.nsims} sims)")
        print(f"log Bayes factor A vs B > {log_bf:.2f} "
              f"(> 2 means decisive for A)")
    else:
        log_bf = rej_a.log_evidence - rej_b.log_evidence
        print(f"log Z_B (rejection) = {rej_b.log_evidence:.3f}")
        print(f"log Bayes factor A vs B = {log_bf:.2f} "
              f"(> 2 means decisive for A)")
    assert log_bf > 2.0
    return res_a, rej_a, rej_b, log_bf


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
