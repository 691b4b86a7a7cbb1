"""Karl Broman's socks problem — mixed discrete/continuous prior.

PyTorch counterpart of ``examples/example_socks.py``, the classic ABC
teaching example (reference ``test/runtests.jl:30-75``): 11 socks were
picked from the laundry and all 11 were singletons — how many socks are
there, and what fraction are pairs? The prior mixes a DISCRETE count
(NegativeBinomial) with a CONTINUOUS proportion (Beta); `Factored`
handles the mix, and the push keeps the count an integer wherever the
user sees it while the ensemble evolves in float.

The simulator (``kissabc_tpu_torch.models.socks_sim``) picks
``min(n_socks, 11)`` socks without replacement with static shapes: the
drawer's sock ids, pairs first, and the socks with the 11 smallest of
512 uniforms picked; pairs are counted by sorting the picked ids.

    python examples_torch/example_socks.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.models import SOCKS_MAXN, socks_sim
from kissabc_tpu_torch.utils.device import resolve_device


def main(device=None):
    dev = resolve_device(device)
    # prior from the reference: mean 30, sd 15 over the count
    prior_mu, prior_sd = 30, 15
    prior_size = -prior_mu**2 / (prior_mu - prior_sd**2)
    prior = kt.Factored(
        kt.NegativeBinomial(prior_size, prior_size / (prior_mu + prior_size)),
        kt.Beta(15, 2),
    )

    def cost(theta, gen):
        n_socks, prop_pairs = theta
        r = torch.rand(SOCKS_MAXN, generator=gen, device=gen.device)
        sample_pairs, sample_odds = socks_sim(n_socks, prop_pairs, r)
        # observed: 0 pairs, 11 odd socks
        return (torch.abs(sample_pairs - 0) + torch.abs(sample_odds - 11)
                ).to(torch.float32)

    res = kt.smc(prior, cost, nparticles=5000, epstol=0.01, max_iters=60,
                 key=0, device=dev)
    n_socks, prop_pairs = res.P
    print(f"n_socks    = {n_socks}   (reference posterior mean ~46.2)")
    print(f"prop_pairs = {prop_pairs}   (reference posterior mean ~0.866)")
    assert n_socks.approx(46.2, atol=4.0)
    assert prop_pairs.approx(0.866, atol=0.06)
    # the count is an integer in the returned sample (the push)
    assert float(n_socks.particles[0]) == int(n_socks.particles[0])
    return res


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
