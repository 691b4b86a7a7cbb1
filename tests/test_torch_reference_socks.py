"""KissABC.jl's runtests socks problem on kissabc_tpu_torch
(``tests/test_reference_parity.py:14-72`` on the port): the prior
``Factored(NegativeBinomial(...), Beta(15, 2))`` that the port could not
build before its univariate families, the per-walker socks cost mapped
with ``torch.func.vmap`` equal bit for bit to a loop over the walkers,
and ``smc`` and the AIS ``sample`` at the reference parity file's
settings, held to its bands, on the CPU (each takes a few seconds).
"""

import numpy as np
import torch
from torch.func import vmap

import kissabc_tpu_torch as kt
from kissabc_tpu_torch import models
from torch_threads import one_torch_thread  # noqa: F401


def test_socks_prior_matches_reference_parameters():
    prior, _ = models.socks()
    nb, beta = prior.p
    size = -30 ** 2 / (30 - 15 ** 2)
    assert np.isclose(float(nb.r), size) and np.isclose(
        float(nb.p), size / (30 + size))
    assert (float(beta.alpha), float(beta.beta)) == (15.0, 2.0)
    assert np.isclose(kt.mean(nb), 30.0, rtol=1e-5)
    assert np.isclose(kt.std(nb), 15.0, rtol=1e-5)


def test_socks_cost_under_vmap_equals_a_loop():
    """64 walkers, the uniforms given: vmap of ``socks_sim`` equals the
    loop over walkers bit for bit, and the counts are those of the
    reference's simulator (pairs + odds = min(n, 11))."""
    prior, _ = models.socks()
    g = torch.Generator()
    g.manual_seed(3)
    n_socks, prop = prior.push_tree(prior.sample_tree(g, 64))
    n_socks = torch.cat([n_socks[:60], torch.tensor([0, 1, 11, 600],
                                                    dtype=torch.int32)])
    r = torch.rand((64, models.SOCKS_MAXN), generator=g)
    pairs, odds = vmap(models.socks_sim)(n_socks, prop, r)
    for i in range(64):
        p1, o1 = models.socks_sim(n_socks[i], prop[i], r[i])
        assert int(p1) == int(pairs[i]) and int(o1) == int(odds[i])
    picked = torch.clamp(n_socks, max=11)
    assert torch.equal(pairs * 2 + odds, picked)
    assert (pairs >= 0).all() and (odds >= 0).all()
    # a drawer of single socks gives no pair; one of pairs only, few odds
    p0, o0 = models.socks_sim(torch.tensor(40), torch.tensor(0.0), r[0])
    assert int(p0) == 0 and int(o0) == 11


def test_socks_smc():
    """Posterior means ~= (46.2, 0.866) (runtests.jl:59-60,73-74)."""
    prior, cost = models.socks()
    res = kt.smc(prior, cost, nparticles=2000, alpha=0.95, r_epstol=0,
                 epstol=0.01, key=11, device="cpu")
    n_post, p_post = res.P
    assert abs(n_post.mean() - 46.2) < 4.0
    assert abs(p_post.mean() - 0.866) < 0.03
    assert np.allclose(n_post.particles, np.round(n_post.particles))


def test_socks_ais():
    """The same posterior through AIS and ApproxPosterior
    (runtests.jl:57-60)."""
    prior, cost = models.socks()
    model = kt.ApproxPosterior(prior, cost, 0.1)
    n_post, p_post = kt.sample(model, kt.AIS(500), 2000, ntransitions=20,
                               discard_initial=4000, key=12, device="cpu")
    assert abs(n_post.mean() - 46.2) < 5.0
    assert abs(p_post.mean() - 0.866) < 0.04
    assert np.allclose(n_post.particles, np.round(n_post.particles))
