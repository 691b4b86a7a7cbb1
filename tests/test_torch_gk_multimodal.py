"""The g-and-k and multimodal tests of ``tests/test_gk_multimodal.py`` on
kissabc_tpu_torch, on the CPU, with the JAX tests' settings, keys and
bands:

- g-and-k inference on the JAX example's observed octiles
  (``examples/example_gk.py`` ``DATA_SUMM``) with the port example's
  simulator (``examples_torch/example_gk.py``), smc at 1024 particles,
  alpha 0.9, eps 0.08, key 21; a, b and k within the JAX test's bands
  of the truth. (``tests/test_torch_examples_smc.py``'s
  ``test_example_gk_against_jax`` holds the walkthrough itself, at
  other settings: 512 particles, alpha 0.95, eps 0.05, key 1.)
- a bimodal posterior (modes at +-2): both modes survive smc on one
  device (key 22), and on a walker mesh of 8 CPU shards
  (``make_mesh(walker=8, devices=["cpu"] * 8)``, key 23), where the
  sharded run equals the unsharded one as the JAX test holds it. The
  JAX test skips the mesh case without 8 devices; the port's mesh of
  CPU shards needs none.
"""

import numpy as np
import torch
from walkthroughs import jax_example, one_torch_thread, torch_example  # noqa: F401

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.parallel.mesh import make_mesh


def test_gk_inference():
    data = torch.as_tensor(np.array(jax_example("example_gk").DATA_SUMM),
                           dtype=torch.float32)
    ex = torch_example("example_gk")

    def cost(theta, gen):
        s = ex.quantiles(ex.gk_sample(gen, theta), ex.OCTILES)
        return torch.sqrt(torch.mean(torch.square(s - data)))

    res = kt.smc(ex.prior, cost, nparticles=1024, alpha=0.9, epstol=0.08,
                 key=21, device="cpu")
    a, b, g, k = res.P
    # location and scale recover tightly; g (skewness) is weakly
    # identified from octiles, k moderately
    assert abs(a.mean() - ex.TRUE[0]) < 0.3
    assert abs(b.mean() - ex.TRUE[1]) < 0.5
    assert abs(k.mean() - ex.TRUE[3]) < 0.4


def _bimodal_cost(x, gen):
    # posterior modes at x = +-2
    return torch.abs(x * x - 4.0) + 0.1 * torch.abs(
        torch.randn((), generator=gen, device=gen.device))


def test_multimodal_mixing_single_chip():
    prior = kt.Uniform(-10, 10)
    res = kt.smc(prior, _bimodal_cost, nparticles=1000, alpha=0.9,
                 epstol=0.2, key=22, device="cpu")
    x = res.P.particles
    frac_pos = (x > 0).mean()
    assert 0.2 < frac_pos < 0.8  # both modes survive
    assert np.abs(np.abs(x) - 2).mean() < 0.2


def test_multimodal_mixing_sharded():
    """The sharded population behaves as one: both modes populated on a
    walker mesh, and equal to the unsharded run (same key)."""
    mesh = make_mesh(walker=8, devices=["cpu"] * 8)
    prior = kt.Uniform(-10, 10)
    res = kt.smc(prior, _bimodal_cost, nparticles=1024, alpha=0.9,
                 epstol=0.2, mesh=mesh, key=23, device="cpu")
    x = res.P.particles
    frac_pos = (x > 0).mean()
    assert 0.2 < frac_pos < 0.8
    res2 = kt.smc(prior, _bimodal_cost, nparticles=1024, alpha=0.9,
                  epstol=0.2, key=23, device="cpu")
    np.testing.assert_allclose(np.sort(x), np.sort(res2.P.particles),
                               rtol=1e-5)
