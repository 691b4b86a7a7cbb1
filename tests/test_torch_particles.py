"""The ``Particles`` tests of ``tests/test_particles.py`` on
kissabc_tpu_torch (constructors, p-statistics, the two-sided approx,
algebra and numpy ufuncs, comparisons, ``hpdi``, tree bundling,
pickling, the MonteCarloMeasurements sugar and the reference's
sigma-point workflow), with the JAX tests' values, keys and bands.

Three JAX tests are held against the JAX package already, in
``tests/test_torch_particles_helpers.py``, and are not repeated here:

- ``test_chainsstack``: ``test_chainsstack_and_pmap_apply_equal_jax``
  (the stacked clouds equal the JAX package's, lengths included);
- ``test_sigmapoints_moments_exact`` and
  ``test_sigmapoints_tuple_and_missing_S``: ``test_sigmapoints_equal_jax``
  (the points equal the JAX package's for the matrix, scalar and tuple
  forms; their moments; the missing-covariance ``TypeError``).

``test_pm_independent_clouds_combine_in_quadrature`` keeps only what
``test_pm_equal_jax_and_independent`` there does not hold.
"""

import copy
import pickle

import numpy as np
import pytest
import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.particles import particles_from_tree
from torch_threads import one_torch_thread  # noqa: F401


def test_sampling_constructor():
    p = kt.Particles(20_000, kt.Normal(1.5, 0.7), key=3)
    assert len(p) == 20_000
    assert abs(p.mean() - 1.5) < 0.02
    assert abs(p.std() - 0.7) < 0.02
    # a discrete family's draws stay integers, int32 as in the JAX package
    q = kt.Particles(5_000, kt.Poisson(4.0), key=1)
    assert q.particles.dtype == np.int32
    assert abs(q.mean() - 4.0) < 0.15
    r = kt.Particles(5_000, kt.DiscreteUniform(0, 5), key=1)
    assert r.particles.dtype == np.int32


def test_p_functions():
    p = kt.Particles(np.arange(101, dtype=np.float32))
    assert kt.pmean(p) == 50.0
    assert kt.pmedian(p) == 50.0
    assert abs(kt.pstd(p) - np.std(np.arange(101.0), ddof=1)) < 1e-6
    assert kt.pquantile(p, 0.25) == 25.0
    assert kt.pmean([1.0, 3.0]) == 2.0


def test_two_sided_approx():
    a = kt.Particles(np.random.default_rng(0).normal(0.0, 1.0, 4000))
    tight = kt.Particles(np.random.default_rng(1).normal(0.5, 0.01, 4000))
    assert tight.approx(a)
    assert a.approx(tight)
    assert not tight.approx(kt.Particles(
        np.random.default_rng(2).normal(5.0, 0.01, 4000)))


def test_algebra_and_map():
    p = kt.Particles(np.array([1.0, 2.0, 3.0]))
    assert np.allclose(((p + 1) * 2).particles, [4.0, 6.0, 8.0])
    assert np.allclose((1 - p).particles, [0.0, -1.0, -2.0])
    assert np.allclose((p ** 2).particles, [1.0, 4.0, 9.0])
    assert np.allclose(p.map(np.exp).particles, np.exp([1.0, 2.0, 3.0]))


def test_ufunc_propagation():
    p = kt.Particles(np.array([0.0, np.pi / 2, np.pi]))
    s = np.sin(p)
    assert isinstance(s, kt.Particles)
    assert np.allclose(s.particles, [0.0, 1.0, 0.0], atol=1e-12)
    q = np.maximum(p, np.pi / 4)
    assert isinstance(q, kt.Particles)
    assert np.allclose(q.particles, [np.pi / 4, np.pi / 2, np.pi])
    m = np.add(np.array([1.0, 2.0, 3.0]), p)
    assert isinstance(m, kt.Particles)
    frac, whole = np.modf(kt.Particles(np.array([1.5, 2.25, -0.5])))
    assert isinstance(frac, kt.Particles) and isinstance(whole, kt.Particles)
    assert np.allclose(frac.particles, [0.5, 0.25, -0.5])
    assert np.allclose(np.add.reduce(p), np.pi * 1.5)


def test_comparisons_and_extra_dunders():
    p = kt.Particles(np.random.default_rng(0).normal(0.0, 1.0, 20_000))
    mask = p > 0
    assert isinstance(mask, kt.Particles)
    assert abs(mask.mean() - 0.5) < 0.02
    assert abs((p < 1.0).mean() - 0.8413) < 0.02
    d = kt.Particles(np.array([1.0, 2.0, 3.0]))
    assert np.allclose((d % 2).particles, [1.0, 0.0, 1.0])
    assert np.allclose((d // 2).particles, [0.0, 1.0, 1.0])
    assert np.allclose((2 ** d).particles, [2.0, 4.0, 8.0])
    eq = d == 2.0
    assert isinstance(eq, kt.Particles)
    assert eq.mean() == 1.0 / 3.0
    assert (d != 2.0).mean() == 2.0 / 3.0
    with pytest.raises(ValueError):
        bool(eq)
    assert bool(kt.Particles(np.array([5.0])) == 5.0)


def test_hpdi():
    rng = np.random.default_rng(0)
    p = kt.Particles(rng.normal(0.0, 1.0, 100_000))
    lo, hi = kt.hpdi(p, 0.95)
    assert abs(lo + 1.96) < 0.05 and abs(hi - 1.96) < 0.05
    q = kt.Particles(rng.exponential(1.0, 100_000))
    lo, hi = kt.hpdi(q, 0.9)
    assert lo < 0.01
    eq_lo, eq_hi = np.quantile(q.particles, [0.05, 0.95])
    assert (hi - lo) < (eq_hi - eq_lo)
    frac = float(((q.particles >= lo) & (q.particles <= hi)).mean())
    assert abs(frac - 0.9) < 0.005
    assert kt.hpdi(np.arange(101.0), 0.5)[0] >= 0.0
    assert kt.hpdi(np.array([3.0])) == (3.0, 3.0)
    with pytest.raises(ValueError):
        kt.hpdi(np.array([]))
    ivs = kt.hpdi([p, kt.Particles(rng.normal(100.0, 1.0, 10_000))], 0.95)
    assert len(ivs) == 2 and abs(ivs[1][0] - 98.04) < 0.2
    with pytest.raises(ValueError):
        kt.hpdi(np.zeros((2, 100)))


def test_tree_bundling_matrix_leaves():
    tree = (np.ones((10,)), np.arange(20.0).reshape(10, 2),
            np.arange(40.0).reshape(10, 2, 2))
    cols = particles_from_tree(tree)
    # 1 scalar + 2 vector + 4 matrix components
    assert len(cols) == 7
    # matrix components flatten row-major: entry (0, 1) of walker w is
    # 4w + 1
    assert np.allclose(cols[4].particles, 4 * np.arange(10.0) + 1)
    # torch leaves bundle as numpy leaves do
    tcols = particles_from_tree(tuple(torch.as_tensor(x) for x in tree))
    assert [c.particles.tolist() for c in tcols] == [
        c.particles.tolist() for c in cols]


def test_ufunc_reductions_return_python_scalars():
    rng = np.random.default_rng(3)
    p = kt.Particles(rng.standard_normal(64))
    for r in (np.max(p), np.min(p), np.add.reduce(p)):
        assert isinstance(r, float)
    assert isinstance(np.sin(p), kt.Particles)


def test_mcm_constructor_sugar():
    p = kt.Particles(2000)
    assert abs(p.mean()) < 1e-9
    assert abs(p.std() - 1.0) < 1e-3
    q = kt.pm(3.0, 0.5, 2000)
    assert abs(q.mean() - 3.0) < 1e-9 and abs(q.std() - 0.5) < 1e-3
    assert kt.plus_minus is kt.pm
    m = np.stack([np.zeros(10), np.ones(10)], axis=1)
    cols = kt.Particles(m)
    assert isinstance(cols, list) and len(cols) == 2
    assert cols[1].mean() == 1.0


def test_sigmapoints_reference_workflow():
    """The reference's commented workflow (smc.jl:225-236): smc on the
    banana cost, then ``Particles(sigmapoints(mean(R), cov(R)))``."""
    pp = kt.Factored(kt.Normal(0, 5), kt.Normal(0, 5))

    def cc(theta, gen):
        x, y = theta
        n1 = 0.01 * torch.randn((), generator=gen, device=gen.device)
        n2 = 0.01 * torch.randn((), generator=gen, device=gen.device)
        return 50 * (x + n1 - y ** 2) ** 2 + (y - 1 + n2) ** 2

    R = kt.smc(pp, cc, alpha=0.95, nparticles=128, epstol=2.0,
               max_iters=100, key=0, device="cpu").P
    sP = kt.Particles(kt.sigmapoints(kt.mean(R), kt.cov(R)))
    assert isinstance(sP, list) and len(sP) == 2
    np.testing.assert_allclose(
        [sP[0].mean(), sP[1].mean()], kt.mean(R), rtol=1e-6)
    np.testing.assert_allclose(kt.cov(sP), kt.cov(R), rtol=1e-5,
                               atol=1e-10)


def test_pm_independent_clouds_combine_in_quadrature():
    """Default-keyed clouds are independent, shared explicit keys give
    one cloud (the quadrature sum is held in the helpers' file)."""
    assert (kt.pm(1.0, 0.1) - kt.pm(1.0, 0.1)).std() > 0.05
    a = kt.pm(0.0, 1.0, key=7)
    b = kt.pm(0.0, 1.0, key=7)
    assert (a - b).std() == 0.0


def test_particles_pickle_deepcopy():
    p = kt.Particles(np.arange(10.0))
    for q in (copy.deepcopy(p), pickle.loads(pickle.dumps(p))):
        np.testing.assert_array_equal(q.particles, p.particles)
    with pytest.raises(TypeError):
        kt.Particles()
