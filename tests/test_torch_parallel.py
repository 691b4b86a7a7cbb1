"""Walker sharding of kissabc_tpu_torch's smc on a mesh of 8 CPU shards
(``make_mesh(walker=8, devices=["cpu"] * 8)``), mirroring the smc tests of
tests/test_parallel.py: the mesh's shape and names, ``constrainer``,
the sharded posterior, sharded equal to unsharded (bit for bit here: the
port draws every population-wide number on the whole population and
cuts it into shards, and runs a cost written in PyTorch on the joined
population, so even the default scheme and a stochastic per-walker cost
give the same bits; the JAX tests hold rtol 1e-5 and
equal iterations), ``smc_stepped`` checkpointed on the mesh and resumed
on the mesh or on one device, the SAME-mesh rule of ``sweep_fused``,
``shard_batched_cost`` and the top-level names. ~25 s in one process.
"""

import types

import numpy as np
import pytest
import torch

import kissabc_tpu as ka
import kissabc_tpu_torch as kt
from kissabc_tpu_torch import models
from kissabc_tpu_torch.parallel import mesh as M
from kissabc_tpu_torch.parallel.mesh import constrainer, make_mesh
from torch_threads import one_torch_thread  # noqa: F401


def _mesh(k=8):
    return make_mesh(walker=k, devices=["cpu"] * k)


def _problem():
    return kt.Normal(1, 0.2), (lambda x: torch.abs(x * x + 1 - 1.5))


def test_make_mesh():
    m = make_mesh(chain=2, walker=4, devices=["cpu"] * 8)
    assert m.axis_names == ("chain", "walker")
    assert m.devices.shape == (2, 4)
    assert m.shape == {"chain": 2, "walker": 4} and m.size == 8
    assert all(d == torch.device("cpu") for d in m.devices.flat)


def test_make_mesh_needs_the_devices():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"mesh needs {have + 1} devices, "
                                         f"have {have}"):
        make_mesh(walker=have + 1)
    with pytest.raises(ValueError, match="mesh needs 4 devices, have 2"):
        make_mesh(walker=4, devices=["cpu"] * 2)


def test_constrainer_identity_without_mesh():
    c = constrainer(None, "walker")
    x = torch.ones(4)
    assert c(x) is x


def test_constrainer_places_shards():
    mesh = _mesh(4)
    x = (torch.arange(16.0), torch.arange(16.0) * 2)
    sh = constrainer(mesh, "walker")(x)
    assert isinstance(sh, M.Sharded) and sh.index == [0, 1, 2, 3]
    assert torch.equal(sh.shards[2][1], x[1][8:12])
    joined = M.join(sh)
    assert all(torch.equal(a, b) for a, b in zip(joined, x))
    assert constrainer(mesh, "walker")(sh) is sh


def test_smc_sharded_walkers():
    pri, cost = _problem()
    res = kt.smc(pri, cost, nparticles=256, epstol=0.1, mesh=_mesh(), key=2)
    assert res.P.approx(0.707, atol=0.05)


@pytest.mark.parametrize("kw", [{}, {"partner_scheme": "roll"},
                                {"resample": "systematic"},
                                {"quantile_impl": "sort"}],
                         ids=["default", "roll", "systematic", "sort"])
def test_smc_sharded_matches_unsharded(kw):
    pri, cost = _problem()
    a = kt.smc(pri, cost, nparticles=128, epstol=0.1, key=3, device="cpu",
               **kw)
    b = kt.smc(pri, cost, nparticles=128, epstol=0.1, key=3, mesh=_mesh(),
               **kw)
    np.testing.assert_allclose(a.P.particles, b.P.particles, rtol=1e-5)
    assert a.iterations == b.iterations
    np.testing.assert_array_equal(a.P.particles, b.P.particles)
    np.testing.assert_array_equal(a.C, b.C)
    assert a.eps == b.eps and a.log_evidence == b.log_evidence


def test_stochastic_per_walker_cost_sharded_matches_unsharded():
    """The cost runs on the joined population, as on one device, and its
    costs are cut into shards: the README model's per-walker form gives
    the same bits on 4 shards and on one device."""
    def cost(theta, g):
        mu, sigma = theta
        x = mu + sigma * torch.randn(200, generator=g, device=g.device)
        return torch.hypot(x.mean() - 2.0, (x.std(correction=0) - 0.04) * 50)

    prior = kt.Factored(kt.Uniform(1, 3), kt.TruncatedNormal(0, 0.05, 0, 100))
    kw = dict(nparticles=128, epstol=0.3, key=5, max_iters=8)
    with pytest.warns(RuntimeWarning, match="max_iters"):
        a = kt.smc(prior, cost, device="cpu", **kw)
    with pytest.warns(RuntimeWarning, match="max_iters"):
        b = kt.smc(prior, cost, mesh=_mesh(4), **kw)
    for x, y in zip(a.P, b.P):
        np.testing.assert_array_equal(x.particles, y.particles)
    np.testing.assert_array_equal(a.C, b.C)


def test_smc_stepped_sharded_checkpoint_resume(tmp_path):
    """Checkpointed on the 8-shard mesh, stopped after 3 iterations,
    resumed on the mesh and on one device: both equal the uninterrupted
    sharded run bit for bit, which equals the unsharded smc."""
    pri, cost = _problem()
    mesh = _mesh()
    p = str(tmp_path / "sharded.npz")
    kw = dict(epstol=0.1, key=7, nparticles=128)
    full = kt.smc_stepped(pri, cost, mesh=mesh, **kw)
    with pytest.warns(RuntimeWarning, match="max_iters"):
        kt.smc_stepped(pri, cost, mesh=mesh, checkpoint_path=p,
                       checkpoint_every=1, max_iters=3, **kw)
    resumed = kt.smc_stepped(pri, cost, mesh=mesh, checkpoint_path=p,
                             checkpoint_every=1, resume=True, **kw)
    np.testing.assert_array_equal(resumed.P.particles, full.P.particles)
    assert resumed.iterations == full.iterations
    single = kt.smc_stepped(pri, cost, checkpoint_path=p, resume=True,
                            device="cpu", **kw)
    np.testing.assert_array_equal(single.P.particles, full.P.particles)
    # a checkpoint of one device resumes on a mesh of 4
    with pytest.warns(RuntimeWarning, match="max_iters"):
        kt.smc_stepped(pri, cost, checkpoint_path=p, checkpoint_every=1,
                       max_iters=2, device="cpu", **kw)
    four = kt.smc_stepped(pri, cost, mesh=_mesh(4), checkpoint_path=p,
                          resume=True, **kw)
    np.testing.assert_array_equal(four.P.particles, full.P.particles)
    unsharded = kt.smc(pri, cost, device="cpu", **kw)
    np.testing.assert_allclose(full.P.particles, unsharded.P.particles,
                               rtol=1e-5)


def test_sweep_fused_needs_the_same_mesh():
    prior, draw, rc = models.flagship()
    mesh = _mesh(4)
    cost = kt.shard_batched_cost(kt.make_streaming_moment_cost(draw, rc),
                                 mesh)
    for fn in (kt.smc, kt.smc_stepped):
        for sweep in (kt.make_fused_smc_sweep(prior, draw, rc),
                      kt.make_fused_smc_sweep(prior, draw, rc,
                                              mesh=_mesh(4)),
                      kt.make_fused_flagship_sweep(128)):
            with pytest.raises(ValueError, match="SAME mesh"):
                fn(prior, cost, cost_vectorized=True, sweep_fused=sweep,
                   mesh=mesh, nparticles=128)


def test_mesh_must_be_a_mesh():
    pri, cost = _problem()
    for fn in (kt.smc, kt.smc_stepped):
        with pytest.raises(TypeError, match="object"):
            fn(pri, cost, mesh=object(), device="cpu")


def test_population_must_divide_the_mesh():
    pri, cost = _problem()
    with pytest.raises(ValueError, match="nparticles=100 must divide"):
        kt.smc(pri, cost, mesh=_mesh(), epstol=0.1)
    with pytest.raises(ValueError, match="other axes of size 1"):
        kt.smc(pri, cost, nparticles=128, epstol=0.1,
               mesh=make_mesh(chain=2, walker=4, devices=["cpu"] * 8))


def test_shard_batched_cost_runs_each_shard_with_its_seed():
    """One seed word from the generator (as the unsharded cost draws
    it), then the kernel cost's plain version once per shard with
    ``seed + (shard + 1) * 2**20``: four distinct seeds, and each shard's
    costs those of ``seeded`` on its block."""
    prior, draw, rc = models.flagship()
    mesh = _mesh(4)
    for base in (kt.make_flagship_cost_batched(ndraws=100),
                 kt.make_streaming_moment_cost(draw, rc, ndraws=100)):
        cost = kt.shard_batched_cost(base, mesh)
        gen = torch.Generator().manual_seed(3)
        th = prior.sample_tree(gen, 256)
        out = cost(th, torch.Generator().manual_seed(9))
        seed = kt.ops.streaming.uint32_words(
            torch.Generator().manual_seed(9), 1)
        seeds = {int(M.fold_seed(seed, g)) for g in range(4)}
        assert len(seeds) == 4 and all(s < 2 ** 32 for s in seeds)
        for g in range(4):
            block = tuple(x[g * 64:(g + 1) * 64] for x in th)
            want = base.seeded(block, M.fold_seed(seed, g))
            assert torch.equal(out.shards[g], want)
        assert not torch.equal(out.shards[0], out.shards[1])
    with pytest.raises(TypeError, match="seeded"):
        kt.shard_batched_cost(lambda th, g: th[0], mesh)


def test_kernel_cost_on_a_mesh_needs_shard_batched_cost():
    prior, draw, rc = models.flagship()
    cost = kt.make_streaming_moment_cost(draw, rc, ndraws=50)
    with pytest.raises(NotImplementedError, match="shard_batched_cost"):
        kt.smc(prior, cost, cost_vectorized=True, nparticles=128,
               mesh=_mesh(4))
    with pytest.raises(ValueError, match="SAME"):
        kt.smc(prior, kt.shard_batched_cost(cost, _mesh(4)),
               cost_vectorized=True, nparticles=128, mesh=_mesh(4))


def test_smc_on_a_mesh_through_the_kernel_paths():
    """The main path of the card on 4 CPU shards: the streaming cost
    through ``shard_batched_cost`` and the fused sweep built for the
    mesh (their plain versions here); the posterior of the README model
    within a loose band at this small size."""
    prior, draw, rc = models.flagship()
    mesh = _mesh(4)
    cost = kt.shard_batched_cost(
        kt.make_streaming_moment_cost(draw, rc, ndraws=100), mesh)
    sweep = kt.make_fused_smc_sweep(prior, draw, rc, ndraws=100, mesh=mesh)
    assert sweep.mesh is mesh
    res = kt.smc(prior, cost, cost_vectorized=True, sweep_fused=sweep,
                 mesh=mesh, nparticles=128, epstol=0.2, key=1)
    mu, sg = res.P
    assert res.eps <= 0.2
    assert abs(float(mu.mean()) - 2.0) < 0.05
    assert abs(float(sg.mean()) - 0.04) < 0.02


def test_top_level_names():
    """Every public top-level name of the JAX package is in the port's
    ``__all__`` and resolves."""
    names = [n for n in dir(ka) if not n.startswith("_")
             and not isinstance(getattr(ka, n), types.ModuleType)]
    assert not sorted(set(names) - set(kt.__all__))
    for n in ("shard_batched_cost", "hpdi", "particles_from_tree"):
        assert n in kt.__all__ and callable(getattr(kt, n))
