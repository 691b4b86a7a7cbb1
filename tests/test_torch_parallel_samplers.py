"""Walker sharding of kissabc_tpu_torch's other samplers on meshes of CPU
shards (``make_mesh(walker=8, devices=["cpu"] * 8)``), mirroring
tests/test_parallel.py:56-92, tests/test_review_fixes.py:71-83,
tests/test_rejection.py:122-134 and tests/test_collectives.py:287-338:

- AIS on a walker mesh (roll and gather schemes, a stochastic per-walker
  cost), on a chain mesh and on a ``(chain=2, walker=4)`` mesh, tsmc,
  pfilter (sort and bisect thresholds), ABCDE (with and without
  earlystop) and ``abc_rejection`` (budget and threshold mode), each with
  a cost written in PyTorch, equal to the unsharded run on the same key
  bit for bit (the JAX tests hold the posterior, and bitwise for
  ``abc_rejection``), and within the JAX tests' posterior bands;
- one AIS sweep of the shard-local halves under the roll scheme moves
  exactly 12 rolls x 2 shard-sized permutes x d leaves to every shard
  and joins nothing when the cost runs once per shard
  (``shard_batched_cost``), counted by a hook on the transport; with a
  PyTorch cost it also joins the proposals once a half-update, and
  equals ``mesh=None`` bit for bit;
- the messages: a population the walker axis does not divide, a kernel
  cost without ``shard_batched_cost``, a sweep built for another mesh.
~25 s in one process.
"""

import numpy as np
import pytest
import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch import models
from kissabc_tpu_torch.core.ais import _halves, make_sweep_halves
from kissabc_tpu_torch.parallel import mesh as M
from kissabc_tpu_torch.parallel.mesh import make_mesh


def _mesh(k=8):
    return make_mesh(walker=k, devices=["cpu"] * k)


def _abc():
    pri = kt.Normal(1, 0.2)
    return kt.ApproxKernelizedPosterior(
        pri, lambda x: torch.abs(x * x + 1 - 1.5), 0.001)


def _equal(a, b):
    pa = a if isinstance(a, (list, tuple)) else [a]
    pb = b if isinstance(b, (list, tuple)) else [b]
    return len(pa) == len(pb) and all(
        np.array_equal(x.particles, y.particles) for x, y in zip(pa, pb))


def test_ais_sharded_walkers():
    res = kt.sample(_abc(), kt.AIS(64), 256, discard_initial=512,
                    mesh=_mesh(), key=4)
    assert res.map(lambda m: m * m + 1).approx(1.5)


@pytest.mark.parametrize("scheme", ["roll", "gather"])
def test_ais_sharded_matches_unsharded(scheme):
    kw = dict(discard_initial=512, key=4, partner_scheme=scheme)
    a = kt.sample(_abc(), kt.AIS(64), 256, device="cpu", **kw)
    b = kt.sample(_abc(), kt.AIS(64), 256, mesh=_mesh(), **kw)
    assert _equal(a, b)


def test_ais_stochastic_cost_sharded_matches_unsharded():
    """The README model's per-walker cost draws from the run's generator:
    it runs on the joined proposals, so 4 shards give the bits of one
    device (and ApproxPosterior's accept rule too)."""
    def cost(theta, g):
        mu, sigma = theta
        x = mu + sigma * torch.randn(100, generator=g, device=g.device)
        return torch.hypot(x.mean() - 2.0, (x.std(correction=0) - 0.04) * 50)

    prior = kt.Factored(kt.Uniform(1, 3), kt.TruncatedNormal(0, 0.05, 0, 100))
    for model in (kt.ApproxKernelizedPosterior(prior, cost, 0.05),
                  kt.ApproxPosterior(prior, cost, 0.1)):
        kw = dict(ntransitions=3, key=1, partner_scheme="roll")
        a = kt.sample(model, kt.AIS(64), 64, device="cpu", **kw)
        b = kt.sample(model, kt.AIS(64), 64, mesh=_mesh(4), **kw)
        assert _equal(a, b)


def test_ais_chain_mesh():
    mesh = make_mesh(chain=8, devices=["cpu"] * 8)
    kw = dict(chains=8, discard_initial=120, key=5)
    res = kt.sample(_abc(), kt.AIS(12), 50, mesh=mesh, **kw)
    assert len(res) == 8 * 50
    assert res.map(lambda m: m * m + 1).approx(1.5)
    assert _equal(res, kt.sample(_abc(), kt.AIS(12), 50, device="cpu", **kw))


def test_chains_with_2d_mesh():
    mesh = make_mesh(chain=2, walker=4, devices=["cpu"] * 8)
    kw = dict(chains=2, discard_initial=100, key=3)
    res = kt.sample(_abc(), kt.AIS(16), 50, mesh=mesh, **kw)
    assert len(res) == 100
    assert res.map(lambda m: m * m + 1).approx(1.5)
    assert _equal(res, kt.sample(_abc(), kt.AIS(16), 50, device="cpu", **kw))
    # the rows' walker meshes: the walkers of each chain sharded
    row = mesh.take("chain", 1)
    assert row.shape == {"walker": 4} and row.local() == [0, 1, 2, 3]


def _flagship_sweep_state(n, cost, init_cost=None):
    """The model of ``cost`` and a start: the walkers and their ``ld``
    by ``init_cost`` (default ``cost``) on one device."""
    prior = kt.Factored(kt.Uniform(1, 3), kt.TruncatedNormal(0, 0.05, 0, 100))
    model = kt.ApproxKernelizedPosterior(prior, cost, 0.1,
                                         cost_vectorized=True)
    init = kt.ApproxKernelizedPosterior(prior, init_cost or cost, 0.1,
                                        cost_vectorized=True)
    gen = torch.Generator().manual_seed(0)
    th = init.init_batch(gen, n)
    lds = init.loglike_batch(init.push(th), gen)
    return model, th, lds


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_ais_sweep_collectives_shard_local(ndev):
    """One roll-scheme sweep of the shard-local halves with the cost run
    once per shard: 12 rolls x 2 shard-sized permutes x 2 leaves to every
    shard, no join, and the six shifts read once a half-update."""
    n, h = 1024, 512
    mesh = _mesh(ndev)
    base = kt.make_flagship_cost_batched(ndraws=64)
    model, th, lds = _flagship_sweep_state(
        n, kt.shard_batched_cost(base, mesh), base)
    sweep = make_sweep_halves(model, n, partner_scheme="roll", mesh=mesh)
    seen = []
    hook = M.add_transport_hook(lambda *a: seen.append(a))
    try:
        M.reset_transfer_counts()
        out = sweep(torch.Generator().manual_seed(1), _halves(th, h),
                    _halves(lds, h))
    finally:
        M.remove_transport_hook(hook)
    assert M.transfers["join"] == 0 and M.host_reads["shifts"] == 2
    assert {k for k, *_ in seen} == {"permute"}
    assert len(seen) == 12 * 2 * 2 * ndev
    assert all(b == h // ndev * 4 for *_, b in seen)
    per_dst = np.bincount([d for _, _, d, _ in seen], minlength=ndev)
    assert (per_dst == 12 * 2 * 2).all()
    assert all(isinstance(x, M.Sharded) and x.n == h and len(x.shards) == ndev
               for x in (out[0][0], out[0][1], out[1][0], out[1][1]))


def test_ais_sweep_sharded_bitwise_matches_unsharded():
    """With a cost written in PyTorch the sharded roll-scheme sweep
    joins the pushed proposals once a half-update (2 leaves x 8 shards)
    and equals the sweep of one device bit for bit."""
    n, h = 1024, 512
    mesh = _mesh(8)

    def cost(thetas, g):
        mu, sigma = thetas
        x = mu[:, None] + sigma[:, None] * torch.randn(
            mu.shape[0], 64, generator=g, device=g.device)
        return torch.hypot(x.mean(1) - 2.0, (x.std(1) - 0.04) * 50)

    model, th, lds = _flagship_sweep_state(n, cost)
    args = (_halves(th, h), _halves(lds, h))
    M.reset_transfer_counts()
    a = make_sweep_halves(model, n, partner_scheme="roll", mesh=mesh)(
        torch.Generator().manual_seed(2), *args)
    assert M.transfers["permute"] == 12 * 2 * 2 * 8
    assert M.transfers["join"] == 2 * 2 * 8
    b = make_sweep_halves(model, n, partner_scheme="roll")(
        torch.Generator().manual_seed(2), *args)
    for half in (0, 1):
        for x, y in zip(M.join(a[0][half]), b[0][half]):
            assert torch.equal(x, y)
        for x, y in zip(M.join(a[1][half]), b[1][half]):
            assert torch.equal(x, y)
    # make_sweep on the mesh: whole populations in and out
    sw = kt.make_sweep(model, n, partner_scheme="gather", mesh=mesh)
    c = sw(torch.Generator().manual_seed(3), th, lds)
    d = kt.make_sweep(model, n, partner_scheme="gather")(
        torch.Generator().manual_seed(3), th, lds)
    for x, y in zip(c[0] + c[1], d[0] + d[1]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kw", [{"partner_scheme": "roll"},
                                {"partner_scheme": "gather", "alpha": 0.9}],
                         ids=["roll", "gather-alpha0.9"])
def test_tsmc_sharded_matches_unsharded(kw):
    prior, ll, _, truth = models.conjugate_normal()
    a = kt.tsmc(prior, ll, nparticles=512, key=3, device="cpu", **kw)
    b = kt.tsmc(prior, ll, nparticles=512, key=3, mesh=_mesh(), **kw)
    assert _equal(a.P, b.P) and a.iterations == b.iterations
    assert a.log_evidence == b.log_evidence and b.lam == 1.0
    assert abs(float(b.P.mean()) - truth[0]) < 0.05
    assert abs(b.log_evidence - truth[2]) < 0.3


def _pf_cost(x, key):
    return torch.abs(x + 0.1 * torch.randn((), generator=key,
                                           device=key.device))


def test_pfilter_abcde_sharded():
    mesh = _mesh()
    pri = kt.Uniform(-10, 10)
    r1 = kt.pfilter(pri, _pf_cost, 512, mesh=mesh, verbose=False, key=6)
    assert r1.P.approx(0.0, atol=0.3)
    r2 = kt.ABCDE(pri, _pf_cost, 0.1, nparticles=256, generations=200,
                  mesh=mesh, verbose=False, key=7)
    assert r2.P.approx(0.0, atol=0.3)


@pytest.mark.parametrize("impl", ["auto", "sort"])
def test_pfilter_sharded_matches_unsharded(impl):
    pri = kt.Uniform(-10, 10)
    kw = dict(verbose=False, key=6, quantile_impl=impl)
    a = kt.pfilter(pri, _pf_cost, 512, device="cpu", **kw)
    b = kt.pfilter(pri, _pf_cost, 512, mesh=_mesh(), **kw)
    assert _equal(a.P, b.P) and _equal(a.C, b.C)
    assert a.eps == b.eps and a.iterations == b.iterations
    assert a.unfixed == b.unfixed


@pytest.mark.parametrize("kw", [{}, {"earlystop": True, "alpha": 0.3}],
                         ids=["default", "earlystop"])
def test_abcde_sharded_matches_unsharded(kw):
    pri = kt.Uniform(-10, 10)
    kw = dict(kw, nparticles=256, generations=60, verbose=False, key=7)
    a = kt.ABCDE(pri, _pf_cost, 0.1, device="cpu", **kw)
    b = kt.ABCDE(pri, _pf_cost, 0.1, mesh=_mesh(), **kw)
    assert _equal(a.P, b.P) and _equal(a.C, b.C)
    assert a.nsim == b.nsim and a.iterations == b.iterations


def test_rejection_sharded_matches_unsharded():
    mesh = _mesh()
    cost = lambda th: torch.abs(th - 0.3)   # noqa: E731
    a = kt.abc_rejection(kt.Uniform(0.0, 1.0), cost, 128, nsims=8192, key=7,
                         device="cpu")
    b = kt.abc_rejection(kt.Uniform(0.0, 1.0), cost, 128, nsims=8192, key=7,
                         mesh=mesh)
    # sharding the chunks changes where they are costed, not the math
    assert np.array_equal(a.C.particles, b.C.particles)
    assert np.array_equal(a.P.particles, b.P.particles)
    kw = dict(eps=0.05, key=7, batch=1024)
    a = kt.abc_rejection(kt.Uniform(0.0, 1.0), _pf_cost, 128, device="cpu",
                         **kw)
    b = kt.abc_rejection(kt.Uniform(0.0, 1.0), _pf_cost, 128, mesh=mesh, **kw)
    assert np.array_equal(a.C.particles, b.C.particles)
    assert np.array_equal(a.P.particles, b.P.particles)
    assert a.nsims == b.nsims and a.naccept == b.naccept


def test_rejection_kernel_cost_once_per_shard():
    """Budget mode through the flagship kernel cost's plain version by
    ``shard_batched_cost``: every chunk costed once per shard, each with
    its folded seed, and the best kept as without a mesh."""
    mesh = _mesh(4)
    prior = kt.Factored(kt.Uniform(1, 3), kt.TruncatedNormal(0, 0.05, 0, 100))
    base = kt.make_flagship_cost_batched(ndraws=100)
    calls = []

    class Counted:
        def seeded(self, th, seed):
            calls.append(th[0].shape[0])
            return base.seeded(th, seed)

        __call__ = base

    cost = kt.shard_batched_cost(Counted(), mesh)
    res = kt.abc_rejection(prior, cost, 64, nsims=4096, batch=1024,
                           cost_vectorized=True, mesh=mesh, key=2)
    assert calls == [256] * 16
    assert res.naccept == 64 and np.all(np.diff(res.C.particles) >= 0)


def test_mesh_messages():
    abc = _abc()
    mesh = _mesh()
    with pytest.raises(ValueError, match="half size 30 must divide the mesh "
                                         r"walker axis \(8 devices\)"):
        kt.sample(abc, kt.AIS(60), 60, mesh=mesh)
    with pytest.raises(ValueError, match=r"n=100 walkers must divide the "
                                         r"mesh walker axis \(8 devices\)"):
        kt.ABCDE(kt.Uniform(-10, 10), _pf_cost, 0.1, nparticles=100,
                 mesh=mesh, verbose=False)
    prior, draw, rc = models.flagship()
    cost = kt.make_streaming_moment_cost(draw, rc, ndraws=50)
    with pytest.raises(ValueError, match="shard_batched_cost"):
        kt.ABCDE(prior, cost, 0.1, nparticles=128, cost_vectorized=True,
                 mesh=mesh, verbose=False)
    with pytest.raises(ValueError, match="SAME mesh as the population"):
        kt.abc_rejection(prior, kt.shard_batched_cost(cost, _mesh(4)), 64,
                         cost_vectorized=True, mesh=mesh)
    with pytest.raises(ValueError, match="SAME mesh"):
        kt.tsmc(kt.Normal(0, 1), lambda t: -t * t, nparticles=64, mesh=mesh,
                sweep_fused=kt.make_fused_tempered_sweep(
                    kt.Normal(0, 1), lambda t: -t * t))
    with pytest.raises(ValueError, match="chains=3 must divide the mesh "
                                         r"chain axis \(2 devices\)"):
        kt.sample(abc, kt.AIS(16), 16, chains=3,
                  mesh=make_mesh(chain=2, devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="does not support"):
        kt.sample(abc, kt.AIS(16), 16, schedule="sequential", mesh=mesh)
    for fn in (kt.pfilter, kt.abc_rejection):
        with pytest.raises(TypeError, match="object"):
            fn(kt.Uniform(0, 1), _pf_cost, 64, mesh=object())
