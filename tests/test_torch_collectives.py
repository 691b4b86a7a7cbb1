"""The walker collectives of ``kissabc_tpu_torch/parallel/mesh.py`` on
meshes of 2, 4 and 8 CPU shards, mirroring tests/test_collectives.py:

- ``roll_walkers`` equals ``torch.roll`` of the joined population bit for
  bit, and JAX's ``roll_walkers`` on the JAX package's 8-device CPU mesh
  on the same numpy input;
- it makes exactly two shard-sized transfers per leaf and shard,
  whatever ndev (counted by a hook on the transport), and falls back to
  ``torch.roll`` where the JAX function does;
- the sharded bisect quantile and systematic resampling from one ``u0``
  equal the JAX functions on the same input;
- a cost written in PyTorch runs on the joined population (one join of
  the pushed proposals, its costs cut into shards), drawing what the
  unsharded cost draws;
- the sharded fused smc sweep (plain path): distinct per-shard seeds, the
  accept count the sum of the shards', each shard the unsharded plain
  sweep on its block with the rolled partners, and the JAX sharded sweep
  in interpret mode on stub bits given the same shifts and seed.
~30 s in one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kissabc_tpu as ka
import kissabc_tpu_torch as kt
from kissabc_tpu.ops import quantile as jq
from kissabc_tpu.ops import resampling as jres
from kissabc_tpu.parallel import mesh as jmesh
from kissabc_tpu_torch import models
from kissabc_tpu_torch.ops import fused_smc as F
from kissabc_tpu_torch.ops import quantile as tq
from kissabc_tpu_torch.ops import resampling as tres
from kissabc_tpu_torch.ops.moves import roll_shifts
from kissabc_tpu_torch.parallel import mesh as M
from torch_threads import one_torch_thread  # noqa: F401


def _mesh(k):
    return M.make_mesh(walker=k, devices=["cpu"] * k)


def _tree(n):
    return (torch.arange(n, dtype=torch.float32),
            torch.arange(2 * n, dtype=torch.float32).reshape(n, 2))


def _shifts(n, s):
    return sorted({0, 1, -1, s, -s, s + 7, n - 1, -(n + 3), 31, 33,
                   1000, -1000})


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_roll_walkers_bitwise_matches_torch_roll(ndev):
    n = 256
    tree = _tree(n)
    mesh = _mesh(ndev)
    sh = M.place(mesh, tree)
    for shift in _shifts(n, n // ndev):
        got = M.join(M.roll_walkers(sh, shift, mesh))
        for g, x in zip(got, tree):
            assert torch.equal(g, torch.roll(x, shift, 0)), shift
    # a plain tree is placed first, a tensor shift read once
    got = M.roll_walkers(tree, torch.tensor(5), mesh)
    assert isinstance(got, M.Sharded)
    assert torch.equal(M.join(got)[0], torch.roll(tree[0], 5, 0))


def test_roll_walkers_matches_jax_on_its_8_device_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    n = 256
    rng = np.random.default_rng(0)
    x = rng.normal(size=n).astype(np.float32)
    y = rng.normal(size=(n, 2)).astype(np.float32)
    jm = jmesh.make_mesh(walker=8)
    f = jax.jit(lambda t, s: jmesh.roll_walkers(t, s, jm))
    mesh = _mesh(8)
    sh = M.place(mesh, (torch.from_numpy(x), torch.from_numpy(y)))
    for shift in _shifts(n, n // 8):
        want = f((jnp.asarray(x), jnp.asarray(y)), jnp.int32(shift))
        got = M.join(M.roll_walkers(sh, shift, mesh))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_roll_walkers_moves_two_shard_sized_transfers_per_leaf(ndev):
    n = 1024
    s = n // ndev
    mesh = _mesh(ndev)
    sh = M.place(mesh, (torch.zeros(n), torch.zeros(n)))
    seen = []
    hook = M.add_transport_hook(lambda kind, src, dst, nbytes:
                                seen.append((kind, src, dst, nbytes)))
    try:
        for shift in (3, -(s + 5), n - 1):
            seen.clear()
            M.reset_transfer_counts()
            M.roll_walkers(sh, shift, mesh)
            assert M.transfers["permute"] == 2 * 2 * ndev
            assert {k for k, *_ in seen} == {"permute"}
            assert all(b == s * 4 for *_, b in seen)
            per_dst = np.bincount([d for _, _, d, _ in seen],
                                  minlength=ndev)
            assert (per_dst == 2 * 2).all()   # 2 transfers x 2 leaves
    finally:
        M.remove_transport_hook(hook)


def test_roll_walkers_fallbacks():
    x = (torch.arange(16, dtype=torch.float32),)
    want = torch.roll(x[0], 5, 0)
    out = M.roll_walkers(x, 5, None)        # no mesh
    assert torch.equal(out[0], want)
    out = M.roll_walkers(x, 5, _mesh(1))    # a trivial axis
    assert torch.equal(out[0], want)
    x15 = (torch.arange(15, dtype=torch.float32),)
    out = M.roll_walkers(x15, 5, _mesh(4))  # 4 does not divide 15
    assert torch.equal(out[0], torch.roll(x15[0], 5, 0))
    assert not isinstance(out, M.Sharded)


def test_permute_and_reductions():
    mesh = _mesh(4)
    v = torch.arange(8.0)
    sh = M.place(mesh, v)
    p = M.permute(sh, 3)
    assert [float(t[0]) for t in p.shards] == [6.0, 0.0, 2.0, 4.0]
    assert float(M.psum(mesh, [t.sum() for t in sh.shards])) == 28.0
    assert float(M.pmin(mesh, [t.min() for t in sh.shards])) == 0.0
    assert float(M.pmax(mesh, [t.max() for t in sh.shards])) == 7.0
    pre = M.exclusive_prefix(mesh, [t.sum() for t in sh.shards])
    assert [float(x) for x in pre] == [0.0, 1.0, 6.0, 15.0]


def _quantile_inputs(n, rng):
    x = rng.normal(size=n).astype(np.float32)
    x[::17] = np.inf
    x[5::23] = -np.inf
    x[7::11] = x[8]   # ties
    mask = rng.uniform(size=n) < 0.7
    return x, mask


@pytest.mark.parametrize("ndev", [2, 8])
@pytest.mark.parametrize("q", [0.0, 0.3, 0.95, 1.0])
def test_sharded_bisect_quantile_matches_jax(ndev, q):
    rng = np.random.default_rng(ndev)
    n = 512
    x, mask = _quantile_inputs(n, rng)
    want = float(jq.masked_quantile_bisect(jnp.asarray(x),
                                           jnp.asarray(mask), q))
    assert want == float(jq.masked_quantile(jnp.asarray(x),
                                            jnp.asarray(mask), q))
    mesh = _mesh(ndev)
    got = tq.masked_quantile_bisect(M.place(mesh, torch.from_numpy(x)),
                                    M.place(mesh, torch.from_numpy(mask)), q)
    assert float(got) == want
    assert float(got) == float(tq.masked_quantile_bisect(
        torch.from_numpy(x), torch.from_numpy(mask), q))


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_systematic_matches_jax_from_one_u0(ndev):
    n = 1024
    rng = np.random.default_rng(ndev)
    alive = rng.uniform(size=n) < 0.4
    key = jax.random.key(ndev)
    want = np.asarray(jres.systematic(key, jnp.asarray(alive,
                                                       jnp.float32)))
    u0 = torch.tensor(np.float32(jax.random.uniform(key, ())))
    mesh = _mesh(ndev)
    w = M.place(mesh, torch.from_numpy(alive).to(torch.float32))
    got = tres.systematic_from_u0(w, u0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert alive[got.numpy()].all()
    np.testing.assert_array_equal(
        got.numpy(), tres.systematic_from_u0(
            torch.from_numpy(alive).to(torch.float32), u0).numpy())


def test_plain_cost_runs_on_the_joined_population():
    """A stochastic per-walker cost on a mesh of 4 shards: the program
    joins the pushed proposals once (one shard-sized transfer a leaf and
    shard), runs the cost on the generator's device and cuts the costs
    into shards, equal bit for bit to the unsharded cost, with the
    generator left in the same state."""
    from kissabc_tpu_torch.core.smc import _program

    def cost(th, g):
        x = th + torch.randn(100, generator=g, device=g.device)
        u = torch.rand(3, generator=g, device=g.device)
        e = torch.empty_like(x).exponential_(generator=g)
        return x.mean() + u.sum() + e.mean()

    n, mesh = 64, _mesh(4)
    pri = kt.Normal(1, 0.2)
    kw = dict(nparticles=n, alpha=0.95, mcmc_retrys=0, mcmc_tol=0.015,
              epstol=0.0, r_epstol=None, min_r_ess=None, max_stretch=2.0,
              max_iters=10, resample="replicate", verbose=False,
              cost_vectorized=False, partner_scheme="auto",
              quantile_impl="auto", sweep_fused=None, caller="smc")
    one = _program(pri, cost, mesh=None, device="cpu", **kw)
    sharded = _program(pri, cost, mesh=mesh, device=None, **kw)
    th = torch.linspace(0, 1, n)
    gen, ref = torch.Generator().manual_seed(0), torch.Generator()
    ref.manual_seed(0)
    want = one.batch_cost(th, ref)
    M.reset_transfer_counts()
    got = sharded.batch_cost(M.place(mesh, th), gen)
    assert M.transfers["join"] == 4
    assert isinstance(got, M.Sharded) and got.index == [0, 1, 2, 3]
    assert torch.equal(M.join(got), want)
    assert torch.equal(gen.get_state(), ref.get_state())


def _sweep_case(n=512, ndev=4):
    prior, draw, rc = models.flagship()
    sweep = kt.make_fused_smc_sweep(prior, draw, rc, ndraws=64, block=128,
                                    chunk=64, walker_tiles=1, bits="stub",
                                    mesh=_mesh(ndev))
    rng = np.random.default_rng(1)
    th = (torch.from_numpy(rng.uniform(1.6, 2.4, n).astype(np.float32)),
          torch.from_numpy(rng.uniform(0.0, 0.1, n).astype(np.float32)))
    lps = prior.logpdf_tree(prior.push_tree(th)).to(torch.float32)
    xs = torch.full((n,), 1e6)
    alive = torch.from_numpy(rng.uniform(size=n) < 0.9)
    return prior, draw, rc, sweep, th, xs, lps, alive


def test_sharded_fused_sweep_plain_path():
    ndev, n = 4, 512
    s = n // ndev
    prior, draw, rc, sweep, th, xs, lps, alive = _sweep_case(n, ndev)
    eps = torch.tensor(0.5)
    out = sweep(torch.Generator().manual_seed(4), th, xs, lps, alive, eps,
                torch.tensor(False))
    words = kt.ops.streaming.uint32_words(torch.Generator().manual_seed(4),
                                          3)
    r1, r2 = roll_shifts(words[:2].tolist(), n)
    seeds = [int(M.fold_seed(words[2], g)) for g in range(ndev)]
    assert len(set(seeds)) == ndev
    commits = 0
    for g in range(ndev):
        blk = slice(g * s, (g + 1) * s)
        parts = ([torch.roll(x, r2, 0)[blk] for x in th],
                 [torch.roll(x, r1, 0)[blk] for x in th])
        want = F.fused_smc_sweep_plain(
            sweep, [x[blk] for x in th], xs[blk], lps[blk], alive[blk], eps,
            False, 0, 0, seeds[g], partners=parts)
        for got, w in zip(list(out[0].shards[g]) + [out[1].shards[g],
                                                    out[2].shards[g]],
                          list(want[0]) + [want[1], want[2]]):
            assert torch.equal(got, w)
        commits += int(want[3].sum())
    assert int(out[3]) == commits > 0
    assert F.launches["fused_smc_sweep"] == 0


def test_sharded_fused_sweep_matches_jax_interpret_on_stub_bits():
    """The JAX sharded sweep (roll_walkers, then the kernel per shard
    with ``seed + (shard + 1) * 2**20``) in interpret mode on its 8
    virtual devices against the port's on 8 CPU shards, given the JAX
    sweep's own shifts and seed."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    ndev, n = 8, 1024
    s = n // ndev
    prior, draw, rc, sweep, th, xs, lps, alive = _sweep_case(n, ndev)
    jprior = ka.Factored(ka.Uniform(1, 3),
                         ka.TruncatedNormal(0, 0.05, 0, 100))

    def jdraw(t, e):
        return t[0] + t[1] * e

    def jrc(t, m):   # the flagship reduce, jnp form
        var = jnp.maximum(m[1] - m[0] * m[0], 0.0)
        return jnp.sqrt(jnp.square(m[0] - 2.0)
                        + jnp.square((jnp.sqrt(var) - 0.04) * 50.0))

    jsweep = ka.make_fused_smc_sweep(
        jprior, jdraw, jrc, ndraws=64, block=128, chunk=64, walker_tiles=1,
        bits="stub", interpret=True, mesh=jmesh.make_mesh(walker=ndev))
    key = jax.random.key(5)
    eps = 0.3
    jout = jsweep(key, tuple(jnp.asarray(x.numpy()) for x in th),
                  jnp.asarray(xs.numpy()), jnp.asarray(lps.numpy()),
                  jnp.asarray(alive.numpy()), jnp.float32(eps),
                  jnp.asarray(False))
    kp, ks = jax.random.split(key)
    words = [int(w) for w in np.asarray(jax.random.bits(kp, (2,),
                                                        jnp.uint32))]
    seed = int(jax.random.bits(ks, (), jnp.uint32))
    r1, r2 = roll_shifts(words, n)
    tm = _mesh(ndev)
    lv = M.place(tm, th)
    ta, tb = M.roll_walkers(lv, r2, tm), M.roll_walkers(lv, r1, tm)
    got_th, got_xs = [], []
    commits = 0
    for g in range(ndev):
        blk = slice(g * s, (g + 1) * s)
        o = sweep.run([x[blk] for x in th], xs[blk], lps[blk], alive[blk],
                      torch.tensor(eps), torch.tensor(False),
                      torch.tensor([0, 0, int(M.fold_seed(
                          torch.tensor(seed), g))]),
                      partners=(list(ta.shards[g]), list(tb.shards[g])))
        got_th.append(o[0])
        got_xs.append(o[1])
        commits += int(o[3].sum())
    gxs = torch.cat(got_xs).numpy()
    jxs = np.asarray(jout[1])
    gcm, jcm = gxs != xs.numpy(), jxs != xs.numpy()
    # the flagship reduce cancels (tests/test_torch_fused_smc.py): commits
    # may differ only within its band of eps
    border = (np.abs(gxs - eps) < 1e-2) | (np.abs(jxs - eps) < 1e-2)
    assert ((gcm == jcm) | border).all() and commits > 10
    assert abs(int(jout[3]) - commits) <= int(border.sum())
    both = gcm & jcm
    for k in range(2):
        gt = torch.cat([o[k] for o in got_th]).numpy()
        np.testing.assert_allclose(gt[both], np.asarray(jout[0][k])[both],
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_array_equal(gt[~gcm], th[k].numpy()[~gcm])


def test_one_shard_sweep_is_the_single_device_sweep():
    """On a mesh of one shard the sweep is the single-device sweep (the
    JAX sweep takes its sharded form only above one device): the same
    draws, seed and outputs."""
    prior, draw, rc = models.flagship()
    one = M.make_mesh(walker=1, devices=["cpu"])
    sw1 = kt.make_fused_smc_sweep(prior, draw, rc, ndraws=50, mesh=one)
    sw0 = kt.make_fused_smc_sweep(prior, draw, rc, ndraws=50)
    th = prior.sample_tree(torch.Generator().manual_seed(0), 128)
    args = (th, torch.ones(128), prior.logpdf_tree(th),
            torch.ones(128, dtype=torch.bool), torch.tensor(0.5),
            torch.tensor(False))
    a = sw1(torch.Generator().manual_seed(5), *args)
    b = sw0(torch.Generator().manual_seed(5), *args)
    assert isinstance(a[0], M.Sharded) and len(a[0].shards) == 1
    for x, y in zip(a[0].shards[0], b[0]):
        assert torch.equal(x, y)
    assert torch.equal(a[1].shards[0], b[1]) and int(a[3]) == int(b[3]) > 0
