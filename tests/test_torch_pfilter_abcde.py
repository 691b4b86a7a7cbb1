"""kissabc_tpu_torch's ``pfilter`` and ``ABCDE``: the end-to-end tests
of ``tests/test_abcde_pfilter.py`` on the port (CPU, plain versions),
with their tolerances; and, bit for bit against the JAX package's
arithmetic on the same inputs, ``masked_distinct``'s position-to-index
map, ABCDE's rank-trick ``count`` (ties included) and its base and
partner indices from one draw of ``(3, n)`` uint32 words.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kissabc_tpu.ops import moves as JM
from kissabc_tpu.ops import tree as JT
import kissabc_tpu_torch as kt
from kissabc_tpu_torch.core import abcde as AB
from kissabc_tpu_torch.ops import moves as M
from torch_threads import one_torch_thread  # noqa: F401


def _mixture_cost(x, gen):
    """The classical 0.1N+N mixture simulator (runtests.jl:144-146)."""
    def draw(f):
        return f((), generator=gen, device=gen.device)
    sim = x + torch.where(draw(torch.rand) < 0.5, draw(torch.randn) * 0.1,
                          draw(torch.randn))
    return torch.abs(sim)


def _dirac(x):
    return torch.abs(x * x + 1 - 1.5)


def test_abcde_dirac():
    res = kt.ABCDE(kt.Normal(1, 0.2), _dirac, 0.01, nparticles=100,
                   generations=500, verbose=False, key=1, device="cpu")
    assert res.reached_eps
    assert res.P.approx(np.sqrt(0.5), atol=0.02)
    assert res.nsim > 0


def test_abcde_earlystop():
    res = kt.ABCDE(kt.Normal(1, 0.2), _dirac, 0.05, nparticles=60,
                   generations=2000, earlystop=True, verbose=False, key=2,
                   device="cpu")
    assert res.reached_eps
    assert res.iterations < 2000


def test_abcde_multivariate_marginal():
    """An ``[n, 2]`` MvNormal leaf beside a scalar one through the packed
    parent gather."""
    pri = kt.Factored(kt.MvNormal(np.zeros(2), np.eye(2)), kt.Normal(0, 1))

    def cost(th):
        v, s = th
        return torch.abs(v[0] - 1.0) + torch.abs(v[1] + 1.0) + torch.abs(s)

    res = kt.ABCDE(pri, cost, 0.35, nparticles=64, generations=300,
                   verbose=False, key=1, device="cpu")
    assert res.reached_eps
    means = [float(np.mean(np.asarray(p.particles))) for p in res.P]
    assert abs(means[0] - 1.0) < 0.1
    assert abs(means[1] + 1.0) < 0.1
    assert abs(means[2]) < 0.1


def test_abcde_mixture_annealing():
    res = kt.ABCDE(kt.Uniform(-10, 10), _mixture_cost, 0.05,
                   nparticles=150, generations=400, alpha=0.3,
                   verbose=False, key=3, device="cpu")
    assert res.P.approx(0.0, atol=0.2)


def test_pfilter_basic():
    res = kt.pfilter(kt.Uniform(-10, 10), _mixture_cost, 400, key=4,
                     device="cpu")
    assert res.P.approx(0.0, atol=0.2)
    assert res.eps < 1.0


def test_pfilter_n_floor():
    """N*q <= 4d forces N = ceil((4d+1)/q) (smc.jl:276-279)."""
    res = kt.pfilter(kt.Normal(0, 1), torch.abs, 5, q=0.7, max_iters=3,
                     key=5, device="cpu")
    assert len(res.C.particles) >= 8


def test_pfilter_epstol_stop():
    res = kt.pfilter(kt.Normal(0, 1), torch.abs, 100, epstol=0.5,
                     eff_tol=0.0, max_iters=50, key=6, device="cpu")
    assert res.eps < 0.5 or res.iterations >= 50


def _indicator(x):
    """>= 1 on integers, ~0.01 |x - 5| on the fractional values only DE
    moves make."""
    x = x.to(torch.float32)
    frac = torch.abs(x - torch.round(x))
    return torch.where(frac < 1e-6, 1.0 + 0.001 * torch.abs(x - 5.0),
                       0.01 * torch.abs(x - 5.0))


def test_pfilter_discrete_prior_raw_cost():
    """pfilter's cost sees the raw float particle (smc.jl:289,308-319):
    eps < 1 is reachable only so; the posterior is pushed; with
    ``cost_on='pushed'`` eps never drops below 1."""
    pri = kt.DiscreteUniform(0, 10)
    res = kt.pfilter(pri, _indicator, 100, epstol=0.5, max_iters=50, key=3,
                     device="cpu")
    assert res.eps < 1.0
    assert float(np.max(res.C.particles)) < 1.0
    vals = res.P.particles
    np.testing.assert_allclose(vals, np.round(vals))
    res2 = kt.pfilter(pri, _indicator, 100, cost_on="pushed", max_iters=3,
                      key=3, device="cpu")
    assert res2.eps >= 1.0


def test_abcde_discrete_prior_raw_cost():
    pri = kt.DiscreteUniform(0, 10)
    res = kt.ABCDE(pri, _indicator, 0.04, nparticles=100, generations=300,
                   verbose=False, key=5, device="cpu")
    assert float(np.max(res.C.particles)) < 1.0
    res2 = kt.ABCDE(pri, _indicator, 0.04, nparticles=100, generations=3,
                    cost_on="pushed", verbose=False, key=5, device="cpu")
    assert float(np.min(res2.C.particles)) >= 1.0


def test_pfilter_unfixed_surfaced():
    """Particles the bounded rejection loop could not regenerate are
    surfaced with a warning; an easy problem leaves none."""
    pri = kt.Uniform(0, 1)

    def cost(x):
        return torch.where(x < 1e-7, 0.0, 1.0)

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = kt.pfilter(pri, cost, 40, inner_retry=2, max_iters=1, key=0,
                         device="cpu")
    if res.unfixed:
        assert any("inner_retry" in str(x.message) for x in w)
    res_ok = kt.pfilter(pri, lambda x: torch.abs(x - 0.5), 40, epstol=0.2,
                        key=0, device="cpu")
    assert res_ok.unfixed == 0


def test_pfilter_quantile_impl_bitwise():
    pri = kt.Uniform(-10, 10)
    a = kt.pfilter(pri, _mixture_cost, 200, key=4, quantile_impl="sort",
                   device="cpu")
    b = kt.pfilter(pri, _mixture_cost, 200, key=4, quantile_impl="bisect",
                   device="cpu")
    assert a.eps == b.eps and a.iterations == b.iterations
    np.testing.assert_array_equal(a.C.particles, b.C.particles)
    with pytest.raises(ValueError, match="quantile_impl"):
        kt.pfilter(pri, _mixture_cost, 200, quantile_impl="nope",
                   device="cpu")


def test_entry_points_validate_and_default_to_cuda():
    pri = kt.Normal(0, 1)
    with pytest.raises(ValueError, match="cost_on"):
        kt.pfilter(pri, torch.abs, 100, cost_on="x", device="cpu")
    with pytest.raises(ValueError, match="alpha"):
        kt.ABCDE(pri, torch.abs, 0.1, alpha=1.0, device="cpu")
    with pytest.raises(ValueError, match=">= 3 particles"):
        kt.ABCDE(pri, torch.abs, 0.1, nparticles=2, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        kt.ABCDE(pri, torch.abs, 0.1, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        kt.pfilter(pri, torch.abs, 100, mesh=object(), device="cpu")
    with pytest.raises(RuntimeError, match="could not initialize"):
        kt.pfilter(pri, lambda x: x * float("inf"), 20, device="cpu")
    if not torch.cuda.is_available():
        for call in (lambda: kt.pfilter(pri, torch.abs, 20),
                     lambda: kt.ABCDE(pri, torch.abs, 0.1, verbose=False)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


# ---------------------------------------------------------------------------
# bit for bit against the JAX arithmetic
# ---------------------------------------------------------------------------

def test_masked_distinct_maps_positions_as_jax():
    """The JAX package's ``masked_distinct`` on 64 keys against the
    port's map of the same positions: the raw draws ``u_j`` in ``[0, m -
    j)`` of each key (``randint`` of its split keys), bumped past each
    other by ``distinct_positions`` and mapped through ``masked_order``,
    give the JAX indices; the order is JAX's stable ``argsort(~mask)``."""
    rng = np.random.default_rng(0)
    n = 200
    mask = rng.uniform(size=n) < 0.3
    jmask = jnp.asarray(mask)
    order = jnp.argsort(~jmask, stable=True)
    porder = M.masked_order(torch.from_numpy(mask))
    np.testing.assert_array_equal(porder.numpy(), np.asarray(order))
    m = int(mask.sum())
    for s in range(64):
        key = jax.random.key(s)
        want = [int(i) for i in JM.masked_distinct(key, jmask, 3,
                                                   order=order)]
        keys = jax.random.split(key, 3)
        raw = [int(jax.random.randint(keys[j], (), 0, max(m - j, 1),
                                      dtype=jnp.int32)) for j in range(3)]
        pos = M.distinct_positions(torch.tensor(raw)[:, None], m)
        assert [int(porder[p[0]]) for p in pos] == want
        # the JAX bump itself: sample_distinct of the same keys
        assert int(pos[1][0]) == int(JT.sample_distinct(
            keys[1], m, (jnp.int32(int(pos[0][0])),)))
    # the port's own draws: uniform indices among the mask's True entries
    one = M.masked_index(torch.Generator().manual_seed(2),
                         torch.from_numpy(mask), shape=(20000,))
    hits = np.bincount(one.numpy(), minlength=n)
    assert hits[~mask].sum() == 0
    assert hits[mask].min() > 0.5 * 20000 / m
    assert hits[mask].max() < 1.5 * 20000 / m
    idx = M.masked_distinct(torch.Generator().manual_seed(1),
                            torch.from_numpy(mask), 3, shape=(4096,))
    stack = torch.stack(idx)
    assert bool(torch.from_numpy(mask)[stack].all())
    assert bool(((stack[0] != stack[1]) & (stack[0] != stack[2])
                 & (stack[1] != stack[2])).all())


def _jax_rank_count(ds):
    """kissabc_tpu/core/abcde.py:126-141, written out."""
    n = ds.shape[0]
    order = jnp.argsort(ds, stable=True)
    ds_sorted = ds[order]
    karr = jnp.arange(n, dtype=jnp.int32)
    run_end = jnp.concatenate(
        [ds_sorted[1:] != ds_sorted[:-1], jnp.ones((1,), bool)])
    cand = jnp.where(run_end, karr, n - 1)
    last = jnp.flip(jax.lax.cummin(jnp.flip(cand)))
    count = jnp.zeros((n,), jnp.int32).at[order].set(last + 1)
    return order, count


def _jax_bases(v, ds, eps_i, order, count):
    """kissabc_tpu/core/abcde.py:147-160, written out."""
    n = ds.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    u = (v[0] % jnp.maximum(count, 1).astype(jnp.uint32)).astype(jnp.int32)
    s = jnp.where(ds > eps_i, order[u], idx)
    aa = (v[1] % jnp.uint32(n - 1)).astype(jnp.int32)
    aa = aa + (aa >= s)
    bb = (v[2] % jnp.uint32(n - 2)).astype(jnp.int32)
    lo, hi = jnp.minimum(aa, s), jnp.maximum(aa, s)
    bb = bb + (bb >= lo)
    bb = bb + (bb >= hi)
    return s, aa, bb


@pytest.mark.parametrize("n", [3, 50, 1000])
def test_rank_trick_and_parents_match_jax(n):
    """``count[i] = #{j : ds[j] <= ds[i]}`` with ties, and the base and
    both partners from the same ``(3, n)`` words, equal the JAX
    arithmetic bit for bit; every parent triple is distinct."""
    rng = np.random.default_rng(n)
    ds = np.round(rng.uniform(0, 1, n), 1).astype(np.float32)   # ties
    eps_i = np.where(ds <= 0.3, 0.3, 0.5).astype(np.float32)
    order, count = _jax_rank_count(jnp.asarray(ds))
    porder, pcount = AB.rank_count(torch.from_numpy(ds))
    np.testing.assert_array_equal(porder.numpy(), np.asarray(order))
    np.testing.assert_array_equal(pcount.numpy(), np.asarray(count))
    np.testing.assert_array_equal(
        pcount.numpy(), (ds[None, :] <= ds[:, None]).sum(1))
    v = jax.random.bits(jax.random.key(n), (3, n), jnp.uint32)
    want = _jax_bases(v, jnp.asarray(ds), jnp.asarray(eps_i), order, count)
    got = AB.bases_from_words(
        torch.from_numpy(np.asarray(v).astype(np.int64)),
        torch.from_numpy(ds), torch.from_numpy(eps_i), porder, pcount)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    s, a, b = (x.numpy() for x in got)
    assert ((s != a) & (s != b) & (a != b)).all()
    assert (ds[s] <= ds).all()   # the base is never worse
