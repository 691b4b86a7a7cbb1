"""kissabc_tpu_torch's ``abc_rejection`` on the CPU.

Bit for bit against the JAX package on the same numpy chunks: the budget
mode's merge against ``jax.lax.top_k(-concat, n)`` (chunks with ``+inf``
and ties), the threshold mode's masked scatter against JAX's
``.at[pos].set(..., mode="drop")`` inside the same ``lax.while_loop``
(its stopping batch, fill and accepted count too), and the final stable
sort against ``jnp.argsort``. Then statistically, the JAX package's own
oracles (``tests/test_rejection.py``) on the port with the same bounds;
``mesh=`` raises, and the flagship cost's plain version runs a small
budget.
"""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.core import rejection as R


def _chunks(seed, nchunks, b, k=2):
    """``nchunks`` numpy chunks of ``b`` walkers: costs from a small set
    with +inf (ties everywhere) and ``k`` theta columns that name each
    draw (chunk, row)."""
    rng = np.random.default_rng(seed)
    costs = rng.choice(np.array([0.1, 0.2, 0.2, 0.3, 0.5, np.inf],
                                np.float32), size=(nchunks, b))
    ids = np.arange(nchunks * b, dtype=np.float32).reshape(nchunks, b)
    ths = tuple(ids + 1000.0 * j for j in range(k))
    return ths, costs


def _jax_budget(ths, costs, n):
    """The JAX budget program's scan step (kissabc_tpu/core/rejection.py
    ``_budget_program``) over given chunks."""
    def step(carry, xs):
        (buf_th, buf_cs), (th, cs) = carry, xs
        merged = jnp.concatenate([buf_cs, cs])
        top, idx = jax.lax.top_k(-merged, n)
        cat = tuple(jnp.concatenate([a, c]) for a, c in zip(buf_th, th))
        return (tuple(x[idx] for x in cat), -top), None

    buf = (tuple(jnp.zeros(n, jnp.float32) for _ in ths),
           jnp.full((n,), jnp.inf, jnp.float32))
    (bt, bc), _ = jax.lax.scan(
        step, buf, (tuple(jnp.asarray(t) for t in ths), jnp.asarray(costs)))
    return np.stack([np.asarray(x) for x in bt]), np.asarray(bc)


def _feeder(ths, costs):
    """A ``draw_chunk(gen)`` that hands out the given chunks in turn."""
    it = iter(range(costs.shape[0]))

    def draw_chunk(gen):
        t = next(it)
        return (tuple(torch.from_numpy(x[t].copy()) for x in ths),
                torch.from_numpy(costs[t].copy()))

    return draw_chunk


@pytest.mark.parametrize("n,b,nchunks,seed", [(8, 16, 5, 0), (5, 3, 9, 1),
                                              (16, 16, 1, 2), (7, 64, 4, 3)])
def test_budget_merge_equals_lax_top_k(n, b, nchunks, seed):
    ths, costs = _chunks(seed, nchunks, b)
    costs[0, :] = np.inf          # a chunk of +inf only: placeholders tie
    jt, jc = _jax_budget(ths, costs, n)
    pt, pc = R._budget(_feeder(ths, costs), None, n, nchunks, False)
    assert np.array_equal(pc.numpy(), jc)
    assert np.array_equal(np.stack([x.numpy() for x in pt]), jt)


def test_torch_topk_ties_differ_but_merge_does_not():
    """The reason for the stable sort: ``lax.top_k`` gives equal values
    lower index first; the merge does too on ``+inf`` ties."""
    a = np.array([1.0, np.inf, 0.5, np.inf, np.inf], np.float32)
    want = np.asarray(jax.lax.top_k(-jnp.asarray(a), 4)[1])
    assert want.tolist() == [2, 0, 1, 3]
    th = torch.arange(5, dtype=torch.float32)
    got, cs = R.merge_best(th[:0], torch.empty(0), th, torch.from_numpy(a), 4)
    assert got.tolist() == want.tolist()


def _jax_threshold(ths, costs, n, eps, max_batches):
    """The JAX threshold program's while_loop (kissabc_tpu/core/
    rejection.py ``_threshold_program``) over given chunks, with its final
    argsort."""
    cth = tuple(jnp.asarray(t) for t in ths)
    ccs = jnp.asarray(costs)
    epsv = float(eps)

    def cond(c):
        t, _th, _cs, fill, *_ = c
        return (t < max_batches) & (fill < n)

    def body(c):
        t, buf_th, buf_cs, fill, nacc = c
        th = tuple(x[t] for x in cth)
        cs = ccs[t]
        m = cs <= epsv
        pos = fill + jnp.cumsum(m) - 1
        pos = jnp.where(m & (pos < n), pos, n)
        buf_th = tuple(bl.at[pos].set(cl, mode="drop")
                       for bl, cl in zip(buf_th, th))
        buf_cs = buf_cs.at[pos].set(cs, mode="drop")
        kept = jnp.sum(m)
        return (t + 1, buf_th, buf_cs, jnp.minimum(fill + kept, n),
                nacc + kept)

    buf_th = tuple(jnp.zeros(n, jnp.float32) for _ in ths)
    buf_cs = jnp.full((n,), jnp.inf, jnp.float32)
    t, buf_th, buf_cs, fill, nacc = jax.lax.while_loop(
        cond, body, (jnp.int32(0), buf_th, buf_cs, jnp.int32(0),
                     jnp.int32(0)))
    order = jnp.argsort(buf_cs)
    return (np.stack([np.asarray(x[order]) for x in buf_th]),
            np.asarray(buf_cs[order]), int(fill), int(nacc), int(t))


@pytest.mark.parametrize("n,b,nchunks,eps,seed", [
    (8, 16, 6, 0.2, 0),      # fills inside the first chunk, drops the rest
    (40, 16, 6, 0.2, 1),     # fills over several chunks
    (500, 16, 6, 0.3, 2),    # never fills: runs every batch
    (12, 10, 8, 0.1, 3)])
def test_threshold_scatter_and_sort_equal_jax(n, b, nchunks, eps, seed):
    ths, costs = _chunks(seed, nchunks, b)
    jt, jc, jfill, jnacc, jt_ = _jax_threshold(ths, costs, n, eps, nchunks)
    pt, pc, fill, nacc, t = R._threshold(_feeder(ths, costs), None, n,
                                         np.float32(eps), nchunks, False)
    assert (t, fill, nacc) == (jt_, jfill, jnacc)
    assert np.array_equal(pc.numpy(), jc)
    assert np.array_equal(np.stack([x.numpy() for x in pt]), jt)


def test_final_sort_is_stable_argsort():
    rng = np.random.default_rng(4)
    cs = rng.choice(np.array([0.1, 0.2, np.inf], np.float32), 64)
    th = np.arange(64, dtype=np.float32)
    pt, pc = R.sort_best_first(torch.from_numpy(th), torch.from_numpy(cs))
    order = np.asarray(jnp.argsort(jnp.asarray(cs)))
    assert np.array_equal(pt.numpy(), th[order])
    assert np.array_equal(pc.numpy(), cs[order])


# ---------------------------------------------------------------------------
# the JAX package's oracles (tests/test_rejection.py), on the port
# ---------------------------------------------------------------------------

def test_budget_mode_uniform_ball():
    res = kt.abc_rejection(kt.Uniform(0.0, 1.0), lambda th: torch.abs(th - 0.3),
                           512, nsims=65536, key=0, device="cpu")
    assert res.nsims == 65536 and res.naccept == 512
    expected_eps = 512 / 65536 / 2
    assert abs(res.eps - expected_eps) < 0.3 * expected_eps
    assert abs(res.P.mean() - 0.3) < 3 * expected_eps
    assert res.C.particles.max() == pytest.approx(res.eps)
    assert np.all(np.diff(res.C.particles) >= 0)
    assert res.log_evidence == pytest.approx(np.log(512 / 65536))


def test_budget_mode_buffer_merge_across_chunks():
    res = kt.abc_rejection(kt.Uniform(0.0, 1.0), lambda th: torch.abs(th - 0.3),
                           64, nsims=16384, batch=256, key=1, device="cpu")
    assert res.nsims == 16384
    assert abs(res.eps - 64 / 16384 / 2) < 0.6 * (64 / 16384 / 2)


def test_threshold_mode_evidence_matches_gaussian_mass():
    res = kt.abc_rejection(kt.Normal(0.0, 1.0), lambda th: torch.abs(th),
                           2048, eps=0.5, batch=8192, key=3, device="cpu")
    assert res.naccept >= 2048
    truth = 2 * stats.norm.cdf(0.5) - 1
    assert abs(np.exp(res.log_evidence) - truth) < 0.03
    assert res.C.particles.max() <= 0.5
    assert abs(res.P.mean()) < 0.05
    assert abs(res.P.std() - stats.truncnorm.std(-0.5, 0.5)) < 0.02


def test_budget_mode_infinite_cost_shortfall_warns():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = kt.abc_rejection(
            kt.Uniform(0.0, 1.0),
            lambda th: torch.where(th < 0.001, th, torch.full_like(th, math.inf)),
            64, nsims=1024, key=11, device="cpu")
    assert any("finite cost" in str(x.message) for x in w)
    assert res.naccept < 64
    assert np.isfinite(res.eps) or res.naccept == 0
    kept = res.C.particles[:res.naccept]
    assert np.all(np.isfinite(kept))
    assert res.log_evidence <= np.log(max(res.naccept, 1) / 1024)


def test_threshold_mode_sorted_and_budget_capped():
    res = kt.abc_rejection(kt.Normal(0.0, 1.0), lambda th: torch.abs(th),
                           32, eps=1.0, batch=4096, max_sims=1000, key=12,
                           device="cpu")
    assert res.nsims <= 1000
    finite = res.C.particles[np.isfinite(res.C.particles)]
    assert len(finite) > 0
    assert np.all(np.diff(finite) >= 0)


def test_threshold_unfilled_warns():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = kt.abc_rejection(kt.Normal(0.0, 1.0), lambda th: torch.abs(th),
                               256, eps=1e-5, batch=512, max_sims=2048, key=4,
                               device="cpu")
    assert any("unfilled" in str(x.message) or "accepted within"
               in str(x.message) for x in w)
    assert res.naccept < 256
    assert np.isinf(res.C.particles).any()
    assert res.nsims == 2048


def test_mixed_prior_pushes_discrete():
    pri = kt.Factored(kt.Uniform(0.0, 1.0), kt.DiscreteUniform(1, 10))

    def cost(th, gen):
        u, k = th
        return torch.abs(u - 0.5) + torch.abs(k - 4.0)

    res = kt.abc_rejection(pri, cost, 256, nsims=16384, key=5, device="cpu")
    u, kpart = res.P
    assert np.issubdtype(kpart.particles.dtype, np.integer)
    assert kpart.mean() == pytest.approx(4.0, abs=0.3)
    assert abs(u.mean() - 0.5) < 0.1


def test_knob_validation():
    with pytest.raises(ValueError):
        kt.abc_rejection(kt.Normal(0, 1), lambda th: th, 10, eps=1.0,
                         nsims=100, device="cpu")
    with pytest.raises(ValueError):
        kt.abc_rejection(kt.Normal(0, 1), lambda th: th, 100, nsims=10,
                         device="cpu")
    with pytest.raises(ValueError, match="nparticles"):
        kt.abc_rejection(kt.Normal(0, 1), lambda th: th, 0, device="cpu")
    with pytest.raises(ValueError, match="max_sims"):
        kt.abc_rejection(kt.Normal(0, 1), lambda th: th, 10, eps=1.0,
                         max_sims=0, device="cpu")


def test_mesh_raises_and_device_defaults_to_cuda(monkeypatch):
    # mesh= takes a Mesh (tests/test_torch_parallel_samplers.py holds the
    # sharded run against the unsharded one)
    with pytest.raises(TypeError, match="Mesh"):
        kt.abc_rejection(kt.Uniform(0.0, 1.0), lambda th: th, 8, nsims=64,
                         mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kt.abc_rejection(kt.Uniform(0.0, 1.0), lambda th: th, 8, nsims=64)


def test_same_key_repeats_and_generator_key():
    kw = dict(nsims=4096, batch=1024, device="cpu")
    cost = lambda th, g: torch.abs(th - 0.3 + 0.01 * torch.randn(  # noqa
        (), generator=g))
    a = kt.abc_rejection(kt.Uniform(0.0, 1.0), cost, 32, key=7, **kw)
    b = kt.abc_rejection(kt.Uniform(0.0, 1.0), cost, 32, key=7, **kw)
    g = torch.Generator()
    g.manual_seed(7)
    c = kt.abc_rejection(kt.Uniform(0.0, 1.0), cost, 32, key=g, **kw)
    assert np.array_equal(a.C.particles, b.C.particles)
    assert np.array_equal(a.P.particles, c.P.particles)


def test_vector_prior_budget_and_threshold():
    """An ``[n, d]`` leaf (MvNormal) goes through both merges."""
    tgt = torch.tensor([0.5, -0.5])
    cost = lambda x: torch.linalg.norm(x - tgt)   # noqa: E731
    pri = kt.MvNormal(np.zeros(2), 1.0)
    a = kt.abc_rejection(pri, cost, 64, nsims=8192, batch=2048, key=1,
                         device="cpu")
    b = kt.abc_rejection(pri, cost, 64, eps=0.3, batch=2048, key=1,
                         device="cpu")
    for r in (a, b):
        assert len(r.P) == 2 and r.naccept >= 64
        assert abs(r.P[0].mean() - 0.5) < 0.15
        assert abs(r.P[1].mean() + 0.5) < 0.15


def test_flagship_cost_plain_small_budget():
    """The batched flagship cost (kernel #1's plain version on the CPU)
    in budget mode, the JAX bench's rejection row cut to 16384 sims."""
    prior = kt.Factored(kt.Uniform(1, 3), kt.TruncatedNormal(0, 0.05, 0, 100))
    res = kt.abc_rejection(prior, kt.make_flagship_cost_batched(), 32,
                           nsims=16384, batch=4096, cost_vectorized=True,
                           key=2, device="cpu")
    assert res.nsims == 16384 and res.naccept == 32
    assert res.log_evidence == pytest.approx(math.log(32 / 16384))
    cs = res.C.particles
    assert np.all(np.diff(cs) >= 0) and cs[-1] == np.float32(res.eps)
    mu, sg = res.P
    assert abs(mu.mean() - 2.0) < 0.05 and abs(sg.mean() - 0.0401) < 0.005
