"""The plain PyTorch versions of kissabc_tpu_torch's two CUDA kernels,
held on the CPU against the JAX Pallas kernels run in interpret mode on
the deterministic stub bit stream (the golden models of
tests/test_pallas.py), plus the Philox stream's known answers and
statistics. The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kissabc_tpu.ops import pallas_kernels as pk
from kissabc_tpu_torch.ops import kernels as K
from kissabc_tpu_torch.utils.rng import as_generator
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5  # the JAX golden tolerance (tests/test_pallas.py)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1.0, 3.0, n).astype(np.float32),
            rng.uniform(0.01, 0.1, n).astype(np.float32))


# ---------------------------------------------------------------------------
# shared device helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,pid,seed,ctr", [
    ((256, 128), 0, 42, 0), ((256, 128), 1, 42, 7), ((16, 128), 3, 2**32 - 1,
                                                     10_002)])
def test_stub_bits_match_jax(shape, pid, seed, ctr):
    """Bit for bit against the JAX golden twin ``stub_bits_numpy``."""
    want = pk.stub_bits_numpy(pid, seed, ctr, shape)
    sub = torch.arange(shape[0])[:, None]
    lane = torch.arange(shape[1])[None, :]
    got = K.stub_bits(pid, torch.tensor([seed]), ctr, sub, lane)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_sincos_2pi_matches_jax():
    """Within 1 float32 ulp of the JAX polynomial sincos on the 23-bit
    uniform grid and the quadrant boundaries."""
    rng = np.random.default_rng(3)
    t = np.concatenate([rng.random(100_000).astype(np.float32),
                        np.float32([0.0, 0.25, 0.5, 0.75,
                                    np.nextafter(np.float32(1), 0)])])
    jc, js = (np.asarray(v) for v in jax.jit(pk._sincos_2pi)(jnp.asarray(t)))
    tc, ts = (v.numpy() for v in K.sincos_2pi(torch.from_numpy(t)))
    for got, want in ((tc, jc), (ts, js)):
        assert (np.abs(got - want) <= np.spacing(np.float32(1.0))).all()
    assert np.abs(tc - np.cos(2 * np.pi * t.astype(np.float64))).max() < 5e-7


@pytest.mark.parametrize("n,block,wt", [(300, 256, 8), (1, 128, 8),
                                        (5000, 1024, 8), (3 * 1024, 1024, 4),
                                        (70_000, 2048, 1)])
def test_plan_tiles_matches_jax(n, block, wt):
    assert K.plan_tiles(n, block, wt) == pk._plan_tiles(n, block, wt)


def test_to_unit_mantissa_trick():
    b = torch.tensor([0, 2**32 - 1, 2**31, 511, 512])
    u = K.to_unit(b)
    want = ((np.array([0, 2**32 - 1, 2**31, 511, 512], np.uint32) >> 9)
            | 0x3F800000).view(np.float32) - 1.0
    np.testing.assert_array_equal(u.numpy(), want)
    assert float(u.max()) < 1.0 and float(u.min()) == 0.0


# Philox4x32-10 known answers (Random123 kat_vectors)
_PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", _PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    words = K.philox4x32_10(*(torch.tensor([c]) for c in ctr),
                            torch.tensor([key[0]]), key[1])
    assert tuple(int(w) for w in words) == want


# ---------------------------------------------------------------------------
# (e) kernel 1, normal_summary_cost: plain version vs the JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,ndraws,block,chunk,wt", [
    (300, 700, 256, 128, 8),    # the ragged golden case of test_pallas.py
    (1000, 1000, 128, 128, 2),  # two programs, four tiles
])
def test_normal_summary_cost_stub_matches_jax_interpret(n, ndraws, block,
                                                        chunk, wt):
    mu, sg = _inputs(n, 7)
    seed = 42
    want = np.asarray(pk.normal_summary_cost(
        jnp.asarray(mu), jnp.asarray(sg), jnp.uint32(seed), ndraws=ndraws,
        block=block, chunk=chunk, interpret=True, bits="stub",
        walker_tiles=wt))
    kw = dict(ndraws=ndraws, block=block, chunk=chunk, bits="stub",
              walker_tiles=wt)
    tmu, tsg = torch.from_numpy(mu), torch.from_numpy(sg)
    got = K.normal_summary_cost(tmu, tsg, seed, **kw)  # CPU -> plain
    plain = K.normal_summary_cost_plain(tmu, tsg, seed, **kw)
    assert torch.equal(got, plain)
    assert got.shape == (n,) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_philox_cost_statistics_and_streams():
    """At mu=2, sigma=0.04: E[cost] = E hypot(N(0, 0.04/sqrt(1000)),
    50 N(0, 0.04/sqrt(2000))) = 0.0357 (tests/test_pallas.py:33-41).
    Different seeds differ, the same seed repeats, and the plain
    version's slabbing does not change a single bit."""
    n = 4096
    mu, sg = torch.full((n,), 2.0), torch.full((n,), 0.04)
    c3 = K.normal_summary_cost(mu, sg, 3)
    assert torch.isfinite(c3).all()
    assert abs(float(c3.mean()) - 0.0357) < 0.004
    assert not torch.allclose(c3, K.normal_summary_cost(mu, sg, 4))
    assert torch.equal(c3, K.normal_summary_cost(mu, sg, 3))
    s1, s2 = K._moments_philox(torch.tensor([3]), 0, 64, 1000, "cpu")
    slab = K._SLAB
    try:
        K._SLAB = 4 * 64 * 7   # seven groups a slab: ragged in q
        t1, t2 = K._moments_philox(torch.tensor([3]), 0, 64, 1000, "cpu")
    finally:
        K._SLAB = slab
    np.testing.assert_allclose(t1.numpy(), s1.numpy(), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(t2.numpy(), s2.numpy(), rtol=1e-5)


def test_flagship_cost_batched_draws_seed_from_generator():
    cost = K.make_flagship_cost_batched(ndraws=200)
    th = tuple(torch.from_numpy(x) for x in _inputs(64, 1))
    a = cost(th, as_generator(9, "cpu"))
    b = cost(th, as_generator(9, "cpu"))
    c = cost(th, as_generator(10, "cpu"))
    assert a.shape == (64,) and torch.equal(a, b) and not torch.equal(a, c)


def test_wrapper_validates_inputs():
    mu = torch.ones(10)
    with pytest.raises(ValueError, match="float32 vector of length 10"):
        K.normal_summary_cost(mu, torch.ones(10, dtype=torch.float64), 0)
    with pytest.raises(ValueError, match="float32 vector of length 10"):
        K.normal_summary_cost(mu, torch.ones(9), 0)
    with pytest.raises(ValueError, match="contiguous"):
        K.normal_summary_cost(mu, torch.ones(20)[::2], 0)
    with pytest.raises(ValueError, match="bits must be"):
        K.normal_summary_cost(mu, mu, 0, bits="threefry")
    with pytest.raises(ValueError, match="multiple of 128"):
        K.normal_summary_cost(mu, mu, 0, bits="stub", block=100)


# ---------------------------------------------------------------------------
# (f) kernel 2, the fused sweep: plain version vs the JAX kernel
# ---------------------------------------------------------------------------

def _jax_sweep_words(key):
    """The roll shifts and seed the JAX step draws (pallas_kernels.py
    :479-485), so the port's sweep can be given the same ones."""
    words = np.asarray(jax.random.bits(key, (3,), jnp.uint32))
    return [int(w) for w in words]


@pytest.mark.parametrize("n,lps0,eps", [(300, -3.0, 0.5), (777, 0.0, 0.3)])
def test_fused_sweep_stub_matches_jax_interpret(n, lps0, eps):
    ndraws, block, chunk = 700, 256, 128
    step = pk.make_fused_flagship_sweep(n, block=block, chunk=chunk,
                                        ndraws=ndraws, interpret=True,
                                        bits="stub")
    key = jax.random.key(n)
    mu, sg = _inputs(n, 1)
    rng = np.random.default_rng(2)
    xs = rng.uniform(0.2, 1.0, n).astype(np.float32)
    lps = np.full(n, lps0, np.float32)
    (jmu, jsg), jxs, jlps, jacc = jax.jit(step)(
        key, (jnp.asarray(mu), jnp.asarray(sg)), jnp.asarray(xs),
        jnp.asarray(lps), jnp.float32(eps))
    jmu, jsg, jxs, jlps = map(np.asarray, (jmu, jsg, jxs, jlps))
    jcm = (jmu != mu) | (jxs != xs)

    w0, w1, w2 = _jax_sweep_words(key)
    from kissabc_tpu_torch.ops.moves import roll_shifts
    r1, r2 = roll_shifts([w0, w1], n)
    tmu, tsg = torch.from_numpy(mu), torch.from_numpy(sg)
    dmu = torch.roll(tmu, r2) - torch.roll(tmu, r1)
    dsg = torch.roll(tsg, r2) - torch.roll(tsg, r1)
    omu, osg, oxs, olps, commit = K.fused_sweep(
        tmu, tsg, dmu, dsg, torch.from_numpy(xs), torch.from_numpy(lps),
        eps, w2, ndraws=ndraws, block=block, chunk=chunk, bits="stub")
    cm = commit.numpy()
    assert cm.shape == (n,) and omu.shape == (n,)  # no padding walkers
    assert int(jacc) == jcm.sum() > 0
    # commit masks equal except where the cost is within 1e-5 of eps
    border = np.abs(oxs.numpy() - eps) < 1e-5
    assert ((cm == jcm) | border).all()
    both = cm & jcm
    for got, want in ((omu, jmu), (osg, jsg), (oxs, jxs), (olps, jlps)):
        np.testing.assert_allclose(got.numpy()[both], want[both], rtol=RTOL,
                                   atol=ATOL)
    # walkers that do not commit keep their inputs bit for bit
    for got, x in ((omu, mu), (osg, sg), (oxs, xs), (olps, lps)):
        np.testing.assert_array_equal(got.numpy()[~cm], x[~cm])
    assert (oxs.numpy()[cm] < eps).all()


def test_fused_flagship_sweep_step_on_cpu():
    n = 200
    step = K.make_fused_flagship_sweep(n, ndraws=300)
    gen = as_generator(0, "cpu")
    mu, sg = (torch.from_numpy(x) for x in _inputs(n, 3))
    xs, lps = torch.ones(n), torch.zeros(n)
    (omu, osg), oxs, olps, acc = step(gen, (mu, sg), xs, lps, 0.5)
    changed = omu != mu
    assert int(acc) == int(changed.sum()) > 0
    assert ((omu[changed] >= 1) & (omu[changed] <= 3)).all()
    assert (osg[changed] >= 0).all() and (oxs[changed] < 0.5).all()
    assert torch.equal(oxs[~changed], xs[~changed])
    assert torch.isfinite(olps[changed]).all()
    with pytest.raises(ValueError, match="n >= 3"):
        K.make_fused_flagship_sweep(2)


def test_fused_sweep_constants_match_jax_formula():
    c = K.fused_sweep_constants(max_stretch=2.0, mu_lo=1.0, mu_hi=3.0,
                                sg_sigma=0.05, sg_lo=0.0, sg_hi=100.0)
    assert c["inv_sqrt_d"] == np.float32(2.0 / math.sqrt(2.0))
    # the flagship prior's logpdf at an interior point, in float64
    lp = -math.log(2.0) + (-math.log(0.05) - 0.5 * math.log(2 * math.pi)
                           - math.log(0.5) - 0.5 * (0.04 / 0.05) ** 2)
    assert abs(c["lp_const"] - 0.04 ** 2 * c["half_inv_var"] - lp) < 1e-5


def test_work_counts():
    nb, ops = K.normal_summary_cost_work(1 << 20, 1000)
    assert nb == 12 * (1 << 20) + 8 and ops > 4e10
    nb2, ops2 = K.fused_sweep_work(131072, 1000)
    assert nb2 == 41 * 131072 + 12 and ops2 > ops / 8
    # only walkers that pass gate 1 are charged the simulator
    nb3, ops3 = K.fused_sweep_work(131072, 1000, 65536)
    nb4, ops4 = K.fused_sweep_work(131072, 1000, 0)
    assert nb3 == nb4 == nb2 and ops4 < ops3 < ops2
    assert ops2 - ops3 == ops3 - ops4


def test_fused_sweep_proposal_gate1_is_the_sweeps():
    """The gate-1 mask the bound counts with is the sweep's own: every
    commit passed it, and with eps = +inf every walker that passed it
    commits (the flagship cost is finite inside the prior's support)."""
    n = 400
    mu, sg = (torch.from_numpy(x) for x in _inputs(n, 5))
    dmu = torch.roll(mu, 7) - torch.roll(mu, 3)
    dsg = torch.roll(sg, 7) - torch.roll(sg, 3)
    xs, lps = torch.full((n,), 0.5), torch.full((n,), -3.0)
    consts = K.fused_sweep_constants(max_stretch=2.0, mu_lo=1.0, mu_hi=3.0,
                                     sg_sigma=0.05, sg_lo=0.0, sg_hi=100.0)
    kw = dict(consts=consts, block=256, bits="stub")
    gate1 = K.fused_sweep_proposal_plain(mu, sg, dmu, dsg, lps, 9, **kw)[3]
    assert 0 < int(gate1.sum()) < n
    for eps, same in ((0.5, False), (float("inf"), True)):
        commit = K.fused_sweep_plain(
            mu, sg, dmu, dsg, xs, lps, eps, 9, ndraws=300, target_mu=2.0,
            target_sd=0.04, sd_weight=50.0, chunk=128, **kw)[4]
        assert not (commit & ~gate1).any()
        assert torch.equal(commit, gate1) == same
