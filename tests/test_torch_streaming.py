"""kissabc_tpu_torch's generic streaming simulator cost
(``make_streaming_moment_cost``): its plain version held on the CPU
against the JAX Pallas kernel run in interpret mode on the stub bit
stream (the golden shape of tests/test_pallas.py:257-318), the Philox
stream's statistics, the wrapper's contract and the JAX package's
validation messages. The CUDA kernel is held against the plain version
on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kissabc_tpu.ops import pallas_kernels as pk
import kissabc_tpu_torch as kt
from kissabc_tpu_torch import models
from kissabc_tpu_torch.ops import streaming as S
from kissabc_tpu_torch.utils.rng import as_generator
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 3e-4, 3e-5   # the JAX golden tolerance (test_pallas.py:318)
GOLDEN = dict(ndraws=700, block=256, chunk=128, walker_tiles=8)


def _jax_seed(key):
    """The seed the JAX cost draws from its key (pallas_kernels.py:2642)."""
    return int(jax.random.bits(key, (), jnp.uint32))


def _gk_jax(th, e):
    a, b, g, k = th
    return a + b * (1.0 + 0.8 * jnp.tanh(g * e / 2.0)) * e \
        * jnp.exp(k * jnp.log1p(e * e))


_GK_TORCH = models.g_and_k()[1]   # the port's own g-and-k draw


# name: (JAX draw, port draw, stats (JAX, port) or None, K, noise)
CASES = {
    "moments-flagship": (lambda th, z: th[0] + th[1] * z,
                         lambda th, z: th[0] + th[1] * z, None, 2, "normal"),
    "ecdf-ragged": (lambda th, z: th[0] + th[1] * z,
                    lambda th, z: th[0] + th[1] * z,
                    ([lambda x, t=t: (x < t).astype(jnp.float32)
                      for t in (1.5, 2.0, 2.5)] + [jnp.ones_like],
                     [lambda x, t=t: (x < t).to(torch.float32)
                      for t in (1.5, 2.0, 2.5)] + [torch.ones_like]),
                    2, "normal"),
    "uniform-exponential": (lambda th, u: -jnp.log1p(-u) / th[0],
                            lambda th, u: -torch.log1p(-u) / th[0], None, 1,
                            "uniform"),
    "g-and-k": (_gk_jax, _GK_TORCH, None, 4, "normal"),
}


# parameter ranges by K: a rate; the flagship (mu, sigma); the g-and-k
# prior of bench.py:362-370
_RANGES = {1: [(1.0, 3.0)], 2: [(1.0, 3.0), (0.01, 0.1)],
           4: [(0.0, 6.0), (0.1, 3.0), (-1.0, 5.0), (0.0, 0.9)]}


def _thetas(k, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, n).astype(np.float32)
            for lo, hi in _RANGES[k]]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_interpret_on_stub_bits(name):
    """Moments and costs of the plain version against the Pallas kernel
    at the golden shape (n=300, 700 draws: a ragged last chunk pair),
    from the same thetas and the JAX cost's own seed."""
    jdraw, tdraw, stats, k, noise = CASES[name]
    jstats, tstats = stats if stats else (None, None)
    n = 300
    th = _thetas(k, n, 5)
    seen = {}

    def keep(thetas, m):
        seen["m"] = m
        return m[0] + 10.0 * m[1] if len(m) > 1 else m[0]

    jcost = pk.make_streaming_moment_cost(
        jdraw, keep, nmoments=2, stats=jstats, noise=noise, bits="stub",
        interpret=True, **GOLDEN)
    key = jax.random.key(0)
    want = np.asarray(jcost(tuple(map(jnp.asarray, th)), key))
    jm = [np.asarray(m) for m in seen["m"]]

    tcost = kt.make_streaming_moment_cost(
        tdraw, lambda thetas, m: m[0] + 10.0 * m[1] if len(m) > 1 else m[0],
        nmoments=2, stats=tstats, noise=noise, bits="stub", **GOLDEN)
    tth = tuple(torch.from_numpy(x) for x in th)
    seed = _jax_seed(key)
    moments = tcost.moments(tth, seed)
    assert len(moments) == len(jm)
    for got, m in zip(moments, jm):
        assert got.shape == (n,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), m, rtol=RTOL, atol=ATOL)
    got = tcost.reduce_cost(tth, moments)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if stats is not None:   # the boundary mask drops contributions: E[1]=1
        np.testing.assert_allclose(moments[-1].numpy(), 1.0, rtol=1e-6)


def test_cost_equals_plain_on_cpu_and_draws_seed_from_gen():
    draw = CASES["moments-flagship"][1]
    cost = kt.make_streaming_moment_cost(
        draw, lambda th, m: m[0] - m[1], ndraws=200)
    th = tuple(torch.from_numpy(x) for x in _thetas(2, 64, 1))
    a = cost(th, as_generator(9, "cpu"))
    b = cost(th, as_generator(9, "cpu"))
    c = cost(th, as_generator(10, "cpu"))
    assert a.shape == (64,) and torch.equal(a, b) and not torch.equal(a, c)
    seed = int(torch.randint(0, 1 << 32, (1,),
                             generator=as_generator(9, "cpu"),
                             dtype=torch.int64))
    m = cost.moments_plain(th, seed)
    assert torch.equal(a, m[0] - m[1])
    assert S.launches["streaming_moment_cost"] == 0   # the CPU launches none


def test_bare_theta_and_scalar_leaf_check():
    cost = kt.make_streaming_moment_cost(lambda th, u: -torch.log1p(-u) / th,
                                         lambda th, m: m[0], noise="uniform",
                                         ndraws=100)
    rate = torch.full((16,), 2.0)
    assert cost(rate, as_generator(0, "cpu")).shape == (16,)
    with pytest.raises(ValueError, match="scalar"):
        cost((torch.ones(8, 2),), as_generator(0, "cpu"))


def test_philox_statistics():
    """Philox bits: the flagship model at its truth has mean cost 0.0357
    (tests/test_pallas.py:331-346), and the uniform inverse-cdf draw has
    the Exp(2) raw moments E[x] = 0.5, E[x^2] = 0.5."""
    def reduce_cost(th, m):
        var = torch.clamp(m[1] - m[0] * m[0], min=0.0)
        return torch.sqrt(torch.square(m[0] - 2.0)
                          + torch.square((torch.sqrt(var) - 0.04) * 50.0))

    n = 1024
    cost = kt.make_streaming_moment_cost(lambda th, z: th[0] + th[1] * z,
                                         reduce_cost)
    c = cost((torch.full((n,), 2.0), torch.full((n,), 0.04)),
             as_generator(0, "cpu"))
    assert torch.isfinite(c).all()
    assert abs(float(c.mean()) - 0.0357) < 0.005
    expo = kt.make_streaming_moment_cost(
        lambda th, u: -torch.log1p(-u) / th[0], lambda th, m: m[0],
        noise="uniform", ndraws=4000)
    m1, m2 = expo.moments((torch.full((256,), 2.0),), 3)
    assert abs(float(m1.mean()) - 0.5) < 0.01
    assert abs(float(m2.mean()) - 0.5) < 0.03


@pytest.mark.parametrize("kw,match", [
    (dict(nmoments=0), "nmoments"), (dict(nmoments=9), "nmoments"),
    (dict(noise="poisson"), "noise"), (dict(block=100), "multiple of 128"),
    (dict(stats=[]), "stats must have"),
])
def test_validation_messages_match_jax(kw, match):
    with pytest.raises(ValueError, match=match) as jerr:
        pk.make_streaming_moment_cost(lambda t, z: z, lambda t, m: m[0], **kw)
    with pytest.raises(ValueError, match=match) as terr:
        kt.make_streaming_moment_cost(lambda t, z: z, lambda t, m: m[0], **kw)
    assert str(terr.value) == str(jerr.value)


def test_no_interpret_and_bits_checked():
    with pytest.raises(TypeError, match="interpret"):
        kt.make_streaming_moment_cost(lambda t, z: z, lambda t, m: m[0],
                                      interpret=True)
    with pytest.raises(ValueError, match="bits must be"):
        kt.make_streaming_moment_cost(lambda t, z: z, lambda t, m: m[0],
                                      bits="threefry")


def test_work_counts_follow_the_model():
    flag = kt.make_streaming_moment_cost(lambda th, z: th[0] + th[1] * z,
                                         lambda th, m: m[0])
    gk = kt.make_streaming_moment_cost(_GK_TORCH, lambda th, m: m[0])
    nb, ops = flag.work(1 << 20, 2)
    assert nb == 4 * (1 << 20) * 4 + 8
    assert ops == (1 << 20) * (1000 * (S.NOISE_OPS["normal"] + 2 + 1 + 2)
                               + 2)
    assert gk.work(1 << 20, 4)[1] > ops   # the g-and-k draw costs more
