"""kissabc_tpu_torch's ``ess``/``rhat`` (its own numpy copy of
``kissabc_tpu/utils/diagnostics.py``) equal the JAX package's on the
same arrays — exactly, since both run the same float64 numpy — on the
cases of ``tests/test_diagnostics.py``, and take torch tensors and the
port's ``Particles``.
"""

import numpy as np
import pytest
import torch

import kissabc_tpu as ka
import kissabc_tpu_torch as kt
from kissabc_tpu.utils import diagnostics as JD
from kissabc_tpu_torch.utils import diagnostics as TD


def _ar1(rho, n, seed):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal(n)
    y = np.empty(n)
    y[0] = e[0]
    for t in range(1, n):
        y[t] = rho * y[t - 1] + np.sqrt(1 - rho * rho) * e[t]
    return y


def _antithetic():
    z = np.random.default_rng(3).standard_normal(5000)
    anti = np.empty(10000)
    anti[0::2], anti[1::2] = z, -z
    return anti


def _cases():
    rng = np.random.default_rng(0)
    tail = rng.normal(size=4000)
    tail[:500] = tail.max() + 1.0
    return {
        "iid": rng.standard_normal((4, 2000)),
        "ar1": _ar1(0.9, 20000, 1),
        "disjoint": np.concatenate([rng.standard_normal((1, 1000)),
                                    rng.standard_normal((1, 1000)) + 3.0]),
        "drift": np.linspace(0.0, 5.0, 2000) + rng.standard_normal(2000),
        "antithetic": _antithetic(),
        "constant": np.ones(100),
        "short5": rng.standard_normal(5),
        "short7": rng.standard_normal(7),
        "frozen": np.concatenate([np.zeros((1, 100)), np.ones((1, 100))]),
        "cauchy": rng.standard_cauchy((4, 1000)),
        "scale": np.vstack([rng.standard_normal((2, 1000)),
                            5.0 * rng.standard_normal((2, 1000))]),
        "tail-point-mass": tail,
    }


CASES = _cases()


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", sorted(CASES))
def test_ess_rhat_equal_jax(name):
    x = CASES[name]
    for method in ("mean", "rank", "bulk", "tail"):
        _same(TD.ess(x, method=method), JD.ess(x, method=method))
    _same(TD.ess(x, split=False), JD.ess(x, split=False))
    for method in ("split", "rank"):
        _same(TD.rhat(x, method=method), JD.rhat(x, method=method))


def test_torch_tensor_and_particles_inputs():
    x = CASES["iid"].astype(np.float32)
    _same(kt.ess(torch.from_numpy(x)), JD.ess(x))
    _same(kt.rhat(torch.from_numpy(x)), JD.rhat(x))
    p = kt.Particles(x[0])
    _same(kt.ess(p), JD.ess(ka.Particles(x[0])))
    ps = [kt.Particles(c) for c in x[:3]]
    jps = [ka.Particles(c) for c in x[:3]]
    _same(kt.ess(ps, method="rank"), JD.ess(jps, method="rank"))
    _same(kt.rhat(tuple(ps)), JD.rhat(tuple(jps)))
    assert kt.ess(ps).shape == (3,)


def test_helpers_and_validation_equal_jax():
    x = np.random.default_rng(4).standard_normal((3, 256))
    _same(TD.autocovariance(x), JD.autocovariance(x))
    _same(TD.rank_normalize(x), JD.rank_normalize(x))
    for fn in (TD.ess, TD.rhat):
        with pytest.raises(ValueError, match="method"):
            fn(x, method="bogus")
    with pytest.raises(ValueError):
        TD.ess(np.zeros(3))
    with pytest.raises(ValueError):
        TD.rhat(np.zeros((2, 3)))
    with pytest.raises(ValueError):
        TD.ess(np.zeros((2, 3, 4)))


def test_on_a_port_ais_run():
    """tests/test_diagnostics.py's AIS case on the port's ``sample``."""
    pri = kt.Normal(0.0, 1.0)
    mdl = kt.CommonLogDensity(1, lambda g: pri.sample(g),
                              lambda x: -0.5 * x * x)
    res = kt.sample(mdl, kt.AIS(32), 400, ntransitions=4, key=7,
                    device="cpu")
    e, r, n = kt.ess(res), kt.rhat(res.particles), len(res)
    assert 0 < e <= n * np.log10(n) + 1e-6
    assert r < 1.2
