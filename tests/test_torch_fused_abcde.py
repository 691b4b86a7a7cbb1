"""kissabc_tpu_torch's fused ABC-DE generation (``ops/fused_abcde.py``,
kernel #10): its plain version held on the CPU against the JAX Pallas
kernel ``make_fused_abcde_generation`` in interpret mode on the stub bit
stream, given the JAX generation's own seed, on the flagship model (cost
on the raw and on the pushed proposal) and on a discrete prior, with
inactive walkers and walkers at lps = -inf; the generation's contract
and messages; and ABCDE through it against the split path (the cases of
``tests/test_pallas.py::TestFusedABCDEGeneration``). The CUDA kernel is
held against the plain version on the card by chip_smoke.py.

Tolerance: the gate masks are equal; the commit masks are equal except
where the simulated cost lies within 1e-4 (relative, floor 1) of
``max(eps_i, ds)`` (XLA's CPU and PyTorch's transcendentals differ by an
ulp); committed values within the JAX golden tolerance (rtol 2e-4, atol
2e-5, tests/test_pallas.py:104); walkers that do not commit keep their
inputs bit for bit. The ABCDE runs keep the tolerances of the JAX tests
they mirror.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kissabc_tpu as ka
import kissabc_tpu_torch as kt
from kissabc_tpu_torch import convert
from kissabc_tpu_torch.ops import fused_abcde as FD
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
BAND = 1e-4
KW = dict(ndraws=200, chunk=128, block=128, walker_tiles=2, bits="stub")
GAMMA = float(2.38 / np.sqrt(4.0))


def _models(lib):
    """(prior, draw, reduce_cost) per case in ``jnp`` or ``torch``: the
    flagship model of tests/test_pallas.py:1333-1350; the flagship draw
    with the linear reduce of the JAX golden tests (its ``m2 - m1^2``
    cancels no digits, so the sums' order, a few ulps, stays within the
    tolerance); and the discrete prior of
    tests/test_abcde_pfilter.py:117-132 with a Gaussian simulator around
    the particle."""
    dist = kt if lib is torch else ka
    fprior = dist.Factored(dist.Uniform(1, 3),
                           dist.TruncatedNormal(0, 0.05, 0, 100))

    def fdraw(th, eps):
        return th[0] + th[1] * eps

    def frc(th, m):
        var = lib.maximum(m[1] - m[0] * m[0], lib.zeros_like(m[0]))
        return lib.sqrt(lib.square(m[0] - 2.0)
                        + lib.square((lib.sqrt(var) - 0.04) * 50.0))

    def ddraw(x, eps):
        return x + 0.5 * eps

    def drc(x, m):
        return lib.abs(m[0] - 5.0)

    return {"flagship": (fprior, fdraw, frc),
            "flagship-linear": (fprior, fdraw,
                                lambda th, m: m[0] + 10.0 * m[1]),
            "discrete": (dist.DiscreteUniform(0, 10), ddraw, drc),
            # a Dirac marginal: pushed to its atom 2.5 in the kernel
            "dirac": (dist.Factored(dist.Dirac(2.5), dist.Uniform(0.1, 1.0)),
                      fdraw, lambda th, m: lib.abs(m[0] - 3.0))}


def _population(case, n, rng):
    """(thetas, bases, lps, ds, active, eps_i) as numpy: the bases are
    random rows of the population, a quarter of the walkers inactive, a
    few at lps = -inf."""
    if case.startswith("flagship"):
        th = (rng.uniform(1.5, 2.5, n).astype(np.float32),
              rng.uniform(0.01, 0.1, n).astype(np.float32))
    elif case == "dirac":
        th = (rng.uniform(2.0, 3.0, n).astype(np.float32),
              rng.uniform(0.1, 1.0, n).astype(np.float32))
    else:
        th = (rng.integers(0, 11, n) + rng.uniform(-0.4, 0.4, n)).astype(
            np.float32)
    # costs and thresholds on the scale of the model's costs
    lo, hi, e_lo, e_hi = ((20.0, 70.0, 30.0, 45.0) if case ==
                          "flagship-linear" else (0.0, 2.0, 0.3, 0.8))
    idx = [rng.integers(0, n, n) for _ in range(3)]
    if isinstance(th, tuple):
        bases = tuple(tuple(x[i] for x in th) for i in idx)
    else:
        bases = tuple(th[i] for i in idx)
    ds = rng.uniform(lo, hi, n).astype(np.float32)
    active = rng.uniform(size=n) > 0.25
    eps_i = np.where(ds <= e_lo, e_lo, e_hi).astype(np.float32)
    return th, bases, ds, active, eps_i


def _leaves(th):
    return list(th) if isinstance(th, tuple) else [th]


@pytest.mark.parametrize("case,cost_on", [("flagship-linear", "raw"),
                                          ("flagship-linear", "pushed"),
                                          ("discrete", "raw"),
                                          ("discrete", "pushed"),
                                          ("dirac", "pushed")])
def test_generation_matches_the_pallas_kernel(case, cost_on):
    n = 300   # a tail of 44 walkers in the last 128-row of a stub tile
    jprior, jdraw, jrc = _models(jnp)[case]
    pprior, pdraw, prc = _models(torch)[case]
    rng = np.random.default_rng(3)
    th, bases, ds, active, eps_i = _population(case, n, rng)
    jtree = (lambda t: tuple(map(jnp.asarray, t)) if isinstance(t, tuple)
             else jnp.asarray(t))
    lps = np.asarray(jprior.logpdf_tree(jprior.push_tree(jtree(th))),
                     np.float32).copy()
    lps[::13] = -np.inf
    jgen = ka.make_fused_abcde_generation(jprior, jdraw, jrc, gamma=GAMMA,
                                          cost_on=cost_on, interpret=True,
                                          **KW)
    key = jax.random.key(7)
    jout = jgen(key, jtree(th), tuple(jtree(b) for b in bases),
                jnp.asarray(lps), jnp.asarray(ds), jnp.asarray(active),
                jnp.asarray(eps_i))
    want = [np.asarray(x) for x in _leaves(jout[0])] + [
        np.asarray(x) for x in jout[1:]]
    seed = int(jax.random.bits(key, (), jnp.uint32))
    pgen = kt.make_fused_abcde_generation(pprior, pdraw, prc, gamma=GAMMA,
                                          cost_on=cost_on, **KW)
    pth, plps, pds = convert.abcde_state_from_numpy(th, lps, ds)
    pbases = [_leaves(convert.abcde_state_from_numpy(b, lps, ds)[0])
              for b in bases]
    out = pgen.generation_plain(
        _leaves(pth), pbases, plps, pds,
        torch.from_numpy(active).float(), torch.from_numpy(eps_i), seed,
        terms=True)
    got = [x.numpy() for x in out[0]] + [x.numpy() for x in out[1:4]]
    dp = out[4].numpy()
    gate_g, gate_w = got[-1] > 0.5, want[-1] > 0.5
    np.testing.assert_array_equal(gate_g, gate_w)
    assert not gate_g[~active].any()
    assert 0 < gate_g.sum() < n
    # a walker at lps = -inf passes the gate with any finite proposal
    assert gate_g[(lps == -np.inf) & active].any()
    inputs = _leaves(th) + [lps, ds]
    commit = [np.any([o != x for o, x in zip(outs[:-1], inputs)], axis=0)
              for outs in (got, want)]
    hi = np.maximum(eps_i, ds)
    border = np.abs(dp - hi) < BAND * np.maximum(1.0, np.abs(hi))
    differ = commit[0] != commit[1]
    assert not (differ & ~border).any()
    both = commit[0] & commit[1]
    assert both.sum() > 0 and not commit[0][~gate_g].any()
    for g, w, x in zip(got[:-1], want[:-1], inputs):
        np.testing.assert_allclose(g[both], w[both], rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(g[~commit[0]], x[~commit[0]])
        np.testing.assert_array_equal(w[~commit[1]], x[~commit[1]])
    if case == "discrete":   # the raw float shadow is committed
        m = got[0][both]
        assert (m != np.round(m)).any()


def test_generation_draws_one_seed_word():
    """``gen`` draws one word from the generator as the seed and runs the
    plain version on CPU tensors; the outputs keep the population's
    structure and the gate is float 0/1."""
    prior, draw, rc = _models(torch)["flagship"]
    g = kt.make_fused_abcde_generation(prior, draw, rc, gamma=GAMMA, **KW)
    assert g.gamma == GAMMA and g.mesh is None
    th, bases, ds, active, eps_i = _population("flagship", 256,
                                               np.random.default_rng(1))
    pth, lps, pds = convert.abcde_state_from_numpy(
        th, np.zeros(256, np.float32), ds)
    pb = tuple(convert.abcde_state_from_numpy(b, lps, ds)[0] for b in bases)
    act, ei = torch.from_numpy(active), torch.from_numpy(eps_i)
    out = g(torch.Generator().manual_seed(2), pth, pb, lps, pds, act, ei)
    seed = FD.uint32_words(torch.Generator().manual_seed(2), 1)
    want = g.generation_plain(list(pth), [list(b) for b in pb], lps, pds,
                              act.float(), ei, seed)
    assert isinstance(out[0], tuple) and len(out[0]) == 2
    for a, b in zip(list(out[0]) + list(out[1:]), list(want[0])
                    + list(want[1:])):
        assert torch.equal(a, b)
    assert set(out[3].unique().tolist()) <= {0.0, 1.0}


# ---------------------------------------------------------------------------
# TestFusedABCDEGeneration
# ---------------------------------------------------------------------------

def _flagship_cost():
    prior, draw, rc = _models(torch)["flagship"]
    return prior, draw, rc, kt.make_streaming_moment_cost(draw, rc,
                                                          ndraws=200)


def test_validation():
    prior, draw, rc, scost = _flagship_cost()
    with pytest.raises(ValueError, match="multiple of 128"):
        kt.make_fused_abcde_generation(prior, draw, rc, gamma=GAMMA,
                                       block=100)
    with pytest.raises(ValueError, match="cost_on"):
        kt.make_fused_abcde_generation(prior, draw, rc, gamma=GAMMA,
                                       cost_on="x")
    with pytest.raises(TypeError, match="Mesh"):
        kt.make_fused_abcde_generation(prior, draw, rc, gamma=GAMMA,
                                       mesh=object())
    bad = kt.make_fused_abcde_generation(prior, draw, rc, gamma=0.123, **KW)
    with pytest.raises(ValueError, match="same gamma"):
        kt.ABCDE(prior, scost, 0.1, nparticles=256, cost_vectorized=True,
                 sweep_fused=bad, verbose=False, device="cpu")
    with pytest.raises(ValueError, match="SAME mesh"):
        kt.ABCDE(prior, scost, 0.1, nparticles=256, cost_vectorized=True,
                 sweep_fused=bad, mesh=object(), verbose=False,
                 device="cpu")
    g = kt.make_fused_abcde_generation(prior, draw, rc, gamma=GAMMA, **KW)
    th = torch.ones(128)
    with pytest.raises(ValueError, match="leaves"):
        g(torch.Generator(), (th,), ((th,),) * 3, th, th, th, th)


def test_fused_matches_split_statistically():
    """ABCDE with the fused generation (plain version, stub bits)
    recovers the flagship posterior as the split path does, with a
    comparable simulator-call tally (tests/test_pallas.py:1356-1373)."""
    prior, draw, rc, scost = _flagship_cost()
    gen = kt.make_fused_abcde_generation(prior, draw, rc, gamma=GAMMA, **KW)
    a = kt.ABCDE(prior, scost, 0.1, nparticles=512, generations=40,
                 cost_vectorized=True, sweep_fused=gen, verbose=False, key=3,
                 device="cpu")
    b = kt.ABCDE(prior, scost, 0.1, nparticles=512, generations=40,
                 cost_vectorized=True, verbose=False, key=3, device="cpu")
    for res in (a, b):
        mu, sg = res.P
        assert abs(mu.mean() - 2.0) < 0.02
        assert abs(sg.mean() - 0.04) < 0.005
    assert abs(a.nsim - b.nsim) / b.nsim < 0.15


def test_generation_refuses_what_the_kernel_cannot_read():
    """Every vector the kernel reads has the population's length and
    device: a shorter base or cost vector is refused before a launch."""
    prior, draw, rc = _models(torch)["flagship"]
    g = kt.make_fused_abcde_generation(prior, draw, rc, gamma=GAMMA, **KW)
    th = [torch.ones(128), torch.ones(128)]
    v = torch.ones(128)
    with pytest.raises(ValueError, match="ta must be a vector of length"):
        g.run(th, [th, [v, v[:64]], th], v, v, v, v, 7)
    with pytest.raises(ValueError, match="eps_i must be a vector"):
        g.run(th, [th, th, th], v, v, v, v[:100], 7)
    with pytest.raises(ValueError, match="unsupported device"):
        g.run([x.to("meta") for x in th], [th] * 3, v, v, v, v, 7)
