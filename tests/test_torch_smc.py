"""kissabc_tpu_torch's smc on the CPU: one iteration of the loop body
held against the JAX ``program.body`` from the same numpy state, the
README oracle run end to end through the port, the knob checks with
the JAX package's messages, and what the port still leaves out.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kissabc_tpu as ka
from kissabc_tpu.core.smc import _smc_program
from kissabc_tpu.core.smc import _SMCState as JState
from kissabc_tpu.ops.pallas_kernels import (
    make_flagship_cost_batched as jax_flagship_cost)
import kissabc_tpu_torch as kt
from kissabc_tpu_torch import convert
from kissabc_tpu_torch.core.smc import _SMCProgram


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run on small tensors, where one thread is the
    fastest and does not contend with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_prior():
    return ka.Factored(ka.Uniform(1, 3), ka.TruncatedNormal(0, 0.05, 0, 100))


def _spec_of(jprior):
    """The numpy spec of a JAX flagship prior, read from its marginals."""
    u, t = jprior.p
    return ("Factored", [
        ("Uniform", {"a": float(u.a), "b": float(u.b)}),
        ("Truncated", {"base": ("Normal", {"mu": float(t.base.mu),
                                           "sigma": float(t.base.sigma)}),
                       "lo": float(t.lo), "hi": float(t.hi)})])


def _port_prior():
    return convert.prior_from_numpy(_spec_of(_jax_prior()))


def _f32_ulps(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


# ---------------------------------------------------------------------------
# (g) one body iteration from one numpy state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(alpha=0.95, min_r_ess=None, impl="sort", ties=False),   # resamples
    dict(alpha=0.95, min_r_ess=None, impl="bisect", ties=False),
    dict(alpha=0.5, min_r_ess=0.1, impl="sort", ties=False),     # does not
    dict(alpha=0.9, min_r_ess=0.5, impl="bisect", ties=True),    # flag set
])
def test_body_matches_jax_before_the_sweep(case):
    """eps bitwise equal, logz within 1 ulp, alive and it equal: the
    parts of an iteration fixed before the sweep's randomness enters."""
    n = 128
    alpha = case["alpha"]
    min_r_ess = alpha ** 2 if case["min_r_ess"] is None else case["min_r_ess"]
    r_epstol = (1 - alpha) ** 1.5 / 50.0
    rng = np.random.default_rng(4)
    thetas = (rng.uniform(1, 3, n).astype(np.float32),
              rng.uniform(0.01, 0.2, n).astype(np.float32))
    xs = rng.exponential(0.5, n).astype(np.float32)
    if case["ties"]:
        xs[: n * 3 // 4] = np.float32(0.125)
    alive = rng.random(n) < 0.85
    eps, logz, it = np.float32(2.5), np.float32(-0.7), 5
    jprior = _jax_prior()
    lps = np.asarray(jax.vmap(lambda a, b: jprior.logpdf_tree((a, b)))(
        *map(jnp.asarray, thetas)), np.float32)

    knobs = dict(nparticles=n, alpha=alpha, mcmc_retrys=0, mcmc_tol=0.015,
                 epstol=0.0, r_epstol=r_epstol, min_r_ess=min_r_ess,
                 max_stretch=2.0, max_iters=100, resample="replicate",
                 verbose=False, quantile_impl=case["impl"])
    jprog = _smc_program(jprior, jax_flagship_cost(), cost_vectorized=True,
                         **knobs)
    jstate = JState(jax.random.key(0), tuple(map(jnp.asarray, thetas)),
                    jnp.asarray(xs), jnp.asarray(lps), jnp.asarray(alive),
                    jnp.float32(eps), jnp.float32(logz), jnp.int32(it),
                    jnp.int32(0), jnp.asarray(False))
    jout = jax.jit(jprog.body)(jstate)

    tprog = _SMCProgram(_port_prior(), kt.make_flagship_cost_batched(),
                        device="cpu", **knobs)
    tstate = convert.state_from_numpy(thetas, xs, lps, alive, eps, logz, it,
                                      key=0, device="cpu")
    tout = tprog.body(tstate)

    assert np.float32(tout.eps).view(np.uint32) == \
        np.float32(jout.eps).view(np.uint32)
    assert _f32_ulps(tout.logz, jout.logz) <= 1
    np.testing.assert_array_equal(tout.alive.numpy(), np.asarray(jout.alive))
    assert int(tout.it) == int(jout.it) == it + 1
    # the sweep itself: committed walkers are in support, under eps
    mu, sg = tout.thetas
    assert ((mu >= 1) & (mu <= 3)).all() and (sg >= 0).all()
    moved = tout.xs != torch.from_numpy(xs)
    assert (tout.xs[moved] <= tout.eps).all()
    assert torch.isfinite(tout.lps).all()


def test_convert_state_and_prior():
    st = convert.state_from_numpy(
        (np.ones(4), np.zeros(4)), np.arange(4), np.zeros(4),
        np.array([1, 0, 1, 1], bool), 0.5, -1.0, 3)
    assert st.thetas[0].dtype == torch.float32 and st.alive.dtype == torch.bool
    assert int(st.it) == 3 and not bool(st.done)
    p = _port_prior()
    assert isinstance(p, kt.Factored) and p.nparams == 2
    assert float(p.p[1].base.sigma) == np.float32(0.05)
    assert isinstance(convert.prior_from_numpy(
        ("Multinomial", {"n": 3, "p": [0.5, 0.5]})), kt.Multinomial)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        convert.prior_from_numpy(("NoSuchFamily", {"n": 3}))


# ---------------------------------------------------------------------------
# (h) the README oracle through the port, end to end
# ---------------------------------------------------------------------------

def test_readme_normal_model_through_port():
    """The README flagship model (tests/test_smc.py:11-27): posterior
    mu=2.0+-0.0062, sigma=0.0401+-0.00081, through the batched cost."""
    prior = kt.Factored(kt.Uniform(1, 3), kt.TruncatedNormal(0, 0.05, 0, 100))
    res = kt.smc(prior, kt.make_flagship_cost_batched(), cost_vectorized=True,
                 nparticles=200, key=1, device="cpu")
    mu_p, sig_p = res.P
    assert res.eps < 0.02
    assert abs(mu_p.mean() - 2.0) < 0.02
    assert abs(sig_p.mean() - 0.0401) < 0.004
    assert res.C.shape == (200,) and res.ess == len(mu_p)
    assert np.isfinite(res.log_evidence) and res.log_evidence < 0


def _small_run(**kw):
    prior = kt.Factored(kt.Uniform(1, 3), kt.TruncatedNormal(0, 0.05, 0, 100))
    args = dict(cost_vectorized=True, nparticles=64, epstol=0.3, key=3,
                device="cpu")
    args.update(kw)
    return kt.smc(prior, kt.make_flagship_cost_batched(ndraws=200), **args)


def test_smc_deterministic_and_quantile_impls_bitwise():
    a = _small_run()
    b = _small_run()
    c = _small_run(quantile_impl="bisect")
    np.testing.assert_array_equal(a.C, b.C)
    np.testing.assert_array_equal(a.C, c.C)
    assert a.eps == c.eps <= 0.3 and a.iterations == c.iterations
    d = _small_run(key=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a.C, d.C)


@pytest.mark.parametrize("kw", [dict(resample="systematic"),
                                dict(partner_scheme="roll", mcmc_retrys=2)])
def test_smc_variants_converge(kw):
    res = _small_run(**kw)
    assert res.eps <= 0.3
    assert abs(res.P[0].mean() - 2.0) < 0.2


def test_smc_max_iters_warns():
    with pytest.warns(RuntimeWarning, match="smc: stopped at the max_iters=3"):
        res = _small_run(max_iters=3, epstol=0.0)
    assert res.iterations == 3
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _small_run()


# ---------------------------------------------------------------------------
# knob validation: the JAX package's messages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    dict(alpha=0.0), dict(alpha=1.5), dict(min_r_ess=0.0),
    dict(mcmc_retrys=-1), dict(r_epstol=-1.0), dict(mcmc_tol=-0.1),
    dict(max_stretch=1.0), dict(resample="multinomial"),
    dict(partner_scheme="ring"), dict(quantile_impl="median"),
    dict(nparticles=2),
])
def test_knob_validation_messages_match_jax(bad):
    with pytest.raises(ValueError) as jerr:
        ka.smc(_jax_prior(), lambda th, k: th[0], **bad)
    with pytest.raises(ValueError) as terr:
        kt.smc(_port_prior(), kt.make_flagship_cost_batched(),
               cost_vectorized=True, device="cpu", **bad)
    assert str(terr.value) == str(jerr.value)


def test_left_for_later_slices_raise():
    """Walker sharding runs (tests/test_torch_parallel.py); a mesh that
    is not a ``Mesh`` raises ``TypeError`` naming its type and the
    caller."""
    prior, cost = _port_prior(), kt.make_flagship_cost_batched()
    with pytest.raises(TypeError, match="mesh"):
        kt.smc(prior, cost, cost_vectorized=True, mesh=object(),
               device="cpu")
    with pytest.raises(TypeError, match="smc_stepped.*mesh"):
        kt.smc_stepped(prior, cost, cost_vectorized=True, mesh=object(),
                       device="cpu")


def test_smc_defaults_to_cuda():
    """No entry point picks the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kt.smc(_port_prior(), kt.make_flagship_cost_batched(),
               cost_vectorized=True, nparticles=64)
