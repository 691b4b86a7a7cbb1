"""kissabc_tpu_torch's AIS moves (``ops/moves.py``) against the JAX
package's (``kissabc_tpu/ops/moves.py``): the stretch variate, the
raw-bits -> variate maps and the partner shifts on the same uint32 words,
the fused rotation mixture and the single-walker mixture from the same
draws, and the statistical checks of ``tests/test_moves.py`` (the
stretch Jacobian, the g-density, MH keeping N(0, 1)).

Tolerances: integer results and the uniform map bit for bit; float32
arithmetic that goes through ``exp``/``log``/``log1p`` within 2 ulps
(XLA's CPU transcendentals and PyTorch's differ by 1 ulp); the normal
map within 128 ulps, because ``jax.lax.erf_inv`` and ``torch.erfinv``
are different approximations (89 ulps, 2.1e-5 absolute, the largest
seen over 200000 words).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kissabc_tpu as ka
from kissabc_tpu.ops import moves as JM
import kissabc_tpu_torch as kt
from kissabc_tpu_torch.core import ais as PA
from kissabc_tpu_torch.ops import moves as PM
from torch_threads import one_torch_thread  # noqa: F401

ERFINV_ULPS = 128


def _words(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)


def _t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64)
                           if np.asarray(x).dtype == np.uint32
                           else np.array(x))


def _ulps(a, b):
    """Distance in float32 units in the last place."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# the variates, bit for bit or within the stated ulps
# ---------------------------------------------------------------------------

def test_cdf_g_inv_matches_jax_and_closed_form():
    u = np.random.default_rng(1).random(4096).astype(np.float32)
    for a in (2.0, 3.0, 5.0):
        want = np.asarray(JM.cdf_g_inv(jnp.asarray(u), a))
        got = PM.cdf_g_inv(torch.as_tensor(u), a).numpy()
        np.testing.assert_array_equal(got, want)
    # transition.jl:46 and the support [1/a, a]
    for uu in (0.0, 0.3, 1.0):
        closed = (uu * (math.sqrt(3) - math.sqrt(1 / 3))
                  + math.sqrt(1 / 3)) ** 2
        assert abs(float(PM.cdf_g_inv(torch.tensor(uu), 3.0)) - closed) < 1e-6


def test_bits_to_variate_maps_match_jax():
    w = _words(200_000)
    jw, pw = jnp.asarray(w), _t(w)
    np.testing.assert_array_equal(
        PM._bits_to_uniform(pw).numpy(), np.asarray(JM._bits_to_uniform(jw)))
    lu_p = PM._bits_to_log_uniform(pw).numpy()
    lu_j = np.asarray(JM._bits_to_log_uniform(jw))
    assert _ulps(lu_p, lu_j).max() <= 2
    z_p = PM._bits_to_normal(pw).numpy()
    z_j = np.asarray(JM._bits_to_normal(jw))
    assert np.isfinite(z_p).all()
    assert _ulps(z_p, z_j).max() <= ERFINV_ULPS


def test_bits_to_variate_laws():
    """The maps keep the laws of the primitives they replace (the moment
    and range checks of tests/test_moves.py)."""
    pw = _t(_words(200_000, seed=3))
    u = PM._bits_to_uniform(pw).numpy()
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 2e-3 and abs(u.var() - 1 / 12) < 1e-3
    z = PM._bits_to_normal(pw).numpy()
    assert abs(z.mean()) < 6e-3 and abs(z.std() - 1.0) < 5e-3
    assert abs(np.mean(z ** 4) - 3.0) < 0.06
    lu = PM._bits_to_log_uniform(pw).numpy()
    assert (lu <= 0).all() and abs((-lu).mean() - 1.0) < 6e-3


@pytest.mark.parametrize("hc,ks", [(7, (1, 2, 3)), (65536, (1, 2, 3)),
                                   (5, (3,)), (1000, (2, 2, 1))])
def test_distinct_shifts_match_jax(hc, ks):
    for seed in range(20):
        v = _words(sum(ks), seed)
        want = [int(x) for x in JM._distinct_shifts(jnp.asarray(v), hc, ks)]
        got = [int(x) for x in PM._distinct_shifts(_t(v), hc, ks)]
        assert got == want
        i = 0
        for k in ks:   # distinct within each group, all inside [0, hc)
            grp = got[i:i + k]
            assert len(set(grp)) == k and all(0 <= x < hc for x in grp)
            i += k


# ---------------------------------------------------------------------------
# the moves from the same draws
# ---------------------------------------------------------------------------

def _ensemble(h, seed, shapes=((), (3,))):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(h,) + s).astype(np.float32) for s in shapes)


@pytest.mark.parametrize("accept_lu", [True, False])
def test_rollfused_mixture_from_the_same_words(accept_lu):
    """JAX's ``_mixture_batched_rollfused`` on a key and the port's
    ``rollfused_from_words`` on the words and shifts that key gives:
    proposals within 1e-5 relative (the DE jitter's normals carry the
    erfinv difference), corr and lu within 2 ulps."""
    h, d = 256, 4
    half, comp = _ensemble(h, 0), _ensemble(h, 1)
    key = jax.random.key(11)
    jp, jc, jlu = JM._mixture_batched_rollfused(
        key, tuple(map(jnp.asarray, half)), tuple(map(jnp.asarray, comp)), d,
        3.0, None, accept_lu, h)
    kshift, kvec = jax.random.split(key)
    v = np.asarray(jax.random.bits(kshift, (6,), jnp.uint32))
    R = 6 + 4 + int(accept_lu)
    w = np.asarray(jax.random.bits(kvec, (R, h), jnp.uint32))
    shifts = PM._distinct_shifts(_t(v), h, (1, 2, 3))
    pp, pc, plu = PM.rollfused_from_words(
        tuple(map(torch.as_tensor, half)), tuple(map(torch.as_tensor, comp)),
        d, 3.0, _t(w), shifts, accept_lu)
    for a, b in zip(pp, jp):
        # the DE jitter's normals differ by up to ERFINV_ULPS (erfinv):
        # the proposals agree to 1e-5 relative
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    assert _ulps(pc.numpy(), np.asarray(jc)).max() <= 2
    if accept_lu:
        assert _ulps(plu.numpy(), np.asarray(jlu)).max() <= 2
    else:
        assert plu is None and jlu is None


def test_mixture_one_from_the_same_draws():
    """JAX's ``mixture_one`` on a key and the port's moves on the draws
    that key gives (the split chain of kissabc_tpu/ops/moves.py:57-126):
    the same proposal and correction."""
    hc, d = 9, 2
    comp = _ensemble(hc, 2, shapes=((), ()))
    theta = tuple(np.float32(x) for x in (0.3, -1.2))
    jcomp = tuple(map(jnp.asarray, comp))
    pcomp = tuple(map(torch.as_tensor, comp))
    ptheta = tuple(torch.tensor(x) for x in theta)
    for s in range(30):
        key = jax.random.key(s)
        jprop, jcorr = JM.mixture_one(key, tuple(map(jnp.asarray, theta)),
                                      jcomp, hc, d)
        km, k1, k2, k3 = jax.random.split(key, 4)
        mid = int(jax.random.randint(km, (), 0, 7, dtype=jnp.int32))
        kp, kz = jax.random.split(k1)
        j = int(jax.random.randint(kp, (), 0, hc, dtype=jnp.int32))
        uz = np.array(jax.random.uniform(kz, (), jnp.float32))
        ka_, kb, kg, kt_ = jax.random.split(k2, 4)
        ia = jax.random.randint(ka_, (), 0, hc, dtype=jnp.int32)
        ib = int(ka.ops.tree.sample_distinct(kb, hc, (ia,)))
        ia = int(ia)
        gn = np.array(jax.random.normal(kg, (), jnp.float32))
        noise = [np.array(x) for x in jax.tree_util.tree_leaves(
            JM._noise_like(kt_, tuple(map(jnp.asarray, theta))))]
        kwa, kwb, kwc, kr = jax.random.split(k3, 4)
        wa = jax.random.randint(kwa, (), 0, hc, dtype=jnp.int32)
        wb = ka.ops.tree.sample_distinct(kwb, hc, (wa,))
        wc = int(ka.ops.tree.sample_distinct(kwc, hc, (wa, wb)))
        wa, wb = int(wa), int(wb)
        r = np.array(jax.random.normal(kr, (3,), jnp.float32))

        def at(i):
            return tuple(x[i] for x in pcomp)

        p_s, c_s = PM.stretch_move(ptheta, at(j), PM.cdf_g_inv(
            torch.as_tensor(uz), 3.0), d)
        p_d = PM.de_move(ptheta, at(ia), at(ib), torch.as_tensor(gn),
                         tuple(torch.as_tensor(x) for x in noise), d)
        p_w = PM.walk_move(ptheta, at(wa), at(wb), at(wc),
                           torch.as_tensor(r))
        prop, corr = PM.mixture_move(torch.tensor(mid < 4),
                                     torch.tensor(4 <= mid < 6), p_s, c_s,
                                     p_d, p_w)
        for a, b in zip(prop, jprop):
            assert _ulps(a.numpy(), np.asarray(b)).max() <= 2, (s, mid)
        assert _ulps(corr.numpy(), np.asarray(jcorr)).max() <= 2


# ---------------------------------------------------------------------------
# the statistical checks of tests/test_moves.py
# ---------------------------------------------------------------------------

def test_sample_g_density():
    a = 3.0
    g = _gen(1)
    zs = PM.cdf_g_inv(torch.rand(40_000, generator=g), a).numpy()
    assert zs.min() >= 1 / a - 1e-6 and zs.max() <= a + 1e-6
    grid = np.linspace(1 / a, a, 100_000)
    dens = 1 / np.sqrt(grid)
    m1 = np.trapezoid(grid * dens, grid) / np.trapezoid(dens, grid)
    assert abs(zs.mean() - m1) < 0.01
    assert PM.sample_g(g, a).shape == ()


def test_move_shapes_and_corrections():
    d = 3
    g = _gen(2)
    half = (torch.randn(8, d, generator=g),)
    comp = (torch.randn(10, d, generator=g),)
    for kern, zero_corr in ((PM.stretch_one, False), (PM.de_one, True),
                            (PM.walk_one, True), (PM.mixture_one, False)):
        props, corr = PM.propose_half(g, half, comp, d, kernel=kern)
        assert props[0].shape == (8, d) and corr.shape == (8,)
        if zero_corr:
            assert torch.equal(corr, torch.zeros(8))
    for scheme, hc in (("roll", 10), ("gather", 10), ("roll", 8),
                       ("gather", 8)):
        props, corr, lu = PM.propose_half(g, half, (comp[0][:hc],), d,
                                          scheme=scheme, accept_lu=True)
        assert props[0].shape == (8, d) and corr.shape == (8,)
        # only equal halves on the rotation scheme fuse the accept draw
        assert (lu is None) == (scheme == "gather" or hc != 8)


def test_stretch_correction_is_jacobian():
    """corr = (d-1) log Z and the proposal lies on the line through
    theta_i and the partner."""
    d = 4
    half = (torch.full((1, d), 2.0),)
    comp = (torch.zeros(3, d),)
    props, corr = PM.propose_half(_gen(3), half, comp, d,
                                  kernel=PM.stretch_one)
    z = float(props[0][0, 0]) / 2.0
    assert torch.allclose(props[0][0], torch.full((d,), z * 2.0))
    assert abs(float(corr[0]) - (d - 1) * math.log(z)) < 1e-5


def test_mixture_mh_preserves_standard_normal():
    """The red/black mixture sweep on a CommonLogDensity N(0, I_2) target
    started from the target keeps it (moment checks of
    tests/test_moves.py)."""
    d, n = 2, 64
    model = kt.CommonLogDensity(
        d, lambda g: torch.randn(d, generator=g),
        lambda x: -0.5 * torch.sum(x * x))
    sweep = PA.make_sweep(model, n)
    g = _gen(4)
    th = torch.randn(n, d, generator=g)
    ld = model.loglike_batch(th, g)
    hist = []
    for _ in range(300):
        th, ld = sweep(g, th, ld)
        hist.append(th)
    samples = torch.stack(hist[100:]).reshape(-1, d).numpy()
    assert abs(samples.mean()) < 0.05
    assert abs(samples.std() - 1.0) < 0.05
    assert abs(np.corrcoef(samples.T)[0, 1]) < 0.05


def test_partners_are_distinct_and_in_range():
    g = _gen(5)
    comp = (torch.arange(50, dtype=torch.float32),)
    for scheme, h in (("roll", 50), ("roll", 30), ("gather", 30)):
        parts = PM._partners(g, comp, h, 50, 3, scheme)
        idx = torch.stack([p[0] for p in parts]).long()
        assert idx.shape == (3, h) and int(idx.min()) >= 0
        assert int(idx.max()) < 50
        assert bool((idx[0] != idx[1]).all() & (idx[0] != idx[2]).all()
                    & (idx[1] != idx[2]).all())
