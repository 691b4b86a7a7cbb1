"""kissabc_tpu_torch's fused AIS sweeps (``ops/fused_ais.py``): the plain
versions of kernels #6, #7 and #8 held on the CPU against the JAX Pallas
kernels in interpret mode on the stub bit stream, given the JAX sweeps'
own partner shifts and seeds; the sweeps' contracts (full and halves
carry) and validation messages. The CUDA kernels are held against the
plain versions on the card by chip_smoke.py.

Tolerance: the JAX golden tolerance (rtol 2e-4, atol 2e-5,
tests/test_pallas.py:104) on committed values; uncommitted walkers keep
their inputs bit for bit. The commit masks agree, except, for kernel #6,
where the MH log-ratio lies within 1e-4 of the accept draw (XLA's CPU
``exp``/``log`` and PyTorch's differ by an ulp).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kissabc_tpu as ka
from kissabc_tpu.ops import pallas_kernels as JP
import kissabc_tpu_torch as kt
from kissabc_tpu_torch import convert
from kissabc_tpu_torch.ops import fused_ais as FA

RTOL, ATOL = 2e-4, 2e-5
BORDER = 1e-4
FL = dict(scale=0.1, ndraws=200, target_mu=2.0, target_sd=0.04,
          sd_weight=50.0, a_stretch=3.0, mu_lo=1.0, mu_hi=3.0, sg_sigma=0.05,
          sg_lo=0.0, sg_hi=100.0, block=128, chunk=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.as_tensor(np.array(x))


def _flagship_start(n, seed=0):
    """mu ~ U(1, 3), sigma ~ U(0.01, 0.1), their prior logpdf, and
    loglikelihoods in [-30, -1] (tests/test_pallas.py:464-472, with
    lower ll so that more walkers commit)."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(1, 3, n).astype(np.float32)
    sg = rng.uniform(0.01, 0.1, n).astype(np.float32)
    lp = (-np.log(2.0) - 0.5 * np.log(2 * np.pi * 0.05 ** 2)
          - sg ** 2 / (2 * 0.05 ** 2) - np.log(0.5)).astype(np.float32)
    ll = rng.uniform(-30, -1, n).astype(np.float32)
    return mu, sg, lp, ll


def _same(got, want, inputs, allowed=None):
    """Committed values within the golden tolerance, the commit masks
    equal (or differing only where ``allowed``), uncommitted walkers
    untouched on both sides. Returns the number of commits."""
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]

    def committed(outs):
        return np.any([o != x for o, x in zip(outs, inputs)], axis=0)

    gc, wc = committed(got), committed(want)
    differ = gc != wc
    assert not (differ & ~(allowed if allowed is not None
                           else np.zeros_like(differ))).any(), \
        f"commit masks differ on {int(differ.sum())} walkers"
    both = gc & wc
    for g, w, x in zip(got, want, inputs):
        np.testing.assert_allclose(g[both], w[both], rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(g[~gc], x[~gc])
        np.testing.assert_array_equal(w[~wc], x[~wc])
    return int(both.sum())


def test_rot_shifts6_matches_jax():
    for h in (3, 7, 256, 65536):
        for s in range(10):
            key = jax.random.key(s)
            want = [int(x) for x in JP._rot_shifts6(key, h)]
            words = _t(np.asarray(jax.random.bits(key, (6,), jnp.uint32))
                       .astype(np.int64))
            assert FA.rot_shifts6(words, h).tolist() == want


# ---------------------------------------------------------------------------
# kernel #7: one half-update of the flagship model
# ---------------------------------------------------------------------------

def test_flagship_half_matches_the_pallas_kernel():
    n, h = 512, 256
    mu, sg, lp, ll = _flagship_start(n)
    shifts = [5, 17, 200, 3, 99, 131]
    seed = 1234
    parts = []
    for r in shifts:
        parts += [jnp.roll(jnp.asarray(mu[h:]), -r),
                  jnp.roll(jnp.asarray(sg[h:]), -r)]
    kw = {k: v for k, v in FL.items()}
    want = JP._fused_ais_half_call(
        *(jnp.asarray(x[:h]) for x in (mu, sg, lp, ll)), tuple(parts),
        jnp.uint32(seed), h=h, interpret=True, bits="stub", **kw)
    model = FA.FlagshipAIS(bits="stub", **FL)
    got = model.half_plain(*(_t(x[:h]) for x in (mu, sg, lp, ll)),
                           _t(mu[h:]), _t(sg[h:]), torch.tensor(shifts), seed)
    assert _same(got[:4], want, [x[:h] for x in (mu, sg, lp, ll)]) > 0


def test_flagship_sweep_contract():
    """The sweep's halves are kernel #7's plain half-update with shifts
    and seeds from the generator (seven words per half), half B against
    the updated half A; inputs are not written."""
    n, h = 512, 256
    mu, sg, lp, ll = map(_t, _flagship_start(n, 1))
    sweep = kt.make_fused_flagship_ais_sweep(n, bits="stub", **FL)
    keep = [x.clone() for x in (mu, sg, lp, ll)]
    (omu, osg), (olp, oll) = sweep(torch.Generator().manual_seed(3),
                                   (mu, sg), (lp, ll))
    assert all(torch.equal(a, b) for a, b in zip(keep, (mu, sg, lp, ll)))
    g = torch.Generator().manual_seed(3)
    w = FA.uint32_words(g, 7)
    a = sweep.model.half_plain(mu[:h], sg[:h], lp[:h], ll[:h], mu[h:],
                               sg[h:], FA.rot_shifts6(w[:6], h), w[6:])
    w = FA.uint32_words(g, 7)
    b = sweep.model.half_plain(mu[h:], sg[h:], lp[h:], ll[h:], a[0], a[1],
                               FA.rot_shifts6(w[:6], h), w[6:])
    for out, x, y in zip((omu, osg, olp, oll), a, b):
        assert torch.equal(out, torch.cat([x, y]))
    assert bool((omu != mu)[:h].any() & (omu != mu)[h:].any())


# ---------------------------------------------------------------------------
# kernel #8: both halves in one launch
# ---------------------------------------------------------------------------

def test_flagship_full_matches_the_pallas_kernel():
    n = 512
    mu, sg, lp, ll = _flagship_start(n, 2)
    shifts = np.array([5, 17, 200, 3, 99, 131, 1, 2, 250, 4, 5, 6], np.int32)
    seed = 77
    want = JP._fused_ais_full_call(
        *(jnp.asarray(x) for x in (mu, sg, lp, ll)), jnp.asarray(shifts),
        jnp.uint32(seed), n=n, interpret=True, bits="stub", **FL)
    model = FA.FlagshipAIS(bits="stub", **FL)
    got = model.full_plain(*(_t(x) for x in (mu, sg, lp, ll)),
                           torch.as_tensor(shifts.astype(np.int64)), seed)
    assert _same(got[:4], want, [mu, sg, lp, ll]) > 0
    h = n // 2   # both halves commit
    assert (np.asarray(want[0])[:h] != mu[:h]).any()
    assert (np.asarray(want[0])[h:] != mu[h:]).any()


def test_onekernel_sweep_draws_thirteen_words():
    n = 512
    mu, sg, lp, ll = map(_t, _flagship_start(n, 3))
    sweep = kt.make_fused_flagship_ais_sweep_onekernel(n, bits="stub", **FL)
    (omu, osg), (olp, oll) = sweep(torch.Generator().manual_seed(4),
                                   (mu, sg), (lp, ll))
    w = FA.uint32_words(torch.Generator().manual_seed(4), 13)
    shifts = torch.cat([FA.rot_shifts6(w[:6], n // 2),
                        FA.rot_shifts6(w[6:12], n // 2)])
    want = sweep.model.full_plain(mu, sg, lp, ll, shifts, w[12:])
    for a, b in zip((omu, osg, olp, oll), want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# kernel #6: the generic half-update
# ---------------------------------------------------------------------------

def _jax_models():
    fprior = ka.Factored(ka.Uniform(1, 3), ka.TruncatedNormal(0, 0.05, 0, 100))
    gprior = ka.Factored(ka.Uniform(0, 6), ka.Uniform(0.1, 3),
                         ka.Uniform(-1, 5), ka.Uniform(0.0, 0.9))
    dprior = ka.Factored(ka.DiscreteUniform(1, 10), ka.Uniform(0.1, 1.0))
    return fprior, gprior, dprior


def _dirac_prior(dist):
    """A Dirac marginal: the sweep pushes its atom, as the JAX kernel."""
    return dist.Factored(dist.Dirac(2.5), dist.Uniform(0.1, 1.0))


def _models(lib):
    """(prior, draw, reduce_cost, stats, scale) per case, in ``jnp`` or
    ``torch``: the flagship draw with the linear reduce of the JAX golden
    tests (no cancellation), g-and-k with ecdf stats, and the mixed
    discrete prior of tests/test_pallas.py:811-861."""
    if lib is torch:
        fprior = kt.Factored(kt.Uniform(1, 3),
                             kt.TruncatedNormal(0, 0.05, 0, 100))
        gprior = kt.Factored(kt.Uniform(0, 6), kt.Uniform(0.1, 3),
                             kt.Uniform(-1, 5), kt.Uniform(0.0, 0.9))
        dprior = kt.Factored(kt.DiscreteUniform(1, 10), kt.Uniform(0.1, 1.0))
        f32 = (lambda b: b.to(torch.float32))
        tanh, exp, log1p, absf = torch.tanh, torch.exp, torch.log1p, torch.abs
    else:
        fprior, gprior, dprior = _jax_models()
        f32 = (lambda b: b.astype(jnp.float32))
        tanh, exp, log1p, absf = jnp.tanh, jnp.exp, jnp.log1p, jnp.abs

    def fdraw(th, e):
        mu, sg = th
        return mu + sg * e

    def gdraw(th, e):
        a, b, g, k = th
        return a + b * (1.0 + 0.8 * tanh(g * e / 2.0)) * e \
            * exp(k * log1p(e * e))

    def gk_reduce(th, m):
        return (lib.square(m[0] - 0.25) + lib.square(m[1] - 0.5)
                + lib.square(m[2] - 0.75))

    ecdf = [lambda x, t=t: f32(x < t) for t in (2.0, 3.0, 4.0)]
    return {
        "flagship-linear": (fprior, fdraw, lambda th, m: m[0] + 10.0 * m[1],
                            None, 30.0),
        "g-and-k-ecdf": (gprior, gdraw, gk_reduce, ecdf, 0.5),
        "discrete": (dprior, fdraw, lambda th, m: absf(m[0] - 3.0), None,
                     0.5),
        "dirac": (_dirac_prior(kt if lib is torch else ka), fdraw,
                  lambda th, m: absf(m[0] - 3.0), None, 0.5),
    }


def _generic_start(case, n, rng):
    if case == "flagship-linear":
        th = [rng.uniform(1.5, 2.5, n), rng.uniform(0.01, 0.1, n)]
    elif case == "g-and-k-ecdf":
        th = [rng.uniform(0, 6, n), rng.uniform(0.1, 3, n),
              rng.uniform(-1, 5, n), rng.uniform(0, 0.9, n)]
    elif case == "dirac":
        th = [rng.uniform(2.0, 3.0, n), rng.uniform(0.1, 1.0, n)]
    else:
        th = [rng.integers(1, 11, n) + rng.uniform(-0.4, 0.4, n),
              rng.uniform(0.1, 1.0, n)]
    return [x.astype(np.float32) for x in th]


@pytest.mark.parametrize("case", ["flagship-linear", "g-and-k-ecdf",
                                  "discrete", "dirac"])
def test_generic_sweep_matches_the_pallas_kernel(case):
    """JAX ``make_fused_ais_sweep`` (interpret, stub) on a key against the
    port's half-updates given the shifts and seeds that key gives
    (``_rot_shifts6`` and the split chain of pallas_kernels.py:1510-1530):
    half A against the old half B, half B against the port's half A."""
    n, h = 256, 128
    kw = dict(ndraws=200 if case != "g-and-k-ecdf" else 300, block=128,
              chunk=128, walker_tiles=2, bits="stub")
    jprior, jdraw, jreduce, jstats, scale = _models(jnp)[case]
    pprior, pdraw, preduce, pstats, _ = _models(torch)[case]
    rng = np.random.default_rng(5)
    th = _generic_start(case, n, rng)
    jth = tuple(map(jnp.asarray, th))
    lp = np.asarray(jprior.logpdf_tree(jprior.push_tree(jth)), np.float32)
    ll = rng.uniform(-20, -1, n).astype(np.float32)
    jsw = ka.make_fused_ais_sweep(jprior, jdraw, jreduce, scale=scale,
                                  stats=jstats, interpret=True, **kw)
    key = jax.random.key(9)
    jout = jsw(key, jth, (jnp.asarray(lp), jnp.asarray(ll)))
    want = [np.asarray(x) for x in list(jout[0]) + list(jout[1])]

    def draws(k):
        kp, ks = jax.random.split(k)
        return (torch.tensor([int(x) for x in JP._rot_shifts6(kp, h)]),
                int(jax.random.bits(ks, (), jnp.uint32)))

    (sa, seeda), (sb, seedb) = map(draws, jax.random.split(key))
    psw = kt.make_fused_ais_sweep(pprior, pdraw, preduce, scale=scale,
                                  stats=pstats, **kw)
    (tha, thb), ((lpa, lla), (lpb, llb)) = convert.ais_state_from_numpy(
        th, (lp, ll), halves=True)
    a = psw.half_plain(list(tha), lpa, lla, list(thb), sa, seeda, terms=True)
    b = psw.half_plain(list(thb), lpb, llb, a[0], sb, seedb, terms=True)
    got = [torch.cat([x, y]).numpy() for x, y in zip(a[0], b[0])] + [
        torch.cat([a[1], b[1]]).numpy(), torch.cat([a[2], b[2]]).numpy()]
    # the accept's borderline: |lw - log u| < BORDER
    border = np.concatenate([t[3][1].abs().numpy() < BORDER
                             for t in (a, b)])
    commits = _same(got, want, th + [lp, ll], allowed=border)
    assert commits > 0
    if case == "discrete":   # the raw float shadow is committed
        m = got[0][got[0] != th[0]]
        assert (m != np.round(m)).any()
        assert ((np.rint(m) >= 1) & (np.rint(m) <= 10)).all()


def test_generic_halves_contract_equals_the_full_contract():
    prior, draw, reduce_cost, stats, scale = _models(torch)["discrete"]
    kw = dict(scale=scale, ndraws=100, block=128, chunk=128, walker_tiles=2,
              bits="stub")
    rng = np.random.default_rng(6)
    n = 256
    th = _generic_start("discrete", n, rng)
    lp = prior.logpdf_tree(prior.push_tree(tuple(map(_t, th)))).numpy()
    ll = rng.uniform(-20, -1, n).astype(np.float32)
    full = kt.make_fused_ais_sweep(prior, draw, reduce_cost, **kw)
    halves = kt.make_fused_ais_sweep(prior, draw, reduce_cost, halves=True,
                                     **kw)
    th_t, ld_t = convert.ais_state_from_numpy(th, (lp, ll))
    (fth, (flp, fll)) = full(torch.Generator().manual_seed(1), th_t, ld_t)
    hth, hld = halves(torch.Generator().manual_seed(1),
                      *convert.ais_state_from_numpy(th, (lp, ll),
                                                    halves=True))
    for k in range(2):
        assert torch.equal(fth[k], torch.cat([hth[0][k], hth[1][k]]))
    assert torch.equal(flp, torch.cat([hld[0][0], hld[1][0]]))
    assert torch.equal(fll, torch.cat([hld[0][1], hld[1][1]]))
    assert bool((fth[0] != th_t[0]).any())
    assert isinstance(fth, tuple) and fth[0].shape == (n,)


def test_generic_sweep_is_two_half_updates_with_words_from_the_generator():
    """Each half of #6's sweep draws seven words from ``gen`` in one draw
    (six shift words, then the seed) and runs ``half_words`` on them,
    which is ``half`` on the shifts ``rot_shifts6`` makes of the first
    six; half B proposes against the updated half A; the inputs are not
    written."""
    prior, draw, reduce_cost, stats, scale = _models(torch)["discrete"]
    sw = kt.make_fused_ais_sweep(prior, draw, reduce_cost, scale=scale,
                                 ndraws=100, block=128, chunk=128,
                                 walker_tiles=2, bits="stub", halves=True)
    rng = np.random.default_rng(8)
    n, h = 256, 128
    th = _generic_start("discrete", n, rng)
    lp = prior.logpdf_tree(prior.push_tree(tuple(map(_t, th)))).numpy()
    ll = rng.uniform(-20, -1, n).astype(np.float32)
    th_t, ld_t = convert.ais_state_from_numpy(th, (lp, ll), halves=True)
    keep = [x.clone() for x in list(th_t[0]) + list(th_t[1])]
    (ta, tb), ((lpa, lla), (lpb, llb)) = sw(torch.Generator().manual_seed(4),
                                            th_t, ld_t)
    assert all(torch.equal(a, b) for a, b in zip(
        keep, list(th_t[0]) + list(th_t[1])))
    g = torch.Generator().manual_seed(4)
    wa, wb = sw._draws(g), sw._draws(g)
    a = sw.half_words(list(th_t[0]), *ld_t[0], list(th_t[1]), wa)
    b = sw.half_words(list(th_t[1]), *ld_t[1], a[0], wb)
    for got, want in zip(list(ta) + [lpa, lla] + list(tb) + [lpb, llb],
                         list(a[0]) + [a[1], a[2]] + list(b[0])
                         + [b[1], b[2]]):
        assert torch.equal(got, want)
    a2 = sw.half(list(th_t[0]), *ld_t[0], list(th_t[1]),
                 FA.rot_shifts6(wa[:6], h), wa[6:])
    for got, want in zip(list(ta) + [lpa, lla],
                         list(a2[0]) + [a2[1], a2[2]]):
        assert torch.equal(got, want)
    assert bool((ta[0] != th_t[0][0]).any())


def test_generic_sweep_hands_the_kernel_words_on_the_walkers_device(
        monkeypatch):
    """On the kernel's path each half-update of #6 is one draw of seven
    words and one launch given them on the walkers' device, with no
    ``rot_shifts6`` on the way; given shifts run on the CPU only. The
    walkers' device is ``meta`` here, and the launch records what it is
    given."""
    prior, draw, reduce_cost, _, scale = _models(torch)["flagship-linear"]
    sw = kt.make_fused_ais_sweep(prior, draw, reduce_cost, scale=scale,
                                 block=128, halves=True)
    meta = torch.device("meta")
    seen = []
    monkeypatch.setattr(FA, "rot_shifts6", lambda *a: pytest.fail(
        "rot_shifts6 on the kernel's path: the kernel derives the shifts"))
    monkeypatch.setattr(sw, "launch", lambda upd, lp, ll, comp, words, outs,
                        geometry=None: seen.append((words.device,
                                                    words.shape)))
    th = [torch.ones(128, device=meta)] * 2
    ld = (torch.zeros(128, device=meta), torch.zeros(128, device=meta))
    sw(torch.Generator(), (th, th), (ld, ld))
    assert seen == [(meta, (7,))] * 2
    with pytest.raises(ValueError, match="CPU only.*half_words"):
        sw.half(th, *ld, th, torch.zeros(6, dtype=torch.int64), 0)


# ---------------------------------------------------------------------------
# validation and the device contract
# ---------------------------------------------------------------------------

def test_validation_messages():
    prior, draw, reduce_cost, _, _ = _models(torch)["flagship-linear"]
    with pytest.raises(ValueError, match="multiple of 128"):
        kt.make_fused_ais_sweep(prior, draw, reduce_cost, scale=0.5,
                                block=100)
    with pytest.raises(ValueError, match="nmoments"):
        kt.make_fused_ais_sweep(prior, draw, reduce_cost, scale=0.5,
                                nmoments=0)
    with pytest.raises(ValueError, match="noise"):
        kt.make_fused_ais_sweep(prior, draw, reduce_cost, scale=0.5,
                                noise="poisson")
    with pytest.raises(ValueError, match="requires halves=True"):
        kt.make_fused_ais_sweep(prior, draw, reduce_cost, scale=0.5,
                                mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        kt.make_fused_ais_sweep(prior, draw, reduce_cost, scale=0.5,
                                halves=True, mesh=object())
    sw = kt.make_fused_ais_sweep(prior, draw, reduce_cost, scale=0.5,
                                 ndraws=50, block=128, chunk=128,
                                 bits="stub")
    th = (torch.full((255,), 2.0), torch.full((255,), 0.05))
    ld = (torch.zeros(255), torch.zeros(255))
    gen = torch.Generator()
    with pytest.raises(ValueError, match="even walker count"):
        sw(gen, th, ld)
    with pytest.raises(ValueError, match="at least 6 walkers"):
        sw(gen, tuple(x[:4] for x in th), tuple(x[:4] for x in ld))
    with pytest.raises(ValueError, match="leaves"):
        sw(gen, th[:1], ld)
    with pytest.raises(ValueError, match="even walker count"):
        kt.make_fused_flagship_ais_sweep(511)
    with pytest.raises(ValueError, match="at least 6 walkers"):
        kt.make_fused_flagship_ais_sweep(4)
    with pytest.raises(ValueError, match="n % 256 == 0"):
        kt.make_fused_flagship_ais_sweep_onekernel(384)
    with pytest.raises(ValueError, match="n/2 % block == 0"):
        kt.make_fused_flagship_ais_sweep_onekernel(512, block=512)
    with pytest.raises(ValueError, match="bits"):
        kt.make_fused_flagship_ais_sweep(512, bits="tpu")


def test_flagship_sweeps_hand_the_kernel_words_on_the_walkers_device(
        monkeypatch):
    """A generator may live on another device than the walkers (a CPU
    generator beside CUDA tensors): the raw words (shift words and seed)
    that the sweeps of #7 and #8 hand their launches lie on the walkers'
    device, where the kernel reads them: seven a half, thirteen a sweep,
    and no ``rot_shifts6`` on the way. The walkers' device is reported as
    ``meta`` here, and the launches record what they are given."""
    n = 256
    seen = []
    monkeypatch.setattr(FA, "_check_flagship", lambda thetas, lds, n: (
        [*thetas, *lds], torch.device("meta")))
    monkeypatch.setattr(FA, "rot_shifts6", lambda *a: pytest.fail(
        "rot_shifts6 on the CUDA path: the kernels derive the shifts"))
    monkeypatch.setattr(FA.FlagshipAIS, "launch_half",
                        lambda self, ins, comp, words, outs:
                        seen.append(("half", words.device, words.shape)))
    monkeypatch.setattr(FA.FlagshipAIS, "launch_full",
                        lambda self, ins, words, outs:
                        seen.append(("full", words.device, words.shape)))
    th = (torch.ones(n), torch.ones(n))
    ld = (torch.zeros(n), torch.zeros(n))
    kt.make_fused_flagship_ais_sweep(n, block=128)(torch.Generator(), th, ld)
    kt.make_fused_flagship_ais_sweep_onekernel(n, block=128)(
        torch.Generator(), th, ld)
    meta = torch.device("meta")
    assert seen == [("half", meta, (7,))] * 2 + [("full", meta, (13,))]


def test_wrappers_refuse_what_they_cannot_launch():
    """No silent fallback: a tensor on another device than the CPU or
    CUDA is refused, and a launch without the CUDA toolchain raises."""
    n = 256
    th = (torch.ones(n, device="meta"), torch.ones(n, device="meta"))
    ld = (torch.zeros(n, device="meta"), torch.zeros(n, device="meta"))
    sweep = kt.make_fused_flagship_ais_sweep(n, block=128)
    with pytest.raises(ValueError, match="unsupported device"):
        sweep(torch.Generator(), th, ld)
    if shutil.which("nvcc") is None:
        model = FA.FlagshipAIS(bits="hw", **FL)
        x = torch.ones(128)
        geo = FA.flagship_geometry(128)
        with pytest.raises(RuntimeError, match="nvcc"):
            model.launch_half([x] * 4, [x] * 2, torch.zeros(7, dtype=int),
                              [x] * 4, geometry=geo)
        with pytest.raises(RuntimeError, match="nvcc"):
            model.launch_full([x] * 4, torch.zeros(13, dtype=int), [x] * 4,
                              geometry=geo)
