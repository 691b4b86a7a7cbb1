"""Kernels #6, #9 and #10 of kissabc_tpu_torch on a mesh of CPU shards
(their plain versions; the CUDA forms are held against these on the card
by chip_smoke.py and on the host emulation by
tests/test_torch_fused_parts_emulated.py), mirroring the sharded parts of
tests/test_pallas.py:1015-1052 (#6 with halves and a mesh, the
``halves=True`` rule), :1170-1210 (#9) and :1372-1395 (#10):

- each wrapper built for a mesh runs once per shard with the shard's
  folded seed (``fold_seed``), in the partners-given form for #6 and #9
  (the six partners of each leaf rolled across shards by
  ``partner_rolls``): each shard's outputs equal the plain partner form
  on its block of the ``torch.roll``ed other half, bit for bit; the
  partner form given the snapshot's own rolls is the snapshot form, bit
  for bit; a mesh of one shard is the single-device sweep;
- each shard's plain partner form against the JAX kernel's per-shard
  output under ``shard_map`` in interpret mode on stub bits on the 8
  virtual CPU devices of tests/conftest.py, given the JAX sweep's own
  shifts and seeds: commit masks equal but where the accept's margin
  lies within 1e-4 (#6, #9) or the cost within 1e-4 of its threshold
  (#10), committed values within the JAX golden tolerance (rtol 2e-4,
  atol 2e-5), uncommitted walkers untouched;
- tsmc and ABCDE through the sweeps built for the mesh.
~35 s in one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kissabc_tpu as ka
from kissabc_tpu.ops import pallas_kernels as JP
from kissabc_tpu.parallel import mesh as jmesh
import kissabc_tpu_torch as kt
from kissabc_tpu_torch import models
from kissabc_tpu_torch.ops import fused_ais as FA
from kissabc_tpu_torch.parallel import mesh as M
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
BORDER = 1e-4


def _mesh(k):
    return M.make_mesh(walker=k, devices=["cpu"] * k)


def _need8():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")


def _same(got, want, inputs, allowed=None):
    """Committed values within the golden tolerance, the commit masks
    equal (or differing only where ``allowed``), uncommitted walkers
    untouched on both sides. Returns the number of commits."""
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]

    def committed(outs):
        return np.any([o != x for o, x in zip(outs, inputs)], axis=0)

    gc, wc = committed(got), committed(want)
    ok = (gc == wc) if allowed is None else ((gc == wc) | allowed)
    assert ok.all(), f"commit masks differ on {int((~ok).sum())} walkers"
    both = gc & wc
    for g, w, x in zip(got, want, inputs):
        np.testing.assert_allclose(g[both], w[both], rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(g[~gc], x[~gc])
        np.testing.assert_array_equal(w[~wc], x[~wc])
    return int(both.sum())


def _rolled_block(comp, shifts, blk):
    """Leaf-major partner leaves of one shard: each leaf of the whole
    other half rolled by ``-r`` (``comp[(i + r) % h]``), its block."""
    return [torch.roll(c, -int(r), 0)[blk] for c in comp for r in shifts]


# ---------------------------------------------------------------------------
# kernel #6
# ---------------------------------------------------------------------------

def _ais_models(lib):
    dist = kt if lib is torch else ka
    fprior = dist.Factored(dist.Uniform(1, 3),
                           dist.TruncatedNormal(0, 0.05, 0, 100))
    dprior = dist.Factored(dist.DiscreteUniform(1, 10),
                           dist.Uniform(0.1, 1.0))

    def fdraw(th, e):
        return th[0] + th[1] * e

    return {"flagship-linear": (fprior, fdraw,
                                lambda th, m: m[0] + 10.0 * m[1], 30.0),
            "discrete": (dprior, fdraw,
                         lambda th, m: (lib.abs if lib is jnp
                                        else torch.abs)(m[0] - 3.0), 0.5)}


def _ais_start(case, n, rng):
    if case == "flagship-linear":
        th = [rng.uniform(1.5, 2.5, n), rng.uniform(0.01, 0.1, n)]
    else:
        th = [rng.integers(1, 11, n) + rng.uniform(-0.4, 0.4, n),
              rng.uniform(0.1, 1.0, n)]
    return [x.astype(np.float32) for x in th]


KW6 = dict(ndraws=64, block=128, chunk=64, walker_tiles=1, bits="stub")


def _ais_state(case, n):
    prior, draw, rc, scale = _ais_models(torch)[case]
    rng = np.random.default_rng(4)
    th = [torch.from_numpy(x) for x in _ais_start(case, n, rng)]
    lp = prior.logpdf_tree(prior.push_tree(tuple(th))).to(torch.float32)
    ll = torch.from_numpy(rng.uniform(-20, -1, n).astype(np.float32))
    return prior, draw, rc, scale, th, lp, ll


def test_ais_sweep_on_a_mesh_is_the_partner_form_per_shard():
    ndev, n = 4, 512
    h, s = n // 2, n // 8
    prior, draw, rc, scale, th, lp, ll = _ais_state("discrete", n)
    mesh = _mesh(ndev)
    sw = kt.make_fused_ais_sweep(prior, draw, rc, scale=scale, halves=True,
                                 mesh=mesh, **KW6)
    assert sw.mesh is mesh
    tha, thb = tuple(x[:h] for x in th), tuple(x[h:] for x in th)
    M.reset_transfer_counts()
    out = sw(torch.Generator().manual_seed(5), (tha, thb),
             ((lp[:h], ll[:h]), (lp[h:], ll[h:])))
    assert M.transfers["permute"] == 2 * 6 * 2 * 2 * ndev
    assert M.transfers["join"] == 0 and M.host_reads["shifts"] == 2
    replay = torch.Generator().manual_seed(5)
    comp, ins = list(thb), (list(tha), lp[:h], ll[:h])
    outs, commits = [], 0
    for half in (0, 1):
        words = FA.uint32_words(replay, 7)
        shifts = FA.rot_shifts6(words[:6], h)
        seeds = [int(M.fold_seed(words[6], g)) for g in range(ndev)]
        assert len(set(seeds)) == ndev
        got_half = []
        for g in range(ndev):
            blk = slice(g * s, (g + 1) * s)
            want = sw.half_plain([x[blk] for x in ins[0]], ins[1][blk],
                                 ins[2][blk], None, None, seeds[g],
                                 partners=_rolled_block(comp, shifts, blk))
            got = (list(out[0][half].shards[g]), out[1][half][0].shards[g],
                   out[1][half][1].shards[g])
            for a, b in zip(got[0] + list(got[1:]),
                            list(want[0]) + list(want[1:])):
                assert torch.equal(a, b)
            commits += int((want[0][0] != ins[0][0][blk]).sum())
            got_half.append(want)
        new = [torch.cat([w[0][k] for w in got_half]) for k in range(2)]
        if half == 0:   # half B against the updated half A
            comp, ins = new, (list(thb), lp[h:], ll[h:])
    assert commits > 0


@pytest.mark.parametrize("bits", ["stub", "hw"])
def test_ais_partner_form_given_the_snapshot_rolls_is_the_snapshot_form(
        bits):
    n = 512
    h = n // 2
    prior, draw, rc, scale, th, lp, ll = _ais_state("flagship-linear", n)
    sw = kt.make_fused_ais_sweep(prior, draw, rc, scale=scale,
                                 **dict(KW6, bits=bits))
    words = FA.uint32_words(torch.Generator().manual_seed(8), 7)
    shifts = FA.rot_shifts6(words[:6], h)
    upd, comp = [x[:h] for x in th], [x[h:] for x in th]
    a = sw.half_plain(upd, lp[:h], ll[:h], comp, shifts, words[6:])
    b = sw.half_plain(upd, lp[:h], ll[:h], None, None, words[6:],
                      partners=_rolled_block(comp, shifts, slice(0, h)))
    c = sw.half_parts(upd, lp[:h], ll[:h],
                      _rolled_block(comp, shifts, slice(0, h)), words[6:])
    for x, y, z in zip(list(a[0]) + list(a[1:]), list(b[0]) + list(b[1:]),
                       list(c[0]) + list(c[1:])):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_ais_sweep_mesh_rules():
    prior, draw, rc, scale, th, lp, ll = _ais_state("flagship-linear", 64)
    with pytest.raises(ValueError, match="requires halves=True"):
        kt.make_fused_ais_sweep(prior, draw, rc, scale=scale, mesh=_mesh(4))
    sw = kt.make_fused_ais_sweep(prior, draw, rc, scale=scale, halves=True,
                                 mesh=_mesh(8), **KW6)
    h = 36
    with pytest.raises(ValueError, match=r"half size 36 must divide the mesh "
                                         r"walker axis \(8 devices\)"):
        sw(torch.Generator(), (tuple(x[:h] for x in th),
                               tuple(x[h:2 * h] for x in th)),
           ((lp[:h], ll[:h]), (lp[h:2 * h], ll[h:2 * h])))
    # a mesh of one shard: the single-device sweep
    one = kt.make_fused_ais_sweep(prior, draw, rc, scale=scale, halves=True,
                                  mesh=_mesh(1), **KW6)
    plain = kt.make_fused_ais_sweep(prior, draw, rc, scale=scale,
                                    halves=True, **KW6)
    args = ((tuple(x[:32] for x in th), tuple(x[32:] for x in th)),
            ((lp[:32], ll[:32]), (lp[32:], ll[32:])))
    a = one(torch.Generator().manual_seed(1), *args)
    b = plain(torch.Generator().manual_seed(1), *args)
    for half in (0, 1):
        for x, y in zip(a[0][half].shards[0], b[0][half]):
            assert torch.equal(x, y)
        for x, y in zip(a[1][half], b[1][half]):
            assert torch.equal(x.shards[0], y)


@pytest.mark.parametrize("case", ["flagship-linear", "discrete"])
def test_ais_sharded_sweep_matches_jax_interpret_on_stub_bits(case):
    """The JAX sweep with halves and a mesh of 8 (roll_walkers, then the
    kernel per shard under shard_map with seed + (shard + 1) * 2**20) in
    interpret mode, against the port's plain partner form per shard
    given the JAX sweep's shifts and seeds: half A against the old half
    B, half B against the port's half A."""
    _need8()
    ndev, n = 8, 256
    h, s = n // 2, n // 16
    jprior, jdraw, jrc, scale = _ais_models(jnp)[case]
    prior, draw, rc, _ = _ais_models(torch)[case]
    rng = np.random.default_rng(5)
    th = _ais_start(case, n, rng)
    jth = tuple(map(jnp.asarray, th))
    lp = np.asarray(jprior.logpdf_tree(jprior.push_tree(jth)), np.float32)
    ll = rng.uniform(-20, -1, n).astype(np.float32)
    jsw = jax.jit(ka.make_fused_ais_sweep(
        jprior, jdraw, jrc, scale=scale, interpret=True, halves=True,
        mesh=jmesh.make_mesh(walker=ndev), **KW6))
    key = jax.random.key(9)
    jout = jsw(key, (tuple(x[:h] for x in jth), tuple(x[h:] for x in jth)),
               ((jnp.asarray(lp[:h]), jnp.asarray(ll[:h])),
                (jnp.asarray(lp[h:]), jnp.asarray(ll[h:]))))
    want = [np.concatenate([np.asarray(a), np.asarray(b)])
            for a, b in zip(jout[0][0], jout[0][1])] + [
        np.concatenate([np.asarray(jout[1][0][j]), np.asarray(jout[1][1][j])])
        for j in (0, 1)]
    sw = kt.make_fused_ais_sweep(prior, draw, rc, scale=scale, **KW6)
    t = [torch.from_numpy(x) for x in th]
    tlp, tll = torch.from_numpy(lp), torch.from_numpy(ll)
    comp = [x[h:] for x in t]
    outs, margins = [], []
    for half, k in enumerate(jax.random.split(key)):
        kp, ks = jax.random.split(k)
        shifts = [int(x) for x in JP._rot_shifts6(kp, h)]
        seed = torch.tensor(int(jax.random.bits(ks, (), jnp.uint32)))
        base = half * h
        parts = []
        for g in range(ndev):
            blk = slice(g * s, (g + 1) * s)
            rows = slice(base + g * s, base + (g + 1) * s)
            parts.append(sw.half_plain(
                [x[rows] for x in t], tlp[rows], tll[rows], None, None,
                M.fold_seed(seed, g), terms=True,
                partners=_rolled_block(comp, shifts, blk)))
        outs.append([torch.cat([p[0][k] for p in parts]) for k in range(2)]
                    + [torch.cat([p[k] for p in parts]) for k in (1, 2)])
        margins.append(torch.cat([p[3][1] for p in parts]))
        comp = outs[0][:2]
    got = [torch.cat([a, b]).numpy() for a, b in zip(*outs)]
    border = torch.cat(margins).abs().numpy() < BORDER
    assert _same(got, want, th + [lp, ll], allowed=border) > 0


# ---------------------------------------------------------------------------
# kernel #9
# ---------------------------------------------------------------------------

Y = np.array([1.2, 0.8, 1.5, 0.9, 1.1, 1.3, 0.7, 1.0], np.float32)
KW9 = dict(block=128, walker_tiles=1, bits="stub")


def _conj(lib):
    dist = kt if lib is torch else ka
    const = np.float32(len(Y) / 2 * np.log(2 * np.pi))

    def ll(theta):
        s = 0.0
        for y in Y:
            s = s + lib.square(np.float32(y) - theta)
        return -0.5 * s - const

    return dist.Normal(0, 1), ll


def test_tempered_sweep_on_a_mesh_is_the_partner_form_per_shard():
    ndev, n = 4, 512
    h, s = n // 2, n // 8
    prior, ll_elem = _conj(torch)
    th = torch.randn(n, generator=torch.Generator().manual_seed(2))
    lp, ll = prior.logpdf(th), ll_elem(th)
    mesh = _mesh(ndev)
    sw = kt.make_fused_tempered_sweep(prior, ll_elem, mesh=mesh, **KW9)
    lam = torch.tensor(0.4)
    out = sw(torch.Generator().manual_seed(6), (th[:h], th[h:]),
             ((lp[:h], ll[:h]), (lp[h:], ll[h:])), lam)
    replay = torch.Generator().manual_seed(6)
    comp, ins, commits = [th[h:]], ([th[:h]], lp[:h], ll[:h]), 0
    for half in (0, 1):
        words = FA.uint32_words(replay, 7)
        shifts = FA.rot_shifts6(words[:6], h)
        new = []
        for g in range(ndev):
            blk = slice(g * s, (g + 1) * s)
            want = sw.half_plain([ins[0][0][blk]], ins[1][blk], ins[2][blk],
                                 None, None, M.fold_seed(words[6], g), lam,
                                 partners=_rolled_block(comp, shifts, blk))
            got = (out[0][half].shards[g], out[1][half][0].shards[g],
                   out[1][half][1].shards[g])
            assert torch.equal(got[0], want[0][0])
            assert torch.equal(got[1], want[1])
            assert torch.equal(got[2], want[2])
            commits += int((want[0][0] != ins[0][0][blk]).sum())
            new.append(want[0][0])
        comp, ins = [torch.cat(new)], ([th[h:]], lp[h:], ll[h:])
    assert commits > 0


def test_tempered_sharded_sweep_matches_jax_interpret_on_stub_bits():
    _need8()
    ndev, n = 8, 256
    h, s = n // 2, n // 16
    jprior, jll = _conj(jnp)
    prior, ll_elem = _conj(torch)
    rng = np.random.default_rng(5)
    th = rng.normal(0, 1, n).astype(np.float32)
    lp = np.asarray(jprior.logpdf(jnp.asarray(th)), np.float32)
    ll = np.asarray(jll(jnp.asarray(th)), np.float32)
    jsw = jax.jit(ka.make_fused_tempered_sweep(
        jprior, jll, interpret=True, mesh=jmesh.make_mesh(walker=ndev),
        **KW9))
    key = jax.random.key(9)
    sw = kt.make_fused_tempered_sweep(prior, ll_elem, **KW9)
    t, tlp, tll = (torch.from_numpy(x) for x in (th, lp, ll))
    commits = 0
    for lam in (0.3, 1.0):
        jout = jsw(key, (jnp.asarray(th[:h]), jnp.asarray(th[h:])),
                   ((jnp.asarray(lp[:h]), jnp.asarray(ll[:h])),
                    (jnp.asarray(lp[h:]), jnp.asarray(ll[h:]))),
                   jnp.float32(lam))
        want = [np.concatenate([np.asarray(jout[0][0]),
                                np.asarray(jout[0][1])])] + [
            np.concatenate([np.asarray(jout[1][0][j]),
                            np.asarray(jout[1][1][j])]) for j in (0, 1)]
        comp, outs, margins = [t[h:]], [], []
        for half, k in enumerate(jax.random.split(key)):
            kp, ks = jax.random.split(k)
            shifts = [int(x) for x in JP._rot_shifts6(kp, h)]
            seed = torch.tensor(int(jax.random.bits(ks, (), jnp.uint32)))
            parts = []
            for g in range(ndev):
                blk = slice(g * s, (g + 1) * s)
                rows = slice(half * h + g * s, half * h + (g + 1) * s)
                parts.append(sw.half_plain(
                    [t[rows]], tlp[rows], tll[rows], None, None,
                    M.fold_seed(seed, g), lam, terms=True,
                    partners=_rolled_block(comp, shifts, blk)))
            outs.append([torch.cat([p[0][0] for p in parts])]
                        + [torch.cat([p[k] for p in parts]) for k in (1, 2)])
            margins.append(torch.cat([p[3][1] for p in parts]))
            comp = [outs[0][0]]
        got = [torch.cat([a, b]).numpy() for a, b in zip(*outs)]
        border = torch.cat(margins).abs().numpy() < BORDER
        commits += _same(got, want, [th, lp, ll], allowed=border)
    assert commits > 0


def test_tsmc_through_the_sharded_tempered_sweep():
    prior, ll_elem, _, truth = models.conjugate_normal()
    mesh = _mesh(4)
    sw = kt.make_fused_tempered_sweep(prior, ll_elem, mesh=mesh)
    res = kt.tsmc(prior, ll_elem, nparticles=1024, mcmc_steps=5, key=1,
                  mesh=mesh, sweep_fused=sw)
    assert res.lam == 1.0
    assert abs(float(res.P.mean()) - truth[0]) < 0.05
    assert abs(float(res.P.std()) - truth[1]) < 0.05
    assert abs(res.log_evidence - truth[2]) < 0.3


# ---------------------------------------------------------------------------
# kernel #10
# ---------------------------------------------------------------------------

GAMMA = float(2.38 / np.sqrt(4.0))
KW10 = dict(ndraws=64, chunk=64, block=128, walker_tiles=1, bits="stub")


def _abcde_models(lib):
    dist = kt if lib is torch else ka
    prior = dist.Factored(dist.Uniform(1, 3),
                          dist.TruncatedNormal(0, 0.05, 0, 100))
    return prior, (lambda th, e: th[0] + th[1] * e), (
        lambda th, m: m[0] + 10.0 * m[1])


def _abcde_population(n, rng):
    th = (rng.uniform(1.5, 2.5, n).astype(np.float32),
          rng.uniform(0.01, 0.1, n).astype(np.float32))
    idx = [rng.integers(0, n, n) for _ in range(3)]
    bases = tuple(tuple(x[i] for x in th) for i in idx)
    ds = rng.uniform(20.0, 70.0, n).astype(np.float32)
    active = rng.uniform(size=n) > 0.25
    eps_i = np.where(ds <= 30.0, 30.0, 45.0).astype(np.float32)
    return th, bases, ds, active, eps_i


def test_abcde_generation_on_a_mesh_runs_once_per_shard():
    ndev, n = 4, 512
    s = n // ndev
    prior, draw, rc = _abcde_models(torch)
    th, bases, ds, active, eps_i = _abcde_population(
        n, np.random.default_rng(2))
    t = [torch.from_numpy(x) for x in th]
    tb = [[torch.from_numpy(x) for x in b] for b in bases]
    lps = prior.logpdf_tree(prior.push_tree(tuple(t))).to(torch.float32)
    vec = [torch.from_numpy(x) for x in (ds, active, eps_i)]
    mesh = _mesh(ndev)
    gen_ = kt.make_fused_abcde_generation(prior, draw, rc, gamma=GAMMA,
                                          mesh=mesh, **KW10)
    M.reset_transfer_counts()
    out = gen_(torch.Generator().manual_seed(3), tuple(t),
               tuple(tuple(b) for b in tb), lps, *vec)
    assert M.transfers == {"permute": 0, "join": 0}
    seed = FA.uint32_words(torch.Generator().manual_seed(3), 1)
    gates = 0
    for g in range(ndev):
        blk = slice(g * s, (g + 1) * s)
        want = gen_.generation_plain(
            [x[blk] for x in t], [[x[blk] for x in b] for b in tb],
            lps[blk], vec[0][blk], vec[1][blk].float(), vec[2][blk],
            M.fold_seed(seed, g))
        for a, b in zip(list(out[0].shards[g]) + [out[k].shards[g]
                                                  for k in (1, 2, 3)],
                        list(want[0]) + list(want[1:])):
            assert torch.equal(a, b)
        gates += int(want[3].sum())
    assert gates > 0
    with pytest.raises(ValueError, match=r"n=100 walkers must divide the "
                                         r"mesh walker axis \(8 devices\)"):
        kt.make_fused_abcde_generation(prior, draw, rc, gamma=GAMMA,
                                       mesh=_mesh(8), **KW10)(
            torch.Generator(), tuple(x[:100] for x in t),
            tuple(tuple(x[:100] for x in b) for b in tb), lps[:100],
            *(v[:100] for v in vec))


def test_abcde_sharded_generation_matches_jax_interpret_on_stub_bits():
    _need8()
    ndev, n = 8, 1024
    s = n // ndev
    jprior, jdraw, jrc = _abcde_models(jnp)
    prior, draw, rc = _abcde_models(torch)
    rng = np.random.default_rng(3)
    th, bases, ds, active, eps_i = _abcde_population(n, rng)
    jtree = (lambda t: tuple(map(jnp.asarray, t)))
    lps = np.asarray(jprior.logpdf_tree(jprior.push_tree(jtree(th))),
                     np.float32).copy()
    lps[::13] = -np.inf
    jgen = ka.make_fused_abcde_generation(
        jprior, jdraw, jrc, gamma=GAMMA, interpret=True,
        mesh=jmesh.make_mesh(walker=ndev), **KW10)
    key = jax.random.key(7)
    jout = jgen(key, jtree(th), tuple(jtree(b) for b in bases),
                jnp.asarray(lps), jnp.asarray(ds), jnp.asarray(active),
                jnp.asarray(eps_i))
    want = [np.asarray(x) for x in jout[0]] + [np.asarray(x)
                                               for x in jout[1:]]
    seed = torch.tensor(int(jax.random.bits(key, (), jnp.uint32)))
    pgen = kt.make_fused_abcde_generation(prior, draw, rc, gamma=GAMMA,
                                          **KW10)
    t = [torch.from_numpy(x) for x in th]
    tb = [[torch.from_numpy(x) for x in b] for b in bases]
    tl, td = torch.from_numpy(lps), torch.from_numpy(ds)
    ta, te = torch.from_numpy(active).float(), torch.from_numpy(eps_i)
    parts = []
    for g in range(ndev):
        blk = slice(g * s, (g + 1) * s)
        parts.append(pgen.generation_plain(
            [x[blk] for x in t], [[x[blk] for x in b] for b in tb], tl[blk],
            td[blk], ta[blk], te[blk], M.fold_seed(seed, g), terms=True))
    got = [torch.cat([p[0][k] for p in parts]).numpy() for k in range(2)] + [
        torch.cat([p[k] for p in parts]).numpy() for k in (1, 2, 3)]
    dp = torch.cat([p[4] for p in parts]).numpy()
    np.testing.assert_array_equal(got[-1] > 0.5, want[-1] > 0.5)
    hi = np.maximum(eps_i, ds)
    border = np.abs(dp - hi) < BORDER * np.maximum(1.0, np.abs(hi))
    assert _same(got[:-1], want[:-1], list(th) + [lps, ds],
                 allowed=border) > 0


def test_abcde_through_the_sharded_generation():
    """ABCDE on a mesh of 4 with #10's plain version once per shard and
    #4's through ``shard_batched_cost`` at the init recovers the
    flagship posterior as the split run on one device does, with a
    comparable simulator-call tally (the rule of
    tests/test_torch_fused_abcde.py, after tests/test_pallas.py:1404-1416)."""
    prior, draw, rc = models.flagship()
    mesh = _mesh(4)
    gamma = 1.0 * 2.38 / np.sqrt(4.0)
    kw = dict(ndraws=64, chunk=64, block=128, walker_tiles=1)
    fused = kt.make_fused_abcde_generation(prior, draw, rc, gamma=gamma,
                                           mesh=mesh, bits="stub", **kw)
    base = kt.make_streaming_moment_cost(draw, rc, **kw)
    cost = kt.shard_batched_cost(base, mesh)
    run = dict(nparticles=256, generations=30, verbose=False, key=3,
               cost_vectorized=True)
    a = kt.ABCDE(prior, cost, 0.1, mesh=mesh, sweep_fused=fused, **run)
    b = kt.ABCDE(prior, base, 0.1, device="cpu", **run)
    for res in (a, b):
        mu, sg = res.P
        assert abs(mu.mean() - 2.0) < 0.03
        assert abs(sg.mean() - 0.04) < 0.01
    assert abs(a.nsim - b.nsim) / b.nsim < 0.2
    with pytest.raises(ValueError, match="SAME mesh"):
        kt.ABCDE(prior, cost, 0.1, mesh=mesh, sweep_fused=(
            kt.make_fused_abcde_generation(prior, draw, rc, gamma=gamma,
                                           **kw)), **run)
