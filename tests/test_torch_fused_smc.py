"""kissabc_tpu_torch's generic fused smc sweep (``make_fused_smc_sweep``)
and ``smc(sweep_fused=)``: the sweep's plain version held on the CPU
against the JAX Pallas kernel in interpret mode on the stub bit stream,
given the JAX sweep's own partner shifts and seed
(pallas_kernels.py:2440-2447); the production sampler with the fused
sweep recovering the README posterior as the JAX package does
(tests/test_pallas.py:948-962); and the sweep's contract. The CUDA
kernel is held against the plain version on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kissabc_tpu as ka
import kissabc_tpu_torch as kt
from kissabc_tpu_torch import convert, models
from kissabc_tpu_torch.ops import fused_smc as F
from kissabc_tpu_torch.ops.moves import roll_shifts
from kissabc_tpu_torch.utils.rng import as_generator
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5   # the JAX golden tolerance (test_pallas.py:104)
BORDER = 1e-5             # commits may differ where |cost - eps| < BORDER
# The flagship reduce's var = m2 - m1*m1 cancels: at m1 ~ 2 and sigma
# down to ~0.003, var ~ 1e-5 against ulp(m2 ~ 4) = 4.8e-7, so one ulp of a
# moment sum (XLA's summation tree against the kernels' sequential sums)
# moves sd by up to ~5% and the cost, weighted 50x, by up to ~4e-3
# (3.8e-3 measured): its costs and borderline band use this instead
CANCEL_ATOL = 1e-2
TILES = dict(ndraws=200, block=128, chunk=128, walker_tiles=2)


FLAGSHIP_SPEC = ("Factored", [
    ("Uniform", {"a": 1, "b": 3}),
    ("Truncated", {"base": ("Normal", {"mu": 0, "sigma": 0.05}), "lo": 0,
                   "hi": 100})])
# the g-and-k prior of bench.py:362-370: four Uniform marginals
GK_SPEC = ("Factored", [("Uniform", {"a": 0, "b": 6}),
                        ("Uniform", {"a": 0.1, "b": 3}),
                        ("Uniform", {"a": -1, "b": 5}),
                        ("Uniform", {"a": 0.0, "b": 0.9})])
# the mixed discrete prior of tests/test_pallas.py:873: the sweep pushes
# the proposal (m rounded half to even) for the prior and the simulator
# and commits the raw one
MIXED_SPEC = ("Factored", [("DiscreteUniform", {"a": 1, "b": 10}),
                           ("Uniform", {"a": 0.1, "b": 1.0})])
# a Dirac marginal: the sweep pushes its atom (2.5, not a rounding), as the
# JAX kernel does, and commits the raw float-evolved proposal
DIRAC_SPEC = ("Factored", [("Dirac", {"value": 2.5}),
                           ("Uniform", {"a": 0.1, "b": 1.0})])


def _jax_prior(spec):
    _, marginals = spec
    out = []
    for family, p in marginals:
        if family == "Uniform":
            out.append(ka.Uniform(p["a"], p["b"]))
        elif family == "DiscreteUniform":
            out.append(ka.DiscreteUniform(p["a"], p["b"]))
        elif family == "Dirac":
            out.append(ka.Dirac(p["value"]))
        else:
            out.append(ka.TruncatedNormal(p["base"][1]["mu"],
                                          p["base"][1]["sigma"], p["lo"],
                                          p["hi"]))
    return ka.Factored(*out)


def _models(lib):
    """(draw, reduce_cost, stats) of the flagship and g-and-k models in
    ``jnp`` or ``torch``; the torch draws and flagship reduce are the
    port's own (``kissabc_tpu_torch.models``)."""
    if lib is torch:
        _, flagship_draw, flagship_reduce = models.flagship()
        gk_draw = models.g_and_k()[1]
        f32 = (lambda b: b.to(torch.float32))
    else:
        def flagship_draw(th, e):
            mu, sg = th
            return mu + sg * e

        def flagship_reduce(th, m):
            var = jnp.maximum(m[1] - m[0] * m[0], 0.0)
            return jnp.sqrt(jnp.square(m[0] - 2.0)
                            + jnp.square((jnp.sqrt(var) - 0.04) * 50.0))

        def gk_draw(th, e):
            a, b, g, k = th
            return a + b * (1.0 + 0.8 * jnp.tanh(g * e / 2.0)) * e \
                * jnp.exp(k * jnp.log1p(e * e))

        f32 = (lambda b: b.astype(jnp.float32))

    def linear_reduce(th, m):   # no cancellation: the golden test's form
        return m[0] + 10.0 * m[1]

    def gk_reduce(th, m):   # ecdf at the probes vs a g-and-k truth
        return (lib.square(m[0] - 0.25) + lib.square(m[1] - 0.5)
                + lib.square(m[2] - 0.75))

    def mixed_reduce(th, mo):   # tests/test_pallas.py:879-881
        var = lib.maximum(mo[1] - mo[0] * mo[0], lib.zeros_like(mo[0]))
        return lib.hypot(mo[0] - 3.0, lib.sqrt(var) - 0.5)

    ecdf = [lambda x, t=t: f32(x < t) for t in (2.0, 3.0, 4.0)]
    return {"flagship": (flagship_draw, flagship_reduce, None),
            "mixed": (flagship_draw, mixed_reduce, None),
            "flagship-linear": (flagship_draw, linear_reduce, None),
            "g-and-k-ecdf": (gk_draw, gk_reduce, ecdf)}


CASES = {   # name: (prior spec, model, ndraws, eps quantile, flag,
    #               cost tolerance and borderline band)
    "flagship-linear": (FLAGSHIP_SPEC, "flagship-linear", 200, 0.5, False,
                        BORDER),
    "flagship-linear-flag": (FLAGSHIP_SPEC, "flagship-linear", 200, 0.5,
                             True, BORDER),
    "flagship": (FLAGSHIP_SPEC, "flagship", 200, 0.5, False, CANCEL_ATOL),
    "g-and-k-ecdf-ragged": (GK_SPEC, "g-and-k-ecdf", 300, 0.6, False,
                            BORDER),
    "mixed-discrete": (MIXED_SPEC, "mixed", 200, 0.5, False, BORDER),
    "dirac": (DIRAC_SPEC, "mixed", 200, 0.5, False, BORDER),
}


def _population(spec, n, rng):
    if spec is FLAGSHIP_SPEC:
        th = [rng.uniform(1.6, 2.4, n), rng.uniform(0.0, 0.1, n)]
    elif spec is MIXED_SPEC:   # float-evolved m, as a population carries it
        th = [rng.uniform(0.6, 10.4, n), rng.uniform(0.1, 1.0, n)]
    elif spec is DIRAC_SPEC:
        th = [rng.uniform(2.0, 3.0, n), rng.uniform(0.1, 1.0, n)]
    else:
        th = [rng.uniform(lo, hi, n) for lo, hi in
              ((2.0, 4.0), (0.5, 1.5), (-0.5, 0.5), (0.0, 0.5))]
    return [x.astype(np.float32) for x in th]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_sweep_matches_jax_interpret_on_stub_bits(name):
    spec, model, ndraws, q, flag, band = CASES[name]
    n = 300
    tiles = dict(TILES, ndraws=ndraws)
    jdraw, jreduce, jstats = _models(jnp)[model]
    tdraw, treduce, tstats = _models(torch)[model]
    jprior, tprior = _jax_prior(spec), convert.prior_from_numpy(spec)
    rng = np.random.default_rng(11)
    th = _population(spec, n, rng)
    lps = np.array(jax.vmap(lambda *t: jprior.logpdf_tree(
        jprior.push_tree(t)))(*map(jnp.asarray, th)), np.float32)
    alive = rng.random(n) < 0.9
    xs = np.full(n, 1e6, np.float32)

    tsweep = kt.make_fused_smc_sweep(tprior, tdraw, treduce, stats=tstats,
                                     bits="stub", **tiles)
    key = jax.random.key(21)
    kp, ks = jax.random.split(key)   # the JAX sweep's draws (:2440-2447)
    words = [int(w) for w in np.asarray(jax.random.bits(kp, (2,),
                                                        jnp.uint32))]
    seed = int(jax.random.bits(ks, (), jnp.uint32))
    r1, r2 = roll_shifts(words, n)
    tth = [torch.from_numpy(x.copy()) for x in th]
    # eps: a quantile of the proposals' costs, so about half can commit
    probe = F.fused_smc_sweep_plain(
        tsweep, tth, torch.from_numpy(xs), torch.from_numpy(lps),
        torch.ones(n, dtype=torch.bool), 1e6, False, r1, r2, seed)
    eps = float(np.quantile(probe[1].numpy()[probe[3].numpy()], q))
    if flag:   # a tie at eps: flag selects <=
        xs_tie = probe[1].numpy()[probe[3].numpy()]
        eps = float(xs_tie[np.argmin(np.abs(xs_tie - eps))])

    jsweep = ka.make_fused_smc_sweep(jprior, jdraw, jreduce, stats=jstats,
                                     bits="stub", interpret=True, **tiles)
    jth, jxs, jlps, jacc = jsweep(
        key, tuple(map(jnp.asarray, th)), jnp.asarray(xs), jnp.asarray(lps),
        jnp.asarray(alive), jnp.float32(eps), jnp.asarray(flag))
    jth = [np.asarray(x) for x in jth]
    jxs, jlps = np.asarray(jxs), np.asarray(jlps)
    jcm = jxs != xs

    oth, oxs, olps, cm = F.fused_smc_sweep_plain(
        tsweep, tth, torch.from_numpy(xs), torch.from_numpy(lps),
        torch.from_numpy(alive), eps, flag, r1, r2, seed)
    cm = cm.numpy()
    assert int(jacc) == jcm.sum() > 10 and cm.sum() > 10
    # a walker that committed on one side only shows its cost there
    border = ((np.abs(oxs.numpy() - eps) < band)
              | (np.abs(jxs - eps) < band))
    assert ((cm == jcm) | border).all()
    assert (cm != jcm).sum() <= 2
    both = cm & jcm
    for got, want in zip(list(oth) + [olps], jth + [jlps]):
        np.testing.assert_allclose(got.numpy()[both], want[both], rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(oxs.numpy()[both], jxs[both], rtol=RTOL,
                               atol=CANCEL_ATOL if band == CANCEL_ATOL
                               else ATOL)
    for got, x in zip(list(oth) + [oxs, olps], th + [xs, lps]):
        np.testing.assert_array_equal(got.numpy()[~cm], x[~cm])
    assert not cm[~alive].any()
    if flag:
        assert (oxs.numpy()[cm] == eps).any()
    if spec is MIXED_SPEC:   # the raw proposal is committed, not the pushed
        m = oth[0].numpy()[cm]
        assert (m != np.rint(m)).all()
    if spec is DIRAC_SPEC:   # pushed to the atom: every lp is the same
        assert (oth[0].numpy()[cm] != 2.5).all()
        assert (olps.numpy()[cm] == lps[0]).all()


def test_sweep_contract_on_cpu():
    prior = convert.prior_from_numpy(FLAGSHIP_SPEC)
    draw, reduce_cost, _ = _models(torch)["flagship"]
    sweep = kt.make_fused_smc_sweep(prior, draw, reduce_cost, ndraws=100)
    n = 256
    gen = as_generator(0, "cpu")
    th = prior.sample_tree(gen, n)
    xs, lps = torch.full((n,), 0.5), prior.logpdf_tree(th)
    alive = torch.ones(n, dtype=torch.bool)
    eps, flag = torch.tensor(0.5), torch.tensor(False)
    a = sweep(as_generator(3, "cpu"), th, xs, lps, alive, eps, flag)
    b = sweep(as_generator(3, "cpu"), th, xs, lps, alive, eps, flag)
    (mu, sg), oxs, olps, nacc = a
    assert isinstance(a[0], tuple) and nacc.dtype == torch.int64
    assert int(nacc) == int((oxs != xs).sum()) > 0
    assert torch.equal(mu, b[0][0]) and torch.equal(oxs, b[1])
    assert (oxs[oxs != xs] < 0.5).all() and torch.isfinite(olps).all()
    assert F.launches["fused_smc_sweep"] == 0   # the CPU launches none
    with pytest.raises(ValueError, match="at least 3"):
        sweep(gen, tuple(t[:2] for t in th), xs[:2], lps[:2], alive[:2],
              eps, flag)
    with pytest.raises(ValueError, match="2 scalar marginals"):
        sweep(gen, th[:1], xs, lps, alive, eps, flag)


def test_validation_and_mesh():
    prior = convert.prior_from_numpy(FLAGSHIP_SPEC)
    draw, reduce_cost, _ = _models(torch)["flagship"]
    with pytest.raises(ValueError, match="multiple of 128"):
        kt.make_fused_smc_sweep(prior, draw, reduce_cost, block=100)
    with pytest.raises(ValueError, match="noise"):
        kt.make_fused_smc_sweep(prior, draw, reduce_cost, noise="laplace")
    with pytest.raises(TypeError, match="object"):
        kt.make_fused_smc_sweep(prior, draw, reduce_cost, mesh=object())
    sweep = kt.make_fused_smc_sweep(prior, draw, reduce_cost)
    cost = kt.make_streaming_moment_cost(draw, reduce_cost)
    with pytest.raises(TypeError, match="object"):
        kt.smc(prior, cost, cost_vectorized=True, sweep_fused=sweep,
               mesh=object(), device="cpu")


def test_work_counts():
    prior = convert.prior_from_numpy(FLAGSHIP_SPEC)
    draw, reduce_cost, _ = _models(torch)["flagship"]
    sweep = kt.make_fused_smc_sweep(prior, draw, reduce_cost)
    n = 1 << 20
    nbytes, ops = sweep.work(n)
    assert nbytes == n * (8 * 2 + 17) + 29
    cost = kt.make_streaming_moment_cost(draw, reduce_cost)
    assert ops > cost.work(n, 2)[1]   # the sweep adds per-walker work
    # only walkers that pass gate 1 are charged the simulator
    nb_half, ops_half = sweep.work(n, n // 2)
    nb_none, ops_none = sweep.work(n, 0)
    assert nb_half == nb_none == nbytes
    assert ops_none < ops_half < ops
    assert ops - ops_half == ops_half - ops_none


def test_proposal_plain_gate1_is_the_sweeps():
    """The gate-1 mask the bound counts with is the sweep's own: every
    commit passed it, and with eps = +inf every walker that passed it
    commits (the flagship cost is finite inside the prior's support)."""
    prior = convert.prior_from_numpy(FLAGSHIP_SPEC)
    draw, reduce_cost, _ = _models(torch)["flagship"]
    sweep = kt.make_fused_smc_sweep(prior, draw, reduce_cost, ndraws=100)
    n = 512
    th = list(prior.sample_tree(as_generator(1, "cpu"), n))
    lps = prior.logpdf_tree(tuple(th))
    alive = torch.arange(n) % 4 != 0
    xs = torch.full((n,), 0.5)
    gate1 = F.proposal_plain(sweep, th, lps, alive, 3, 40, 99)[3]
    assert 0 < int(gate1.sum()) < n and not gate1[~alive].any()
    for eps, same in ((0.5, False), (float("inf"), True)):
        commit = F.fused_smc_sweep_plain(sweep, th, xs, lps, alive, eps,
                                         False, 3, 40, 99)[3]
        assert not (commit & ~gate1).any()
        assert torch.equal(commit, gate1) == same


def test_smc_with_fused_sweep_recovers_readme_posterior():
    """Production smc with the fused sweep at 512 particles to
    epstol=0.1 (tests/test_pallas.py:948-962): the port on the CPU
    through the plain versions, and the JAX package from the same
    settings (interpret mode, stub bits), both to the README posterior."""
    settings = dict(nparticles=512, cost_vectorized=True, epstol=0.1)
    prior, draw, reduce_cost = models.flagship()   # the port's own copy
    res = kt.smc(prior,
                 kt.make_streaming_moment_cost(draw, reduce_cost, ndraws=200),
                 sweep_fused=kt.make_fused_smc_sweep(
                     prior, draw, reduce_cost, bits="stub", **TILES),
                 key=7, device="cpu", **settings)
    jdraw, jreduce, _ = _models(jnp)["flagship"]
    jprior = _jax_prior(FLAGSHIP_SPEC)
    jres = ka.smc(jprior,
                  ka.make_streaming_moment_cost(jdraw, jreduce, ndraws=200),
                  sweep_fused=ka.make_fused_smc_sweep(
                      jprior, jdraw, jreduce, bits="stub", interpret=True,
                      **TILES),
                  key=7, **settings)
    for r in (res, jres):
        mu, sg = r.P
        assert abs(mu.mean() - 2.0) < 0.05
        assert abs(sg.mean() - 0.04) < 0.01
        assert float(r.eps) <= 0.1
    assert res.C.shape == (512,) and res.ess == len(res.P[0])


def test_smc_with_fused_sweep_on_a_discrete_marginal():
    """tests/test_pallas.py:864-890 with ``sweep_fused``: the mixed
    discrete prior through the streaming cost and the fused sweep (the
    plain versions on the CPU), 512 particles to epstol 0.08; the
    discrete marginal comes back pushed (integral) and the posterior
    within the JAX test's bands."""
    prior = convert.prior_from_numpy(MIXED_SPEC)
    draw, reduce_cost, _ = _models(torch)["mixed"]
    res = kt.smc(prior,
                 kt.make_streaming_moment_cost(draw, reduce_cost, ndraws=500),
                 sweep_fused=kt.make_fused_smc_sweep(prior, draw, reduce_cost,
                                                     ndraws=500),
                 nparticles=512, cost_vectorized=True, epstol=0.08, key=5,
                 device="cpu")
    m_post, s_post = res.P
    assert np.allclose(m_post.particles, np.rint(m_post.particles))
    assert abs(m_post.mean() - 3.0) < 0.3
    assert abs(s_post.mean() - 0.5) < 0.15
    assert float(res.eps) <= 0.08


def _normal_sweeps():
    """The same one-parameter model for both packages: prior N(1, 0.5),
    draw theta + 0.1 eps, cost |E[x] - 1|."""
    kw = dict(bits="stub", **TILES)
    jsweep = ka.make_fused_smc_sweep(
        ka.Normal(1.0, 0.5), lambda th, e: th + 0.1 * e,
        lambda th, m: jnp.abs(m[0] - 1.0), interpret=True, **kw)
    tsweep = kt.make_fused_smc_sweep(
        kt.Normal(1.0, 0.5), lambda th, e: th + 0.1 * e,
        lambda th, m: torch.abs(m[0] - 1.0), **kw)
    return jsweep, tsweep


def test_sweep_takes_a_one_tuple_for_a_single_marginal():
    """As the JAX sweep, only the leaf count is checked: a 1-tuple
    population for a prior that is not Factored runs, gives the bare
    tensor population's results and comes back as a 1-tuple."""
    _, sweep = _normal_sweeps()
    n = 256
    th = torch.from_numpy(
        np.random.default_rng(5).normal(1.0, 0.5, n).astype(np.float32))
    xs, lps = torch.full((n,), 0.3), kt.Normal(1.0, 0.5).logpdf(th)
    alive = torch.ones(n, dtype=torch.bool)
    args = (xs, lps, alive, torch.tensor(0.3), torch.tensor(False))
    bare = sweep(as_generator(3, "cpu"), th, *args)
    tup = sweep(as_generator(3, "cpu"), (th,), *args)
    assert torch.is_tensor(bare[0])
    assert isinstance(tup[0], tuple) and len(tup[0]) == 1
    assert torch.equal(tup[0][0], bare[0])
    for a, b in zip(tup[1:], bare[1:]):
        assert torch.equal(a, b)
    assert 0 < int(bare[3]) < n


def test_sweep_leaf_count_message_matches_jax():
    jsweep, tsweep = _normal_sweeps()
    x = np.linspace(0.5, 1.5, 128).astype(np.float32)
    xs, lps = np.full(128, 0.3, np.float32), np.zeros(128, np.float32)
    alive = np.ones(128, bool)
    with pytest.raises(ValueError) as jerr:
        jsweep(jax.random.key(0), (jnp.asarray(x), jnp.asarray(x)),
               jnp.asarray(xs), jnp.asarray(lps), jnp.asarray(alive), 0.3,
               False)
    t = torch.from_numpy(x)
    with pytest.raises(ValueError) as terr:
        tsweep(as_generator(0, "cpu"), (t, t), torch.from_numpy(xs),
               torch.from_numpy(lps), torch.from_numpy(alive),
               torch.tensor(0.3), torch.tensor(False))
    assert str(terr.value) == str(jerr.value)
    assert str(terr.value) == "prior has 1 scalar marginals but thetas has " \
        "2 leaves"


# ---------------------------------------------------------------------------
# the kernel's launch geometry and the compaction's lane share (host side)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, threads, blocks", [
    (1, 256, 1), (255, 256, 1), (256, 256, 1), (257, 256, 2),
    (1 << 20, 256, 4096), (1 << 20, 512, 2048), (1000, 32, 32),
    (1000, 128, 8), (0, 256, 1)])
def test_sweep_geometry(n, threads, blocks):
    assert F.sweep_geometry(n, threads) == (blocks, threads)
    assert blocks * threads >= n


@pytest.mark.parametrize("threads", [0, 16, 31, 48, 100, 1056, 2048, -32])
def test_sweep_geometry_refuses_block_sizes_the_kernel_cannot_take(threads):
    """The kernel compacts into kSweepMaxThreads shared slots, and its
    ballots take whole warps."""
    with pytest.raises(ValueError, match="multiple of 32"):
        F.sweep_geometry(1000, threads)


def test_default_block_size_fits_the_kernel():
    src = (kt.__path__[0] + "/csrc/generic.cuh")
    text = open(src).read()
    assert f"constexpr int kSweepMaxThreads = {F.MAX_SWEEP_THREADS};" in text
    assert F.SWEEP_THREADS % 32 == 0
    assert 32 <= F.SWEEP_THREADS <= F.MAX_SWEEP_THREADS


def test_lane_share_counts_whole_warps_per_block():
    t = 256
    assert F.lane_share(torch.ones(4 * t, dtype=torch.bool), t) == 1.0
    assert F.lane_share(torch.zeros(4 * t, dtype=torch.bool), t) == 1.0
    one = torch.zeros(t, dtype=torch.bool)
    one[[3, 100, 255]] = True            # three walkers on one warp
    assert F.lane_share(one, t) == 3 / 32
    mask = torch.zeros(2 * t + 10, dtype=torch.bool)
    mask[:33] = True                     # block 0: 33 -> two warps
    mask[t:t + 64] = True                # block 1: 64 -> two warps
    mask[2 * t:] = True                  # block 2 (ragged): 10 -> one warp
    assert F.lane_share(mask, t) == (33 + 64 + 10) / (64 + 64 + 32)


def test_lane_share_of_32_is_the_uncompacted_warps():
    """threads=32: a warp of 32 walkers runs the loop while any of them
    passes, the design without compaction."""
    mask = torch.zeros(128, dtype=torch.bool)
    mask[0] = True                       # warp 0: 1 of 32
    mask[64:96] = True                   # warp 2: 32 of 32
    assert F.lane_share(mask, 32) == 33 / 64
    assert F.lane_share(mask, 128) == 33 / 64   # one block, two warps


def test_lane_share_at_the_pass_rate_of_the_smc_path():
    """At a 44% gate-1 pass rate compaction keeps ~88% of the lanes busy
    in blocks of 256 (~93% in 512), against ~44% without it."""
    gen = torch.Generator().manual_seed(0)
    mask = torch.rand(1 << 16, generator=gen) < 0.44
    plain = F.lane_share(mask, 32)
    assert abs(plain - 0.44) < 0.01
    s256, s512 = F.lane_share(mask, 256), F.lane_share(mask, 512)
    assert 0.85 < s256 < 0.91 and 0.91 < s512 < 0.95
    assert plain < s256 < s512


def test_lane_share_of_the_sweeps_gate1_mask():
    prior = convert.prior_from_numpy(FLAGSHIP_SPEC)
    draw, reduce_cost, _ = _models(torch)["flagship"]
    sweep = kt.make_fused_smc_sweep(prior, draw, reduce_cost, ndraws=100)
    n = 1000
    th = list(prior.sample_tree(as_generator(2, "cpu"), n))
    lps = prior.logpdf_tree(tuple(th))
    gate1 = F.proposal_plain(sweep, th, lps, torch.ones(n, dtype=torch.bool),
                             3, 40, 99)[3]
    p = int(gate1.sum())
    blocks, t = F.sweep_geometry(n)
    per_block = [int(gate1[b * t:(b + 1) * t].sum()) for b in range(blocks)]
    want = p / sum(32 * -(-q // 32) for q in per_block)
    assert F.lane_share(gate1) == want
    assert F.lane_share(gate1) >= F.lane_share(gate1, 32)
