"""kissabc_tpu_torch building blocks held against their JAX counterparts
on the CPU: quantiles, resampling, the smc proposal, distributions, tree
helpers, device selection — and the rule that the port imports nothing
of JAX or of the JAX package.

Inputs are made with numpy from a seed and handed to both packages.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kissabc_tpu as ka
from kissabc_tpu.ops import moves as jmoves
from kissabc_tpu.ops import quantile as jq
from kissabc_tpu.ops import resampling as jres
from kissabc_tpu.particles import hpdi as jhpdi
from kissabc_tpu_torch import distributions as D
from kissabc_tpu_torch.ops import moves as tmoves
from kissabc_tpu_torch.ops import quantile as tq
from kissabc_tpu_torch.ops import resampling as tres
from kissabc_tpu_torch.ops.tree import tgather, tselect
from kissabc_tpu_torch.particles import Particles, hpdi, particles_from_tree
from kissabc_tpu_torch.utils.device import resolve_device
from kissabc_tpu_torch.utils.rng import as_generator

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run on small tensors, where one thread is the
    fastest and does not contend with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f32_bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# (a) quantiles: both implementations give JAX's bits
# ---------------------------------------------------------------------------

def _quantile_case(trial):
    """tests/test_ops.py:120 cases: plain, duplicates, +-inf."""
    rng = np.random.default_rng(100 + trial)
    n = 257
    x = rng.normal(size=n).astype(np.float32)
    if trial >= 2:
        x = np.round(x * 4) / 4
    if trial >= 4:
        x[rng.random(n) < 0.2] = np.inf
        x[rng.random(n) < 0.05] = -np.inf
    mask = rng.random(n) < 0.7
    mask[0] = True
    return x, mask


@pytest.mark.parametrize("trial", range(6))
@pytest.mark.parametrize("impl", ["sort", "bisect"])
def test_quantile_bits_match_jax(trial, impl):
    """Exact: the same float32 bits as JAX for every q (tolerance 0)."""
    x, mask = _quantile_case(trial)
    tfn = tq.masked_quantile if impl == "sort" else tq.masked_quantile_bisect
    jfn = jq.masked_quantile if impl == "sort" else jq.masked_quantile_bisect
    for q in (0.05, 0.5, 0.7, 0.95, 1.0):
        want = np.float32(jfn(jnp.asarray(x), jnp.asarray(mask), q))
        got = tfn(torch.from_numpy(x), torch.from_numpy(mask), q)
        assert got.dtype == torch.float32
        assert _f32_bits(got.numpy()) == _f32_bits(want), (q, got, want)


def test_quantile_matches_numpy_type7_and_inf():
    rng = np.random.default_rng(0)
    x = rng.normal(size=101).astype(np.float32)
    mask = rng.random(101) < 0.6
    for q in (0.1, 0.5, 0.7, 0.95):
        got = float(tq.masked_quantile(torch.from_numpy(x),
                                       torch.from_numpy(mask), q))
        assert abs(got - np.quantile(x[mask], q)) < 1e-5
    x = torch.tensor([1.0, math.inf, 2.0, math.inf])
    m = torch.ones(4, dtype=torch.bool)
    for fn in (tq.masked_quantile, tq.masked_quantile_bisect):
        assert float(fn(x, m, 0.25)) == 1.75
        assert float(fn(x, m, 1.0)) == math.inf


def test_resolve_quantile_impl():
    assert tq.resolve_quantile_impl("auto", None, 1 << 18) == "bisect"
    assert tq.resolve_quantile_impl("auto", None, 1000) == "sort"
    assert tq.resolve_quantile_impl("sort", None, 1 << 20) == "sort"
    with pytest.raises(ValueError, match="quantile_impl must be"):
        tq.resolve_quantile_impl("median", None)


# ---------------------------------------------------------------------------
# (b) resampling: equal indices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_replicate_alive_matches_jax(seed):
    rng = np.random.default_rng(seed)
    alive = rng.random(50) < 0.3
    alive[seed] = True
    want = np.asarray(jres.replicate_alive(jnp.asarray(alive)))
    got = tres.replicate_alive(torch.from_numpy(alive)).numpy()
    np.testing.assert_array_equal(got, want)
    idxalive = np.nonzero(alive)[0]  # smc.jl:146-149
    np.testing.assert_array_equal(
        got, np.tile(idxalive, -(-50 // len(idxalive)))[:50])


@pytest.mark.parametrize("n", [7, 64, 1001])
def test_systematic_matches_jax_from_same_u0(n):
    """The same u0 and weights give the same ancestor indices as
    ``jax systematic``; every count is within 1 of n*w."""
    rng = np.random.default_rng(n)
    w = rng.exponential(size=n).astype(np.float32) ** 3 + 1e-12
    key = jax.random.fold_in(jax.random.key(0), n)
    want = np.asarray(jres.systematic(key, jnp.asarray(w)))
    u0 = np.float32(jax.random.uniform(key, ()))
    got = tres.systematic_from_u0(torch.from_numpy(w),
                                  torch.tensor(u0)).numpy()
    np.testing.assert_array_equal(got, want)
    counts = np.bincount(got, minlength=n)
    assert (np.abs(counts - n * w / w.sum()) <= 1.0 + 1e-4).all()


def test_systematic_alive_weights_and_generator():
    alive = torch.tensor([True, False, True, True, False, False, True, True])
    gen = as_generator(3, "cpu")
    idx = tres.systematic(gen, alive.to(torch.float32))
    assert alive[idx].all()
    assert sorted(torch.bincount(idx, minlength=8).tolist())[-1] <= 2
    eq = tres.systematic_from_u0(torch.ones(8), torch.tensor(0.3))
    np.testing.assert_array_equal(eq.numpy(), np.arange(8))


# ---------------------------------------------------------------------------
# (c) the smc proposal: identical from the same shifts / partners and w
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["roll", "gather"])
def test_gaussian_diff_propose_matches_jax(scheme):
    """Bitwise: the port's arithmetic on JAX's own draws."""
    n, d, max_stretch = 40, 2, 2.0
    rng = np.random.default_rng(5)
    ens = (rng.uniform(1, 3, n).astype(np.float32),
           rng.uniform(0.01, 0.1, n).astype(np.float32))
    key = jax.random.key(11)
    want = jmoves.gaussian_diff_propose(
        key, tuple(map(jnp.asarray, ens)), d, max_stretch, scheme=scheme)
    # replay the JAX draws (ops/moves.py:494-510)
    ka_, kb, kw = jax.random.split(key, 3)
    w = np.array(max_stretch * jax.random.normal(kw, (n,), jnp.float32)
                 / math.sqrt(d))
    tens = tuple(torch.from_numpy(x) for x in ens)
    if scheme == "roll":
        v = np.asarray(jax.random.bits(ka_, (2,), jnp.uint32))
        r1, r2 = tmoves.roll_shifts([int(v[0]), int(v[1])], n)
        got = tmoves.propose_roll(tens, torch.from_numpy(w), r1, r2)
    else:
        i = np.arange(n)
        a = np.asarray(jax.random.randint(ka_, (n,), 0, n - 1, jnp.int32))
        a = a + (a >= i)
        b = np.asarray(jax.random.randint(kb, (n,), 0, n - 2, jnp.int32))
        lo, hi = np.minimum(a, i), np.maximum(a, i)
        b = b + (b >= lo)
        b = b + (b >= hi)
        got = tmoves.propose_gather(tens, torch.from_numpy(w),
                                    torch.from_numpy(a), torch.from_numpy(b))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_gaussian_diff_propose_draws_and_schemes():
    gen = as_generator(0, "cpu")
    x = torch.linspace(0, 1, 20)
    for scheme in ("roll", "gather", "auto"):
        p = tmoves.gaussian_diff_propose(gen, (x, x * 2), 2, scheme=scheme)
        assert p[0].shape == (20,) and torch.isfinite(p[0]).all()
    assert tmoves._resolve_scheme("auto", tmoves.AUTO_ROLL_MIN) == "roll"
    assert tmoves._resolve_scheme("auto", 100) == "gather"
    with pytest.raises(ValueError, match="partner scheme"):
        tmoves._resolve_scheme("ring", 100)
    with pytest.raises(ValueError, match=">= 3 walkers"):
        tmoves.gaussian_diff_propose(gen, torch.zeros(2), 1)
    r1, r2 = tmoves.roll_shifts([5, 5], 10)
    assert r1 != r2 and 1 <= r1 < 10 and 1 <= r2 < 10


# ---------------------------------------------------------------------------
# (d) distributions: logpdf within 2 float32 ulps, push exact
# ---------------------------------------------------------------------------

def _pair(name):
    return {
        "uniform": (ka.Uniform(1, 3), D.Uniform(1, 3)),
        "normal": (ka.Normal(0.5, 2.0), D.Normal(0.5, 2.0)),
        "truncnormal": (ka.TruncatedNormal(0, 0.05, 0, 100),
                        D.TruncatedNormal(0, 0.05, 0, 100)),
        "truncuniform": (ka.Truncated(ka.Uniform(0, 4), 1, 2),
                         D.Truncated(D.Uniform(0, 4), 1, 2)),
    }[name]


def _assert_ulps(got, want, ulps=2):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    inf = ~np.isfinite(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    diff = np.abs(got[~inf].astype(np.float64) - want[~inf])
    assert (diff <= ulps * np.spacing(np.abs(want[~inf]))).all(), diff.max()


@pytest.mark.parametrize("name", ["uniform", "normal", "truncnormal",
                                  "truncuniform"])
def test_logpdf_matches_jax(name):
    jd, td = _pair(name)
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(1.0, 2.0, 500), [1.0, 3.0, 0.0, -1e-3,
                                                    100.0, 2.0]])
    x = x.astype(np.float32)
    _assert_ulps(td.logpdf(torch.from_numpy(x)).numpy(),
                 np.asarray(jd.logpdf(jnp.asarray(x))))


def test_factored_logpdf_push_and_sampling():
    jp = ka.Factored(ka.Uniform(1, 3), ka.TruncatedNormal(0, 0.05, 0, 100))
    tp = D.Factored(D.Uniform(1, 3), D.TruncatedNormal(0, 0.05, 0, 100))
    assert tp.nparams == len(tp) == 2
    rng = np.random.default_rng(2)
    th = (rng.uniform(0.5, 3.5, 300).astype(np.float32),
          rng.normal(0.05, 0.05, 300).astype(np.float32))
    want = jax.vmap(lambda a, b: jp.logpdf_tree(jp.push_tree((a, b))))(
        *map(jnp.asarray, th))
    tth = tuple(map(torch.from_numpy, th))
    _assert_ulps(tp.logpdf_tree(tp.push_tree(tth)).numpy(), np.asarray(want))
    pushed = tp.push_tree(tth)
    for p, x in zip(pushed, th):
        assert p.dtype == torch.float32
        np.testing.assert_array_equal(p.numpy(), x)
    s = tp.sample_tree(as_generator(0, "cpu"), 20000)
    assert ((s[0] >= 1) & (s[0] <= 3)).all() and (s[1] >= 0).all()
    assert abs(float(s[0].mean()) - 2.0) < 0.02
    # half-normal(0.05) mean = 0.05 * sqrt(2/pi)
    assert abs(float(s[1].mean()) - 0.05 * math.sqrt(2 / math.pi)) < 1e-3
    assert torch.isfinite(tp.logpdf_tree(s)).all()


def test_push_rounds_half_even_like_jax():
    """A discrete marginal is rounded half to even and cast to int32, as
    ``DiscreteUniform.push`` does in the JAX package."""

    class Disc(D.Distribution):
        discrete = True

    x = np.array([0.5, 1.5, 2.5, 3.49, -0.5, -1.5], np.float32)
    want = np.asarray(ka.DiscreteUniform(-5, 5).push(jnp.asarray(x)))
    got = Disc().push(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    c = D.Normal(0, 1).push(torch.tensor([2], dtype=torch.int32))
    assert c.dtype == torch.float32 and float(c) == 2.0


def test_truncated_constants_match_jax():
    jd, td = _pair("truncnormal")
    for f in ("_clo", "_chi", "_slo", "_shi", "_mass", "_lz"):
        assert np.float32(getattr(td, f)) == np.float32(getattr(jd, f)), f
    with pytest.raises(ValueError, match="zero probability mass"):
        D.TruncatedNormal(0, 1, 50, 60)


# ---------------------------------------------------------------------------
# tree helpers, particles, generators, devices
# ---------------------------------------------------------------------------

def test_tgather_packed_equals_per_leaf():
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.normal(size=30).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=30).astype(np.float32))
    m = torch.from_numpy(rng.normal(size=(30, 3)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 30, 30))
    ga, (gb, gm) = tgather((a, (b, m)), idx)
    assert torch.equal(ga, a[idx]) and torch.equal(gb, b[idx])
    assert torch.equal(gm, m[idx])
    mask = torch.arange(30) % 2 == 0
    sa, sm = tselect(mask, (a, m), (b, m * 0))
    assert torch.equal(sa, torch.where(mask, a, b))
    assert torch.equal(sm[1], torch.zeros(3))


def test_particles_and_hpdi_match_jax():
    rng = np.random.default_rng(6)
    cols = (rng.gamma(2.0, size=999), rng.normal(size=999))
    ps = particles_from_tree(cols)
    assert len(ps) == 2 and isinstance(ps[0], Particles)
    assert ps[1].approx(0.0, nsig=3)
    for p, c in zip(ps, cols):
        assert hpdi(p, 0.9) == jhpdi(c, 0.9)
    assert isinstance(particles_from_tree(cols[0]), Particles)
    assert len(Particles(100, D.Normal(0, 1), key=1)) == 100


def test_as_generator():
    g = as_generator(5, "cpu")
    assert isinstance(g, torch.Generator) and as_generator(g, "cpu") is g
    a = torch.rand(3, generator=as_generator(5, "cpu"))
    assert torch.equal(a, torch.rand(3, generator=as_generator(5, "cpu")))
    with pytest.raises(TypeError):
        as_generator("5", "cpu")


def test_default_device_is_cuda_and_never_falls_back():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)


# ---------------------------------------------------------------------------
# (i) the port imports nothing of JAX or of the JAX package
# ---------------------------------------------------------------------------

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+kissabc_tpu(?!_torch)\b"
    r"|from\s+kissabc_tpu(?!_torch)\b)|kissabc_tpu\.",
    re.MULTILINE)


def test_port_imports_no_jax():
    files = sorted((REPO / "kissabc_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "tools" / "profile_torch_smc.py"]
    assert len(files) > 10
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {"kissabc_tpu_torch/ops/codegen.py",
            "kissabc_tpu_torch/ops/streaming.py",
            "kissabc_tpu_torch/ops/fused_smc.py",
            "kissabc_tpu_torch/core/rejection.py",
            "kissabc_tpu_torch/utils/host_sim.py",
            "kissabc_tpu_torch/utils/diagnostics.py"} <= names
    hits = [(f.relative_to(REPO), m.group(0).strip())
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits
    # the pattern itself: catches the JAX package, spares the port's name
    assert _FORBIDDEN.search("from kissabc_tpu.ops import x")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from kissabc_tpu import smc")
    assert not _FORBIDDEN.search("from kissabc_tpu_torch.ops import x")
    assert not _FORBIDDEN.search("import kissabc_tpu_torch as kt")
