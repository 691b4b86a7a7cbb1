"""The public surface of kissabc_tpu_torch against the JAX package's, name
by name, on the CPU.

- Every public name of ``kissabc_tpu`` (a non-module name of its
  ``dir`` that does not start with ``_``) is in the port, in its
  ``__all__``, and is a class where the JAX name is one.
- Every public method and attribute of every exported class is there.
- Every parameter of every such callable has its counterpart in the
  port, in the same order and of the same kind. The port may add
  parameters (``device=`` of the entry points) and names (the result
  classes, the flagship kernels' factories).

The only differences allowed are the rows of ``IDIOMS``; any other
fails. Each row is used by some name (``test_every_idiom_row_is_used``).

The methods the guard found missing are held against the JAX package
by structure, dtype and law (the two random streams differ, so no
bits): ``init_sample`` of the three density models, ``Factored.rand``
and ``Factored.sample``, and the argument names ``L`` and ``R`` of
``LKJCholesky.logpdf`` and ``LKJ.logpdf``.
"""

import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from battery_specs import CONTINUOUS, DISCRETE

import kissabc_tpu as ka
import kissabc_tpu_torch as kt

P = inspect.Parameter

# The six kernel factories that take ``interpret=`` in the JAX package.
KERNEL_FACTORIES = (
    "make_streaming_moment_cost", "make_streaming_scan_cost",
    "make_fused_smc_sweep", "make_fused_ais_sweep",
    "make_fused_tempered_sweep", "make_fused_abcde_generation")

# The idiomatic differences: JAX form, port form, reason.
IDIOMS = {
    "gen": (
        "`key`, a method's random key: `d.sample(key, shape)`, "
        "`model.loglike(theta, key)`",
        "`gen`: `d.sample(gen, shape)`, `model.loglike(theta, gen)`",
        "the port draws from the torch.Generator it is handed; the JAX "
        "package splits a threefry key"),
    "sample_tree": (
        "`sample_tree(key)`: one walker's draw",
        "`sample_tree(gen, n)`: n walkers' draws",
        "the port draws a population in one batched call, where the JAX "
        "package vmaps the one-walker draw"),
    "fields": (
        "`Family(*args, **kwargs)`, made by the `dist` decorator over "
        "`Family._fields`",
        "`Family(<fields>)`: the fields as named parameters, in order",
        "the port's constructors are plain functions; construction by "
        "position or by keyword works in both"),
    "interpret": (
        "`interpret=` of the six kernel factories",
        "no such parameter",
        "a kernel's wrapper takes its plain version for a CPU tensor and "
        "launches the kernel for a CUDA tensor"),
}


def _public(mod):
    return sorted(n for n in dir(mod) if not n.startswith("_")
                  and not isinstance(getattr(mod, n), types.ModuleType))


JAX_NAMES = _public(ka)


def _members(cls):
    return sorted(m for m in dir(cls) if not m.startswith("_"))


def _signature(f):
    try:
        return inspect.signature(f)
    except (TypeError, ValueError):
        return None


def _expected(owner, name, jax_obj):
    """The JAX parameters ``[(name, kind)]`` as the port must have them,
    and the ``IDIOMS`` rows that mapped them; None if JAX's callable has
    no signature."""
    used = set()
    sig = _signature(jax_obj)
    if sig is None:
        return None, used
    params = list(sig.parameters.values())
    if (owner is None and inspect.isclass(jax_obj)
            and getattr(jax_obj, "_fields", None)
            and [p.kind for p in params] == [P.VAR_POSITIONAL,
                                             P.VAR_KEYWORD]):
        used.add("fields")
        return [(f, P.POSITIONAL_OR_KEYWORD) for f in jax_obj._fields], used
    out = []
    for p in params:
        n = p.name
        if owner is not None and n == "key":
            used.add("gen")
            n = "gen"
        if owner is None and name in KERNEL_FACTORIES and n == "interpret":
            used.add("interpret")
            continue
        out.append((n, p.kind))
    if owner is not None and name == "sample_tree":
        used.add("sample_tree")
        out.append(("n", P.POSITIONAL_OR_KEYWORD))
    return out, used


def _check_params(owner, name, jax_obj, port_obj):
    label = f"{owner.__name__}.{name}" if owner is not None else name
    want, used = _expected(owner, name, jax_obj)
    if want is None:
        return used
    sig = _signature(port_obj)
    assert sig is not None, f"{label}: the port's callable has no signature"
    names = {n for n, _ in want}
    got = [(p.name, p.kind) for p in sig.parameters.values()
           if p.name in names]
    missing = sorted(names - {n for n, _ in got})
    assert not missing, f"{label}: the port lacks parameters {missing}"
    assert got == want, (
        f"{label}: parameters (name, kind) {got}, JAX {want}")
    return used


def _check_name(name):
    """Check one public JAX name; return the ``IDIOMS`` rows it used."""
    j = getattr(ka, name)
    assert hasattr(kt, name), f"the port lacks {name}"
    assert name in kt.__all__, f"{name} is not in the port's __all__"
    t = getattr(kt, name)
    assert inspect.isclass(t) == inspect.isclass(j), (
        f"{name}: a class in one package only")
    used = set()
    if callable(j):
        used |= _check_params(None, name, j, t)
    if inspect.isclass(j):
        for m in _members(j):
            assert hasattr(t, m), f"the port's {name} lacks {m}"
            jm, tm = getattr(j, m), getattr(t, m)
            if callable(jm):
                assert callable(tm), f"{name}.{m} is not callable in the port"
                used |= _check_params(j, m, jm, tm)
    return used


@pytest.mark.parametrize("name", JAX_NAMES)
def test_public_name_has_its_counterpart(name):
    _check_name(name)


def test_every_idiom_row_is_used():
    used = set()
    for name in JAX_NAMES:
        used |= _check_name(name)
    assert used == set(IDIOMS), sorted(set(IDIOMS) - used)
    assert len(JAX_NAMES) > 140


# --------------------------------------------------------------------------
# construction by keyword (the "fields" row)
# --------------------------------------------------------------------------

FIELD_FAMILIES = sorted(
    n for n in JAX_NAMES
    if "fields" in _expected(None, n, getattr(ka, n))[1])

# the battery's arguments of each family (an alias takes its class's)
ARGS = {spec[0]: spec[1:] for spec in CONTINUOUS + DISCRETE}


def _fields_of(d, fields):
    return [np.asarray(getattr(d, f)).tolist() for f in fields]


@pytest.mark.parametrize("name", FIELD_FAMILIES)
def test_keyword_construction_equals_positional(name):
    fields = getattr(ka, name)._fields
    args = ARGS[getattr(ka, name).__name__]
    kw = dict(zip(fields, args))
    t = getattr(kt, name)
    assert (_fields_of(t(**kw), fields) == _fields_of(t(*args), fields)
            == _fields_of(getattr(ka, name)(*args), fields))


@pytest.mark.parametrize("name,kw", [
    ("Normal", {"mu": 0.5, "sigma": 1.5}), ("Uniform", {"a": -1.0, "b": 2.0}),
    ("Gamma", {"alpha": 3.0, "theta": 1.5})])
def test_keyword_construction_in_both_packages(name, kw):
    assert (_fields_of(getattr(kt, name)(**kw), kw)
            == _fields_of(getattr(ka, name)(**kw), kw))


# --------------------------------------------------------------------------
# the methods the guard found missing, held against the JAX package
# --------------------------------------------------------------------------

N_LAW = 2000


def _structure(x):
    """(type, shape, dtype) of every leaf of a draw."""
    if isinstance(x, (tuple, list)):
        return ("tuple", [_structure(v) for v in x])
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return (tuple(a.shape), str(a.dtype))


def _same_law(a, b, discrete, label):
    """Two samples of one law: the empirical pmfs within 5 sigma (and
    0.01) for a discrete law, a two-sample KS test at p > 1e-4 else."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if discrete:
        vals = np.union1d(a, b)
        pa = (a[:, None] == vals).mean(0)
        pb = (b[:, None] == vals).mean(0)
        p = 0.5 * (pa + pb)
        err = 5.0 * np.sqrt(np.maximum(2 * p * (1 - p), 1e-12) / len(a))
        assert (np.abs(pa - pb) <= np.maximum(err, 0.01)).all(), (
            label, vals, pa, pb)
    else:
        assert st.ks_2samp(a, b).pvalue > 1e-4, label


def _jprior():
    return ka.Factored(ka.DiscreteUniform(1, 6), ka.Normal(0.5, 2.0))


def _tprior():
    return kt.Factored(kt.DiscreteUniform(1, 6), kt.Normal(0.5, 2.0))


def _density(pkg, prior, which):
    if which == "ApproxKernelizedPosterior":
        return pkg.ApproxKernelizedPosterior(prior, lambda th: th[1], 0.1)
    if which == "ApproxPosterior":
        return pkg.ApproxPosterior(prior, lambda th: th[1], 0.1)
    if pkg is ka:
        return ka.CommonLogDensity(
            2, lambda k: (jax.random.randint(k, (), 1, 7),
                          0.5 + 2.0 * jax.random.normal(k, (2,))),
            lambda x: -jnp.sum(x[1] ** 2))
    return kt.CommonLogDensity(
        2, lambda g: (torch.randint(1, 7, (), generator=g, dtype=torch.int32),
                      0.5 + 2.0 * torch.randn(2, generator=g)),
        lambda x: -torch.sum(x[1] ** 2))


@pytest.mark.parametrize("which", ["ApproxKernelizedPosterior",
                                   "ApproxPosterior", "CommonLogDensity"])
def test_init_sample_matches_jax(which):
    """One walker's float draw: the structure and the float32 leaves of
    JAX's ``init_sample``, and its law (the DiscreteUniform leaf by its
    pmf, the Normal leaf by KS) over 2000 draws."""
    jm = _density(ka, _jprior(), which)
    tm = _density(kt, _tprior(), which)
    gen = torch.Generator().manual_seed(3)
    one = tm.init_sample(gen)
    want = jm.init_sample(jax.random.key(3))
    assert _structure(one) == _structure(want)
    assert all(leaf.dtype == torch.float32 for leaf in one)
    jd = jax.vmap(jm.init_sample)(jax.random.split(jax.random.key(4),
                                                   N_LAW))
    td = [tm.init_sample(gen) for _ in range(N_LAW)]
    _same_law([float(d[0]) for d in td], jd[0], True, f"{which} leaf 0")
    tcol = np.array([d[1].reshape(-1)[0].item() for d in td])
    _same_law(tcol, np.asarray(jd[1]).reshape(N_LAW, -1)[:, 0], False,
              f"{which} leaf 1")


def test_factored_rand_and_sample_match_jax():
    """``rand(gen)`` and ``sample(gen, shape=())``: one value per
    marginal, as a tuple; ``sample(gen, shape)``: one array of ``shape``
    per marginal; each marginal keeps its dtype; the law over 2000
    draws equals JAX's."""
    jp, tp = _jprior(), _tprior()
    jp3 = ka.Factored(ka.DiscreteUniform(1, 6), ka.Normal(0.5, 2.0),
                      ka.MvNormal(np.zeros(2), np.eye(2)))
    tp3 = kt.Factored(kt.DiscreteUniform(1, 6), kt.Normal(0.5, 2.0),
                      kt.MvNormal(np.zeros(2), np.eye(2)))
    gen = torch.Generator().manual_seed(5)
    key = jax.random.key(5)
    for j, t in ((jp, tp), (jp3, tp3)):
        assert _structure(t.rand(gen)) == _structure(j.rand(key))
        assert _structure(t.sample(gen)) == _structure(j.sample(key))
        for shape in ((7,), (3, 2)):
            assert (_structure(t.sample(gen, shape))
                    == _structure(j.sample(key, shape)))
    assert isinstance(tp.rand(gen), tuple)
    td = tp.sample(gen, (N_LAW,))
    jd = jp.sample(jax.random.key(6), (N_LAW,))
    _same_law(td[0].numpy(), jd[0], True, "Factored marginal 0")
    _same_law(td[1].numpy(), jd[1], False, "Factored marginal 1")
    tr = [tp.rand(gen) for _ in range(N_LAW)]
    _same_law([int(r[0]) for r in tr], jd[0], True, "Factored.rand 0")
    _same_law([float(r[1]) for r in tr], jd[1], False, "Factored.rand 1")


def test_lkj_logpdf_argument_names_match_jax():
    """``LKJCholesky.logpdf(L=...)`` and ``LKJ.logpdf(R=...)`` by keyword
    equal the JAX package's on the same matrices (the JAX draws)."""
    key = jax.random.key(2)
    for name, arg in (("LKJCholesky", "L"), ("LKJ", "R")):
        j, t = getattr(ka, name)(3, 2.0), getattr(kt, name)(3, 2.0)
        x = np.array(j.sample(key, (16,)))
        want = np.asarray(j.logpdf(**{arg: jnp.asarray(x)}))
        got = t.logpdf(**{arg: torch.as_tensor(x)}).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
