"""Carry the JAX package's state across to the port, from plain numbers
and numpy arrays only (the port imports nothing of the JAX package).

- ``prior_from_numpy(spec)`` builds the port's prior from a nested spec
  of family names and parameters, e.g. ``("Factored", [("Uniform",
  {"a": 1, "b": 3}), ("Truncated", {"base": ("Normal", {"mu": 0,
  "sigma": 0.05}), "lo": 0, "hi": 100})])``; nested families take their
  bases as specs too: ``("Mixture", {"components": [("Normal", {"mu":
  0, "sigma": 0.5}), ("Normal", {"mu": 5, "sigma": 0.5})], "weights":
  [0.5, 0.5]})``, ``("Affine", {"loc": 2, "scale": -3, "base":
  ("Exponential", {"theta": 1})})``;
- ``state_from_numpy(...)`` makes the port's ``_SMCState`` from the numpy
  arrays of a JAX ``_SMCState``;
- ``ais_state_from_numpy(thetas, lds)`` makes the port's AIS ensemble
  (theta leaves and log-density record), whole or as red/black halves;
- ``tsmc_state_from_numpy(thetas, lp, ll, lam)`` and
  ``abcde_state_from_numpy(thetas, lps, ds)`` make the populations of
  tsmc and ABCDE.

Tests use them to run the two packages from one starting point.
"""

from __future__ import annotations

import numpy as np
import torch

from . import distributions as D
from .core.smc import _SMCState
from .utils.rng import as_generator

# every family the port has, by its JAX name ("Factored" nests specs)
_FAMILIES = {name: getattr(D, name) for name in (
    "Uniform", "Normal", "Truncated", "DiscreteUniform", "MvNormal",
    "MultivariateNormal", "Exponential", "Gamma", "LogUniform", "BetaPrime",
    "StudentT", "TDist", "Poisson", "DiscreteNonParametric", "Mixture",
    "MixtureModel", "Affine", "Dirichlet", "Beta", "Erlang", "LogNormal",
    "Laplace", "Cauchy", "Weibull", "Chisq", "FDist", "Logistic",
    "Rayleigh", "Pareto", "InverseGamma", "Gumbel", "TriangularDist",
    "Arcsine", "Semicircle", "Frechet", "Levy", "GeneralizedPareto",
    "Kumaraswamy", "VonMises", "SymTriangularDist", "Cosine",
    "Epanechnikov", "Biweight", "Triweight", "JohnsonSU",
    "GeneralizedExtremeValue", "NormalCanon", "InverseGaussian", "Chi",
    "PGeneralizedGaussian", "Rician", "Lindley", "LogitNormal",
    "NoncentralChisq", "Bernoulli", "Binomial", "Geometric",
    "BetaBinomial", "Hypergeometric", "Skellam", "NegativeBinomial",
    "Categorical", "Dirac", "PoissonBinomial", "Product", "IID",
    "Multinomial", "MvLogNormal", "MvTDist", "Wishart", "InverseWishart",
    "LKJ", "LKJCholesky")}


def _is_spec(x):
    return (isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str)
            and isinstance(x[1], (dict, list)))


def prior_from_numpy(spec):
    """``(family, params)``: ``params`` is a dict of numbers, nested
    lists or arrays (vectors, matrices) for a family, a list of specs
    for ``"Factored"``. A parameter that is itself a spec, or a list of
    specs, is built first: ``"Truncated"`` and ``"Affine"`` take their
    ``base``, ``"Mixture"`` its ``components``, ``"Product"`` its
    ``dists`` and ``"IID"`` its ``d`` as specs, e.g. ``("Wishart",
    {"df": 5.0, "S": [[1.0, 0.3], [0.3, 0.8]]})``, ``("Product",
    {"dists": [("Normal", {"mu": 0, "sigma": 1}), ...]})``."""
    family, params = spec
    if family == "Factored":
        return D.Factored(*(prior_from_numpy(s) for s in params))
    if family not in _FAMILIES:
        raise NotImplementedError(
            f"{family} is not ported yet (the port has "
            f"{', '.join(sorted(_FAMILIES))} and Factored)")
    params = dict(params)
    for name, value in params.items():
        if _is_spec(value):
            params[name] = prior_from_numpy(value)
        elif (isinstance(value, (list, tuple)) and value
              and all(_is_spec(v) for v in value)):
            params[name] = [prior_from_numpy(v) for v in value]
    return _FAMILIES[family](**params)


def state_from_numpy(thetas, xs, lps, alive, eps, logz, it, *, key=0,
                     device="cpu") -> _SMCState:
    """The port's smc state from numpy arrays: ``thetas`` a tuple of
    ``[n]`` (or ``[n, d]``) arrays (one per marginal), ``xs``/``lps`` ``[n]`` float32,
    ``alive`` ``[n]`` bool, ``eps``/``logz`` float32 scalars, ``it`` an
    int. ``key`` seeds the generator the next iteration draws from."""
    dev = torch.device(device)

    def t(x, dtype):
        return torch.as_tensor(np.array(x), device=dev).to(dtype)

    return _SMCState(
        as_generator(key, dev),
        tuple(t(x, torch.float32) for x in thetas),
        t(xs, torch.float32), t(lps, torch.float32), t(alive, torch.bool),
        t(eps, torch.float32), t(logz, torch.float32), t(it, torch.int64),
        torch.zeros((), dtype=torch.int64, device=dev),
        torch.zeros((), dtype=torch.bool, device=dev))


def ais_state_from_numpy(thetas, lds, *, halves=False, device="cpu"):
    """The port's AIS ensemble from numpy arrays: ``thetas`` a tuple of
    ``[n]`` (or ``[n, d]``) arrays or one array, ``lds`` an ``(lp, ll)``
    pair, an ``(lp, cost)`` pair or one ``[n]`` array. Returns ``(thetas,
    lds)`` as float32 tensors; with ``halves=True`` as ``((th_a, th_b),
    (ld_a, ld_b))``, the carry of ``make_sweep_halves``."""
    dev = torch.device(device)

    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev)

    def conv(tree):
        if isinstance(tree, (tuple, list)):
            return tuple(t(x) for x in tree)
        return t(tree)

    th, ld = conv(thetas), conv(lds)
    if not halves:
        return th, ld
    n = (th[0] if isinstance(th, tuple) else th).shape[0]
    h = n // 2

    def split(tree):
        if isinstance(tree, tuple):
            return (tuple(x[:h] for x in tree), tuple(x[h:] for x in tree))
        return tree[:h], tree[h:]

    return split(th), split(ld)


def _f32_tree(thetas, dev):
    """A tuple of arrays (one per marginal) or one array, as float32
    tensors on ``dev``."""
    def t(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev)
    if isinstance(thetas, (tuple, list)):
        return tuple(t(x) for x in thetas)
    return t(thetas)


def tsmc_state_from_numpy(thetas, lp, ll, lam, *, device="cpu"):
    """tsmc's population from numpy arrays: ``(thetas, lp, ll, lam)`` with
    float32 tensors on ``device``, ``lam`` a 0-d tensor (the kernel of
    the fused tempered sweep reads it from device memory)."""
    dev = torch.device(device)
    lp, ll, lam = _f32_tree((lp, ll, lam), dev)
    return _f32_tree(thetas, dev), lp, ll, lam.reshape(())


def abcde_state_from_numpy(thetas, lps, ds, *, device="cpu"):
    """ABCDE's population from numpy arrays: ``(thetas, lps, ds)`` as
    float32 tensors on ``device``."""
    dev = torch.device(device)
    lps, ds = _f32_tree((lps, ds), dev)
    return _f32_tree(thetas, dev), lps, ds
