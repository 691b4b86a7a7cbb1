"""The families of the consistency battery
(``tests/test_distribution_consistency.py``) as specs, and ``build``,
which makes one spec's family in either package. Shared by
``tests/test_torch_distribution_consistency.py`` and ``chip_smoke.py``'s
``conformance`` phase; it imports neither package.
"""

# (family, constructor args); a tuple among the args is a nested spec
CONTINUOUS = [
    ("Uniform", -1.0, 2.0),
    ("Normal", 0.5, 1.5),
    ("Exponential", 2.0),
    ("Beta", 2.0, 3.0),
    ("Gamma", 3.0, 1.5),
    ("LogNormal", 0.2, 0.5),
    ("Laplace", 0.0, 1.0),
    ("Cauchy", 0.0, 1.0),
    ("StudentT", 5.0),
    ("Weibull", 2.0, 1.0),
    ("Chisq", 4.0),
    ("FDist", 5.0, 7.0),
    ("Logistic", 0.0, 1.0),
    ("Rayleigh", 1.5),
    ("Pareto", 3.0, 1.0),
    ("InverseGamma", 3.0, 2.0),
    ("Gumbel", 0.0, 1.0),
    ("TriangularDist", 0.0, 2.0, 0.5),
    ("Arcsine", 0.0, 1.0),
    ("Semicircle", 1.0),
    ("Frechet", 2.5, 1.0),
    ("Levy", 0.0, 1.0),
    ("GeneralizedPareto", 0.0, 1.0, 0.2),
    ("GeneralizedPareto", 0.0, 1.0, 0.0),
    ("Kumaraswamy", 2.0, 3.0),
    ("TruncatedNormal", 0.0, 1.0, -1.0, 2.0),
    ("Erlang", 3, 0.5),
    ("LogUniform", 0.5, 8.0),
    ("SymTriangularDist", 1.0, 2.0),
    ("Cosine", 0.5, 2.0),
    ("Epanechnikov", 0.0, 1.0),
    ("Biweight", 0.0, 1.0),
    ("Triweight", 0.0, 1.0),
    ("JohnsonSU", -1.0, 2.0, 0.5, 1.5),
    ("GeneralizedExtremeValue", 0.5, 2.0, 0.3),
    ("GeneralizedExtremeValue", 0.5, 2.0, 0.0),
    ("GeneralizedExtremeValue", 0.5, 2.0, -0.25),
    ("InverseGaussian", 2.0, 5.0),
    ("Chi", 3.0),
    ("BetaPrime", 3.0, 5.0),
    ("PGeneralizedGaussian", 0.5, 2.0, 1.5),
    ("Rician", 2.0, 0.8),
    ("Lindley", 1.5),
    ("LogitNormal", 0.5, 1.2),
    ("NoncentralChisq", 3.0, 4.0),
    ("StudentT", 4.0),
    ("VonMises", 0.5, 2.0),
    ("Truncated", ("Cauchy", 0.0, 1.0), -2.0, 3.0),
    ("Truncated", ("Weibull", 2.0, 1.5), 0.5, 2.5),
    ("Truncated", ("StudentT", 4.0), -1.5, 1.5),
    ("Truncated", ("InverseGamma", 3.0, 2.0), 0.3, 1.5),
]

DISCRETE = [
    ("Bernoulli", 0.3),
    ("Binomial", 12, 0.4),
    ("Geometric", 0.35),
    ("Poisson", 4.0),
    ("NegativeBinomial", 5.0, 0.4),
    ("DiscreteUniform", -2, 7),
    ("Categorical", [0.2, 0.5, 0.3]),
    ("BetaBinomial", 9, 2.0, 2.0),
    ("Hypergeometric", 8, 6, 7),
    ("Skellam", 2.5, 1.5),
    ("Dirac", 3),
    ("DiscreteNonParametric", [2, 5, 9], [0.3, 0.3, 0.4]),
    ("PoissonBinomial", [0.1, 0.5, 0.9, 0.3]),
]

# the vector, matrix and composite families of the dtype check
_COV2 = [[1.0, 0.3], [0.3, 0.5]]
OTHERS = [
    ("MvNormal", [0.0, 1.0], _COV2),
    ("Dirichlet", [1.0, 2.0, 3.0]),
    ("Product", [("Normal", 0.0, 1.0), ("Gamma", 2.0, 1.0)]),
    ("Product", [("Poisson", 3.0), ("Binomial", 5, 0.3)]),
    ("IID", ("Normal", 0.0, 1.0), 3),
    ("Multinomial", 10, [0.2, 0.3, 0.5]),
    ("MvLogNormal", [0.0, 0.5], _COV2),
    ("MvTDist", 5.0, [0.0, 1.0], _COV2),
    ("Wishart", 4.0, _COV2),
    ("InverseWishart", 5.0, _COV2),
    ("LKJ", 3, 2.0),
    ("LKJCholesky", 3, 2.0),
    ("Truncated", ("Normal", 0.0, 1.0), -1.0, 2.0),
    ("Truncated", ("Poisson", 3.0), 1, 6),
    ("Mixture", [("Normal", 0.0, 1.0), ("Normal", 5.0, 2.0)], [0.3, 0.7]),
    ("Mixture", [("Poisson", 2.0), ("Poisson", 9.0)], [0.5, 0.5]),
    ("Affine", 1.0, 2.0, ("Gamma", 2.0, 1.0)),
    ("Factored", ("DiscreteUniform", 1, 6), ("Normal", 0.0, 1.0),
     ("MvNormal", [0.0, 1.0], _COV2)),
]


def build(pkg, spec):
    """The family of ``spec`` in ``pkg`` (the module ``kissabc_tpu`` or
    ``kissabc_tpu_torch``)."""
    def arg(a):
        if isinstance(a, tuple):
            return build(pkg, a)
        if isinstance(a, list) and a and isinstance(a[0], tuple):
            return [build(pkg, s) for s in a]
        return a
    name, *args = spec
    return getattr(pkg, name)(*[arg(a) for a in args])
