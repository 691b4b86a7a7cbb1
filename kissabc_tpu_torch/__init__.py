"""kissabc_tpu_torch — the PyTorch and CUDA port of ``kissabc_tpu``.

The JAX package stays the reference; this package runs the same
algorithms with torch tensors, on an NVIDIA H100 through hand-written
CUDA kernels (``csrc/``), or on the CPU through each kernel's plain
PyTorch version when the caller passes ``device="cpu"``.

Today: adaptive-epsilon SMC-ABC, whole, and the affine-invariant
ensemble sampler (AIS).

SMC-ABC:

- ``smc`` with a per-walker cost ``cost(theta, gen)`` or ``cost(theta)``
  (the default form), or a batched cost with ``cost_vectorized=True``:
  the flagship README model's ``make_flagship_cost_batched()`` (slice
  1), ``make_streaming_moment_cost(draw, reduce_cost)`` for i.i.d. user
  simulators (slice 2) and ``make_streaming_scan_cost(step, init,
  reduce_cost, nsteps=...)`` for sequential ones (slice 3), each
  compiled into a CUDA kernel;
- the one-kernel sweeps ``make_fused_flagship_sweep`` and
  ``smc(..., sweep_fused=make_fused_smc_sweep(prior, draw,
  reduce_cost))``;
- ``smc_stepped``, the same program stepped from the host, with
  ``IterLog`` records and checkpoint/resume (``checkpoint``);
  ``trace`` profiles a block;
- the priors of ``distributions.py``: every univariate family of the
  JAX package (46 continuous and discrete families from ``Beta`` to
  ``PoissonBinomial``), ``Truncated`` (over any base with a quantile;
  ``TruncatedDiscrete`` over a discrete one)/``TruncatedNormal``,
  ``Mixture``/``MixtureModel``, ``Affine`` (also built by ``+ - *`` on a
  distribution), the vector families ``MvNormal``, ``Dirichlet``,
  ``Product``/``IID``, ``Multinomial``, ``MvLogNormal`` and ``MvTDist``,
  the matrix families ``Wishart``, ``InverseWishart``, ``LKJ`` and
  ``LKJCholesky``, and ``Factored`` of any of them
  (``Factored(LKJ(2), LogUniform(0.1, 10), LogUniform(0.1, 10))``).

AIS (slice 4):

- ``sample(model, AIS(N), ns)`` (also with ``chains=``, the positional
  ``MCMCThreads()``/``MCMCDistributed()`` form, ``thinning=`` and
  ``schedule="sequential"``) and ``sample_raw``, on the three density
  models ``ApproxKernelizedPosterior``, ``ApproxPosterior`` and
  ``CommonLogDensity``, with a per-walker or a batched cost; the
  program and its sweeps ``make_run``, ``make_sweep`` and
  ``make_sweep_halves``, with the JAX package's parameters in its order;
- the fused AIS sweeps, each a CUDA kernel: ``make_fused_ais_sweep``
  (user models), ``make_fused_flagship_ais_sweep`` (one launch per
  half) and ``make_fused_flagship_ais_sweep_onekernel`` (one
  cooperative launch per sweep).

Tempered SMC, the particle filter and ABC-DE (slice 5):

- ``tsmc`` (adaptive tempered SMC with the evidence estimate), with a
  per-walker or batched log-likelihood, or ``sweep_fused=
  make_fused_tempered_sweep(prior, loglike)``: the likelihood compiled
  into one CUDA kernel per half-update;
- ``pfilter`` (the quantile particle filter);
- ``ABCDE`` (ABC differential evolution), or with ``sweep_fused=
  make_fused_abcde_generation(prior, draw, reduce_cost, gamma=...)``:
  one CUDA kernel per generation.

Rejection ABC and the library surface (slice 6):

- ``abc_rejection`` (budget mode: a streaming best-n over chunks;
  threshold mode: a masked scatter up to ``max_sims``) and
  ``RejectionResult``;
- ``host_cost`` (a numpy simulator on the host as a batched cost);
- ``ess`` and ``rhat`` (``utils/diagnostics.py``);
- Distributions.jl's statistics functions (``statistics.py``: ``mean``,
  ``var``, ``cdf``, ``quantile``, ``fit_mle``, ``rand``, ...);
- the ``Particles`` helpers ``chainsstack``, ``pmap_apply``, ``pmean``,
  ``pstd``, ``pmedian``, ``pquantile``, ``pcov``, ``pcor``,
  ``sigmapoints`` and ``pm``/``plus_minus``.

Walker sharding (slice 9): ``smc(..., mesh=make_mesh(walker=k))`` and
``smc_stepped`` shard the population over a mesh
(``parallel/mesh.py``; several processes through ``parallel/
distributed.py``); ``shard_batched_cost`` runs a kernel cost once per
shard and ``make_fused_smc_sweep(..., mesh=)`` the fused sweep.
Slice 10 shards every other sampler the same way (``parallel/
layout.py``): ``sample``/``sample_raw``/``make_run``/``make_sweep``/
``make_sweep_halves`` on a walker mesh, ``sample(..., chains=)`` on a
``chain`` or ``(chain, walker)`` mesh, ``tsmc``, ``pfilter``, ``ABCDE``
and ``abc_rejection`` with ``mesh=``, and the fused sweeps
``make_fused_ais_sweep(..., halves=True, mesh=)``,
``make_fused_tempered_sweep(..., mesh=)`` and
``make_fused_abcde_generation(..., mesh=)``, which run their kernels
once per shard.

It imports nothing of JAX or of the JAX package.
"""

from .core.abcde import ABCDE, ABCDEResult  # noqa: F401
from .core.ais import (  # noqa: F401
    AIS, MCMCDistributed, MCMCThreads, make_run, make_sweep,
    make_sweep_halves, sample, sample_raw)
from .core.density import (  # noqa: F401
    ApproxKernelizedPosterior, ApproxPosterior, CommonLogDensity)
from .core.pfilter import PFilterResult, pfilter  # noqa: F401
from .core.smc import SMCResult, smc, smc_stepped  # noqa: F401
from .core.tsmc import TSMCResult, tsmc  # noqa: F401
from .core.rejection import RejectionResult, abc_rejection  # noqa: F401
from .distributions import (  # noqa: F401
    Affine, Arcsine, Bernoulli, Beta, BetaBinomial, BetaPrime, Binomial,
    Biweight, Categorical, Cauchy, Chi, Chisq, Cosine, Dirac, Dirichlet,
    DiscreteNonParametric, DiscreteUniform, Distribution, Epanechnikov,
    Erlang, Exponential, Factored, FDist, Frechet, Gamma,
    GeneralizedExtremeValue, GeneralizedPareto, Geometric, Gumbel,
    Hypergeometric, IID, InverseGamma, InverseGaussian, InverseWishart,
    JohnsonSU, Kumaraswamy, Laplace, Levy, Lindley, LKJ, LKJCholesky,
    Logistic, LogitNormal, LogNormal, LogUniform, Mixture, MixtureModel,
    Multinomial, MultivariateNormal, MvLogNormal, MvNormal, MvTDist,
    NegativeBinomial, NoncentralChisq, Normal, NormalCanon, Pareto,
    PGeneralizedGaussian, Poisson, PoissonBinomial, Product, Rayleigh,
    Rician, Semicircle, Skellam, StudentT, SymTriangularDist, TDist,
    TriangularDist, Triweight, Truncated, TruncatedDiscrete,
    TruncatedNormal, Uniform, VonMises, Weibull, Wishart)
from .ops.fused_ais import (  # noqa: F401
    make_fused_ais_sweep, make_fused_flagship_ais_sweep,
    make_fused_flagship_ais_sweep_onekernel)
from .ops.fused_abcde import make_fused_abcde_generation  # noqa: F401
from .ops.fused_smc import make_fused_smc_sweep  # noqa: F401
from .ops.fused_tempered import make_fused_tempered_sweep  # noqa: F401
from .ops.kernels import (  # noqa: F401
    make_flagship_cost_batched, make_fused_flagship_sweep)
from .ops.scan import make_streaming_scan_cost  # noqa: F401
from .ops.streaming import make_streaming_moment_cost  # noqa: F401
from .parallel.mesh import shard_batched_cost  # noqa: F401
from .particles import (  # noqa: F401
    Particles, chainsstack, hpdi, particles_from_tree, pcor, pcov, pm,
    pmap_apply, pmean, pmedian, plus_minus, pquantile, pstd, sigmapoints)
from .statistics import (  # noqa: F401
    ccdf, cdf, cor, cov, cquantile, entropy, fit, fit_mle, insupport,
    kurtosis, logccdf, logcdf, loglikelihood, logpdf, maximum, mean, median,
    minimum, mode, params, pdf, product_distribution, quantile, rand,
    skewness, std, support, truncated, var)
from .utils import checkpoint  # noqa: F401
from .utils.diagnostics import ess, rhat  # noqa: F401
from .utils.host_sim import host_cost  # noqa: F401
from .utils.logging import IterLog, trace  # noqa: F401

__all__ = ["smc", "smc_stepped", "SMCResult", "Factored", "Uniform",
           "Normal", "Truncated", "TruncatedNormal", "DiscreteUniform",
           "MvNormal", "Particles", "make_flagship_cost_batched",
           "make_fused_flagship_sweep", "make_streaming_moment_cost",
           "make_streaming_scan_cost", "make_fused_smc_sweep", "IterLog",
           "trace", "AIS", "sample", "sample_raw", "MCMCThreads",
           "MCMCDistributed", "make_run", "make_sweep", "make_sweep_halves",
           "checkpoint", "ApproxKernelizedPosterior", "ApproxPosterior",
           "CommonLogDensity", "make_fused_ais_sweep",
           "make_fused_flagship_ais_sweep",
           "make_fused_flagship_ais_sweep_onekernel", "tsmc", "TSMCResult",
           "pfilter", "PFilterResult", "ABCDE", "ABCDEResult",
           "make_fused_tempered_sweep", "make_fused_abcde_generation",
           "abc_rejection", "RejectionResult", "host_cost", "ess", "rhat",
           "shard_batched_cost", "hpdi", "particles_from_tree",
           "chainsstack", "pmap_apply", "pmean", "pstd", "pmedian",
           "pquantile", "pcov", "pcor", "sigmapoints", "pm", "plus_minus",
           "Exponential", "Gamma", "LogUniform", "BetaPrime", "StudentT",
           "TDist", "Poisson", "DiscreteNonParametric", "TruncatedDiscrete",
           "Mixture", "MixtureModel", "Affine", "Dirichlet",
           # slice 7: the univariate families and the statistics surface
           "Distribution", "MultivariateNormal", "Beta", "Erlang",
           "LogNormal", "Laplace", "Cauchy", "Weibull", "Chisq", "FDist",
           "Logistic", "Rayleigh", "Pareto", "InverseGamma", "Gumbel",
           "TriangularDist", "Arcsine", "Semicircle", "Frechet", "Levy",
           "GeneralizedPareto", "Kumaraswamy", "VonMises",
           "SymTriangularDist", "Cosine", "Epanechnikov", "Biweight",
           "Triweight", "JohnsonSU", "GeneralizedExtremeValue",
           "NormalCanon", "InverseGaussian", "Chi", "PGeneralizedGaussian",
           "Rician", "Lindley", "LogitNormal", "NoncentralChisq",
           "Bernoulli", "Binomial", "Geometric", "BetaBinomial",
           "Hypergeometric", "Skellam", "NegativeBinomial", "Categorical",
           "Dirac", "PoissonBinomial",
           # slice 8: the vector and matrix families
           "Product", "IID", "Multinomial", "MvLogNormal", "MvTDist",
           "Wishart", "InverseWishart", "LKJ", "LKJCholesky",
           "mean", "var", "std", "median", "mode", "skewness", "kurtosis",
           "entropy", "minimum", "maximum", "insupport", "cov", "params",
           "cdf", "ccdf", "logcdf", "logccdf", "pdf", "logpdf", "quantile",
           "cquantile", "fit", "fit_mle", "support", "truncated",
           "product_distribution", "cor", "loglikelihood", "rand"]
