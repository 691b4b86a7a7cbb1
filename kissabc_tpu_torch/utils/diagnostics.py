"""MCMC quality diagnostics: autocorrelation ESS and split-R-hat — the
port's own copy of ``kissabc_tpu/utils/diagnostics.py`` (numpy; the port
imports nothing of the JAX package), which also takes torch tensors.

``ess`` is the autocorrelation-time effective sample size (Geyer initial
monotone positive-sequence truncation, the Stan/ArviZ estimator) and
``rhat`` is split-R-hat (Gelman-Rubin with each chain split in half, so
single-chain nonstationarity is also detected).

Both take ``method=``: the default operates on the raw draws;
``method="rank"`` is the Vehtari et al. 2021 rank-normalized variant
that Stan and ArviZ ship as their default — draws are replaced by
normal scores ``z = ndtri((rank - 3/8) / (S + 1/4))`` (pooled average
ranks over all split chains), which makes the estimators robust for
heavy-tailed posteriors where raw-moment estimators mislead.
``ess(method="tail")`` is ArviZ's tail-ESS: the min over the 5%/95%
quantile-indicator ESS. ``rhat(method="rank")`` is ``max(R-hat of
rank-normalized z, R-hat of rank-normalized folded |x - median|)``.

Diagnostics are post-processing: host-side numpy on fetched samples.

Inputs: 1-D ``[draws]`` (one chain), 2-D ``[chains, draws]`` (numpy
arrays or torch tensors on any device), or a ``Particles`` cloud
(treated as one chain in emission order).
"""

from __future__ import annotations

import math

import numpy as np

from ..particles import Particles
from .hostfetch import fetch

__all__ = ["ess", "rhat", "autocovariance", "rank_normalize"]


def _as_chains(x) -> np.ndarray:
    if isinstance(x, Particles):
        x = x.particles
    x = np.asarray(fetch(x), np.float64)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise ValueError(
            "diagnostics expect [draws] or [chains, draws] samples")
    return x


def autocovariance(x: np.ndarray) -> np.ndarray:
    """Biased (1/n) autocovariance of each row via FFT, lags 0..n-1."""
    x = np.atleast_2d(np.asarray(x, np.float64))
    n = x.shape[-1]
    xc = x - x.mean(axis=-1, keepdims=True)
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(xc, nfft, axis=-1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=-1)[..., :n]
    return acov / n


def _split(chains: np.ndarray) -> np.ndarray:
    """Split each chain in half (drop one trailing draw if odd)."""
    m, n = chains.shape
    h = n // 2
    return np.concatenate([chains[:, :h], chains[:, h:2 * h]], axis=0)


def rank_normalize(chains: np.ndarray) -> np.ndarray:
    """Replace draws by pooled normal scores (Vehtari et al. 2021 §3.1):
    fractional average ranks over ALL chains' draws combined, mapped
    through the normal quantile function with Blom's offset,
    ``z = ndtri((r - 3/8) / (S + 1/4))``. Ties (discrete marginals)
    share their average rank. Shape-preserving on ``[chains, draws]``."""
    from scipy.special import ndtri
    from scipy.stats import rankdata
    chains = np.asarray(chains, np.float64)
    r = rankdata(chains, method="average").reshape(chains.shape)
    return ndtri((r - 0.375) / (chains.size + 0.25))


def _fold(chains: np.ndarray) -> np.ndarray:
    """Fold around the pooled median — turns scale disagreement into
    location disagreement so split-R-hat can see it."""
    return np.abs(chains - np.median(chains))


def _maybe_multiparam(x):
    """Multi-parameter results (a tuple/list of Particles — the shape
    `sample`/`smc` return for d>1 models) map to per-parameter values.
    Restricted to Particles elements: a list of ARRAYS stays the
    [chains, draws] interpretation."""
    if isinstance(x, (tuple, list)) and x and all(
            isinstance(p, Particles) for p in x):
        return list(x)
    return None


def ess(x, split: bool = True,
        method: str = "mean") -> "float | np.ndarray":
    """Effective sample size of (possibly multi-chain) samples.

    Multi-chain rho_t combines within-chain autocovariances with the
    between-chain variance (Vehtari et al. 2021 eq. 10); the sum over
    lags is truncated at the first negative paired sum Gamma_k =
    rho_{2k} + rho_{2k+1} and made monotone (Geyer 1992). ``split=True``
    (default, matching Stan) splits chains in half first.

    ``method``: ``"mean"`` (raw draws — classical ESS of the mean),
    ``"rank"`` / ``"bulk"`` (rank-normalized bulk ESS, the Stan/ArviZ
    default estimator), or ``"tail"`` (min of the 5%/95%
    quantile-indicator ESS, ArviZ's tail-ESS). A tuple/list of
    ``Particles`` (multi-parameter posteriors) returns a per-parameter
    ``np.ndarray`` instead of a scalar.
    """
    multi = _maybe_multiparam(x)
    if multi is not None:
        return np.array([ess(p, split=split, method=method)
                         for p in multi])
    chains = _as_chains(x)
    if chains.shape[1] < 4:
        raise ValueError("ess needs at least 4 draws")
    # split halves the draw count — only split when both halves keep
    # enough draws for the autocovariance to mean anything
    if split and chains.shape[1] >= 8:
        chains = _split(chains)
    if method in ("rank", "bulk"):
        chains = rank_normalize(chains)
    elif method == "tail":
        qs = np.quantile(chains, [0.05, 0.95])
        # np.minimum (not python min): a degenerate tail indicator
        # (constant, e.g. >=5% point mass at the extreme) yields NaN
        # from _ess_core, and python min() is order-dependent with NaN
        # — the NaN must propagate so a broken tail is never silently
        # reported as a finite tail-ESS
        vals = [_ess_core(rank_normalize(chains <= q)) for q in qs]
        return float(np.minimum(vals[0], vals[1]))
    elif method != "mean":
        raise ValueError(
            f"ess method={method!r} not in ('mean', 'rank', 'bulk', "
            "'tail')")
    return _ess_core(chains)


def _ess_core(chains: np.ndarray) -> float:
    """Split-ESS estimator on already-split (and possibly
    rank-normalized) ``[chains, draws]``."""
    m, n = chains.shape
    acov = autocovariance(chains)
    w_t = acov.mean(axis=0)                      # mean autocov per lag
    var_w = (acov[:, 0] * n / (n - 1.0)).mean()  # W, unbiased
    if var_w == 0.0:
        return float("nan")                      # constant chains
    if m > 1:
        var_plus = var_w * (n - 1.0) / n + chains.mean(
            axis=1).var(ddof=1)
    else:
        var_plus = var_w * (n - 1.0) / n
    rho = 1.0 - (var_w - w_t) / var_plus
    # Geyer initial monotone positive sequence on the paired sums
    # Gamma_k = rho_{2k} + rho_{2k+1} (Gamma_0 = 1 + rho_1, so antithetic
    # chains can legitimately reach tau < 1, i.e. ESS > m*n)
    tau_sum = 0.0
    prev = float("inf")
    for k in range(0, (n - 1) // 2):
        g = rho[2 * k] + rho[2 * k + 1]
        if g < 0.0:
            break
        g = min(g, prev)
        prev = g
        tau_sum += g
    tau = max(-1.0 + 2.0 * tau_sum, 1e-12)
    # Stan's antithetic-chain safeguard: ESS <= S log10(S)
    s = m * n
    return float(min(s / tau, s * math.log10(max(s, 10))))


def rhat(x, method: str = "split") -> "float | np.ndarray":
    """Split-R-hat (Gelman-Rubin with halved chains): sqrt(var+ / W).
    ~1 at convergence; > ~1.01 signals trouble (Vehtari et al. 2021).

    ``method="split"`` runs on the raw draws; ``method="rank"`` is the
    Stan/ArviZ default — ``max(split-R-hat of rank-normalized z,
    split-R-hat of rank-normalized folded |x - median|)``, robust to
    heavy tails and sensitive to scale (not just location)
    disagreement. A tuple/list of ``Particles`` returns a
    per-parameter ``np.ndarray``."""
    multi = _maybe_multiparam(x)
    if multi is not None:
        return np.array([rhat(p, method=method) for p in multi])
    chains = _as_chains(x)
    if chains.shape[1] < 4:
        raise ValueError("rhat needs at least 4 draws")
    chains = _split(chains)
    if method == "rank":
        return float(max(_rhat_core(rank_normalize(chains)),
                         _rhat_core(rank_normalize(_fold(chains)))))
    if method != "split":
        raise ValueError(
            f"rhat method={method!r} not in ('split', 'rank')")
    return _rhat_core(chains)


def _rhat_core(chains: np.ndarray) -> float:
    m, n = chains.shape
    w = chains.var(axis=1, ddof=1).mean()
    b = chains.mean(axis=1).var(ddof=1)
    if w == 0.0:
        # chains frozen at DIFFERENT constants is the worst divergence
        # R-hat exists to flag — inf, not nan (nan only when the whole
        # input is one constant)
        return float("inf") if b > 0.0 else float("nan")
    var_plus = w * (n - 1.0) / n + b
    return float(np.sqrt(var_plus / w))
