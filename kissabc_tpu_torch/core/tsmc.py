"""Adaptive tempered SMC with evidence estimation — the PyTorch
counterpart of ``kissabc_tpu/core/tsmc.py``.

Classical Bayesian SMC over the tempered targets

    pi_lambda(theta)  ∝  prior(theta) * exp(lambda * loglike(theta)),
    lambda: 0 -> 1,

with the next temperature chosen so that the Kish ESS of the incremental
weights is ``alpha * N`` (``next_lambda``: 40 bisection steps), systematic
resampling, and red/black ensemble-move rejuvenation (the 4:2:1 stretch /
DE / walk mixture of AIS) targeting the current tempered density. The
evidence estimate is the by-product

    log Z = sum_t log mean_i exp(dlambda_t * ll_i).

The JAX ``lax.while_loop`` is a Python loop whose only host read is the
stop flag ``lam < 1`` (the iteration count is a host integer); nothing
else inside an iteration is read on the host. ``sweep_fused`` replaces
the split rejuvenation with ``make_fused_tempered_sweep``'s kernel,
one launch per half-update.

``mesh=`` shards the population over a walker mesh with the rule of
``parallel/layout.py``: the sums of ``next_lambda``'s 40-step ESS
bisection and of the evidence increment are float64 sums of the shards
reduced over the mesh and rounded once (on one device too), the maxima
``pmax``; the systematic resampler is smc's sharded one
(``exclusive_prefix``), and the ancestors are gathered from the joined
population straight into the two halves of the rejuvenation, which are
``Sharded`` (``propose_half(..., mesh=)``), and joined again after it.
With a likelihood written in PyTorch the run equals the unsharded one
bit for bit; a fused sweep built for the mesh runs its kernel once per
shard (statistical parity). The split path also reads the six shifts of
each half-update on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.moves import propose_half
from ..ops.quantile import ess_weights
from ..ops.resampling import systematic
from ..ops.tree import tfloat, tgather, tree_map, tselect
from ..parallel import layout as L
from ..particles import particles_from_tree
from ..utils.hostfetch import fetch_tree
from ..utils.rng import as_generator, log_uniform
from .density import per_walker_cost

_f32 = torch.float32
_NEG_INF = float("-inf")


class TSMCResult(NamedTuple):
    P: object            # posterior Particles (unweighted, post-resample)
    log_evidence: float  # marginal-likelihood estimate log Z
    lam: float           # final temperature (1.0 on success)
    iterations: int
    ess: float           # Kish ESS of the last incremental weights
                         # (pre-resample): a sampler-health indicator




def next_lambda(lam, ll, alpha, n):
    """The temperature step: bisect ``dlam`` in ``(0, 1 - lam]`` for 40
    steps so that the Kish ESS of ``exp(dlam * ll - max)`` is ``alpha *
    n`` (the ESS falls as ``dlam`` grows), or take the full step when it
    keeps the ESS at or above the target. ``lam`` is a float32 0-d
    tensor; the result is one too, computed on the device. ``ll`` may be
    ``Sharded``: the maxima and sums are then reduced over its mesh."""
    target = alpha * n
    lay = L.layout_of(ll)

    def ess_at(dlam):
        lw = lay.map(lambda x: dlam.to(x.device) * x, ll)
        top = lay.max(lw)
        return ess_weights(lay.map(lambda x: torch.exp(x - top.to(x.device)),
                                   lw))

    full = 1.0 - lam
    lo, hi = torch.zeros_like(full), full
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        too_low = ess_at(mid) < target
        lo, hi = torch.where(too_low, lo, mid), torch.where(too_low, mid, hi)
    dlam = 0.5 * (lo + hi)
    return torch.where(ess_at(full) >= target, full, dlam)


def evidence_increment(dlam, ll):
    """``(m + log mean exp(dlam * ll - m), weights)`` with ``m = max(dlam
    * ll)``: the log-evidence increment of one temperature step and the
    (unnormalized) incremental weights ``exp(dlam * ll - m)``; the mean
    a float64 sum rounded once, over the mesh for a ``Sharded`` ``ll``."""
    lay = L.layout_of(ll)
    lw = lay.map(lambda x: dlam.to(x.device) * x, ll)
    m = lay.max(lw)
    w = lay.map(lambda x: torch.exp(x - m.to(x.device)), lw)
    n = ll.n if lay.sharded else ll.shape[0]
    return m + torch.log(lay.fsum(w) / n), w


def _tempered_accept(props, upd, lp_u, ll_u, lpp, llp, corr, lu, lam):
    """The tempered MH accept and commit of one half (or shard)."""
    lam = lam.to(lp_u.device)
    old = lp_u + lam * ll_u
    new = torch.where(torch.isfinite(lpp), lpp + lam * llp, _NEG_INF)
    acc = lu <= (corr + new - old)
    return (tselect(acc, props, upd), torch.where(acc, lpp, lp_u),
            torch.where(acc, llp, ll_u))


class _TSMCProgram:
    """tsmc for one configuration: ``init(gen)``, ``body(state)`` and
    ``rejuvenate``; ``__call__(gen)`` runs the loop to its end."""

    def __init__(self, prior, loglike, *, nparticles, alpha, mcmc_steps,
                 max_iters, partner_scheme, loglike_vectorized, sweep_fused,
                 lay):
        self.prior, self.n, self.alpha = prior, nparticles, alpha
        self.mcmc_steps, self.max_iters = mcmc_steps, max_iters
        self.partner_scheme, self.sweep_fused = partner_scheme, sweep_fused
        self.lay, self.device = lay, lay.device
        self._ll = (loglike if loglike_vectorized
                    else per_walker_cost(loglike, "tsmc"))

    def vlp(self, thetas):
        p = self.prior
        return self.lay.map(lambda t: p.logpdf_tree(p.push_tree(t)).to(_f32),
                            thetas)

    def vll(self, thetas, gen):
        lay = self.lay
        return lay.map(lambda c: c.to(_f32), lay.cost(
            self._ll, thetas, gen, push=self.prior.push_tree))

    def half_update(self, gen, upd, lp_u, ll_u, comp, lam):
        """MH-update one half against the other at temperature ``lam``."""
        lay = self.lay
        props, corr, lu = propose_half(gen, upd, comp, self.prior.nparams,
                                       scheme=self.partner_scheme,
                                       mesh=lay.mesh, accept_lu=True)
        lpp = self.vlp(props)
        llp = self.vll(props, gen)
        if lu is None:
            lu = lay.place(log_uniform(gen, (lay.size(lp_u),)))
        out = lay.map(lambda *a: _tempered_accept(*a, lam), props, upd, lp_u,
                      ll_u, lpp, llp, corr, lu)
        return lay.unzip(out, 3)

    def _halves(self, thetas, lp, ll):
        """The population (whole, on one device) as two halves on the
        layout."""
        h, place = self.n // 2, self.lay.place
        th = (place(tree_map(lambda x: x[:h], thetas)),
              place(tree_map(lambda x: x[h:], thetas)))
        return th, (place(lp[:h]), place(lp[h:])), (place(ll[:h]),
                                                     place(ll[h:]))

    def rejuvenate(self, gen, th, lps, lls, lam):
        """``mcmc_steps`` red/black mixture sweeps targeting pi_lam, on the
        population carried as two halves (``_halves``); returns it whole,
        on the layout."""
        for _ in range(self.mcmc_steps):
            if self.sweep_fused is not None:
                th, ((lpa, lla), (lpb, llb)) = self.sweep_fused(
                    gen, th, ((lps[0], lls[0]), (lps[1], lls[1])), lam)
                lps, lls = (lpa, lpb), (lla, llb)
            else:
                tha, lpa, lla = self.half_update(gen, th[0], lps[0], lls[0],
                                                 th[1], lam)
                thb, lpb, llb = self.half_update(gen, th[1], lps[1], lls[1],
                                                 tha, lam)
                th, lps, lls = (tha, thb), (lpa, lpb), (lla, llb)
        lay = self.lay
        if lay.sharded:   # the halves joined, then cut over the population
            th, lps, lls = (tuple(lay.join(x) for x in pair)
                            for pair in (th, lps, lls))
        return (lay.place(tree_map(lambda a, b: torch.cat([a, b]), *th)),
                lay.place(torch.cat(lps)), lay.place(torch.cat(lls)))

    def init(self, gen):
        thetas = self.lay.place(tfloat(self.prior.sample_tree(gen, self.n)))
        dev = self.device
        zero = torch.zeros((), dtype=_f32, device=dev)
        return (thetas, self.vlp(thetas), self.vll(thetas, gen), zero,
                zero.clone(), torch.tensor(float(self.n), device=dev))

    def body(self, gen, state):
        thetas, lp, ll, lam, logz, _ess = state
        dlam = next_lambda(lam, ll, self.alpha, self.n)
        inc, w = evidence_increment(dlam, ll)
        logz = logz + inc
        ess = ess_weights(w)
        # reweight and resample back to uniform weights: one packed gather
        # (of the joined population on a mesh: ancestors lie on any shard)
        idx = systematic(gen, w)
        lay = self.lay
        thetas, lp, ll = tgather(tuple(lay.join(x) for x in (thetas, lp, ll)),
                                 idx)
        lam = lam + dlam
        thetas, lp, ll = self.rejuvenate(gen, *self._halves(thetas, lp, ll),
                                         lam)
        return thetas, lp, ll, lam, logz, ess

    def __call__(self, gen):
        state = self.init(gen)
        it = 0
        # one host read per iteration: the stop flag
        while it < self.max_iters and bool(state[3] < 1.0):
            state = self.body(gen, state)
            it += 1
        return state, it


def tsmc(prior, loglike, *, nparticles: int = 1000, alpha: float = 0.5,
         mcmc_steps: int = 3, max_iters: int = 1000,
         partner_scheme: str = "auto", mesh=None,
         loglike_vectorized: bool = False, sweep_fused=None, key=0,
         device=None) -> TSMCResult:
    """Adaptive tempered SMC.

    - ``prior``: any distribution of the port (incl. ``Factored``).
    - ``loglike(theta[, gen])``: log-likelihood of one pushed parameter
      pack, mapped over the walkers with ``torch.func.vmap``; with
      ``loglike_vectorized=True``, ``loglike(pushed_thetas, gen) -> [n]``
      takes the whole batch.
    - ``alpha``: the incremental-ESS target fraction in (0, 1).
    - ``mcmc_steps``: red/black rejuvenation sweeps per temperature.
    - ``sweep_fused``: ``make_fused_tempered_sweep(prior, loglike_elem)``,
      one kernel per half-update in place of the split rejuvenation; the
      init still evaluates ``loglike``, so both must describe the SAME
      likelihood.
    - ``key``: an int seed or a ``torch.Generator`` on the run's device;
      ``device``: ``None`` runs on CUDA (and raises without a card),
      ``"cpu"`` runs the plain versions.
    - ``mesh``: a walker mesh shards the population (the module
      docstring); ``nparticles / 2`` must divide its walker axis, a
      batched kernel likelihood comes through ``shard_batched_cost`` and
      a ``sweep_fused`` must be built for the SAME mesh."""
    if not 0 < alpha < 1:
        raise ValueError("alpha must be in (0, 1)")
    if sweep_fused is not None and mesh is not None \
            and getattr(sweep_fused, "mesh", None) is not mesh:
        raise ValueError(
            "tsmc(mesh=...) with sweep_fused needs the sweep built for "
            "the SAME mesh: make_fused_tempered_sweep(..., mesh=mesh) — "
            "a single-chip fused sweep cannot run on sharded "
            "populations")
    lay = L.layout(mesh, device, "tsmc", loglike,
                   (nparticles // 2, nparticles - nparticles // 2),
                   "half size {n}")
    dev = lay.device
    program = _TSMCProgram(
        prior, loglike, nparticles=nparticles, alpha=alpha,
        mcmc_steps=mcmc_steps, max_iters=max_iters,
        partner_scheme=partner_scheme, loglike_vectorized=loglike_vectorized,
        sweep_fused=sweep_fused, lay=lay)
    (thetas, _, _, lam, logz, ess), it = program(as_generator(key, dev))
    pushed = prior.push_tree(lay.join(thetas))
    return TSMCResult(
        P=particles_from_tree(fetch_tree(pushed)),
        log_evidence=float(logz),
        lam=float(lam),
        iterations=it,
        ess=float(ess),
    )
