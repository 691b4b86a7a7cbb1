"""Adaptive-epsilon SMC-ABC — the PyTorch counterpart of
``kissabc_tpu/core/smc.py`` (the reference's ``src/smc.jl:92-206``).

Each iteration:

  1. adaptive threshold: eps <- type-7 quantile of the alive costs
  2. alive-mask update with the boundary flag, evidence update
  3. replication (or systematic) resampling when alpha*ESS <= N*min_r_ess
  4. delayed-acceptance rejuvenation sweep with accept-counting retries:
     Gaussian-difference proposals for the whole population, the prior
     gate, the batched simulator, the eps gate and the commit
  5. stall / epstol / acceptance stopping rule

The JAX ``lax.while_loop`` becomes a Python loop whose stop flag is read
once per iteration; the ``lax.cond`` around resampling becomes an ``if``
on one host-read flag. The population is a tuple of ``[n]`` (or
``[n, d]``) tensors on the run's device.

Two cost contracts, as in the JAX package:

- per walker (``cost_vectorized=False``, the default): ``cost(theta,
  gen) -> scalar`` or ``cost(theta) -> scalar`` (``core/density.py``'s
  ``_adapt_cost``). ``theta`` is one walker's pushed parameters and
  ``gen`` the run's ``torch.Generator``: a stochastic cost draws with
  ``generator=gen, device=gen.device``. The counterpart of the JAX
  ``vmap`` is ``torch.func.vmap(..., randomness="different")``, so every
  walker gets its own draws and the run repeats from its ``key``. A
  one-argument cost is deterministic, as in JAX (it has no key), and is
  mapped with ``randomness="error"``: a draw inside it raises. A cost
  vmap cannot map (``.item()``, Python control flow on a tensor) raises
  vmap's error with a hint; nothing loops over the walkers in Python;
- batched (``cost_vectorized=True``): ``cost(pushed_thetas, gen) ->
  costs[n]``, e.g. ``make_streaming_moment_cost`` or
  ``make_streaming_scan_cost``.

``smc_stepped`` drives the same program one ``body`` at a time from the
host, with ``IterLog`` records and checkpoint/resume
(``utils/checkpoint.py``).
"""

from __future__ import annotations

import math
import os
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..ops.moves import gaussian_diff_propose
from ..ops.quantile import (masked_quantile, masked_quantile_bisect,
                            resolve_quantile_impl)
from ..ops.resampling import replicate_alive, systematic
from ..ops.tree import tfloat, tgather, tree_map, tselect
from ..particles import particles_from_tree
from ..utils import checkpoint as ckpt
from ..utils.device import resolve_device
from ..utils.hostfetch import fetch
from ..utils.rng import as_generator, log_uniform
from .density import per_walker_cost  # noqa: F401 (re-exported)

_f32 = torch.float32


class _SMCState(NamedTuple):
    """Loop carry of the smc loop. ``key`` is the run's
    ``torch.Generator``; every other field is a tensor on its device."""
    key: object
    thetas: object   # population: tuple of [n] tensors (or one tensor)
    xs: object       # costs [n]
    lps: object      # prior log-densities [n]
    alive: object    # bool mask [n]
    eps: object      # current threshold
    logz: object     # accumulated log survival mass (evidence)
    it: object       # iteration counter
    acc: object      # accepted count of the last sweep
    done: object     # stop flag


class SMCResult(NamedTuple):
    P: object          # Particles (or list of Particles) — alive posterior
    C: np.ndarray      # final cost array (full population, smc.jl:205)
    eps: float         # final threshold
    iterations: int
    ess: int
    # log P(cost < eps | prior): the telescoping product of the
    # per-iteration survival fractions (adaptive-SMC evidence estimator)
    log_evidence: float = float("nan")


class _SMCProgram:
    """The smc program for one configuration: ``init_state(gen)``,
    ``body(state)``, ``cond(state)``, and ``__call__(gen)`` which runs
    the loop to its end."""

    def __init__(self, prior, cost, *, nparticles, alpha, mcmc_retrys,
                 mcmc_tol, epstol, r_epstol, min_r_ess, max_stretch,
                 max_iters, resample, verbose, partner_scheme="auto",
                 quantile_impl="auto", sweep_fused=None, device="cpu",
                 cost_vectorized=True):
        self.prior = prior
        self.cost = (cost if cost_vectorized
                     else per_walker_cost(cost))
        self.sweep_fused = sweep_fused
        self.n = nparticles
        self.alpha, self.epstol, self.r_epstol = alpha, epstol, r_epstol
        self.min_r_ess, self.max_stretch = min_r_ess, max_stretch
        self.max_iters, self.resample, self.verbose = \
            max_iters, resample, verbose
        self.partner_scheme = partner_scheme
        self.retry_n = 1 + mcmc_retrys
        self.tol_count = mcmc_tol * nparticles
        self.device = torch.device(device)
        self.qfn = (masked_quantile
                    if resolve_quantile_impl(quantile_impl, None,
                                             nparticles) == "sort"
                    else masked_quantile_bisect)

    def logpdf(self, thetas):
        p = self.prior
        return p.logpdf_tree(p.push_tree(thetas)).to(_f32)

    def batch_cost(self, thetas, gen):
        return self.cost(self.prior.push_tree(thetas), gen).to(_f32)


    def init(self, gen):
        thetas = tfloat(self.prior.sample_tree(gen, self.n))
        return thetas, self.batch_cost(thetas, gen), self.logpdf(thetas)

    def mcmc_sweep(self, gen, thetas, xs, lps, alive, eps, flag):
        """One retry round of the rejuvenation sweep (smc.jl:159-191);
        proposals all read the pre-sweep snapshot."""
        if self.sweep_fused is not None:
            return self.sweep_fused(gen, thetas, xs, lps, alive, eps, flag)
        props = gaussian_diff_propose(gen, thetas, self.prior.nparams,
                                      self.max_stretch,
                                      scheme=self.partner_scheme)
        lprob = log_uniform(gen, (self.n,))
        lpp = self.logpdf(props)
        # gate 1 — prior-only MH (smc.jl:172-175); -inf lpp rejected
        lm = torch.clamp(lpp - lps, max=0.0)
        gate1 = alive & (lpp > float("-inf")) & (lprob < lm)
        # gate 2 — simulator (smc.jl:176-181); batched, masked afterward
        xp = self.batch_cost(props, gen)
        gate2 = torch.where(flag, xp <= eps, xp < eps)
        commit = gate1 & gate2
        thetas = tselect(commit, props, thetas)
        xs = torch.where(commit, xp, xs)
        lps = torch.where(commit, lpp, lps)
        return thetas, xs, lps, commit.sum()

    def body(self, state: _SMCState) -> _SMCState:
        gen, thetas, xs, lps, alive, eps, logz, it = state[:8]
        n = self.n
        it = it + 1
        eps_v = eps
        prev_cnt = alive.sum()  # walkers representing prior | cost < eps_v
        eps = self.qfn(xs, alive, self.alpha)
        xmin = torch.where(alive, xs, float("inf")).min()
        flag = ~(eps > xmin)
        alive = torch.where(flag, xs <= eps, xs < eps)
        ess = alive.sum()
        # evidence: the survival fraction of this eps-lowering (counts
        # taken before resampling)
        logz = logz + (torch.log(ess.to(_f32)) - torch.log(prev_cnt.to(_f32)))

        # Step 2 — resampling (smc.jl:145-153), only when ESS is low
        if bool(self.alpha * ess.to(_f32) <= n * self.min_r_ess):
            if self.resample == "replicate":
                ridx = replicate_alive(alive)
            else:
                ridx = systematic(gen, alive.to(_f32))
            # one packed gather of thetas + xs + lps (ops/tree.py)
            thetas, xs, lps = tgather((thetas, xs, lps), ridx)
            alive = torch.ones_like(alive)
            ess = torch.full_like(ess, n)

        if self.verbose:
            print(f"smc it={int(it)} eps={float(eps)} ESS={int(ess)}")

        # Step 3 — MCMC with accept-accumulating retries (smc.jl:156-193)
        accepted = torch.zeros((), dtype=torch.int64, device=self.device)
        for r in range(self.retry_n):
            if r > 0 and not bool(accepted < self.tol_count):
                break
            thetas, xs, lps, got = self.mcmc_sweep(gen, thetas, xs, lps,
                                                   alive, eps, flag)
            accepted = accepted + got

        stall = 2.0 * torch.abs(eps_v - eps) < self.r_epstol * (
            torch.abs(eps_v) + torch.abs(eps))
        done = stall | (eps <= self.epstol) | (accepted < self.tol_count)
        return _SMCState(gen, thetas, xs, lps, alive, eps, logz, it,
                         accepted, done)

    def cond(self, state: _SMCState) -> bool:
        """One host read per iteration: the stop flag and the count."""
        done, it = torch.stack((state.done.to(torch.int64),
                                state.it)).tolist()
        return not done and it < self.max_iters

    def init_state(self, gen) -> _SMCState:
        thetas, xs, lps = self.init(gen)
        dev = self.device
        return _SMCState(
            gen, thetas, xs, lps,
            torch.ones(self.n, dtype=torch.bool, device=dev),
            torch.tensor(float("inf"), dtype=_f32, device=dev),
            torch.tensor(0.0, dtype=_f32, device=dev),
            torch.tensor(0, dtype=torch.int64, device=dev),
            torch.tensor(0, dtype=torch.int64, device=dev),
            torch.tensor(False, device=dev))

    def __call__(self, gen) -> _SMCState:
        state = self.init_state(gen)
        while self.cond(state):
            state = self.body(state)
        return state


def _validate_smc_knobs(prior, *, nparticles, alpha, mcmc_retrys, mcmc_tol,
                        r_epstol, min_r_ess, max_stretch, resample,
                        partner_scheme="auto", quantile_impl="auto"):
    """Reference error semantics (smc.jl:107-118) plus the string knobs;
    the same messages as the JAX package."""
    if not 0 < alpha <= 1:
        raise ValueError("alpha must be in (0, 1].")
    if r_epstol is None:
        r_epstol = (1 - alpha) ** 1.5 / 50.0
    if min_r_ess is None:
        min_r_ess = alpha ** 2
    if min_r_ess <= 0:
        raise ValueError("min_r_ess must be > 0.")
    if mcmc_retrys < 0:
        raise ValueError("mcmc_retrys must be >= 0.")
    if r_epstol < 0:
        raise ValueError("r_epstol must be >= 0")
    if mcmc_tol < 0:
        raise ValueError("mcmc_tol must be >= 0")
    if max_stretch <= 1:
        raise ValueError("max_stretch must be > 1")
    if resample not in ("replicate", "systematic"):
        raise ValueError(
            f"resample must be 'replicate' or 'systematic', got {resample!r}")
    if partner_scheme not in ("auto", "roll", "gather"):
        raise ValueError(
            "partner_scheme must be 'auto', 'roll' or 'gather', "
            f"got {partner_scheme!r}")
    resolve_quantile_impl(quantile_impl, None)  # validate the string
    min_np = math.ceil(3 * prior.nparams / min(alpha, min_r_ess))
    if nparticles < min_np:
        raise ValueError(f"nparticles must be >= {min_np}.")
    return r_epstol, min_r_ess


def _program(prior, cost, *, nparticles, alpha, mcmc_retrys, mcmc_tol,
             epstol, r_epstol, min_r_ess, max_stretch, max_iters, resample,
             verbose, mesh, cost_vectorized, partner_scheme, quantile_impl,
             sweep_fused, device, caller):
    """The checked knobs and the program, shared by ``smc`` and
    ``smc_stepped``."""
    if mesh is not None:
        raise NotImplementedError(
            f"{caller}(mesh=...): walker sharding is not ported yet")
    r_epstol, min_r_ess = _validate_smc_knobs(
        prior, nparticles=nparticles, alpha=alpha, mcmc_retrys=mcmc_retrys,
        mcmc_tol=mcmc_tol, r_epstol=r_epstol, min_r_ess=min_r_ess,
        max_stretch=max_stretch, resample=resample,
        partner_scheme=partner_scheme, quantile_impl=quantile_impl)
    return _SMCProgram(
        prior, cost, nparticles=nparticles, alpha=alpha,
        mcmc_retrys=mcmc_retrys, mcmc_tol=mcmc_tol, epstol=epstol,
        r_epstol=r_epstol, min_r_ess=min_r_ess, max_stretch=max_stretch,
        max_iters=max_iters, resample=resample, verbose=verbose,
        partner_scheme=partner_scheme, quantile_impl=quantile_impl,
        sweep_fused=sweep_fused, device=resolve_device(device),
        cost_vectorized=cost_vectorized)


def _result(prior, state, caller, max_iters) -> SMCResult:
    if not bool(state.done):
        # the reference loops until an eps stall / epstol / acceptance
        # collapse; max_iters is this build's safety bound
        warnings.warn(
            f"{caller}: stopped at the max_iters={max_iters} safety bound "
            "before any stopping rule (eps stall / epstol / acceptance "
            "collapse) fired; the posterior may not be converged.",
            RuntimeWarning, stacklevel=3)
    alive_np = fetch(state.alive)
    pushed = prior.push_tree(state.thetas)
    pushed_alive = tree_map(lambda x: fetch(x)[alive_np], pushed)
    return SMCResult(
        P=particles_from_tree(pushed_alive),
        C=fetch(state.xs),
        eps=float(state.eps),
        iterations=int(state.it),
        ess=int(alive_np.sum()),
        log_evidence=float(state.logz),
    )


def smc(prior, cost, *, nparticles: int = 100, alpha: float = 0.95,
        mcmc_retrys: int = 0, mcmc_tol: float = 0.015, epstol: float = 0.0,
        r_epstol: float | None = None, min_r_ess: float | None = None,
        max_stretch: float = 2.0, max_iters: int = 10_000,
        resample: str = "replicate", verbose: bool = False,
        parallel: bool = True, mesh=None, cost_vectorized: bool = False,
        partner_scheme: str = "auto", quantile_impl: str = "auto",
        sweep_fused=None, key=0, device=None) -> SMCResult:
    """Adaptive SMC-ABC. Signature and defaults mirror the JAX package
    and the reference (smc.jl:92-106): ``r_epstol=(1-alpha)^1.5/50``,
    ``min_r_ess=alpha^2``.

    ``cost``: per walker, ``cost(theta, gen)`` or ``cost(theta)`` (the
    default, see the module docstring); or, with
    ``cost_vectorized=True``, a batched ``cost(pushed_thetas, gen) ->
    costs[n]`` (``make_flagship_cost_batched()``,
    ``make_streaming_moment_cost``, ``make_streaming_scan_cost``).
    ``sweep_fused``: a one-kernel rejuvenation sweep
    ``sweep(gen, thetas, xs, lps, alive, eps, flag) -> (thetas, xs, lps,
    naccept)`` (``make_fused_smc_sweep``) that replaces the split sweep;
    the init still runs ``cost``. ``key``: an int seed or a
    ``torch.Generator`` on the run's device. ``device``: ``None`` runs on
    CUDA (and raises without a card); pass ``"cpu"`` for the plain
    versions on the CPU. ``parallel`` is accepted for API parity;
    ``mesh=`` raises ``NotImplementedError``."""
    del parallel
    program = _program(
        prior, cost, nparticles=nparticles, alpha=alpha,
        mcmc_retrys=mcmc_retrys, mcmc_tol=mcmc_tol, epstol=epstol,
        r_epstol=r_epstol, min_r_ess=min_r_ess, max_stretch=max_stretch,
        max_iters=max_iters, resample=resample, verbose=verbose, mesh=mesh,
        cost_vectorized=cost_vectorized, partner_scheme=partner_scheme,
        quantile_impl=quantile_impl, sweep_fused=sweep_fused, device=device,
        caller="smc")
    state = program(as_generator(key, program.device))
    return _result(prior, state, "smc", max_iters)


def smc_stepped(prior, cost, *, checkpoint_path: str | None = None,
                resume: bool = False, log=None, nparticles: int = 100,
                alpha: float = 0.95, mcmc_retrys: int = 0,
                mcmc_tol: float = 0.015, epstol: float = 0.0,
                r_epstol: float | None = None, min_r_ess: float | None = None,
                max_stretch: float = 2.0, max_iters: int = 10_000,
                resample: str = "replicate", checkpoint_every: int = 10,
                cost_vectorized: bool = False, mesh=None,
                partner_scheme: str = "auto", quantile_impl: str = "auto",
                sweep_fused=None, key=0, device=None) -> SMCResult:
    """Host-stepped smc: the program of ``smc``, driven one ``body`` at a
    time, so the same key gives the same result as ``smc``. After every
    iteration ``log`` (an ``IterLog``) gets ``iteration``, ``eps``,
    ``ess`` and ``accepted``. Every ``checkpoint_every`` iterations the
    whole loop state goes to ``checkpoint_path`` (``utils/checkpoint.py``:
    the population, costs, log-priors, alive mask, eps, evidence,
    iteration, last accept count, stop flag and the run generator's
    state); with ``resume=True`` a run starts from that file when it
    exists and continues the same random stream, so a resumed run
    equals an uninterrupted one. ``mesh=`` raises as in ``smc``."""
    program = _program(
        prior, cost, nparticles=nparticles, alpha=alpha,
        mcmc_retrys=mcmc_retrys, mcmc_tol=mcmc_tol, epstol=epstol,
        r_epstol=r_epstol, min_r_ess=min_r_ess, max_stretch=max_stretch,
        max_iters=max_iters, resample=resample, verbose=False, mesh=mesh,
        cost_vectorized=cost_vectorized, partner_scheme=partner_scheme,
        quantile_impl=quantile_impl, sweep_fused=sweep_fused, device=device,
        caller="smc_stepped")
    state = program.init_state(as_generator(key, program.device))
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        state, _meta = ckpt.load(checkpoint_path, state)
    while program.cond(state):
        state = program.body(state)
        it = int(state.it)
        if log is not None:
            log.emit(iteration=it, eps=float(state.eps),
                     ess=int(state.alive.sum()), accepted=int(state.acc))
        if checkpoint_path and it % checkpoint_every == 0:
            ckpt.save(checkpoint_path, state, {"iteration": it})
    return _result(prior, state, "smc_stepped", max_iters)
