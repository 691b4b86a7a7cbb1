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

``mesh=`` (a ``Mesh`` of ``parallel/mesh.py`` with a ``walker`` axis)
shards the population: particles, costs, log-priors and the alive mask
live as ``Sharded`` blocks of n/ndev walkers, each on its device, and
the loop's scalars on the mesh's home device. The run is the same as
without a mesh, as in the JAX package, whose per-particle keys come from
global indices: every population-wide draw (the initial sample, the
proposal scales and partners, the MH log-u, the resampling offset) is
made on the whole population on the generator's device, as the
unsharded run makes it, and cut into shards; a per-walker or plain
batched cost runs on the joined population (an all-gather of the pushed
proposals) on that device, as the unsharded run runs it, and its costs
are cut into shards; the roll partners move as shard-sized transfers
(``roll_walkers``), the quantile is the bisection over scalar
reductions, and a gather of partners or ancestors joins the population
(an all-gather). The gates and the commit are one function of tensors
(``mh_step``), run shard by shard. A kernel
cost goes through ``shard_batched_cost``: once per shard, with the
shard folded into its seed, so its parity with the unsharded run is
statistical, as in the JAX package. The host reads are those of the
unsharded loop (and, with the roll scheme or a fused sweep, the two
shifts once a sweep).
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
from ..parallel import mesh as M
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


def below(x, eps, flag):
    """The eps test of gate 2 and of the alive mask (smc.jl:176-181):
    ``x < eps``, or ``x <= eps`` where the boundary ``flag`` is set."""
    eps, flag = eps.to(x.device), flag.to(x.device)
    return torch.where(flag, x <= eps, x < eps)


def mh_step(props, thetas, xs, lps, lpp, lprob, xp, alive, eps, flag):
    """Gates 1 and 2 and the commit of one retry round, on one device's
    walkers: returns (thetas, xs, lps, commit mask)."""
    # gate 1 — prior-only MH (smc.jl:172-175); -inf lpp rejected
    lm = torch.clamp(lpp - lps, max=0.0)
    gate1 = alive & (lpp > float("-inf")) & (lprob < lm)
    # gate 2 — simulator (smc.jl:176-181); batched, masked afterward
    commit = gate1 & below(xp, eps, flag)
    return (tselect(commit, props, thetas), torch.where(commit, xp, xs),
            torch.where(commit, lpp, lps), commit)


class _SMCProgram:
    """The smc program for one configuration: ``init_state(gen)``,
    ``body(state)``, ``cond(state)``, and ``__call__(gen)`` which runs
    the loop to its end."""

    mesh = None

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
        self.sort = resolve_quantile_impl(quantile_impl, None,
                                          nparticles) == "sort"

    def qfn(self, xs, alive, q):
        return (masked_quantile if self.sort
                else masked_quantile_bisect)(xs, alive, q)

    def logpdf(self, thetas):
        p = self.prior
        return p.logpdf_tree(p.push_tree(thetas)).to(_f32)

    def batch_cost(self, thetas, gen):
        return self.cost(self.prior.push_tree(thetas), gen).to(_f32)

    def place(self, tree):
        """A whole population as the program holds it (shards on a
        mesh)."""
        return tree

    def smap(self, f, *parts):
        """``f`` on the walkers (shard by shard on a mesh); ``f`` returns
        a tuple, and so does ``smap``."""
        return f(*parts)

    def total(self, x):
        """The sum of a per-walker tensor over the population."""
        return x.sum()

    def init(self, gen):
        thetas = self.place(tfloat(self.prior.sample_tree(gen, self.n)))
        return thetas, self.batch_cost(thetas, gen), self.logpdf(thetas)

    def mcmc_sweep(self, gen, thetas, xs, lps, alive, eps, flag):
        """One retry round of the rejuvenation sweep (smc.jl:159-191);
        proposals all read the pre-sweep snapshot."""
        if self.sweep_fused is not None:
            return self.sweep_fused(gen, thetas, xs, lps, alive, eps, flag)
        props = gaussian_diff_propose(gen, thetas, self.prior.nparams,
                                      self.max_stretch,
                                      scheme=self.partner_scheme,
                                      mesh=self.mesh)
        lprob = self.place(log_uniform(gen, (self.n,)))
        lpp = self.logpdf(props)
        xp = self.batch_cost(props, gen)
        thetas, xs, lps, commit = self.smap(
            lambda *a: mh_step(*a, eps, flag), props, thetas, xs, lps, lpp,
            lprob, xp, alive)
        return thetas, xs, lps, self.total(commit)

    def alive_count(self, alive):
        return self.total(alive)

    def _xmin(self, xs, alive):
        return torch.where(alive, xs, float("inf")).min()

    def _alive(self, xs, eps, flag):
        return self.smap(lambda x: (below(x, eps, flag),), xs)[0]

    def _resample(self, gen, thetas, xs, lps, alive):
        if self.resample == "replicate":
            ridx = replicate_alive(alive)
        else:
            ridx = systematic(gen, alive.to(_f32))
        # one packed gather of thetas + xs + lps (ops/tree.py)
        thetas, xs, lps = tgather((thetas, xs, lps), ridx)
        return thetas, xs, lps, torch.ones_like(alive)

    def checkpoint_view(self, state):
        """The state as a checkpoint holds it (``_ShardedSMCProgram``
        joins the population)."""
        return state

    def from_checkpoint(self, state):
        return state

    def body(self, state: _SMCState) -> _SMCState:
        gen, thetas, xs, lps, alive, eps, logz, it = state[:8]
        n = self.n
        it = it + 1
        eps_v = eps
        # walkers representing prior | cost < eps_v
        prev_cnt = self.alive_count(alive)
        eps = self.qfn(xs, alive, self.alpha)
        xmin = self._xmin(xs, alive)
        flag = ~(eps > xmin)
        alive = self._alive(xs, eps, flag)
        ess = self.alive_count(alive)
        # evidence: the survival fraction of this eps-lowering (counts
        # taken before resampling)
        logz = logz + (torch.log(ess.to(_f32)) - torch.log(prev_cnt.to(_f32)))

        # Step 2 — resampling (smc.jl:145-153), only when ESS is low
        if bool(self.alpha * ess.to(_f32) <= n * self.min_r_ess):
            thetas, xs, lps, alive = self._resample(gen, thetas, xs, lps,
                                                    alive)
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
            self.place(torch.ones(self.n, dtype=torch.bool, device=dev)),
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


class _ShardedSMCProgram(_SMCProgram):
    """The smc program on a walker mesh: the population as ``Sharded``
    blocks, the same draws and arithmetic as ``_SMCProgram`` (the module
    docstring), the counts and extremes reduced over the mesh."""

    def __init__(self, prior, cost, *, mesh, quantile_impl="auto", **kw):
        super().__init__(prior, cost, quantile_impl=quantile_impl,
                         device=mesh.home, **kw)
        self.mesh = mesh
        ndev = mesh.axis_size("walker")
        if self.n % ndev:
            raise ValueError(f"nparticles={self.n} must divide the mesh "
                             f"walker axis ({ndev} devices)")
        self.s = self.n // ndev
        self.sort = resolve_quantile_impl(quantile_impl, mesh,
                                          self.n) == "sort"

    def qfn(self, xs, alive, q):
        if self.sort:   # the sort needs the joined costs (an all-gather)
            return masked_quantile(M.join(xs), M.join(alive), q)
        return masked_quantile_bisect(xs, alive, q)

    def place(self, tree):
        return M.place(self.mesh, tree)

    def smap(self, f, *parts):
        out = parts[0].map(f, *parts[1:])
        return tuple(out.map(lambda o, k=k: o[k])
                     for k in range(len(out.shards[0])))

    def total(self, x):
        return M.psum(self.mesh, [v.sum() for v in x.shards])

    def logpdf(self, thetas):
        return thetas.map(super().logpdf)

    def batch_cost(self, thetas, gen):
        if isinstance(self.cost, M.ShardedCost):
            return self.cost(thetas.map(self.prior.push_tree), gen).map(
                lambda c: c.to(_f32))
        # a cost written in PyTorch runs on the joined population (an
        # all-gather) on the generator's device, as the unsharded run
        # runs it: the same draws and the same costs, cut into shards
        return self.place(super().batch_cost(M.join(thetas), gen))

    def _xmin(self, xs, alive):
        return M.pmin(self.mesh, [torch.where(a, x, float("inf")).min()
                                  for x, a in zip(xs.shards, alive.shards)])

    def _resample(self, gen, thetas, xs, lps, alive):
        if self.resample == "replicate":
            ridx = replicate_alive(M.join(alive))
        else:
            ridx = systematic(gen, alive.map(lambda a: a.to(_f32)))
        # the ancestors may lie on any shard: the population is joined
        # (an all-gather) and each shard takes its rows
        full = M.join(M.Sharded(self.mesh, list(zip(
            thetas.shards, xs.shards, lps.shards)), self.n))
        s = self.s
        rows = M.Sharded(self.mesh, [
            tgather(tree_map(lambda x, g=g: x.to(self.mesh.device_of(g)),
                             full), ridx[g * s:(g + 1) * s].to(
                                 self.mesh.device_of(g)))
            for g in thetas.index], self.n)
        return (rows.map(lambda r: r[0]), rows.map(lambda r: r[1]),
                rows.map(lambda r: r[2]), alive.map(torch.ones_like))

    def checkpoint_view(self, state):
        """The state with the population joined: the layout of the
        unsharded program's state, so a checkpoint resumes on any mesh or
        on one device."""
        return state._replace(thetas=M.join(state.thetas),
                              xs=M.join(state.xs), lps=M.join(state.lps),
                              alive=M.join(state.alive))

    def from_checkpoint(self, state):
        return state._replace(thetas=self.place(state.thetas),
                              xs=self.place(state.xs),
                              lps=self.place(state.lps),
                              alive=self.place(state.alive))


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
        if not isinstance(mesh, M.Mesh):
            raise TypeError(
                f"{caller}(mesh=...) takes a Mesh with a 'walker' axis "
                f"(kissabc_tpu_torch.parallel.mesh.make_mesh), got "
                f"{type(mesh).__name__}")
        if sweep_fused is not None \
                and getattr(sweep_fused, "mesh", None) is not mesh:
            raise ValueError(
                f"{caller}(mesh=...) with sweep_fused needs the sweep built "
                "for the SAME mesh: make_fused_smc_sweep(..., mesh=mesh) — "
                "a single-device fused sweep cannot run on sharded "
                "populations")
    if mesh is not None and cost_vectorized \
            and not isinstance(cost, M.ShardedCost) \
            and callable(getattr(cost, "seeded", None)):
        raise NotImplementedError(
            f"{caller}(mesh=...): a kernel cost runs once per shard on a "
            "mesh: pass shard_batched_cost(cost, mesh)")
    if isinstance(cost, M.ShardedCost) and cost.mesh is not mesh:
        raise ValueError(
            f"{caller}: a cost from shard_batched_cost runs on the SAME "
            "mesh as the population: pass it as mesh=")
    r_epstol, min_r_ess = _validate_smc_knobs(
        prior, nparticles=nparticles, alpha=alpha, mcmc_retrys=mcmc_retrys,
        mcmc_tol=mcmc_tol, r_epstol=r_epstol, min_r_ess=min_r_ess,
        max_stretch=max_stretch, resample=resample,
        partner_scheme=partner_scheme, quantile_impl=quantile_impl)
    kw = dict(nparticles=nparticles, alpha=alpha,
              mcmc_retrys=mcmc_retrys, mcmc_tol=mcmc_tol, epstol=epstol,
              r_epstol=r_epstol, min_r_ess=min_r_ess,
              max_stretch=max_stretch, max_iters=max_iters,
              resample=resample, verbose=verbose,
              partner_scheme=partner_scheme, quantile_impl=quantile_impl,
              sweep_fused=sweep_fused, cost_vectorized=cost_vectorized)
    if mesh is None:
        return _SMCProgram(prior, cost, device=resolve_device(device), **kw)
    if device is not None and torch.device(device).type != mesh.home.type:
        raise ValueError(f"{caller}: device={device!r} but the mesh's "
                         f"devices are {mesh.home.type}")
    return _ShardedSMCProgram(prior, cost, mesh=mesh, **kw)


def _result(program, state, caller, max_iters) -> SMCResult:
    prior = program.prior
    state = program.checkpoint_view(state)
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
    versions on the CPU. ``parallel`` is accepted for API parity.
    ``mesh``: a ``Mesh`` (``parallel/mesh.py``) with a ``walker`` axis
    shards the population over it (the module docstring); the result is
    the same as without it, but for a kernel cost through
    ``shard_batched_cost`` or a fused sweep built for the mesh (the
    shards' seeds differ); ``nparticles`` must divide the axis. A
    ``sweep_fused`` must be built for the SAME mesh."""
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
    return _result(program, state, "smc", max_iters)


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
    equals an uninterrupted one. ``mesh=`` as in ``smc``: the
    checkpoint holds the joined population, so a run checkpointed on a
    mesh resumes on any mesh or on one device."""
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
        state, _meta = ckpt.load(checkpoint_path,
                                 program.checkpoint_view(state))
        state = program.from_checkpoint(state)
    # on a mesh of several processes, the first writes the checkpoint
    writer = mesh is None or mesh.rank == 0
    while program.cond(state):
        state = program.body(state)
        it = int(state.it)
        if log is not None:
            log.emit(iteration=it, eps=float(state.eps),
                     ess=int(program.alive_count(state.alive)),
                     accepted=int(state.acc))
        if checkpoint_path and it % checkpoint_every == 0:
            view = program.checkpoint_view(state)
            if writer:
                ckpt.save(checkpoint_path, view, {"iteration": it})
    return _result(program, state, "smc_stepped", max_iters)
