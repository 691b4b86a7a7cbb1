"""Quantile particle filter — the PyTorch counterpart of
``kissabc_tpu/core/pfilter.py`` (the reference's ``pfilter``,
``src/smc.jl:275-340``).

Repeatedly set eps to the q-quantile of the costs and regenerate every
particle with cost > eps by differential-evolution proposals from the
good set, until the move efficiency ``nbad / nreps`` drops below
``eff_tol``. The reference's unbounded per-particle rejection loop
becomes bounded masked rounds: each round, all still-unfixed bad
particles propose at once; every attempt counts in the efficiency
tally, prior-gate failures too (smc.jl:313-318). The good set is the
snapshot taken before the sweep, as the reference's fixed ``idxok``.

The JAX ``lax.while_loop``s are Python loops whose only host reads are
their conditions: one ``any(active)`` per inner round, one stop flag per
outer iteration, one ``all(ok)`` per init retry round.
``_init_with_retry`` is shared with ``ABCDE``.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import torch

from ..ops.moves import masked_distinct, masked_order
from ..ops.quantile import (masked_quantile_bisect, quantile,
                            resolve_quantile_impl)
from ..ops.tree import tfloat, tgather, tree_map, tselect
from ..particles import Particles, particles_from_tree
from ..utils.device import resolve_device
from ..utils.hostfetch import fetch
from ..utils.rng import as_generator, log_uniform
from .density import per_walker_cost

_f32 = torch.float32


class PFilterResult(NamedTuple):
    P: object
    C: Particles
    eps: float
    iterations: int
    unfixed: int = 0


_INIT_FAILED = ("Prior leads to infinite costs too often; could not "
                "initialize a finite population.")


def _check_cost_on(cost_on):
    if cost_on not in ("raw", "pushed"):
        raise ValueError(
            f"cost_on must be 'raw' or 'pushed', got {cost_on!r}")
    return cost_on == "pushed"


def _logpdf(prior):
    """The batched prior logpdf of raw (float) particles."""
    return lambda ths: prior.logpdf_tree(prior.push_tree(ths)).to(_f32)


def _batched_cost(prior, cost, cost_vectorized, push_cost, caller):
    """``vcost(raw_thetas, gen) -> [n]``: the cost of the raw float
    particles (the reference's ``cost(p.x)``), or of the pushed ones with
    ``push_cost``; a per-walker cost is mapped with ``torch.func.vmap``,
    a batched one (``cost_vectorized``) takes the whole population."""
    mapped = cost if cost_vectorized else per_walker_cost(cost, caller)
    ctree = prior.push_tree if push_cost else (lambda th: th)
    return lambda ths, gen: torch.as_tensor(mapped(ctree(ths), gen)).to(_f32)


def _init_with_retry(prior, vcost, n, gen, max_rounds=1000):
    """The init with a per-particle redraw until (logpdf, cost) are
    finite: the reference's unbounded while (smc.jl:283-294), bounded to
    ``max_rounds`` rounds. ``vcost`` is a batched cost of raw particles
    (``_batched_cost``). Returns (thetas, logpdfs, costs, ok mask)."""
    vlog = _logpdf(prior)

    def draw_all():
        ths = tfloat(prior.sample_tree(gen, n))
        return ths, vlog(ths), vcost(ths, gen)

    thetas, lps, cs = draw_all()
    ok = torch.isfinite(lps) & torch.isfinite(cs)
    t = 0
    while t < max_rounds and not bool(ok.all()):
        nth, nlp, ncx = draw_all()
        thetas = tselect(ok, thetas, nth)
        lps = torch.where(ok, lps, nlp)
        cs = torch.where(ok, cs, ncx)
        ok = torch.isfinite(lps) & torch.isfinite(cs)
        t += 1
    return thetas, lps, cs, ok


def _bshape(w, x):
    return w.reshape(w.shape + (1,) * (x.dim() - 1))


def pfilter(prior, cost, N: int, *, q: float = 0.7, eff_tol: float = 0.1,
            epstol: float = -math.inf, max_iters: float = math.inf,
            proposal_width: float = 0.75, inner_retry: int = 200,
            verbose: bool = False, parallel: bool = True,
            cost_vectorized: bool = False, mesh=None, cost_on: str = "raw",
            quantile_impl: str = "auto", key=0,
            device=None) -> PFilterResult:
    """Signature and defaults mirror the JAX package and the reference
    (smc.jl:275). ``inner_retry`` bounds the rejection rounds of a sweep
    (the reference's loop is unbounded); a particle still above eps after
    them is counted in ``unfixed`` with a ``RuntimeWarning``.
    ``cost(theta[, gen])`` is per walker, or batched with
    ``cost_vectorized=True`` (``make_streaming_moment_cost``,
    ``make_flagship_cost_batched``). ``cost_on``: ``'raw'`` (the
    reference) evaluates the cost on the raw float particle, ``'pushed'``
    snaps discrete marginals first. ``quantile_impl``: ``'sort'``,
    ``'bisect'`` or ``'auto'``, bit-identical. ``key``: an int seed or a
    ``torch.Generator``; ``device``: ``None`` runs on CUDA (and raises
    without a card), ``"cpu"`` the plain versions. ``parallel`` is
    accepted for API parity; ``mesh=`` raises ``NotImplementedError``."""
    del parallel
    push_cost = _check_cost_on(cost_on)
    if mesh is not None:
        raise NotImplementedError(
            "pfilter(mesh=...): walker sharding of pfilter comes in a later "
            "slice")
    d = prior.nparams
    low_n = 4 * d
    if N * q <= low_n:
        N = math.ceil((low_n + 1) / q)
    n = N
    if resolve_quantile_impl(quantile_impl, None, n) == "sort":
        qfn = quantile
    else:
        def qfn(x, qq):
            return masked_quantile_bisect(x, torch.ones_like(x, dtype=bool),
                                          qq)
    max_outer = 100_000 if math.isinf(max_iters) else int(max_iters) + 1
    dev = resolve_device(device)
    gen = as_generator(key, dev)
    vlog = _logpdf(prior)
    vcost = _batched_cost(prior, cost, cost_vectorized, push_cost,
                          "pfilter")

    def regen_round(thetas, lps, cs, good, order, active, eps):
        """One masked rejection round for every still-active bad
        particle (the body of the reference's @goto loop,
        smc.jl:308-326): three distinct good-set partners each, one
        gather of the three, the DE proposal, the prior gate, the cost
        gate."""
        bs, css, dss = masked_distinct(gen, good, 3, order=order,
                                       shape=(n,))
        w = torch.randn(n, generator=gen, device=dev) * proposal_width
        g3 = tgather(thetas, torch.cat([bs, css, dss]))
        props = tree_map(
            lambda x: x[:n] + (x[2 * n:] - x[n:2 * n]) * _bshape(w, x), g3)
        lpp = vlog(props)
        lu = log_uniform(gen, (n,))
        gate_prior = lu <= torch.clamp(lpp - lps, max=0.0)
        xp = vcost(props, gen)
        accept = active & gate_prior & (xp <= eps)
        thetas = tselect(accept, props, thetas)
        lps = torch.where(accept, lpp, lps)
        cs = torch.where(accept, xp, cs)
        return thetas, lps, cs, accept, active.sum()  # every attempt

    thetas, lps, cs, ok = _init_with_retry(prior, vcost, n, gen)
    if not bool(ok.all()):
        raise RuntimeError(_INIT_FAILED)
    eps = torch.tensor(float("inf"), dtype=_f32, device=dev)
    active = torch.zeros(n, dtype=torch.bool, device=dev)
    it, done = 0, False
    while not done and it < max_outer:
        it += 1
        eps = qfn(cs, q)
        bad = cs > eps
        good = ~bad
        order = masked_order(good)   # good-first positions
        nbad = bad.sum()
        active, reps, t = bad, torch.zeros((), dtype=torch.int64,
                                           device=dev), 0
        while t < inner_retry and bool(active.any()):
            thetas, lps, cs, fixed, nreps = regen_round(
                thetas, lps, cs, good, order, active, eps)
            active = active & ~fixed
            reps = reps + nreps
            t += 1
        eff = nbad.to(_f32) / torch.clamp(reps, min=1).to(_f32)
        if verbose:
            print(f"pfilter it={it} eps={float(eps)} eff={float(eff)}")
        done = bool((eff < eff_tol) | (eps < epstol)) or it > max_iters
    unfixed = int(active.sum())
    if unfixed:
        warnings.warn(
            f"pfilter: {unfixed} particle(s) still above eps after "
            f"inner_retry={inner_retry} rejection rounds in the final "
            "sweep; raise inner_retry or loosen the threshold.",
            RuntimeWarning, stacklevel=2)
    return PFilterResult(
        P=particles_from_tree(tree_map(fetch, prior.push_tree(thetas))),
        C=Particles(fetch(cs)),
        eps=float(eps),
        iterations=it,
        unfixed=unfixed,
    )
