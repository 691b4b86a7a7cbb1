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

``mesh=`` shards the population over a walker mesh with the rule of
``parallel/layout.py``: the threshold is the bisect quantile over the
shards (``resolve_quantile_impl(quantile_impl, mesh, n)``), the
good-first order and the partner draws are made on the joined good mask
and the whole population, the three partners gathered from the joined
population, a cost written in PyTorch runs on the joined proposals, and
every count, ``any(active)`` and stop test is reduced over the mesh: the
run equals the unsharded one bit for bit.
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
from ..parallel import layout as L
from ..particles import Particles, particles_from_tree
from ..utils.hostfetch import fetch, fetch_tree
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


def _logpdf(prior, lay=None):
    """The batched prior logpdf of raw (float) particles (shard by shard
    on a mesh layout)."""
    def one(ths):
        return prior.logpdf_tree(prior.push_tree(ths)).to(_f32)

    return one if lay is None else (lambda ths: lay.map(one, ths))


def _batched_cost(prior, cost, cost_vectorized, push_cost, caller,
                  lay=None):
    """``vcost(raw_thetas, gen) -> [n]``: the cost of the raw float
    particles (the reference's ``cost(p.x)``), or of the pushed ones with
    ``push_cost``; a per-walker cost is mapped with ``torch.func.vmap``,
    a batched one (``cost_vectorized``) takes the whole population. On a
    mesh layout the cost runs as ``lay.cost`` runs it (the joined
    population, or once per shard from ``shard_batched_cost``)."""
    mapped = cost if cost_vectorized else per_walker_cost(cost, caller)
    ctree = prior.push_tree if push_cost else (lambda th: th)
    if lay is None or not lay.sharded:
        return lambda ths, gen: torch.as_tensor(
            mapped(ctree(ths), gen)).to(_f32)
    return lambda ths, gen: lay.map(
        lambda c: torch.as_tensor(c).to(_f32),
        lay.cost(mapped, ths, gen, push=ctree))


def _init_with_retry(prior, vcost, n, gen, max_rounds=1000, lay=None):
    """The init with a per-particle redraw until (logpdf, cost) are
    finite: the reference's unbounded while (smc.jl:283-294), bounded to
    ``max_rounds`` rounds. ``vcost`` is a batched cost of raw particles
    (``_batched_cost``). Returns (thetas, logpdfs, costs, ok mask), each
    ``Sharded`` on a mesh layout (the draws made whole and cut)."""
    lay = lay or L.OneDevice(gen.device)
    vlog = _logpdf(prior, lay)

    def draw_all():
        ths = lay.place(tfloat(prior.sample_tree(gen, n)))
        return ths, vlog(ths), vcost(ths, gen)

    def finite(lp, c):
        return torch.isfinite(lp) & torch.isfinite(c)

    thetas, lps, cs = draw_all()
    ok = lay.map(finite, lps, cs)
    t = 0
    while t < max_rounds and int(lay.count(ok)) < n:
        nth, nlp, ncx = draw_all()
        thetas = lay.map(tselect, ok, thetas, nth)
        lps = lay.map(torch.where, ok, lps, nlp)
        cs = lay.map(torch.where, ok, cs, ncx)
        ok = lay.map(finite, lps, cs)
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
    accepted for API parity. ``mesh``: a walker mesh shards the
    population (the module docstring); the population, ``N`` raised to
    the reference's minimum, must divide its walker axis, and a batched
    kernel cost comes through ``shard_batched_cost``."""
    del parallel
    push_cost = _check_cost_on(cost_on)
    d = prior.nparams
    low_n = 4 * d
    if N * q <= low_n:
        N = math.ceil((low_n + 1) / q)
    n = N
    lay = L.layout(mesh, device, "pfilter", cost, (n,))
    if resolve_quantile_impl(quantile_impl, mesh, n) == "sort":
        def qfn(x, qq):
            return quantile(lay.join(x), qq)
    else:
        def qfn(x, qq):
            return masked_quantile_bisect(
                x, lay.map(lambda v: torch.ones_like(v, dtype=bool), x), qq)
    max_outer = 100_000 if math.isinf(max_iters) else int(max_iters) + 1
    dev = lay.device
    gen = as_generator(key, dev)
    vlog = _logpdf(prior, lay)
    vcost = _batched_cost(prior, cost, cost_vectorized, push_cost,
                          "pfilter", lay)

    def regen_round(thetas, lps, cs, good, order, active, eps):
        """One masked rejection round for every still-active bad
        particle (the body of the reference's @goto loop,
        smc.jl:308-326): three distinct good-set partners each, one
        gather of the three, the DE proposal, the prior gate, the cost
        gate."""
        bs, css, dss = masked_distinct(gen, good, 3, order=order,
                                       shape=(n,))
        w = torch.randn(n, generator=gen, device=dev) * proposal_width
        # one gather of the three partners (of the joined population on a
        # mesh), each shard's proposals from its block of the indices
        idx = lay.place(torch.stack([bs, css, dss], 1))
        full = lay.join(thetas)

        def propose(i, wi):
            g3 = tgather(tree_map(lambda x: x.to(i.device), full),
                         i.T.reshape(-1))
            s = i.shape[0]
            return tree_map(lambda x: x[:s] + (x[2 * s:] - x[s:2 * s])
                            * _bshape(wi, x), g3)

        props = lay.map(propose, idx, lay.place(w))
        lpp = vlog(props)
        lu = lay.place(log_uniform(gen, (n,)))
        xp = vcost(props, gen)

        def gate(th, lp, c, act, pr, lpp_, lu_, xp_):
            gate_prior = lu_ <= torch.clamp(lpp_ - lp, max=0.0)
            accept = act & gate_prior & (xp_ <= eps.to(xp_.device))
            return (tselect(accept, pr, th), torch.where(accept, lpp_, lp),
                    torch.where(accept, xp_, c), accept)

        thetas, lps, cs, accept = lay.unzip(lay.map(
            gate, thetas, lps, cs, active, props, lpp, lu, xp), 4)
        return thetas, lps, cs, accept, lay.count(active)  # every attempt

    thetas, lps, cs, ok = _init_with_retry(prior, vcost, n, gen, lay=lay)
    if int(lay.count(ok)) < n:
        raise RuntimeError(_INIT_FAILED)
    eps = torch.tensor(float("inf"), dtype=_f32, device=dev)
    active = lay.place(torch.zeros(n, dtype=torch.bool, device=dev))
    it, done = 0, False
    while not done and it < max_outer:
        it += 1
        eps = qfn(cs, q)
        bad = lay.map(lambda c: c > eps.to(c.device), cs)
        good = lay.join(lay.map(torch.logical_not, bad))
        order = masked_order(good)   # good-first positions
        nbad = lay.count(bad)
        active, reps, t = bad, torch.zeros((), dtype=torch.int64,
                                           device=dev), 0
        while t < inner_retry and bool(lay.count(active) > 0):
            thetas, lps, cs, fixed, nreps = regen_round(
                thetas, lps, cs, good, order, active, eps)
            active = lay.map(lambda a, f: a & ~f, active, fixed)
            reps = reps + nreps
            t += 1
        eff = nbad.to(_f32) / torch.clamp(reps, min=1).to(_f32)
        if verbose:
            print(f"pfilter it={it} eps={float(eps)} eff={float(eff)}")
        done = bool((eff < eff_tol) | (eps < epstol)) or it > max_iters
    unfixed = int(lay.count(active))
    if unfixed:
        warnings.warn(
            f"pfilter: {unfixed} particle(s) still above eps after "
            f"inner_retry={inner_retry} rejection rounds in the final "
            "sweep; raise inner_retry or loosen the threshold.",
            RuntimeWarning, stacklevel=2)
    thetas, cs = lay.join(thetas), lay.join(cs)
    return PFilterResult(
        P=particles_from_tree(fetch_tree(prior.push_tree(thetas))),
        C=Particles(fetch(cs)),
        eps=float(eps),
        iterations=it,
        unfixed=unfixed,
    )
