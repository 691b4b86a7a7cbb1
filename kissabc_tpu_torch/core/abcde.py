"""ABC Differential Evolution — the PyTorch counterpart of
``kissabc_tpu/core/abcde.py`` (the reference's ``ABCDE``,
``src/smc.jl:347-430``, after Turner & Sederberg).

A generational double-buffered population: each generation, particle i
picks a base s (itself, or, when above its annealed threshold, a random
not-worse particle, smc.jl:389-391), takes the DE step ``theta_s +
gamma * (theta_a - theta_b)`` with ``gamma = pw * 2.38 / sqrt(2d)``
(smc.jl:368,400), passes a cheap prior-MH gate before the simulator
(smc.jl:401-403), and commits when ``cost <= max(eps_i, Delta_i)``
(smc.jl:406).

The "random not-worse particle" is drawn with the JAX package's rank
trick (``rank_count``: a stable sort, the ends of runs of ties, a
reversed cummin and one scatter; no ``searchsorted``), and the base and
both DE partners come from one draw of ``(3, n)`` uint32 words by modulo
arithmetic (``bases_from_words``), in int64 because torch has no full
uint32 arithmetic. ``sweep_fused`` replaces the per-walker downstream of
a generation (proposal, prior gate, simulator, commit) with
``make_fused_abcde_generation``'s kernel; the population-global draws
and the one gather of the three parents stay here.

The JAX ``lax.while_loop`` is a Python loop. Host reads per generation:
the ``earlystop`` test (the loop condition), and the progress line when
``verbose`` (the reference's default) prints.

``mesh=`` shards the population over a walker mesh with the rule of
``parallel/layout.py``: the thresholds' extremes are reduced over the
mesh, ``rank_count`` and ``bases_from_words`` run on the joined costs
with the whole population's words, the three parents are gathered from
the joined population and cut into shards, and the rest of the
generation runs shard by shard (a cost written in PyTorch on the joined
proposals; a fused generation once per shard, statistical parity): with
a PyTorch cost the run equals the unsharded one bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.tree import tgather, tree_map, tselect
from ..parallel import layout as L
from ..particles import Particles, particles_from_tree
from ..utils.hostfetch import fetch, fetch_tree
from ..utils.rng import as_generator, log_uniform, uint32_words
from .pfilter import (_INIT_FAILED, _batched_cost, _check_cost_on,
                      _init_with_retry, _logpdf)

_f32 = torch.float32


class ABCDEResult(NamedTuple):
    P: object
    C: Particles
    reached_eps: bool
    nsim: int
    iterations: int


def rank_count(ds):
    """``(order, count)``: the stable ascending order of ``ds`` and, for
    every particle i, ``count[i] = #{j : ds[j] <= ds[i]}``, ties
    included. In sorted space the count at position k is the last index
    of k's run of ties plus one: mark the run ends, take the suffix
    minimum of their positions (one reversed cummin) and scatter back
    through ``order``."""
    n = ds.shape[0]
    order = torch.argsort(ds, stable=True)
    ds_sorted = ds[order]
    k = torch.arange(n, device=ds.device)
    run_end = torch.cat([ds_sorted[1:] != ds_sorted[:-1],
                         torch.ones(1, dtype=torch.bool, device=ds.device)])
    cand = torch.where(run_end, k, n - 1)
    last = torch.flip(torch.cummin(torch.flip(cand, (0,)), 0).values, (0,))
    count = torch.empty_like(k).scatter_(0, order, last + 1)
    return order, count


def bases_from_words(v, ds, eps_i, order, count):
    """The base ``s`` and the DE partners ``a != s`` and ``b != a, s`` of
    every particle from ``(3, n)`` uint32 words (int64 tensors), with the
    JAX package's modulo rule: a particle above its threshold takes a
    uniform one of its ``count`` not-worse particles as its base, else
    itself (smc.jl:389-399)."""
    n = ds.shape[0]
    idx = torch.arange(n, device=ds.device)
    u = v[0] % torch.clamp(count, min=1)
    s = torch.where(ds > eps_i, order[u], idx)
    aa = v[1] % (n - 1)
    aa = aa + (aa >= s).to(aa.dtype)
    bb = v[2] % (n - 2)
    lo, hi = torch.minimum(aa, s), torch.maximum(aa, s)
    bb = bb + (bb >= lo).to(bb.dtype)
    bb = bb + (bb >= hi).to(bb.dtype)
    return s, aa, bb


def ABCDE(prior, cost, eps_target: float, *, nparticles: int = 50,
          generations: int = 20, alpha: float = 0.0, earlystop: bool = False,
          verbose: bool = True, proposal_width: float = 1.0,
          parallel: bool = True, cost_vectorized: bool = False, mesh=None,
          cost_on: str = "raw", sweep_fused=None, key=0,
          device=None) -> ABCDEResult:
    """Signature and defaults mirror the JAX package and the reference
    (smc.jl:347). ``cost(theta[, gen])`` is per walker, or batched with
    ``cost_vectorized=True``. ``cost_on``: ``'raw'`` (the reference)
    evaluates the cost on the raw float particle, ``'pushed'`` snaps
    discrete marginals first. ``sweep_fused``: a fused generation from
    ``make_fused_abcde_generation(prior, draw, reduce_cost, gamma=...)``
    whose ``gamma`` must equal ``proposal_width * 2.38 / sqrt(2d)``; the
    init still evaluates ``cost``. ``verbose`` prints each generation (a
    host read). ``key``: an int seed or a ``torch.Generator``;
    ``device``: ``None`` runs on CUDA (and raises without a card),
    ``"cpu"`` the plain versions. ``parallel`` is accepted for API
    parity. ``mesh``: a walker mesh shards the population (the module
    docstring); ``nparticles`` must divide its walker axis, a batched
    kernel cost comes through ``shard_batched_cost``, and a
    ``sweep_fused`` must be built for the SAME mesh."""
    if not 0 <= alpha < 1:
        raise ValueError("alpha must be in 0 <= alpha < 1.")
    push_cost = _check_cost_on(cost_on)
    if sweep_fused is not None and mesh is not None \
            and getattr(sweep_fused, "mesh", None) is not mesh:
        raise ValueError(
            "ABCDE(mesh=...) with sweep_fused needs the generation "
            "built for the SAME mesh: make_fused_abcde_generation(..., "
            "mesh=mesh) — a single-chip fused generation cannot run on "
            "sharded populations")
    del parallel
    n = nparticles
    d = prior.nparams
    if n < 3:
        raise ValueError(
            f"ABCDE needs >= 3 particles (a DE step draws two partners "
            f"distinct from the base), got {n}")
    gamma = proposal_width * 2.38 / math.sqrt(2 * d)
    if sweep_fused is not None:
        fg = getattr(sweep_fused, "gamma", None)
        if fg is not None and abs(fg - gamma) > 1e-6 * abs(gamma):
            raise ValueError(
                f"sweep_fused was built with gamma={fg:.6g} but this "
                f"call needs proposal_width*2.38/sqrt(2d) = {gamma:.6g}"
                " — pass the same gamma to make_fused_abcde_generation")
    lay = L.layout(mesh, device, "ABCDE", cost, (n,))
    dev = lay.device
    gen = as_generator(key, dev)
    vlog = _logpdf(prior, lay)
    vcost = _batched_cost(prior, cost, cost_vectorized, push_cost, "ABCDE",
                          lay)

    def generation(thetas, lps, ds, nsims):
        eps_l, eps_h = lay.min(ds), lay.max(ds)
        eps_pop = torch.clamp(eps_l + alpha * (eps_h - eps_l),
                              min=eps_target)

        def thresholds(d):
            active = (d > eps_target if earlystop   # smc.jl:382-384
                      else torch.ones_like(d, dtype=torch.bool))
            # the per-particle threshold (smc.jl:388)
            return active, torch.where(d <= eps_target, eps_target,
                                       eps_pop.to(d.device))

        active, eps_i = lay.unzip(lay.map(thresholds, ds), 2)
        ds_all = lay.join(ds)
        order, count = rank_count(ds_all)
        v = uint32_words(gen, 3 * n).reshape(3, n)
        s, aa, bb = bases_from_words(v, ds_all, lay.join(eps_i), order,
                                     count)
        # one gather for the three parents (ops/tree.py), of the joined
        # population on a mesh, then cut into shards
        g3 = tgather(lay.join(thetas), torch.cat([s, aa, bb]))
        ts, ta, tb = (lay.place(tree_map(lambda x, j=j: x[j * n:(j + 1) * n],
                                         g3))
                      for j in range(3))
        if sweep_fused is not None:
            thetas, lps, ds, gate = sweep_fused(
                gen, thetas, (ts, ta, tb), lps, ds, active, eps_i)
            return thetas, lps, ds, lay.map(
                lambda c, g: c + g.to(c.dtype), nsims, gate)
        props = lay.map(lambda a, b, c: tree_map(
            lambda xs, xa, xb: xs + gamma * (xa - xb), a, b, c), ts, ta, tb)
        lpp = vlog(props)
        lu = lay.place(log_uniform(gen, (n,)))
        gate = lay.map(lambda act, l, lp, lpp_: act & (
            l <= torch.clamp(lpp_ - lp, max=0.0)), active, lu, lps, lpp)
        nsims = lay.map(lambda c, g: c + g.to(c.dtype), nsims,
                        gate)   # smc.jl:404
        dp = vcost(props, gen)

        def commit(th, lp, d, g, e, pr, lpp_, dp_):
            c = g & (dp_ <= torch.maximum(e, d))
            return (tselect(c, pr, th), torch.where(c, lpp_, lp),
                    torch.where(c, dp_, d))

        # double buffer: every read above saw the old population
        out = lay.map(commit, thetas, lps, ds, gate, eps_i, props, lpp, dp)
        return lay.unzip(out, 3) + (nsims,)

    thetas, lps, ds, ok = _init_with_retry(prior, vcost, n, gen, lay=lay)
    if int(lay.count(ok)) < n:
        raise RuntimeError(_INIT_FAILED)
    nsims = lay.place(torch.zeros(n, dtype=torch.int64, device=dev))
    it = 0
    while it < generations and (not earlystop
                                or bool(lay.max(ds) > eps_target)):
        thetas, lps, ds, nsims = generation(thetas, lps, ds, nsims)
        it += 1
        if verbose:
            done = lay.count(lay.map(lambda d: d <= eps_target, ds))
            print(f"ABCDE gen={it} completion="
                  f"{float(done.to(_f32) / n)} "
                  f"eps_range=({float(lay.min(ds))},{float(lay.max(ds))})")
    ds_np = fetch(lay.join(ds))
    return ABCDEResult(
        P=particles_from_tree(fetch_tree(prior.push_tree(
            lay.join(thetas)))),
        C=Particles(ds_np),
        reached_eps=bool(ds_np.max() <= eps_target),
        nsim=int(lay.count(nsims)),
        iterations=it,
    )
