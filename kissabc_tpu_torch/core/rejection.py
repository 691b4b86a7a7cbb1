"""Plain rejection-ABC — the PyTorch counterpart of
``kissabc_tpu/core/rejection.py`` (Pritchard et al. 1999; Beaumont 2002
top-quantile variant): the textbook baseline sampler, the sanity oracle
for ``smc``/``AIS`` posteriors, and a direct Monte-Carlo estimate of
the ABC acceptance mass ``P(cost <= eps | prior)``.

Two modes:

- **budget mode** (``nsims=``): draw a fixed simulation budget in chunks
  and keep the best ``nparticles`` — a streaming top-n carrying an
  ``n``-wide best-so-far buffer, merged with each chunk by one stable
  sort of the concatenated costs. The JAX program is one ``lax.scan``;
  here a Python loop queues every chunk on the device and the host reads
  the result once, at the end.
- **threshold mode** (``eps=``): accept draws with ``cost <= eps`` into a
  fixed buffer by a cumsum-indexed masked scatter (a position ``>= n``
  is dropped, as JAX's ``mode="drop"`` drops it) inside a loop bounded
  by ``max_sims``; the loop reads the fill count once a batch, as
  ``smc`` reads its stop flag, so it stops after the batch JAX's
  ``while_loop`` stops after.

Ties decide which draws fill the buffer (every unfilled slot and every
non-finite cost is ``+inf``), so both merges keep JAX's order: equal
costs lower index first (``lax.top_k``), and the final sort of threshold
mode is stable (``jnp.argsort``). ``torch.topk`` does not keep that
order and is not used.

Each chunk draws its prior sample and then its cost's randomness from
the one run generator, in that order. The cost sees the float particle;
the returned population is pushed onto the prior's support.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..ops.tree import tfloat, tgather, tree_leaves, tree_map
from ..particles import Particles, particles_from_tree
from ..utils.device import resolve_device
from ..utils.hostfetch import fetch
from ..utils.rng import as_generator
from .density import per_walker_cost

_f32 = torch.float32


class RejectionResult(NamedTuple):
    P: object            # posterior Particles (pushed, sorted best-first)
    C: Particles         # kept costs, ascending (+inf = unfilled slots)
    eps: float           # budget mode: worst finite kept cost;
    #                      threshold mode: the eps the caller passed
    nsims: int           # total simulator calls
    naccept: int         # finite-cost kept draws (budget) / accepted (eps)
    log_evidence: float  # log P(cost <= eps | prior) = log(naccept/nsims)


def _make_draw_chunk(prior, cost, b, cost_vectorized):
    """One chunk of ``b`` prior draws and their costs (non-finite costs
    become ``+inf``): ``draw_chunk(gen) -> (float thetas, costs[b])``."""
    cost2 = cost if cost_vectorized else per_walker_cost(cost,
                                                         "abc_rejection")

    def draw_chunk(gen):
        ths = tfloat(prior.sample_tree(gen, b))
        cs = torch.as_tensor(cost2(ths, gen)).to(_f32)
        return ths, torch.nan_to_num(cs, nan=math.inf, posinf=math.inf,
                                     neginf=math.inf)

    return draw_chunk


def _empty_buffer(ths, n):
    """The ``n``-slot buffer before the first chunk: a zeroed population
    with the structure, trailing shapes and dtypes of the chunk ``ths``,
    and ``+inf`` costs."""
    zeros = tree_map(lambda x: torch.zeros((n,) + tuple(x.shape[1:]),
                                           dtype=x.dtype, device=x.device),
                     ths)
    dev = tree_leaves(ths)[0].device
    return zeros, torch.full((n,), math.inf, dtype=_f32, device=dev)


def merge_best(buf_th, buf_cs, ths, cs, n):
    """Keep the best ``n`` of the buffer and the chunk: ``lax.top_k`` of
    the negated concatenated costs, equal costs lower index first (the
    buffer before the chunk). Returns ``(thetas, costs)``, ascending."""
    merged = torch.cat([buf_cs, cs])
    costs, idx = torch.sort(merged, stable=True)
    idx = idx[:n]
    cat = tree_map(lambda a, c: torch.cat([a, c]), buf_th, ths)
    return tgather(cat, idx), costs[:n]


def scatter_accepted(buf_th, buf_cs, ths, cs, fill, eps, n):
    """Write the chunk's draws with ``cost <= eps`` into the buffer at
    ``fill, fill+1, ...`` in chunk order; positions ``>= n`` are dropped
    (JAX's ``.at[pos].set(..., mode="drop")``). ``fill`` is a 0-d int64
    tensor. Returns ``(thetas, costs, fill, kept)``, ``kept`` the chunk's
    accepted count."""
    m = cs <= eps
    pos = fill + torch.cumsum(m.to(torch.int64), 0) - 1
    pos = torch.where(m & (pos < n), pos, torch.full_like(pos, n))

    def put(buf, vals):
        # one sink row past the end takes every dropped draw
        out = torch.cat([buf, buf[:1]])
        out[pos] = vals.to(buf.dtype)
        return out[:n]

    kept = m.sum()
    return (tree_map(put, buf_th, ths), put(buf_cs, cs),
            torch.clamp(fill + kept, max=n), kept)


def sort_best_first(buf_th, buf_cs):
    """The population and costs in ``jnp.argsort`` order of the costs
    (stable: equal costs keep their slot order)."""
    order = torch.sort(buf_cs, stable=True).indices
    return tgather((buf_th, buf_cs), order)


def _budget(draw_chunk, gen, n, nchunks, verbose):
    buf_th = buf_cs = None
    for _ in range(nchunks):
        ths, cs = draw_chunk(gen)
        if buf_th is None:
            buf_th, buf_cs = _empty_buffer(ths, n)
        buf_th, buf_cs = merge_best(buf_th, buf_cs, ths, cs, n)
        if verbose:
            print(f"abc_rejection chunk: running eps={float(buf_cs[n - 1])}")
    # the merge keeps the buffer ascending, so no final sort is needed
    return buf_th, buf_cs


def _threshold(draw_chunk, gen, n, epsv, max_batches, verbose):
    buf_th = buf_cs = None
    t, fill, nacc = 0, None, None
    # the JAX while_loop's condition, one host read of fill a batch
    while t < max_batches and (fill is None or int(fill) < n):
        ths, cs = draw_chunk(gen)
        if buf_th is None:
            buf_th, buf_cs = _empty_buffer(ths, n)
            fill = torch.zeros((), dtype=torch.int64, device=cs.device)
            nacc = torch.zeros_like(fill)
        buf_th, buf_cs, fill, kept = scatter_accepted(
            buf_th, buf_cs, ths, cs, fill, epsv, n)
        nacc = nacc + kept
        if verbose:
            print(f"abc_rejection batch {t}: +{int(kept)} accepted")
        t += 1
    buf_th, buf_cs = sort_best_first(buf_th, buf_cs)
    return buf_th, buf_cs, int(fill), int(nacc), t


def abc_rejection(prior, cost, nparticles: int, *, eps: float | None = None,
                  nsims: int | None = None, batch: int | None = None,
                  max_sims: int = 10_000_000, cost_vectorized: bool = False,
                  mesh=None, verbose: bool = False, key=0,
                  device=None) -> RejectionResult:
    """Rejection ABC. Exactly one of ``eps`` / ``nsims`` selects the mode
    (default: budget mode with ``nsims = 100 * nparticles``).

    ``cost``: per walker, ``cost(theta, gen)`` or ``cost(theta)`` (mapped
    with ``torch.func.vmap``, as in ``smc``), or with
    ``cost_vectorized=True`` a batched ``cost(thetas, gen) -> costs[b]``
    (``make_flagship_cost_batched()``, ``make_streaming_moment_cost``,
    ``host_cost``). ``batch`` is the per-chunk simulation width (default
    ``max(nparticles, 4096)`` capped at the budget); the carry buffer
    stays ``nparticles`` wide. ``max_sims`` bounds threshold mode, spent
    in whole batches (the realized budget is ``floor(max_sims/batch) *
    batch``); if the buffer is still unfilled at the budget a
    ``RuntimeWarning`` reports the shortfall (unfilled slots carry cost
    ``+inf``). Budget mode rounds ``nsims`` up to whole chunks (realized
    budget ``ceil(nsims/batch) * batch``). ``key``: an int seed or a
    ``torch.Generator`` on the run's device. ``device``: ``None`` runs on
    CUDA (and raises without a card); ``"cpu"`` runs the plain versions.
    ``mesh=`` raises ``NotImplementedError``: walker sharding is not
    ported yet.
    """
    if mesh is not None:
        raise NotImplementedError(
            "abc_rejection(mesh=...): walker sharding is not ported yet")
    if eps is not None and nsims is not None:
        raise ValueError("pass either eps= (threshold mode) or nsims= "
                         "(budget mode), not both")
    n = int(nparticles)
    if n < 1:
        raise ValueError("nparticles must be >= 1")

    if batch is None:
        batch = max(n, 4096)
        if eps is None:
            batch = min(batch, nsims if nsims is not None else 100 * n)
    b = max(int(batch), 1)

    if eps is None:
        # ---- budget mode: streaming top-n over ceil(nsims/b) chunks ----
        total = 100 * n if nsims is None else int(nsims)
        if total < n:
            raise ValueError(f"nsims={total} < nparticles={n}")
    else:
        if int(max_sims) < 1:
            raise ValueError(f"max_sims must be >= 1, got {max_sims}")
    dev = resolve_device(device)
    gen = as_generator(key, dev)

    if eps is None:
        nchunks = math.ceil(total / b)
        total = nchunks * b  # realized budget (rounded up to whole chunks)
        draw_chunk = _make_draw_chunk(prior, cost, b, cost_vectorized)
        thetas, cs = _budget(draw_chunk, gen, n, nchunks, verbose)
        cs = fetch(cs)
        # kept slots with +inf cost are either never-overwritten
        # placeholders or infinite-cost draws — neither is a posterior
        # sample; cs is ascending, so the finite ones lead
        naccept = int(np.sum(np.isfinite(cs)))
        epsv = float(cs[naccept - 1]) if naccept else float("inf")
        if naccept < n:
            warnings.warn(
                f"abc_rejection: only {naccept}/{n} draws had finite cost "
                f"within nsims={total}; trailing slots are unfilled "
                "placeholders (cost +inf) — raise nsims or check the "
                "simulator.", RuntimeWarning, stacklevel=2)
    else:
        # ---- threshold mode: bounded masked accumulate ----
        epsv = float(eps)
        b = min(b, int(max_sims))  # never exceed the simulation budget
        max_batches = max(1, int(max_sims) // b)
        draw_chunk = _make_draw_chunk(prior, cost, b, cost_vectorized)
        thetas, cs, fill, naccept, t = _threshold(
            draw_chunk, gen, n, epsv, max_batches, verbose)
        cs = fetch(cs)
        total = t * b
        if fill < n:
            warnings.warn(
                f"abc_rejection: only {fill}/{n} particles accepted after "
                f"{total} simulations (budget max_sims={int(max_sims)}, "
                f"spent in whole batches of {b}) at eps={epsv}; unfilled "
                "slots have cost +inf — raise max_sims or loosen eps.",
                RuntimeWarning, stacklevel=2)

    logz = (math.log(naccept) - math.log(total)) if naccept else -math.inf
    pushed = tree_map(fetch, prior.push_tree(thetas))
    return RejectionResult(
        P=particles_from_tree(pushed),
        C=Particles(cs),
        eps=epsv,
        nsims=total,
        naccept=int(naccept),
        log_evidence=logz,
    )
