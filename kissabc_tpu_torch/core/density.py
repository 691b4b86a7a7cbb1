"""Density models — the PyTorch counterpart of
``kissabc_tpu/core/density.py`` (the reference's ``src/types.jl``).

Three targets, each with the protocol the AIS sampler drives
(types.jl:3-8): ``init_batch`` (``init_sample`` for one walker),
``loglike_batch``, ``nparams``, ``accept_lu``/``accept_batch``,
``ld_valid``, ``push``. A log-density record (``ld``) is

- ``ApproxKernelizedPosterior``: ``(logprior, loglikelihood)``;
- ``ApproxPosterior``: ``(logprior, cost)``;
- ``CommonLogDensity``: one log-density,

each a tensor with the walker axis first. The accept rules are pure
elementwise functions of ``(lu, old_ld, new_ld, corr)``: the reference's
``-randexp() <= lW`` is ``log U <= lW``.

A cost (or ``lpi``) is per walker, ``cost(theta, gen)`` or
``cost(theta)`` (``_adapt_cost``): ``theta`` is one walker's pushed
parameters and ``gen`` the run's ``torch.Generator``; a stochastic cost
draws with ``generator=gen, device=gen.device``. ``per_walker_cost``
maps it over the walkers with ``torch.func.vmap``, which gives every
walker its own draws. With ``cost_vectorized=True`` (``lpi_vectorized``)
the cost takes the whole pushed population, ``cost(thetas, gen) ->
[n]``: ``make_flagship_cost_batched()`` or
``make_streaming_moment_cost``.
"""

from __future__ import annotations

import inspect

import torch
from torch.func import vmap

from ..ops.tree import tfloat, tree_leaves, tree_map
from ..utils.rng import log_uniform

_f32 = torch.float32


def _adapt_cost(cost):
    """A user cost in the canonical ``(theta, gen)`` form: a callable
    with two or more required positional parameters passes as it is;
    any other becomes ``lambda theta, gen: cost(theta)``."""
    try:
        n = len([p for p in inspect.signature(cost).parameters.values()
                 if p.default is inspect.Parameter.empty
                 and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)])
    except (TypeError, ValueError):
        n = 1
    if n >= 2:
        return cost
    return lambda theta, gen: cost(theta)


_VMAP_HINT = (
    "the per-walker cost could not be mapped over the walkers with "
    "torch.func.vmap; write it with tensor ops vmap can batch (no .item(), "
    "no Python control flow on tensors), or pass a batched cost "
    "cost(thetas, gen) -> costs[n] with cost_vectorized=True")


def per_walker_cost(cost, caller="smc"):
    """The batched cost ``(pushed_thetas, gen) -> costs[n]`` of a
    per-walker ``cost(theta, gen)`` or ``cost(theta)``: the counterpart
    of the JAX package's ``vmap`` over walkers. Walkers are mapped on
    the leading axis of every leaf."""
    cost2 = _adapt_cost(cost)
    # a cost without the generator is deterministic (as in JAX, where it
    # gets no key): a draw inside it raises instead of being shared
    mapped = vmap(cost2, in_dims=(0, None), randomness=(
        "different" if cost2 is cost else "error"))

    def batched(thetas, gen):
        try:
            return mapped(thetas, gen)
        except RuntimeError as e:
            if not str(e).startswith("vmap"):
                raise
            raise RuntimeError(f"{e}\n{caller}: {_VMAP_HINT}") from e

    return batched


def _finite(x):
    return torch.isfinite(x)


def _as_f32(x, like):
    return torch.as_tensor(x, device=like.device).to(_f32)


def _neg_inf_where(valid, lw):
    return torch.where(valid, lw, torch.full_like(lw, float("-inf")))


class Density:
    """Base class; the concrete models fill in the protocol."""

    @property
    def nparams(self):
        raise NotImplementedError

    def loglike_batch(self, pushed, gen):
        raise NotImplementedError

    def loglike_on(self, lay, pushed, gen):
        """``loglike_batch`` of a population on a layout
        (``parallel/layout.py``): on a mesh, a cost from
        ``shard_batched_cost`` runs once per shard, any other on the
        joined population, its ``ld`` cut into shards."""
        if not lay.sharded:
            return self.loglike_batch(pushed, gen)
        sharded = self._sharded_loglike(lay, pushed, gen)
        if sharded is not None:
            return sharded
        return lay.place(self.loglike_batch(lay.join(pushed), gen))

    def _sharded_loglike(self, lay, pushed, gen):
        """The ``ld`` of a kernel cost run once per shard, or None."""
        return None

    def accept_batch(self, gen, old_lds, new_lds, corr):
        """MH accept over ``[h]`` walkers with one batched log-uniform
        draw."""
        lu = log_uniform(gen, corr.shape)
        return self.accept_lu(lu, old_lds, new_lds, corr)

    def accept_lu(self, lu, old_ld, new_ld, corr):
        raise NotImplementedError

    def accept(self, gen, old_ld, new_ld, corr):
        return self.accept_lu(log_uniform(gen, ()), old_ld, new_ld, corr)

    def push(self, theta):
        """Generic densities snap no dtypes (types.jl:27)."""
        return theta

    def init_batch(self, gen, n):
        """``n`` initial walkers, float (the reference's ``op(float,
        ...)`` init)."""
        raise NotImplementedError

    def init_sample(self, gen):
        """One initial walker, float: ``init_batch``'s draw of one walker
        without its walker axis."""
        return tree_map(lambda x: x[0], self.init_batch(gen, 1))

    def loglike(self, theta_pushed, gen):
        """One walker's ``ld`` (the sequential schedule)."""
        raise NotImplementedError

    def ld_valid(self, ld):
        raise NotImplementedError


class _ABCDensity(Density):
    """Shared by the two ABC densities: a prior and a cost."""

    def __init__(self, prior, cost, cost_vectorized):
        self.prior = prior
        self.vectorized = bool(cost_vectorized)
        self.cost = cost if cost_vectorized else _adapt_cost(cost)
        self._batched = cost if cost_vectorized else per_walker_cost(
            cost, "sample")

    @property
    def nparams(self):
        return self.prior.nparams

    def push(self, theta):
        return self.prior.push_tree(theta)

    def init_batch(self, gen, n):
        return tfloat(self.prior.sample_tree(gen, n))

    def _sharded_loglike(self, lay, pushed, gen):
        from ..parallel.mesh import ShardedCost
        if not isinstance(self._batched, ShardedCost):
            return None
        costs = self._batched(pushed, gen)
        return lay.map(lambda p, c: self._ld(
            self.prior.logpdf_tree(p).to(_f32), c.to(_f32)), pushed, costs)

    def _lp_cost(self, pushed, gen, batched):
        lp = self.prior.logpdf_tree(pushed).to(_f32)
        c = (self._batched(pushed, gen) if batched
             else self.cost(pushed, gen))
        return lp, _as_f32(c, lp)


class ApproxKernelizedPosterior(_ABCDensity):
    """ABC density with the Gaussian kernel N(0, eps): loglikelihood =
    ``-(cost/eps)^2/2`` where the prior is finite (types.jl:40-75).
    ``cost_vectorized=True`` declares a batched ``cost(thetas, gen)``."""

    def __init__(self, prior, cost, target_average_cost,
                 cost_vectorized=False):
        super().__init__(prior, cost, cost_vectorized)
        self.scale = float(target_average_cost)

    def _ld(self, lp, c):
        ll = torch.where(_finite(lp), -0.5 * torch.square(c / self.scale),
                         lp)
        return lp, ll.to(_f32)

    def loglike_batch(self, pushed, gen):
        return self._ld(*self._lp_cost(pushed, gen, True))

    def loglike(self, theta_pushed, gen):
        return self._ld(*self._lp_cost(theta_pushed, gen, False))

    def ld_valid(self, ld):
        return _finite(ld[0] + ld[1])

    def accept_lu(self, lu, old_ld, new_ld, corr):
        lw = corr + (new_ld[0] + new_ld[1]) - (old_ld[0] + old_ld[1])
        return lu <= _neg_inf_where(self.ld_valid(new_ld), lw)


class ApproxPosterior(_ABCDensity):
    """ABC density with a hard threshold: accept = MH on the prior ratio
    and ``new_cost <= max(maxcost, old_cost)``; the ``max`` lets early
    walkers anneal in from above the threshold (types.jl:76-104)."""

    def __init__(self, prior, cost, max_cost, cost_vectorized=False):
        super().__init__(prior, cost, cost_vectorized)
        self.maxcost = float(max_cost)

    def _ld(self, lp, c):
        return lp, torch.where(_finite(lp), c, -lp)

    def loglike_batch(self, pushed, gen):
        return self._ld(*self._lp_cost(pushed, gen, True))

    def loglike(self, theta_pushed, gen):
        return self._ld(*self._lp_cost(theta_pushed, gen, False))

    def ld_valid(self, ld):
        return _finite(ld[0]) & _finite(ld[1])

    def accept_lu(self, lu, old_ld, new_ld, corr):
        lw = corr + new_ld[0] - old_ld[0]
        lw = _neg_inf_where(self.ld_valid(new_ld), lw)
        gate_cost = torch.clamp(old_ld[1], min=self.maxcost) - new_ld[1] >= 0
        return (lu <= lw) & gate_cost


class CommonLogDensity(Density):
    """A classical MCMC target: ``nparameters``, ``sample_init(gen)`` (one
    walker's start) and a log-density ``lpi(x)`` or ``lpi(x, gen)``
    (types.jl:105-128, e.g. the Rosenbrock banana, KissABC.jl:140-147).
    ``sample_init`` is mapped over the walkers with ``torch.func.vmap``;
    ``lpi_vectorized=True`` declares a batched ``lpi(xs, gen)``."""

    def __init__(self, nparameters, sample_init, lpi, lpi_vectorized=False):
        self._n = int(nparameters)
        self.sample_init = sample_init
        self.vectorized = bool(lpi_vectorized)
        self.lpi = lpi if lpi_vectorized else _adapt_cost(lpi)
        self._batched = lpi if lpi_vectorized else per_walker_cost(
            lpi, "sample")

    @property
    def nparams(self):
        return self._n

    def init_batch(self, gen, n):
        draw = vmap(lambda _: self.sample_init(gen), randomness="different")
        return tfloat(draw(torch.zeros(n, device=gen.device)))

    def init_sample(self, gen):
        return tfloat(self.sample_init(gen))

    def loglike_batch(self, pushed, gen):
        out = self._batched(pushed, gen)
        return _as_f32(out, tree_leaves(pushed)[0])

    def _sharded_loglike(self, lay, pushed, gen):
        from ..parallel.mesh import ShardedCost
        if not isinstance(self._batched, ShardedCost):
            return None
        return self._batched(pushed, gen).map(lambda c: c.to(_f32))

    def loglike(self, theta_pushed, gen):
        return _as_f32(self.lpi(theta_pushed, gen),
                       tree_leaves(theta_pushed)[0])

    def ld_valid(self, ld):
        return _finite(ld)

    def accept_lu(self, lu, old_ld, new_ld, corr):
        lw = _neg_inf_where(self.ld_valid(new_ld), corr + new_ld - old_ld)
        return lu <= lw
