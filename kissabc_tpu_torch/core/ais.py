"""Affine-invariant ensemble sampler (AIS) and the ``sample`` driver —
the PyTorch counterpart of ``kissabc_tpu/core/ais.py`` (the reference's
``AIS`` and its AbstractMCMC ``step``, ``src/KissABC.jl:21-80``, driving
``transition!``, ``src/transition.jl:67-82``).

- The ensemble is a tuple of ``[n]`` (or ``[n, d]``) float tensors. One
  *sweep* updates the red half against the black half, then the black
  half against the updated red half: the standard parallel form of the
  Goodman-Weare moves. The halves are carried as two separate trees
  (``make_sweep_halves``) and rejoin only at emission.
- One *block* is ``ntransitions * thinning`` sweeps followed by emitting
  all n walkers, pushed: the simulator-call budget and sample count of
  the reference's round robin for the same arguments.
- The init draws the whole ensemble and redraws invalid walkers in
  bounded retry rounds (KissABC.jl:50-61); a budget that runs out is a
  ``RuntimeError`` on the host.
- ``schedule="sequential"`` runs the reference's literal one-walker
  round robin (serial; for parity studies).
- ``chains=`` runs independent chains one after another, each on a
  generator seeded from the run's key, and concatenates their samples
  (the reference's ``MCMCThreads``).

The JAX ``lax.scan`` loops are Python loops; the split sweep reads
nothing on the host, so a block runs without a device sync.

``mesh=`` (``parallel/mesh.py``):

- a walker mesh shards each half: the red and black halves are carried
  as two ``Sharded`` trees and each half-update is shard-local but for
  its partners (``ops/moves.py``: the six rotation partners as
  shard-sized transfers, which read the shifts on the host once a
  half-update; the gathered partners from the joined other half). Every
  draw is made on the whole half on the generator's device and cut into
  shards, and a cost written in PyTorch runs on the joined proposals, so
  the samples are the unsharded run's bit for bit; a kernel cost comes
  through ``shard_batched_cost`` and runs once per shard (statistical
  parity). The population is joined at the init and at each emission;
- a chain mesh (``make_mesh(chain=C)``) runs chain c on row ``c // (Nc
  / C)`` of the chain axis, on its device with its own generator, so
  each chain's samples are those of the unsharded multi-chain run; on a
  ``(chain, walker)`` mesh each chain's walkers are sharded over its
  row.
"""

from __future__ import annotations

import math

import torch

from ..ops.moves import mixture_one, propose_half
from ..ops.tree import tree_leaves, tree_map, tselect
from ..parallel import layout as L
from ..parallel import mesh as M
from ..particles import particles_from_tree
from ..utils.device import resolve_device
from ..utils.hostfetch import fetch, fetch_tree
from ..utils.rng import as_generator, log_uniform, uint32_words


class AIS:
    """Ensemble sampler configuration: ``AIS(nparticles)``
    (KissABC.jl:21-23)."""

    def __init__(self, nparticles: int):
        self.nparticles = int(nparticles)

    def __repr__(self):
        return f"AIS({self.nparticles})"


# ---------------------------------------------------------------------------
# ensemble init with a bounded invalid-retry (KissABC.jl:50-61)
# ---------------------------------------------------------------------------

def _init_ensemble(model, gen, n, retry_sampling, lay=None):
    """(thetas, lds, valid): the whole ensemble drawn at once, the
    invalid walkers redrawn in at most ``retry_sampling`` rounds. On a
    mesh layout (``parallel/layout.py``) the draws are cut into shards
    and the outputs are ``Sharded``."""
    lay = lay or L.OneDevice(gen.device)

    def draw_all():
        th = lay.place(model.init_batch(gen, n))
        return th, model.loglike_on(lay, lay.map(model.push, th), gen)

    thetas, lds = draw_all()
    valid = lay.map(model.ld_valid, lds)
    t = 0
    while t < retry_sampling and int(lay.count(valid)) < n:
        nth, nld = draw_all()
        thetas = lay.map(tselect, valid, thetas, nth)
        lds = lay.map(tselect, valid, lds, nld)
        valid = lay.map(model.ld_valid, lds)
        t += 1
    return thetas, lds, valid


# ---------------------------------------------------------------------------
# the red/black sweep
# ---------------------------------------------------------------------------

def _half_update(model, gen, upd, upd_lds, comp, kernel, scheme, lay=None):
    """MH-update the walkers of one half (``upd``) against partners from
    the other half (``comp``); on a mesh layout the halves are
    ``Sharded``."""
    lay = lay or L.OneDevice(gen.device)
    props, corr, lu = propose_half(gen, upd, comp, model.nparams,
                                   kernel=kernel, scheme=scheme,
                                   mesh=lay.mesh, accept_lu=True)
    new_lds = model.loglike_on(lay, lay.map(model.push, props), gen)
    if lu is None:   # accept_batch's draw, made on the whole half
        lu = lay.place(log_uniform(gen, (lay.size(upd),)))
    acc = lay.map(model.accept_lu, lu, upd_lds, new_lds, corr)
    # the reference stores the raw float proposal, pushing only at
    # loglike and emission time (transition.jl:77)
    return lay.map(tselect, acc, props, upd), lay.map(tselect, acc, new_lds,
                                                      upd_lds)


def _halves(tree, h):
    return (tree_map(lambda x: x[:h], tree), tree_map(lambda x: x[h:], tree))


def _unhalves(pair):
    return tree_map(lambda a, b: torch.cat([a, b]), *pair)


def _walker_layout(mesh, n, caller):
    """The layout of an ensemble of ``n`` on ``mesh`` (a walker mesh,
    whose axis divides both halves), or one device without a mesh."""
    if mesh is None:
        return L.OneDevice("cpu")
    L.check_mesh(mesh, caller)
    if mesh.axis_size("chain") > 1:
        raise ValueError(
            f"{caller}(mesh=...) takes a walker mesh; a chain axis places "
            "the chains of sample(..., chains=...)")
    mesh.local("walker")   # other axes of size 1
    h = n // 2
    L.check_divides(h, mesh, "half size {n}")
    L.check_divides(n - h, mesh, "half size {n}")
    return L.OnMesh(mesh)


def _halves_on(lay, tree, h):
    """A whole population (or a ``Sharded`` one) as two halves on the
    layout."""
    if lay.sharded and isinstance(tree, M.Sharded):
        tree = lay.join(tree)
    a, b = _halves(tree, h)
    return lay.place(a), lay.place(b)


def _whole(lay, pair):
    """The two halves joined into one population on one device."""
    if lay.sharded:
        pair = tuple(lay.join(x) if isinstance(x, M.Sharded) else x
                     for x in pair)
    return _unhalves(pair)


def make_sweep_halves(model, n, kernel=mixture_one, constrain=lambda t: t,
                      partner_scheme="auto", mesh=None):
    """One red/black sweep over the ensemble carried as two half trees:
    ``sweep(gen, (th_a, th_b), (ld_a, ld_b)) -> (th, ld)`` in the same
    form. The parameters are the JAX package's, in its order:
    ``constrain`` is applied to each half (on one device the identity);
    ``partner_scheme``: ``"roll"`` (rotation partners), ``"gather"``
    (per-walker random partners, the reference's law) or ``"auto"``;
    ``mesh``: a walker mesh, on which each half is a ``Sharded`` (plain
    halves are placed on it) and stays shard-local but for its partners
    (the module docstring), with the bits of ``mesh=None``."""
    lay = _walker_layout(mesh, n, "make_sweep_halves")

    def sweep(gen, th, ld):
        tha, thb = (lay.place(x) for x in th)
        lda, ldb = (lay.place(x) for x in ld)
        tha, lda = _half_update(model, gen, tha, lda, thb, kernel,
                                partner_scheme, lay)
        thb, ldb = _half_update(model, gen, thb, ldb, tha, kernel,
                                partner_scheme, lay)
        return ((constrain(tha), constrain(thb)),
                (constrain(lda), constrain(ldb)))

    return sweep


def make_sweep(model, n, kernel=mixture_one, constrain=lambda t: t,
               partner_scheme="auto", mesh=None):
    """One red/black sweep over a single ``[n]``-leading ensemble:
    ``sweep(gen, thetas, lds) -> (thetas, lds)``; splits into halves,
    sweeps and concatenates. Parameters as ``make_sweep_halves``; on a
    mesh the halves are placed on it for the sweep and joined after it
    (``thetas`` and ``lds`` may be whole or ``Sharded``)."""
    h = n // 2
    sweep2 = make_sweep_halves(model, n, kernel, constrain, partner_scheme,
                               mesh)
    lay = _walker_layout(mesh, n, "make_sweep")

    def sweep(gen, thetas, lds):
        th, ld = sweep2(gen, _halves_on(lay, thetas, h),
                        _halves_on(lay, lds, h))
        return constrain(_whole(lay, th)), constrain(_whole(lay, ld))

    return sweep


# ---------------------------------------------------------------------------
# the reference's literal schedule (KissABC.jl:66-80)
# ---------------------------------------------------------------------------

def _sequential_transition(model, gen, thetas, lds, i):
    """One MH move of walker ``i`` against the current ensemble minus
    ``i`` (transition.jl:67-82), with the single-walker mixture."""
    n = tree_leaves(thetas)[0].shape[0]
    idx = torch.arange(n, device=gen.device)
    idx[i], idx[n - 1] = n - 1, i    # walker i to the last slot
    comp = tree_map(lambda x: x[idx[: n - 1]], thetas)
    theta_i = tree_map(lambda x: x[i], thetas)
    old_ld = tree_map(lambda x: x[i], lds)
    prop, corr = mixture_one(gen, theta_i, comp, n - 1, model.nparams)
    new_ld = model.loglike(model.push(prop), gen)
    acc = model.accept(gen, old_ld, new_ld, corr)

    def put(full, p):
        full = full.clone()
        full[i] = torch.where(acc, p, full[i])
        return full

    return tree_map(put, thetas, prop), tree_map(put, lds, new_ld)


def _check_n(model, n):
    if n < model.nparams + 5:
        raise ValueError(
            f"nparticles = {n} is insufficient, set number of particles in "
            f"AIS(.) at least to {model.nparams + 5}")


def make_sequential_run(model, sampler: AIS, ns: int, *,
                        ntransitions: int = 1, discard_initial: int = 0,
                        retry_sampling: int = 100, thinning: int = 1):
    """``run(gen) -> (samples, valid)`` of the reference's round robin:
    one recorded sample per step, the walker cursor cycling, with
    ``ntransitions`` single-walker moves between records."""
    n = sampler.nparticles
    _check_n(model, n)
    if thinning < 1:
        raise ValueError("thinning must be >= 1")
    total = discard_initial + ns * thinning

    def run(gen):
        thetas, lds, valid = _init_ensemble(model, gen, n, retry_sampling)
        emits, i = [], 0
        for _ in range(total):
            for _ in range(ntransitions):
                thetas, lds = _sequential_transition(model, gen, thetas,
                                                     lds, i)
            emits.append(model.push(tree_map(lambda x: x[i], thetas)))
            i = (i + 1) % n
        # AbstractMCMC's thinning: after the discard, keep the last step
        # of each group of `thinning`
        kept = emits[discard_initial + thinning - 1::thinning]
        return tree_map(lambda *xs: torch.stack(xs), *kept), valid

    return run


# ---------------------------------------------------------------------------
# the sample driver (the reference's re-exported `sample`,
# KissABC.jl:106-175)
# ---------------------------------------------------------------------------

def make_run(model, sampler: AIS, ns: int, *, ntransitions: int = 1,
             discard_initial: int = 0, retry_sampling: int = 100,
             kernel=mixture_one, mesh=None, partner_scheme="auto",
             progress: bool = False, thinning: int = 1):
    """The red/black program ``run(gen) -> (samples [blocks*n, ...],
    valid [n])``: ``ceil(discard_initial * ntransitions / n)`` burn-in
    sweeps, then ``ceil(ns / n)`` blocks of ``ntransitions * thinning``
    sweeps, each emitting the pushed ensemble. ``mesh``: a walker mesh
    (the module docstring)."""
    n = sampler.nparticles
    _check_n(model, n)
    if thinning < 1:
        raise ValueError("thinning must be >= 1")
    lay = _walker_layout(mesh, n, "make_run")
    if lay.sharded:
        L.check_cost(getattr(model, "_batched", None), mesh, "sample")
    sweep = make_sweep_halves(model, n, kernel,
                              partner_scheme=partner_scheme, mesh=mesh)
    h = n // 2
    burn_sweeps = max(0, math.ceil(discard_initial * ntransitions / n))
    blocks = max(1, math.ceil(ns / n))
    sweeps_per_block = ntransitions * thinning

    def run(gen):
        thetas, lds, valid = _init_ensemble(model, gen, n, retry_sampling,
                                            lay if lay.sharded else None)
        th, ld = _halves_on(lay, thetas, h), _halves_on(lay, lds, h)
        if lay.sharded:
            valid = lay.join(valid)
        for _ in range(burn_sweeps):
            th, ld = sweep(gen, th, ld)
        emits = []
        for b in range(blocks):
            for _ in range(sweeps_per_block):
                th, ld = sweep(gen, th, ld)
            emits.append(model.push(_whole(lay, th)))
            if progress:
                print(f"AIS block {b + 1}/{blocks} ({sweeps_per_block} "
                      "sweeps each)", flush=True)
        return tree_map(lambda *xs: torch.cat(xs), *emits), valid

    return run


_INVALID = ("Prior leads to infinite costs too often, tune the prior or "
            "increase `retry_sampling`.")


def sample_raw(model, sampler: AIS, ns: int, *, ntransitions: int = 1,
               discard_initial: int = 0, retry_sampling: int = 100, key=0,
               kernel=mixture_one, mesh=None, progress: bool = False,
               partner_scheme="auto", schedule: str = "red_black",
               thinning: int = 1, device=None):
    """Run AIS and return ``(pushed samples with leading axis [ns],
    valid mask)`` — the tensor-level API under ``sample``. ``mesh``: a
    walker mesh, or a mesh with a chain axis, whose first row is taken
    (one chain)."""
    mesh, dev = _one_chain(mesh, device)
    if schedule == "sequential":
        # the serial round robin has no partner batching, no kernel hook
        # and nothing to shard: refuse knobs that would be ignored
        ignored = [] if partner_scheme == "auto" else ["partner_scheme"]
        ignored += [] if kernel is mixture_one else ["kernel"]
        ignored += [] if mesh is None else ["mesh"]
        ignored += [] if not progress else ["progress"]
        if ignored:
            raise ValueError(
                f"schedule='sequential' does not support {ignored}; "
                "drop them or use the default red_black schedule")
        run = make_sequential_run(
            model, sampler, ns, ntransitions=ntransitions,
            discard_initial=discard_initial, retry_sampling=retry_sampling,
            thinning=thinning)
    elif schedule == "red_black":
        run = make_run(model, sampler, ns, ntransitions=ntransitions,
                       discard_initial=discard_initial,
                       retry_sampling=retry_sampling, kernel=kernel,
                       mesh=mesh, partner_scheme=partner_scheme,
                       progress=progress, thinning=thinning)
    else:
        raise ValueError(
            f"schedule must be 'red_black' or 'sequential', got {schedule!r}")
    flat, valid = run(as_generator(key, dev))
    if not bool(valid.all()):
        raise RuntimeError(_INVALID)
    return tree_map(lambda x: x[:ns], flat), valid


class MCMCThreads:
    """Positional multi-chain marker, as the reference's re-exported
    ``MCMCThreads`` (KissABC.jl:175): ``sample(model, AIS(N),
    MCMCThreads(), ns, nchains)`` routes to ``chains=nchains``."""


class MCMCDistributed:
    """Positional multi-chain marker, as the reference's
    ``MCMCDistributed``; chains run as with ``MCMCThreads``."""


def _chain_generators(key, chains, dev, devices=None):
    """One generator per chain, seeded from ``chains`` words of the run's
    generator; chain c's on ``devices[c]`` when given (its row of a chain
    mesh), else on ``dev``."""
    seeds = fetch(uint32_words(as_generator(key, dev), chains))
    devices = devices or [dev] * chains
    return [as_generator(int(s), d) for s, d in zip(seeds, devices)]


def _row_mesh(row):
    """A chain's walker mesh from its row of a chain mesh: None for a
    row of one device (the chain runs on it unsharded)."""
    return row if row.axis_size("walker") > 1 else None


def _one_chain(mesh, device):
    """(walker mesh or None, run device) of a single chain: a mesh with a
    chain axis gives its first row."""
    if mesh is None:
        return None, resolve_device(device)
    L.check_mesh(mesh, "sample")
    if "chain" in mesh.axis_names:
        mesh = mesh.take("chain", 0)
    L.layout(mesh, device, "sample")   # the device type asked for
    return _row_mesh(mesh), mesh.home


def _chain_rows(mesh, chains, device):
    """Chain c's (walker mesh or None, device) on a mesh with a chain
    axis: the chains in blocks of ``chains / C`` over the axis's rows."""
    L.layout(mesh, device, "sample")
    size = mesh.axis_size("chain")
    if chains % size:
        raise ValueError(f"chains={chains} must divide the mesh chain axis "
                         f"({size} devices)")
    if mesh.distributed:
        raise ValueError(
            "sample(chains=..., mesh=...): a chain axis runs within one "
            "process; shard the walkers of a mesh of several processes")
    rows = [mesh.take("chain", c * size // chains) for c in range(chains)]
    return [(_row_mesh(r), r.home) for r in rows]


def sample(model, sampler: AIS, ns, *args, ntransitions: int = 1,
           discard_initial: int = 0, retry_sampling: int = 100,
           chains: int | None = None, key=0, progress: bool = False,
           kernel=mixture_one, mesh=None, partner_scheme="auto",
           schedule: str = "red_black", thinning: int = 1, device=None):
    """KissABC-style entry point: per-dimension ``Particles`` (unwrapped
    when one-dimensional), as bundle_samples (KissABC.jl:82-94).
    ``chains=Nc`` concatenates Nc independent chains (KissABC.jl:96-104);
    the reference's positional ``sample(model, AIS(N), MCMCThreads(), ns,
    Nc)`` (or ``MCMCDistributed()``) is accepted too. ``progress=True``
    prints each block; ``thinning=t`` keeps every t-th step. ``key``: an
    int seed or a ``torch.Generator`` on the run's device. ``device``:
    ``None`` runs on CUDA (and raises without a card); ``"cpu"`` runs the
    plain versions. ``mesh``: a walker mesh shards each chain's walkers;
    a mesh with a chain axis places the chains on its rows (the module
    docstring); the samples are those without a mesh."""
    if isinstance(ns, (MCMCThreads, MCMCDistributed)) or (
            isinstance(ns, type)
            and issubclass(ns, (MCMCThreads, MCMCDistributed))):
        if len(args) != 2:
            raise TypeError(
                "sample(model, sampler, MCMCThreads(), ns, nchains) "
                f"needs ns and nchains, got {len(args)} extra args")
        if chains is not None:
            raise TypeError(
                "pass nchains positionally after MCMCThreads() OR as "
                "chains=, not both")
        ns, chains = args
    elif args:
        raise TypeError(
            f"sample() got unexpected positional arguments {args}; did "
            "you mean sample(model, sampler, MCMCThreads(), ns, "
            "nchains)?")
    ns = int(ns)
    kw = dict(ntransitions=ntransitions, discard_initial=discard_initial,
              retry_sampling=retry_sampling, kernel=kernel, mesh=mesh,
              progress=progress, partner_scheme=partner_scheme,
              thinning=thinning, device=device)
    if chains is None:
        flat, _ = sample_raw(model, sampler, ns, key=key, schedule=schedule,
                             **kw)
        return particles_from_tree(fetch_tree(flat))
    if schedule != "red_black":
        raise ValueError(
            "schedule='sequential' is single-chain only; drop chains= or "
            "use the default red_black schedule")
    if mesh is not None and "chain" in mesh.axis_names:
        rows = _chain_rows(mesh, chains, device)
        gens = _chain_generators(key, chains, rows[0][1],
                                 [d for _, d in rows])
        outs = [sample_raw(model, sampler, ns, key=g,
                           **dict(kw, mesh=m, device=d))[0]
                for g, (m, d) in zip(gens, rows)]
    else:
        dev = _one_chain(mesh, device)[1]
        outs = [sample_raw(model, sampler, ns, key=g, **kw)[0]
                for g in _chain_generators(key, chains, dev)]
    return particles_from_tree(
        tree_map(lambda *xs: fetch(torch.cat(xs)), *outs))
