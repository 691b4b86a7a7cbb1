"""Proposal moves — the PyTorch counterpart of ``kissabc_tpu/ops/moves.py``.

- smc: ``gaussian_diff_propose``. For every walker i, two distinct
  partners a, b != i from the snapshot population and ``W = (theta_b -
  theta_a) * max_stretch * N(0,1) / sqrt(d)``.
- AIS: the 4:2:1 stretch / differential-evolution / walk mixture of the
  reference (``src/transition.jl``) over a red/black half ensemble,
  partners drawn from the other half. ``stretch_one``, ``de_one``,
  ``walk_one`` and ``mixture_one`` move one walker (the sequential
  schedule, and ``propose_half(kernel=...)`` through
  ``torch.func.vmap``); ``mixture_batched`` moves a whole half with one
  batched draw per random quantity.
- pfilter: ``masked_index`` and ``masked_distinct`` draw among the True
  entries of a mask, by modulo draws from uint32 words mapped through
  the True-first order (``distinct_positions``, ``masked_order``).

Every move is split into its draws from the explicit generator and a
pure function of those draws (``propose_roll``/``propose_gather``,
``stretch_move``/``de_move``/``walk_move``/``mixture_move``,
``rollfused_from_words``), so tests can feed both packages the same
words, shifts and partners. Shifts are computed on the generator's
device: the split AIS sweep reads nothing on the host. On a walker mesh
(``mesh=``, halves ``Sharded``) the draws are still made on the whole
half and cut into shards, so the proposals keep their bits; the rotation
partners then move as shard-sized transfers (``partner_rolls``, which
reads the six shifts on the host), the gathered ones come from the
joined other half.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import vmap

from ..utils.logging import host_read
from ..utils.rng import uint32_words
from .tree import sample_distinct, tree_leaves, tree_map

_F32 = np.float32

AUTO_ROLL_MIN = 16384  # below this, per-walker gathers are cheap and the
# reference-exact partner law wins; above it, two rotations are used


def _resolve_scheme(scheme, n):
    if scheme == "auto":
        return "roll" if n >= AUTO_ROLL_MIN else "gather"
    if scheme not in ("roll", "gather"):
        raise ValueError(
            f"partner scheme must be 'auto', 'roll' or 'gather', "
            f"got {scheme!r}")
    return scheme


def roll_shifts(words, n):
    """Two distinct rotation shifts in [1, n) from two uint32 words,
    with the JAX package's modulo rule. ``words``: two Python ints, or
    an int64 tensor of two words, whose shifts are two 0-dim int64
    tensors on its device, read by nothing on the host."""
    r1 = words[0] % (n - 1) + 1
    r2 = words[1] % (n - 2) + 1
    return r1, r2 + (r2 >= r1)


def _scale(w, x):
    return w.reshape((w.shape[0],) + (1,) * (x.dim() - 1))


def propose_roll(ens, w, r1, r2):
    """``x + (roll(x, r2) - roll(x, r1)) * w``, the shifts Python ints or
    device tensors: each rotation a gather at ``(i - r) % n``, which is
    what ``torch.roll`` reads, so its bits without the shifts on the
    host."""
    n = w.shape[0]
    i = torch.arange(n, device=w.device)
    ia, ib = (i - r1) % n, (i - r2) % n
    return tree_map(lambda x: x + (x[ib] - x[ia]) * _scale(w, x), ens)


def propose_gather(ens, w, a, b, full=None):
    """Per-walker partners ``a``, ``b``: ``x + (x[b] - x[a]) * w``, the
    partners read from ``full`` (the whole population, for a shard of
    it) when given."""
    return tree_map(lambda x, xf: x + (xf[b] - xf[a]) * _scale(w, x), ens,
                    ens if full is None else full)


def gaussian_diff_propose(gen, ens, d, max_stretch=2.0, scheme="auto",
                          mesh=None):
    """Draw the scales and partners from ``gen`` and propose for the
    whole population. ``scheme``: ``"roll"`` (two random rotations,
    marginally uniform distinct partners) or ``"gather"`` (per-walker
    random distinct partners, the reference's law); ``"auto"`` picks
    roll at ``n >= AUTO_ROLL_MIN``, from ``n`` alone, so a population
    sharded over ``mesh`` (``ens`` a ``Sharded``) takes the same partner
    law and gets the same proposals: the draws are made on the whole
    population and cut into shards, the rolls go through
    ``roll_walkers`` (shard-sized transfers) and a gather joins the
    population first (an all-gather, as GSPMD lowers it). An unsharded
    roll keeps its shifts on the device (``propose_roll``): no host
    read, so a CUDA graph can record it."""
    from ..parallel.mesh import Sharded, join, place, roll_walkers
    sharded = isinstance(ens, Sharded)
    n = ens.n if sharded else tree_leaves(ens)[0].shape[0]
    if n < 3:
        raise ValueError(
            f"gaussian_diff_propose needs an ensemble of >= 3 walkers "
            f"(two distinct partners per walker), got n={n}")
    scheme = _resolve_scheme(scheme, n)
    dev = gen.device
    z = torch.randn(n, generator=gen, device=dev)
    w = max_stretch * z / math.sqrt(d)
    if scheme == "roll":
        words = uint32_words(gen, 2)
        if not sharded:
            return propose_roll(ens, w, *roll_shifts(words, n))
        r1, r2 = roll_shifts(host_read("roll shifts", torch.Tensor.tolist,
                                       words), n)
        ra, rb = roll_walkers(ens, r1, ens.mesh), roll_walkers(ens, r2,
                                                               ens.mesh)
        return ens.map(lambda t, ta, tb, wi: tree_map(
            lambda x, xa, xb: x + (xb - xa) * _scale(wi, x), t, ta, tb),
            ra, rb, place(ens.mesh, w))
    i = torch.arange(n, device=dev)
    a = torch.randint(0, n - 1, (n,), generator=gen, device=dev)
    a = a + (a >= i).to(a.dtype)
    b = torch.randint(0, n - 2, (n,), generator=gen, device=dev)
    lo = torch.minimum(a, i)
    hi = torch.maximum(a, i)
    b = b + (b >= lo).to(b.dtype)
    b = b + (b >= hi).to(b.dtype)
    if not sharded:
        return propose_gather(ens, w, a, b)
    full = join(ens)
    return ens.map(lambda t, ai, bi, wi: propose_gather(
        t, wi, ai, bi, full=tree_map(lambda x: x.to(wi.device), full)),
        *(place(ens.mesh, v) for v in (a, b, w)))


# ---------------------------------------------------------------------------
# AIS: the stretch variate and the single-walker moves (transition.jl)
# ---------------------------------------------------------------------------

def _stretch_consts(a):
    """float32 (1/sqrt(a), sqrt(a) - 1/sqrt(a)), as the JAX package
    rounds them."""
    sa = np.sqrt(_F32(a))
    inv = _F32(1.0) / sa
    return float(inv), float(sa - inv)


def cdf_g_inv(u, a):
    """Inverse cdf of the stretch g-pdf, eq. 10 of Foreman-Mackey et al.
    2013 (reference transition.jl:46)."""
    lo, span = _stretch_consts(a)
    return (u * span + lo) ** 2


def sample_g(gen, a=3.0):
    return cdf_g_inv(torch.rand((), generator=gen, device=gen.device), a)


def _noise_like(gen, tree):
    """Standard-normal noise shaped like ``tree`` (the DE jitter)."""
    return tree_map(lambda x: torch.randn(x.shape, generator=gen,
                                          device=gen.device), tree)


def _bshape(w, x):
    """Broadcast a per-walker ``w`` against a leaf ``x`` with trailing
    component axes."""
    return w.reshape(w.shape + (1,) * (x.dim() - w.dim()))


def _take(comp, j):
    return tree_map(lambda x: x[j], comp)


def stretch_move(theta, part, z, d):
    """Goodman-Weare stretch (transition.jl:51-59): ``part + z * (theta -
    part)`` and the log-Jacobian ``(d - 1) log z``."""
    prop = tree_map(lambda pa, pi: pa + _bshape(z, pa) * (pi - pa), part,
                    theta)
    return prop, (d - 1) * torch.log(z)


def de_scale(d):
    return float(_F32(2.38 / math.sqrt(2 * d)))


def de_move(theta, ta, tb, gnorm, noise, d):
    """ter Braak differential evolution (transition.jl:2-22): ``gamma =
    2.38/sqrt(2d) * exp(0.1 gnorm)``, ``theta + gamma (a - b)`` plus the
    triangle-scaled jitter ``gamma/300 (|a-b| + |i-b| + |a-i|) noise``;
    zero correction."""
    gamma = de_scale(d) * torch.exp(0.1 * gnorm)

    def mk(xi, xa, xb, nz):
        g = _bshape(gamma, xi)
        tri = torch.abs(xa - xb) + torch.abs(xi - xb) + torch.abs(xa - xi)
        return xi + g * (xa - xb) + g * tri / 300.0 * nz

    return tree_map(mk, theta, ta, tb, noise)


def walk_move(theta, twa, twb, twc, r):
    """Goodman-Weare walk over three partners (transition.jl:24-43):
    ``theta + sum_k r_k (t_k - centroid)``; zero correction. ``r``: the
    three weights on the leading axis."""
    def mk(xi, xa, xb, xc):
        cen = (xa + xb + xc) / 3.0
        return xi + (_bshape(r[0], xi) * (xa - cen)
                     + _bshape(r[1], xi) * (xb - cen)
                     + _bshape(r[2], xi) * (xc - cen))

    return tree_map(mk, theta, twa, twb, twc)


def mixture_move(is_s, is_d, p_s, c_s, p_d, p_w):
    """Select the stretch, DE or walk proposal per walker; the correction
    is the stretch's where it was chosen, else 0."""
    prop = tree_map(
        lambda a, b, c: torch.where(_bshape(is_s, a), a,
                                    torch.where(_bshape(is_d, a), b, c)),
        p_s, p_d, p_w)
    return prop, torch.where(is_s, c_s, torch.zeros_like(c_s))


def _randint(gen, hi, shape=()):
    return torch.randint(0, hi, shape, generator=gen, device=gen.device)


def stretch_one(gen, theta_i, comp, hc, d, a=3.0):
    """Stretch move of one walker against a partner from ``comp``
    (leaves ``[hc, ...]``)."""
    j = _randint(gen, hc)
    return stretch_move(theta_i, _take(comp, j), sample_g(gen, a), d)


def de_one(gen, theta_i, comp, hc, d):
    ia = _randint(gen, hc)
    ib = sample_distinct(gen, hc, (ia,))
    gnorm = torch.randn((), generator=gen, device=gen.device)
    noise = _noise_like(gen, theta_i)
    prop = de_move(theta_i, _take(comp, ia), _take(comp, ib), gnorm, noise,
                   d)
    return prop, torch.zeros((), device=gen.device)


def walk_one(gen, theta_i, comp, hc, d):
    ia = _randint(gen, hc)
    ib = sample_distinct(gen, hc, (ia,))
    ic = sample_distinct(gen, hc, (ia, ib))
    r = torch.randn(3, generator=gen, device=gen.device)
    prop = walk_move(theta_i, _take(comp, ia), _take(comp, ib),
                     _take(comp, ic), r)
    return prop, torch.zeros((), device=gen.device)


def mixture_one(gen, theta_i, comp, hc, d):
    """4:2:1 stretch/DE/walk mixture (transition.jl:61-65): the three
    proposals are made and one is selected by ``mid ~ U{0..6}``."""
    mid = _randint(gen, 7)
    p_s, c_s = stretch_one(gen, theta_i, comp, hc, d)
    p_d, _ = de_one(gen, theta_i, comp, hc, d)
    p_w, _ = walk_one(gen, theta_i, comp, hc, d)
    return mixture_move(mid < 4, (mid >= 4) & (mid < 6), p_s, c_s, p_d, p_w)


# ---------------------------------------------------------------------------
# AIS: raw uint32 words -> variates (the maps of the JAX package's fused
# per-sweep draw; words are int64 tensors holding uint32 values)
# ---------------------------------------------------------------------------

_ERFINV_LO = _F32(np.nextafter(_F32(-1.0), _F32(0.0)))
_ERFINV_SPAN = float(_F32(1.0) - _ERFINV_LO)
_SQRT2 = float(_F32(math.sqrt(2.0)))


def _bits_to_uniform(bits):
    """uint32 -> U[0,1) by the mantissa bitcast of jax.random.uniform."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


def _bits_to_normal(bits):
    """uint32 -> N(0,1) as ``sqrt(2) erfinv(U(-1,1))``, the open interval
    at -1 as in jax.random.normal."""
    u = _bits_to_uniform(bits) * _ERFINV_SPAN + float(_ERFINV_LO)
    return _SQRT2 * torch.erfinv(u)


def _bits_to_log_uniform(bits):
    """uint32 -> log U, the MH accept draw: ``log1p(-u)``."""
    return torch.log1p(-_bits_to_uniform(bits))


def _bump_distinct(raw):
    """Mutually distinct draws from ``raw[j]`` uniform over ``[0, hc-j)``:
    each is bumped past the earlier ones in ascending order (the
    sorted-exclude arithmetic of ``sample_distinct``)."""
    draws = []
    for u in raw:
        if draws:
            ex = torch.sort(torch.stack(draws), dim=0)[0]
            for t in range(len(draws)):
                u = u + (u >= ex[t]).to(u.dtype)
        draws.append(u)
    return draws


def _distinct_shifts(v, hc, ks):
    """Rotation shifts from raw uint32 words ``v``: for each group size k
    in ``ks``, k words give k distinct draws over ``[0, hc)``. Returns a
    flat list of 0-d tensors on ``v``'s device."""
    out, i = [], 0
    for k in ks:
        out.extend(_bump_distinct([v[i + j] % (hc - j) for j in range(k)]))
        i += k
    return out


def _partner_idx(gen, h, hc, k, scheme):
    """The indices into ``comp`` of k mutually distinct partners for h
    walkers. ``roll``: k distinct rotations, partner ``(i + r_j) % hc``
    (``jnp.roll(x, -r)[:h]``), computed on the device; ``gather``:
    per-walker random distinct indices (the reference law)."""
    if scheme == "roll":
        v = uint32_words(gen, k)
        pos = torch.arange(h, device=gen.device)
        return [torch.remainder(pos + r, hc)
                for r in _distinct_shifts(v, hc, (k,))]
    return _bump_distinct([_randint(gen, hc - j, (h,)) for j in range(k)])


def _partners(gen, comp, h, hc, k, scheme):
    """k mutually distinct partner trees for h walkers from ``comp``
    (``_partner_idx``)."""
    return [_take(comp, i) for i in _partner_idx(gen, h, hc, k, scheme)]


def _rows(words, start, count, like, h):
    """Normal rows ``start .. start+count`` of the word block as a leaf
    shaped like ``like`` (``[h]`` or ``[h, ...]``)."""
    rows = _bits_to_normal(words[start:start + count])
    if like.dim() == 1:
        return rows[0]
    return torch.movedim(rows.reshape(tuple(like.shape[1:]) + (h,)), -1, 0)


def rollfused_from_words(half, comp, d, a_stretch, words, shifts,
                         accept_lu=True, partners=None):
    """The rotation-scheme mixture as a pure function of its draws (the
    JAX package's ``_mixture_batched_rollfused``): ``words`` is the
    ``(6 + C [+ 1], h)`` block of uint32 words (move id, stretch z, DE
    gamma, one jitter row per parameter component, the three walk
    weights, the accept draw), ``shifts`` the six rotations (stretch 1,
    DE 2, walk 3). ``partners``: the six partner trees already rolled
    (a shard's blocks of ``partner_rolls`` on a mesh), in place of
    ``comp`` and ``shifts``. Returns ``(prop, corr, lu)``; ``lu`` is None
    unless ``accept_lu``."""
    leaves = tree_leaves(half)
    h = leaves[0].shape[0]
    cols = [int(np.prod(x.shape[1:], dtype=np.int64)) for x in leaves]
    C = sum(cols)
    mid = words[0] % 7
    is_s, is_d = mid < 4, (mid >= 4) & (mid < 6)
    z = cdf_g_inv(_bits_to_uniform(words[1]), a_stretch)
    nleaves, off = [], 0
    for x, c in zip(leaves, cols):
        nleaves.append(_rows(words, 3 + off, c, x, h))
        off += c
    it = iter(nleaves)
    noise = tree_map(lambda _: next(it), half)
    r = _bits_to_normal(words[3 + C:6 + C])
    lu = _bits_to_log_uniform(words[6 + C]) if accept_lu else None
    if partners is None:
        pos = torch.arange(h, device=words.device)
        partners = [_take(comp, torch.remainder(pos + shift, h))
                    for shift in shifts]
    ps, d1, d2, w1, w2, w3 = partners
    p_s, c_s = stretch_move(half, ps, z, d)
    p_d = de_move(half, d1, d2, _bits_to_normal(words[2]), noise, d)
    p_w = walk_move(half, w1, w2, w3, r)
    prop, corr = mixture_move(is_s, is_d, p_s, c_s, p_d, p_w)
    return prop, corr, lu


def _cut_columns(mesh, words):
    """A ``(R, h)`` block of per-walker words cut into the shards' ``(R,
    s)`` blocks."""
    from ..parallel.mesh import place
    return place(mesh, words.T).map(lambda w: w.T)


def _partner_trees(leaves, like, k):
    """The k partner trees, structured like ``like``, from leaf-major
    partner leaves (leaf l's k copies at ``k l .. k l + k - 1``)."""
    nleaves = len(tree_leaves(like))
    out = []
    for j in range(k):
        it = iter([leaves[k * l + j] for l in range(nleaves)])
        out.append(tree_map(lambda _: next(it), like))
    return out


def _mixture_batched_rollfused(gen, half, comp, d, a_stretch, accept_lu, h):
    """All randomness of the rotation mixture from two draws of words: six
    for the partner shifts, and one ``(R, h)`` block for every per-walker
    quantity. On a mesh (``half`` and ``comp`` ``Sharded``) the words are
    cut into shards and the six partners come as shard-sized transfers
    (``partner_rolls``, which reads the shifts on the host once); each
    shard then moves by ``rollfused_from_words`` on its own device."""
    from ..parallel.mesh import Sharded, partner_rolls
    sharded = isinstance(half, Sharded)
    like = half.shards[0] if sharded else half
    C = sum(int(np.prod(x.shape[1:], dtype=np.int64))
            for x in tree_leaves(like))
    shifts = _distinct_shifts(uint32_words(gen, 6), h, (1, 2, 3))
    R = 6 + C + (1 if accept_lu else 0)
    words = uint32_words(gen, R * h).reshape(R, h)
    if not sharded:
        return rollfused_from_words(half, comp, d, a_stretch, words, shifts,
                                    accept_lu)
    parts = partner_rolls(comp, torch.stack(shifts), half.mesh, half.axis)
    out = half.map(lambda t, w, p: rollfused_from_words(
        t, None, d, a_stretch, w, None, accept_lu,
        partners=_partner_trees(p, t, 6)),
        _cut_columns(half.mesh, words), parts)
    return tuple(out.map(lambda o, i=i: o[i]) for i in range(3))


def _moves_from_draws(half, parts, mid, z, gnorm, noise, r, d):
    """The 4:2:1 mixture of the generic draws, given the six partner
    trees (stretch 1, DE 2, walk 3): ``(prop, corr)``."""
    p_s, c_s = stretch_move(half, parts[0], z, d)
    p_d = de_move(half, parts[1], parts[2], gnorm, noise, d)
    p_w = walk_move(half, parts[3], parts[4], parts[5], r)
    return mixture_move(mid < 4, (mid >= 4) & (mid < 6), p_s, c_s, p_d, p_w)


def mixture_batched(gen, half, comp, d, a_stretch=3.0, scheme="auto",
                    accept_lu=False, mesh=None):
    """The 4:2:1 mixture over one half ensemble, one batched draw per
    random quantity. ``scheme="roll"`` (distinct random rotations of the
    complementary half) with equal halves takes the fused draw of
    ``_mixture_batched_rollfused``; otherwise each quantity is drawn on
    its own. With ``accept_lu=True`` returns ``(prop, corr, lu)``; ``lu``
    is the fused accept draw on the rotation path, else None.

    ``mesh``: ``half`` and ``comp`` are ``Sharded`` over it (plain trees
    are placed on it first). Every draw is made on the whole half on the
    generator's device, as without a mesh, and cut into shards; the
    rotation partners move as shard-sized transfers, the gathered
    partners are read from the joined complementary half (an
    all-gather). The outputs are ``Sharded``, with the bits of
    ``mesh=None``."""
    from ..parallel.mesh import Sharded, join, place
    if mesh is not None:
        half, comp = (x if isinstance(x, Sharded) else place(mesh, x)
                      for x in (half, comp))
    sharded = isinstance(half, Sharded)
    h = half.n if sharded else tree_leaves(half)[0].shape[0]
    hc = comp.n if sharded else tree_leaves(comp)[0].shape[0]
    scheme = _resolve_scheme(scheme, h + hc)
    if scheme == "roll" and h == hc:
        out = _mixture_batched_rollfused(gen, half, comp, d, a_stretch,
                                         accept_lu, h)
        return out if accept_lu else out[:2]
    dev = gen.device
    like = half.shards[0] if sharded else half
    mid = _randint(gen, 7, (h,))
    idx = _partner_idx(gen, h, hc, 1, scheme)
    z = cdf_g_inv(torch.rand(h, generator=gen, device=dev), a_stretch)
    idx += _partner_idx(gen, h, hc, 2, scheme)
    gnorm = torch.randn(h, generator=gen, device=dev)
    noise = tree_map(lambda x: torch.randn((h,) + tuple(x.shape[1:]),
                                           generator=gen, device=dev), like)
    idx += _partner_idx(gen, h, hc, 3, scheme)
    r = torch.randn((3, h), generator=gen, device=dev)
    if not sharded:
        prop, corr = _moves_from_draws(half, [_take(comp, i) for i in idx],
                                       mid, z, gnorm, noise, r, d)
        return (prop, corr, None) if accept_lu else (prop, corr)
    m = half.mesh
    full = join(comp)
    out = half.map(
        lambda t, ii, mi, zi, gi, ni, ri: _moves_from_draws(
            t, [_take(tree_map(lambda x: x.to(mi.device), full), i)
                for i in ii], mi, zi, gi, ni, ri.T, d),
        place(m, tuple(idx)), place(m, mid), place(m, z), place(m, gnorm),
        place(m, noise), place(m, r.T))
    prop, corr = (out.map(lambda o, i=i: o[i]) for i in range(2))
    return (prop, corr, None) if accept_lu else (prop, corr)


def propose_half(gen, half, comp, d, kernel=None, scheme="auto",
                 mesh=None, accept_lu=False):
    """Propose for every walker of ``half`` (leaves ``[H, ...]``) with
    partners from ``comp``. The default is ``mixture_batched``; a
    single-walker kernel (``stretch_one``, ``de_one``, ``walk_one``, or
    one of the same signature) is mapped over the walkers with
    ``torch.func.vmap(randomness="different")``. Returns ``(props,
    corr)``, or ``(props, corr, lu)`` with ``accept_lu=True`` (``lu`` is
    None unless the fused rotation draw made it). ``mesh``: the halves
    are ``Sharded`` over it, as ``mixture_batched`` takes them, with the
    bits of ``mesh=None``; a single-walker kernel runs on the joined
    halves and its outputs are cut into shards."""
    if kernel is None or kernel is mixture_one:
        return mixture_batched(gen, half, comp, d, scheme=scheme,
                               accept_lu=accept_lu, mesh=mesh)
    if mesh is not None:
        from ..parallel.mesh import Sharded, join, place
        half, comp = (join(x) if isinstance(x, Sharded) else x
                      for x in (half, comp))
        props, corr = propose_half(gen, half, comp, d, kernel=kernel)
        out = (place(mesh, props), place(mesh, corr))
        return out + (None,) if accept_lu else out
    hc = tree_leaves(comp)[0].shape[0]
    props, corr = vmap(lambda th: kernel(gen, th, comp, hc, d),
                       randomness="different")(half)
    return (props, corr, None) if accept_lu else (props, corr)


# ---------------------------------------------------------------------------
# pfilter: draws among the True entries of a mask
# ---------------------------------------------------------------------------

def masked_order(mask):
    """Positions of a mask's True entries first, each group in index
    order: the stable ``argsort(~mask)`` of the JAX package."""
    return torch.argsort((~mask).to(torch.uint8), stable=True)


def distinct_positions(words, m):
    """k mutually distinct positions in ``[0, m)`` from k rows of uint32
    words (int64 tensors): row j is reduced modulo ``max(m - j, 1)`` and
    bumped past the earlier draws in ascending order, the construction of
    ``sample_distinct``. ``m`` may be a device tensor: nothing is read on
    the host."""
    m = torch.as_tensor(m, device=words.device)
    return _bump_distinct([words[j] % torch.clamp(m - j, min=1)
                           for j in range(words.shape[0])])


def masked_index(gen, mask, order=None, shape=()):
    """Uniform random indices among the True entries of ``mask``, one per
    element of ``shape``."""
    if order is None:
        order = masked_order(mask)
    (pos,) = distinct_positions(
        uint32_words(gen, max(1, math.prod(shape))).reshape((1,) + shape),
        mask.sum())
    return order[pos]


def masked_distinct(gen, mask, k, order=None, shape=()):
    """k distinct uniform indices among the True entries of ``mask``
    (which must hold at least k), one k-tuple per element of ``shape``:
    positions drawn distinct in ``[0, m)`` and mapped through the
    True-first stable order. pfilter's good-set partner draws
    (smc.jl:309-311) use it with a precomputed ``order``."""
    if order is None:
        order = masked_order(mask)
    words = uint32_words(gen, k * max(1, math.prod(shape)))
    pos = distinct_positions(words.reshape((k,) + shape), mask.sum())
    return tuple(order[p] for p in pos)
