"""Masked type-7 quantiles — the PyTorch counterpart of
``kissabc_tpu/ops/quantile.py``.

Both implementations take exact order statistics and interpolate with
the same float32 formula as the JAX package, so on the same float32
input they give the same bits (``tests/test_torch_ops.py``). Unsigned
32-bit key arithmetic is carried in int64 tensors, whose values stay in
``[0, 2**32)``.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF
_SIGN = 0x80000000


def masked_quantile(x, mask, q):
    """Type-7 quantile of ``x[mask]`` without dynamic shapes: masked-out
    entries are sorted to the end as +inf."""
    n = x.shape[0]
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    xs = torch.sort(torch.where(mask, x, inf)).values
    m = mask.sum()
    h = (m - 1).to(x.dtype) * q
    lo = torch.floor(h).to(torch.int64)
    hi = torch.minimum(lo + 1, m - 1)
    lo = lo.clamp(0, n - 1)
    hi = hi.clamp(0, n - 1)
    frac = h - lo.to(x.dtype)
    xlo = xs[lo]
    xhi = xs[hi]
    # if xlo is inf (all dead, or q beyond the mass) propagate it
    return torch.where(torch.isfinite(xlo), xlo + frac * (xhi - xlo), xlo)


def _f32_key(x):
    """Monotone float32 -> uint32 key (held in int64): negatives are
    bit-complemented, non-negatives get the sign bit set, so unsigned
    order equals IEEE total order."""
    b = x.to(torch.float32).view(torch.int32).to(torch.int64) & _U32
    return torch.where((b >> 31) == 1, b ^ _U32, b | _SIGN)


def _f32_unkey(u):
    """Inverse of ``_f32_key``."""
    b = torch.where((u >> 31) == 1, u ^ _SIGN, u ^ _U32)
    b = torch.where(b >= _SIGN, b - (1 << 32), b)  # two's complement
    return b.to(torch.int32).view(torch.float32)


class _Parts:
    """The blocks of a vector and the reductions over them: one block
    without a mesh, the local shards of a ``Sharded`` (reduced over the
    mesh) with one. Scalars live on the home device; ``on(v, t)`` puts
    one beside block ``t``."""

    def __init__(self, x):
        from ..parallel.mesh import Sharded, pmax, pmin, psum
        if isinstance(x, Sharded):
            mesh = x.mesh
            self.blocks = x.shards
            self.sum = lambda ts: psum(mesh, ts)
            self.min = lambda ts: pmin(mesh, ts)
            self.max = lambda ts: pmax(mesh, ts)
            self.home = mesh.home
        else:
            self.blocks = [x]
            self.sum = self.min = self.max = lambda ts: ts[0]
            self.home = x.device

    @staticmethod
    def on(v, t):
        return v if v.device == t.device else v.to(t.device)


def _kth_smallest(x, mask, k, iters=33):
    """Exact k-th (0-indexed) order statistic of ``x[mask]`` by
    bisection on the uint32 bit pattern of the floats; infinite entries
    are handled by rank bookkeeping. ``x`` and ``mask`` are vectors, or
    ``Sharded`` on one mesh (then every count and extreme is reduced
    over it)."""
    px, pm = _Parts(x), _Parts(mask)
    xs, ms, on = px.blocks, pm.blocks, px.on
    finite = [m & torch.isfinite(v) for v, m in zip(xs, ms)]
    n_neg = px.sum([(m & (v == float("-inf"))).sum()
                    for v, m in zip(xs, ms)])
    n_fin = px.sum([f.sum() for f in finite])
    kf = k - n_neg
    keys = [_f32_key(v) for v in xs]
    lo = px.min([torch.where(f, u, torch.full_like(u, _U32)).min()
                 for f, u in zip(finite, keys)])
    hi = px.max([torch.where(f, u, torch.zeros_like(u)).max()
                 for f, u in zip(finite, keys)])
    for _ in range(iters):
        mid = lo + (hi - lo) // 2
        below = px.sum([(f & (u <= on(mid, u))).sum()
                        for f, u in zip(finite, keys)]) < kf + 1
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=px.home)
    return torch.where(k < n_neg, -inf,
                       torch.where(kf < n_fin, _f32_unkey(hi), inf))


def masked_quantile_bisect(x, mask, q):
    """Type-7 masked quantile without sorting: exact order statistics by
    value bisection and a duplicate-aware neighbour lookup. The same
    results as ``masked_quantile``. On a mesh (``x`` and ``mask``
    ``Sharded``) every step is a scalar reduction over the shards, and
    the result the same as on the joined vectors."""
    px, pm = _Parts(x), _Parts(mask)
    xs, ms, on = px.blocks, pm.blocks, px.on
    m = px.sum([b.sum() for b in ms])
    dtype = xs[0].dtype
    h = (m - 1).to(dtype) * q
    k = torch.floor(h).to(torch.int64).clamp(min=0)
    frac = h - k.to(dtype)
    xlo = _kth_smallest(x, mask, k)
    count_le = px.sum([(b & (v <= on(xlo, v))).sum()
                       for v, b in zip(xs, ms)])
    above = [b & (v > on(xlo, v)) for v, b in zip(xs, ms)]
    inf = torch.tensor(float("inf"), dtype=dtype, device=px.home)
    xhi_strict = px.min([torch.where(a, v, on(inf, v)).min()
                         for a, v in zip(above, xs)])
    any_above = px.sum([a.sum() for a in above]) > 0
    xhi = torch.where(count_le >= k + 2, xlo,
                      torch.where(any_above, xhi_strict, xlo))
    return torch.where(torch.isfinite(xlo), xlo + frac * (xhi - xlo), xlo)


def quantile(x, q):
    """Plain type-7 quantile over the whole array (the reference's eps
    update, smc.jl:299)."""
    return masked_quantile(x, torch.ones_like(x, dtype=torch.bool), q)


def ess_count(mask):
    """The reference's actual ESS: the number of alive particles
    (smc.jl:142)."""
    return mask.sum()


def ess_weights(w):
    """Kish effective sample size ``sum(w)^2 / sum(w^2)`` of a vector or
    a ``Sharded`` one; each sum is a float64 sum rounded once to float32,
    on a mesh the shards' sums added over it (``parallel/layout.py``), so
    the two layouts give the same ESS."""
    from ..parallel.layout import layout_of
    lay = layout_of(w)
    s = lay.fsum(w)
    return s * s / lay.fsum(lay.map(lambda x: x * x, w))


def resolve_quantile_impl(impl, mesh, n=None):
    """``'auto'`` picks the bisection when the population is sharded
    over more than one device or ``n >= 2**18``, else the sort."""
    if impl not in ("auto", "sort", "bisect"):
        raise ValueError(
            f"quantile_impl must be 'auto', 'sort' or 'bisect', "
            f"got {impl!r}")
    if impl == "auto":
        sharded = mesh is not None and getattr(mesh, "size", 1) > 1
        big = n is not None and n >= (1 << 18)
        impl = "bisect" if (sharded or big) else "sort"
    return impl
