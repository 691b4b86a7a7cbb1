"""Masked type-7 quantiles — the PyTorch counterpart of
``kissabc_tpu/ops/quantile.py``.

Both implementations take exact order statistics and interpolate with
the same float32 formula as the JAX package, so on the same float32
input they give the same bits (``tests/test_torch_ops.py``). Unsigned
32-bit key arithmetic is carried in int64 tensors, whose values stay in
``[0, 2**32)``.

``masked_quantile_bisect`` dispatches on what it is given:

- one CUDA vector: one cooperative launch of the hand-written radix
  select ``csrc/select.cu`` (``masked_quantile_select``), which makes
  no host read and no copy; a refused launch raises;
- a CPU vector: ``masked_quantile_bisect_plain``, the bisection in
  PyTorch, the kernel's plain version;
- ``Sharded`` vectors: the same bisection, every count and extreme
  reduced over the mesh.

The sort and the plain bisection make their ``inf`` constant with
``device_scalar``: off the CPU that is a blocking host-to-device copy,
counted in the spans' ``host_copies`` (``utils/logging.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.logging import device_scalar, register_counters
from . import _build

_U32 = 0xFFFFFFFF
_SIGN = 0x80000000

# launches of the radix select (a plain int), registered with the counters that each span records (utils/logging.py)
launches = register_counters("launches.", {"masked_quantile": 0})
# threads a block of the radix select (at 2^20 on the H100, 16.9 us a
# launch against 19.6 us at 512 and 33.7 us at 256; PERF.md)
SELECT_THREADS = 1024


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def masked_quantile(x, mask, q):
    """Type-7 quantile of ``x[mask]`` without dynamic shapes: masked-out
    entries are sorted to the end as +inf."""
    n = x.shape[0]
    inf = device_scalar("quantile inf", float("inf"), x.dtype, x.device)
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
    inf = device_scalar("quantile inf", float("inf"), torch.float32,
                        px.home)
    return torch.where(k < n_neg, -inf,
                       torch.where(kf < n_fin, _f32_unkey(hi), inf))


def masked_quantile_bisect(x, mask, q):
    """Type-7 masked quantile without sorting: exact order statistics
    and a duplicate-aware neighbour lookup, the same results as
    ``masked_quantile``. One CUDA vector goes to the radix select
    kernel, which takes float32 ``x`` only (another dtype raises
    ``TypeError``); a CPU vector or ``Sharded`` vectors go to the
    bisection."""
    from ..parallel.mesh import Sharded
    if not isinstance(x, Sharded) and x.device.type == "cuda":
        return masked_quantile_select(x, mask, q)
    return masked_quantile_bisect_plain(x, mask, q)


@functools.cache
def _select_plan(device_index: int) -> tuple[int, int]:
    """(co-resident blocks, scratch words) of the radix select on a
    card: the blocks of ``SELECT_THREADS`` that fit on it at once, as a
    cooperative launch needs, and the scratch the kernel takes."""
    lib = _build.load_select()
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device_index):
        _build.check(lib, lib.kt_masked_quantile_grid(SELECT_THREADS, out),
                     "masked_quantile occupancy")
    return out[0] * out[1], lib.kt_masked_quantile_scratch_words()


def _select_operands(x, mask):
    """``x`` and ``mask`` as the radix select reads them: contiguous
    vectors of one length, ``x`` float32 and ``mask`` bool (a mask of
    another dtype is taken as its nonzero entries). A ``x`` of another
    dtype raises ``TypeError``: the bisection would interpolate it in its
    own dtype."""
    if x.dtype != torch.float32:
        raise TypeError(f"masked_quantile_select takes float32 x, got "
                        f"{x.dtype}")
    if x.dim() != 1 or mask.shape != x.shape:
        raise ValueError("masked_quantile_select takes vectors of one "
                         f"length, got {tuple(x.shape)} and "
                         f"{tuple(mask.shape)}")
    return x.contiguous(), mask.to(torch.bool).contiguous()


def masked_quantile_select(x, mask, q):
    """``masked_quantile_bisect`` of one CUDA vector by the radix select
    of ``csrc/select.cu`` in one launch of ``SELECT_THREADS`` threads a
    block over at most the co-resident blocks: its bits, no host read, no
    copy. ``x`` float32 and ``mask`` of the same length on one card, ``q``
    a number; a 0-dim float32 tensor on the card."""
    if x.device.type != "cuda" or mask.device != x.device:
        raise ValueError("masked_quantile_select takes x and mask on one "
                         f"CUDA device, got {x.device} and {mask.device}")
    x, mask = _select_operands(x, mask)
    n = x.shape[0]
    index = x.device.index if x.device.index is not None else \
        torch.cuda.current_device()
    co_resident, words = _select_plan(index)
    blocks = min(max(1, -(-n // (4 * SELECT_THREADS))), co_resident)
    lib = _build.load_select()
    out = torch.empty((), dtype=torch.float32, device=x.device)
    scratch = torch.empty(words, dtype=torch.int32, device=x.device)
    err = lib.kt_masked_quantile(
        x.data_ptr(), mask.data_ptr(), n, float(q), out.data_ptr(),
        scratch.data_ptr(), blocks, SELECT_THREADS,
        torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "masked_quantile")
    launches["masked_quantile"] += 1
    return out


def masked_quantile_work(n):
    """(bytes, operations) the radix select must move and do: ``x`` and
    the mask read once (5 bytes an entry) and the result written; one
    key and one digit an entry."""
    return 5 * n + 4, 2 * n


def masked_quantile_bisect_plain(x, mask, q):
    """The bisection: exact order statistics by value bisection and a
    duplicate-aware neighbour lookup (the plain version of the radix
    select). On a mesh (``x`` and ``mask`` ``Sharded``) every step is a
    scalar reduction over the shards, and the result the same as on the
    joined vectors."""
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
    inf = device_scalar("quantile inf", float("inf"), dtype, px.home)
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
