"""Resampling — the PyTorch counterpart of
``kissabc_tpu/ops/resampling.py``. Both schemes return an ``[n]`` index
vector for ``tgather``."""

from __future__ import annotations

import torch


def replicate_alive(alive):
    """``idx[j] = (alive indices, cyclically repeated)[j]`` — the
    reference's ``repeat(idxalive, ceil(n/len(idxalive)))[1:n]``.
    ``alive`` must have at least one True."""
    n = alive.shape[0]
    order = torch.argsort((~alive).to(torch.uint8), stable=True)
    m = alive.sum()
    j = torch.arange(n, device=alive.device)
    return order[j % m]


def systematic(gen, weights):
    """Systematic resampling with one uniform offset drawn from ``gen``."""
    u0 = torch.rand((), generator=gen, device=gen.device)
    return systematic_from_u0(weights, u0)


def systematic_from_u0(weights, u0):
    """Systematic resampling from a given offset ``u0`` in [0, 1), in
    the JAX package's closed form: ``r_j = floor(n*cum_j - u0) + 1``
    crossings per ancestor, then a histogram and a cumulative sum. On a
    mesh (``weights`` a ``Sharded``) the same indices: the total and
    each shard's offset in the cumulative sum are reduced over the mesh
    (``exclusive_prefix``), each shard's cumulative sum taken in float64
    from its offset, and the crossings joined (an all-gather of ``[n]``
    float32) for the histogram. Returns the ``[n]`` ancestor indices (on
    a mesh, on its home device, the same in every process)."""
    from ..parallel.mesh import Sharded
    if isinstance(weights, Sharded):
        return _systematic_sharded(weights, u0)
    n = weights.shape[0]
    # the total a float64 sum rounded once, as on a mesh
    w = weights / weights.to(torch.float64).sum().to(weights.dtype)
    # float64 partial sums rounded once (a float32 cumsum on the CPU
    # accumulates in float64 too): the same cum on every device, and on
    # a mesh
    cum = torch.cumsum(w.to(torch.float64), 0).to(w.dtype)
    return _ancestors(n * cum - u0, n)


def _ancestors(x, n):
    """The ancestor indices from ``x = n * cum - u0``: ``r_j =
    floor(x_j) + 1`` crossings per ancestor, then a histogram and a
    cumulative sum."""
    r = (torch.floor(x).to(torch.int64) + 1).clamp(0, n)
    # a histogram of a known size: bincount on CUDA reads the maximum on
    # the host, a scatter-add does not
    h = torch.zeros(n + 1, dtype=torch.int64, device=r.device).index_add_(
        0, r, torch.ones_like(r))
    idx = torch.cumsum(h, 0)[:n]
    return idx.clamp(0, n - 1)


def _systematic_sharded(weights, u0):
    from ..parallel.mesh import Sharded, exclusive_prefix, join, psum
    mesh, n = weights.mesh, weights.n
    total = psum(mesh, [w.to(torch.float64).sum()
                        for w in weights.shards]).to(weights.shards[0].dtype)
    ws = [w / total.to(w.device) for w in weights.shards]
    pre = exclusive_prefix(mesh, [w.to(torch.float64).sum() for w in ws])
    xs = [n * (p + torch.cumsum(w.to(torch.float64), 0)).to(w.dtype)
          - u0.to(w.device) for p, w in zip(pre, ws)]
    return _ancestors(join(Sharded(mesh, xs, n)), n)
