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
    crossings per ancestor, then a histogram and a cumulative sum."""
    n = weights.shape[0]
    w = weights / weights.sum()
    cum = torch.cumsum(w, 0)
    r = (torch.floor(n * cum - u0).to(torch.int64) + 1).clamp(0, n)
    # a histogram of a known size: bincount on CUDA reads the maximum on
    # the host, a scatter-add does not
    h = torch.zeros(n + 1, dtype=torch.int64, device=r.device).index_add_(
        0, r, torch.ones_like(r))
    idx = torch.cumsum(h, 0)[:n]
    return idx.clamp(0, n - 1)
