"""The noise of the scan kernel (#5), worked out from its seed word.

Walker ``w`` of a cost call with seed word ``seed`` draws the noise of
its steps four at a time: steps ``4 g .. 4 g + 3`` read the four words of
``philox(g, w, STREAM_SCAN, 0, seed)``; words 0 and 1 give the Box-Muller
pair of steps ``4 g`` (the cosine half) and ``4 g + 1`` (the sine half),
words 2 and 3 that of steps ``4 g + 2`` and ``4 g + 3``. The normals are
``streams.normal_pair``'s (the kernels use polynomials: a few float32
ulps apart).
"""

from __future__ import annotations

import torch

from .philox import philox
from .streams import normal_pair

STREAM_SCAN = 6


def scan_noise(seeds, walkers, nsteps, dtype=torch.float64):
    """The ``[len(walkers), nsteps]`` standard normals of each walker's
    path: row k is walker ``walkers[k]`` (int64) of the call whose seed
    word is ``seeds[k]`` (int64, or one int for every row)."""
    dev = walkers.device
    if not torch.is_tensor(seeds):
        seeds = torch.full_like(walkers, int(seeds))
    g = torch.arange(-(-nsteps // 4), device=dev)
    q = philox(g[None, :], walkers[:, None], STREAM_SCAN, 0, seeds[:, None])
    a_cos, a_sin = normal_pair(q[0], q[1], dtype)
    b_cos, b_sin = normal_pair(q[2], q[3], dtype)
    z = torch.stack((a_cos, a_sin, b_cos, b_sin), dim=2)
    return z.reshape(walkers.numel(), -1)[:, :nsteps]
