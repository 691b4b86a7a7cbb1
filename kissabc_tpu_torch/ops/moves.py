"""The smc rejuvenation proposal — the PyTorch counterpart of
``gaussian_diff_propose`` in ``kissabc_tpu/ops/moves.py``.

For every walker i, two distinct partners a, b != i from the snapshot
population and ``W = (theta_b - theta_a) * max_stretch * N(0,1) /
sqrt(d)``. The random draws are split from the arithmetic
(``propose_roll`` / ``propose_gather``) so tests can feed both packages
the same shifts, partners and scales.
"""

from __future__ import annotations

import math

import torch

from ..utils.rng import uint32_words
from .tree import tree_leaves, tree_map

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
    with the JAX package's modulo rule. ``words`` are Python ints."""
    r1 = words[0] % (n - 1) + 1
    r2 = words[1] % (n - 2) + 1
    return r1, r2 + (r2 >= r1)


def _scale(w, x):
    return w.reshape((w.shape[0],) + (1,) * (x.dim() - 1))


def propose_roll(ens, w, r1, r2):
    """Partners ``(i + r1) % n`` and ``(i + r2) % n`` for every walker:
    ``x + (roll(x, r2) - roll(x, r1)) * w``."""
    return tree_map(
        lambda x: x + (torch.roll(x, r2, 0) - torch.roll(x, r1, 0))
        * _scale(w, x), ens)


def propose_gather(ens, w, a, b):
    """Per-walker partners ``a``, ``b``: ``x + (x[b] - x[a]) * w``."""
    return tree_map(lambda x: x + (x[b] - x[a]) * _scale(w, x), ens)


def gaussian_diff_propose(gen, ens, d, max_stretch=2.0, scheme="auto"):
    """Draw the scales and partners from ``gen`` and propose for the
    whole population. ``scheme``: ``"roll"`` (two random rotations,
    marginally uniform distinct partners) or ``"gather"`` (per-walker
    random distinct partners, the reference's law); ``"auto"`` picks
    roll at ``n >= AUTO_ROLL_MIN``."""
    n = tree_leaves(ens)[0].shape[0]
    if n < 3:
        raise ValueError(
            f"gaussian_diff_propose needs an ensemble of >= 3 walkers "
            f"(two distinct partners per walker), got n={n}")
    scheme = _resolve_scheme(scheme, n)
    dev = gen.device
    z = torch.randn(n, generator=gen, device=dev)
    w = max_stretch * z / math.sqrt(d)
    if scheme == "roll":
        r1, r2 = roll_shifts(uint32_words(gen, 2).tolist(), n)
        return propose_roll(ens, w, r1, r2)
    i = torch.arange(n, device=dev)
    a = torch.randint(0, n - 1, (n,), generator=gen, device=dev)
    a = a + (a >= i).to(a.dtype)
    b = torch.randint(0, n - 2, (n,), generator=gen, device=dev)
    lo = torch.minimum(a, i)
    hi = torch.maximum(a, i)
    b = b + (b >= lo).to(b.dtype)
    b = b + (b >= hi).to(b.dtype)
    return propose_gather(ens, w, a, b)
