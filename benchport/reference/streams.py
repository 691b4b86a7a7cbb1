"""The random numbers of the kernels, worked out from their words.

Counters, as the kernels lay them out (the streams are the third
counter word):

- a simulator draw ``d`` of walker ``w`` with ``chunk`` draws a half:
  ``j = d // (2 chunk)``, ``r = d % (2 chunk)``; draws ``r < chunk``
  take the cosine of the Box-Muller pair, the others (``r - chunk``)
  the sine; draw ``l`` of a half reads words ``2 (l & 1)`` and
  ``2 (l & 1) + 1`` of ``philox(j, w, stream, l >> 1, seed)``;
- a walker's own words (proposal, accept): ``philox(g, w, stream, 0,
  seed)`` for the word groups ``g = 0, 1, ...``.

A uniform is the top 23 bits of a word over 2^23, as the kernels' [1, 2)
mantissa trick makes it exactly; the normals follow Box-Muller with
``log1p``, ``sqrt`` and the exact sine and cosine (the kernels use
polynomials: a few float32 ulps apart).
"""

from __future__ import annotations

import math

import torch

from .philox import philox

STREAM_COST, STREAM_SWEEP_WALKER, STREAM_SWEEP_SIM = 3, 4, 5
STREAM_AIS_WALKER, STREAM_AIS_SIM = 8, 9


def unit(b, dtype=torch.float64):
    """U[0, 1) from uint32 words (int64 tensor): the top 23 bits over
    2^23 in float64 (the kernels' float32 uniforms exactly); in a lower
    precision its own mantissa trick, as many top bits as its mantissa
    holds."""
    bits = {torch.float64: 23, torch.bfloat16: 7}[dtype]
    return ((b >> (32 - bits)).to(torch.float64) * 2.0 ** -bits).to(dtype)


def normal_pair(b1, b2, dtype=torch.float64):
    """The Box-Muller pair (r cos, r sin) of two words."""
    r = torch.sqrt(-2.0 * torch.log1p(-unit(b1, dtype)))
    t = unit(b2, dtype) * (2.0 * math.pi)
    return r * torch.cos(t), r * torch.sin(t)


def sim_noise(seed, walkers, ndraws, chunk, stream, dtype=torch.float64):
    """The ``[len(walkers), ndraws]`` standard normals the simulator of
    each of ``walkers`` (int64 indices) draws from ``seed``."""
    dev = walkers.device
    d = torch.arange(ndraws, device=dev)
    j = d // (2 * chunk)
    r = d % (2 * chunk)
    half_b = r >= chunk
    ll = torch.where(half_b, r - chunk, r)
    w = philox(j[None, :], walkers[:, None], stream, (ll >> 1)[None, :],
               seed)
    odd = (ll & 1).bool()[None, :]
    b1 = torch.where(odd, w[2], w[0])
    b2 = torch.where(odd, w[3], w[1])
    zc, zs = normal_pair(b1, b2, dtype)
    return torch.where(half_b[None, :], zs, zc)


def walker_words(seed, walkers, stream, count):
    """``count`` words of each walker: word k from ``philox(k // 4, w,
    stream, 0, seed)``."""
    out = []
    for g in range(-(-count // 4)):
        out.extend(philox(g, walkers, stream, 0, seed))
    return out[:count]


def generator_words(state, count, device):
    """The ``count`` uint32 words (int64) that ``torch.randint(0, 2**32,
    (count,))`` draws from a ``torch.Generator`` in ``state`` on
    ``device``: the words a sweep or a cost draws for its shifts and
    seeds. Returns the words and the state after the draw."""
    g = torch.Generator(device=device)
    g.set_state(state)
    w = torch.randint(0, 1 << 32, (count,), generator=g, device=device,
                      dtype=torch.int64)
    return w, g.get_state()
