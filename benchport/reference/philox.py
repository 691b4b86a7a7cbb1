"""Philox4x32-10 (Salmon et al., SC'11) on int64 tensors that hold uint32
values: the generator the CUDA kernels draw from, keyed by a 32-bit seed
(``k1 = 0``) and counted by four 32-bit words."""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a, m: int):
    """(high, low) 32-bit words of ``a * m`` for uint32 ``a`` (int64
    tensor) and a 32-bit constant, without overflowing int64."""
    lo = a * (m & 0xFFFF)
    hi = a * (m >> 16)
    mid = lo + ((hi & 0xFFFF) << 16)
    return (hi >> 16) + (mid >> 32), mid & MASK


def philox(c0, c1, c2, c3, key):
    """The four output words for counters ``(c0, c1, c2, c3)`` and key
    ``(key, 0)``; the arguments broadcast (ints or int64 tensors)."""
    like = next(v for v in (c0, c1, c2, c3, key) if torch.is_tensor(v))
    c = torch.broadcast_tensors(*[
        v.to(torch.int64) if torch.is_tensor(v)
        else torch.full((), int(v), dtype=torch.int64, device=like.device)
        for v in (c0, c1, c2, c3)])
    c0, c1, c2, c3 = (x & MASK for x in c)
    k0 = key.to(torch.int64) & MASK if torch.is_tensor(key) else int(key)
    k1 = 0
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + W0) & MASK
        k1 = (k1 + W1) & MASK
    return c0, c1, c2, c3
