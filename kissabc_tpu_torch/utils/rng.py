"""Explicit-generator RNG plumbing — the PyTorch counterpart of
``kissabc_tpu/utils/rng.py``.

JAX threads immutable threefry keys; here every random draw takes an
explicit ``torch.Generator`` that lives on the device the draws are made
on. ``as_generator`` is the counterpart of ``as_key``: an int seed
becomes a fresh generator, a generator passes through. The two
frameworks give different numbers from the same seed, so tests hand
both packages the same numpy-made noise where bits must agree.
"""

from __future__ import annotations

import numpy as np
import torch


def as_generator(seed_or_gen, device) -> torch.Generator:
    """An int seed -> a new ``torch.Generator`` on ``device``; a
    generator is returned as it is, after checking that it lives on
    the device type the draws are made on."""
    device = torch.device(device)
    if isinstance(seed_or_gen, torch.Generator):
        if seed_or_gen.device.type != device.type:
            raise ValueError(
                f"generator lives on {seed_or_gen.device}, but the run is "
                f"on {device}")
        return seed_or_gen
    if isinstance(seed_or_gen, (int, np.integer)):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed_or_gen))
        return gen
    raise TypeError(
        f"key must be an int seed or a torch.Generator, got "
        f"{type(seed_or_gen).__name__}")


def uint32_words(gen: torch.Generator, count: int) -> torch.Tensor:
    """``count`` uniform uint32 words as an int64 tensor on the
    generator's device (the counterpart of ``jax.random.bits``)."""
    return torch.randint(0, 1 << 32, (count,), generator=gen,
                         device=gen.device, dtype=torch.int64)


def randexp(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard-exponential float32 draws; ``-randexp() <= lW`` accept
    draws become ``log(U) <= lW`` with ``log(U) = -randexp``."""
    out = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return out.exponential_(generator=gen)


def log_uniform(gen: torch.Generator, shape) -> torch.Tensor:
    """log(U(0,1]) — the MH accept threshold draw (== -randexp)."""
    return -randexp(gen, shape)
