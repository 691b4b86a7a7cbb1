"""Host-simulator escape hatch — the PyTorch counterpart of
``kissabc_tpu/utils/host_sim.py``.

Some real simulators are external black boxes (C/Fortran codes, ODE
packages, subprocess models) that cannot be written as tensor code.
``host_cost`` wraps such a function into a batched cost: the whole
pushed population batch goes to the host once per call as numpy,
is evaluated there, and the cost vector returns to the thetas' device.
It is the JAX package's ``pure_callback`` design: one device<->host
round trip per sweep (not per particle), while the rest of the run —
proposals, gates, resampling — stays on the device.

Usage::

    def my_sim(thetas, seeds):          # numpy in, numpy out
        mu, sigma = thetas              # each np.ndarray [n]
        out = np.empty(len(mu))
        for i in range(len(mu)):
            out[i] = external_code(mu[i], sigma[i], seed=int(seeds[i]))
        return out

    cost = host_cost(my_sim)
    res = smc(prior, cost, cost_vectorized=True)
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.tree import tree_leaves
from .hostfetch import fetch, fetch_tree
from .rng import uint32_words


def host_cost(fn, dtype=torch.float32):
    """Wrap ``fn(thetas_numpy_tree, seeds_numpy[n]) -> costs_numpy[n]``
    into a batched cost ``(thetas, gen) -> costs[n]`` for
    ``cost_vectorized=True`` in ``smc``, ``abc_rejection``, ``ABCDE``,
    ``pfilter`` and the density models.

    Each call draws one uint32 seed per walker from ``gen`` (the
    counterpart of ``jax.random.bits(key, (n,), uint32)``), so the host
    simulator repeats from the run's key. The wrapper takes the whole
    batch, so it must be installed with ``cost_vectorized=True``: a
    per-walker (vmapped) call raises a descriptive error.
    """

    def batched(thetas, gen):
        lead = tree_leaves(thetas)[0]
        if lead.ndim == 0:
            raise ValueError(
                "host_cost produces a BATCHED cost: pass it with "
                "cost_vectorized=True (smc/ABCDE/pfilter) or "
                "cost_vectorized=True on the density model — it cannot "
                "be vmapped per-walker.")
        n = lead.shape[0]
        seeds = fetch(uint32_words(gen, n)).astype(np.uint32)
        out = fn(fetch_tree(thetas), seeds)
        return torch.as_tensor(np.asarray(out), device=lead.device).to(dtype)

    return batched
