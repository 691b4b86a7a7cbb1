"""The user-cost adapter of ``kissabc_tpu/core/density.py`` (``_adapt_cost``,
:34-44). The density models (``ApproxPosterior`` and the others) come
with the AIS slice of the port.

A per-walker cost is ``cost(theta, gen)`` or ``cost(theta)``: ``theta``
is one walker's pushed parameters, ``gen`` the run's
``torch.Generator``. A stochastic cost draws with ``generator=gen`` and
``device=gen.device``; the sampler maps it over the walkers with
``torch.func.vmap``, which gives every walker its own draws.
"""

from __future__ import annotations

import inspect


def _adapt_cost(cost):
    """A user cost in the canonical ``(theta, gen)`` form: a callable
    with two or more required positional parameters passes as it is;
    any other becomes ``lambda theta, gen: cost(theta)``."""
    try:
        n = len([p for p in inspect.signature(cost).parameters.values()
                 if p.default is inspect.Parameter.empty
                 and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)])
    except (TypeError, ValueError):
        n = 1
    if n >= 2:
        return cost
    return lambda theta, gen: cost(theta)
