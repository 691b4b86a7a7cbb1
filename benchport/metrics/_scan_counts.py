"""The yardstick of the scan kernel's (#5) roofline, with the conventions
of ``_counts.py`` (its peaks; a transcendental counts as one; bytes each
read once and written once): the operations and bytes of one launch of
the scan cost over ``n`` walkers, from the configuration's frozen counts
(``configs/<name>.py``: ``STEP_OPS``, ``OBSERVE_OPS``, ``INIT_OPS``,
``NSTATS``, ``NLEAVES``, ``NSERIES``) and the noise below.

#5 is found in the device trace by the name of its ``__global__``
function, ``KERNEL``."""

KERNEL = "streaming_scan_cost_kernel"
# the noise of a step: a quarter of a Philox4x32-10 call (20), the
# mantissa tricks (3), Box-Muller with log1p, sqrt, sin and cos (4)
NOISE_OPS = 27


def scan_cost(mod, cfg, n):
    """(operations, bytes) of one launch over ``n`` walkers: per walker
    the init, per step the noise, the step, the observations and their
    sums, and the means scaled once; the leaves read, the means written,
    the series read and the seed word."""
    nsteps = int(cfg["nsteps"])
    per_step = NOISE_OPS + mod.STEP_OPS + mod.OBSERVE_OPS + mod.NSTATS
    ops = n * (mod.INIT_OPS + nsteps * per_step + mod.NSTATS)
    nbytes = 4 * n * (mod.NLEAVES + mod.NSTATS) \
        + 4 * mod.NSERIES * nsteps + 8
    return ops, nbytes


def roofline(ctx, kernel="k5"):
    """Percent of the least time of ``kernel``'s launches (``ctx["work"]``)
    over #5's device time in the profiled span."""
    if not ctx.get("trace") or not ctx.get("work"):
        return None
    from . import _counts, _trace
    least = sum(_counts.least_seconds(ops, b)
                for k, ops, b in ctx["work"] if k == kernel)
    took = _trace.device_seconds(ctx, lambda name: KERNEL in name)
    if least <= 0 or took <= 0:
        return None
    return 100.0 * least / took
