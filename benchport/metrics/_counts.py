"""The yardstick of the rooflines: the card's peaks and the operations
and bytes each kernel launch needs, from the configuration's frozen
counts (``configs/<name>.py``: ``OPS_PER_DRAW``, ``REDUCE_OPS``,
``PRIOR_OPS``, ``NSTATS``, ``NLEAVES``) and the frozen per-walker counts
below.
A transcendental counts as one operation. Bytes count each population
leaf read once and written once. Where the work depends on the data, a
launch is charged what its inputs need: the simulator only for the
walkers the reference finds passing the prior gate (``nsim``, ``nin``),
the rest for every walker of the launch."""

# NVIDIA H100 SXM, dense float32 outside the tensor cores, and HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# smc sweep (#3), a walker outside the simulator: one Philox4x32-10 call
# (80), three mantissa tricks (9), the proposal scale (log1p, *-2, sqrt,
# *2pi, cos, *, *w: 7), the log accept draw (1), the two partner
# indices (2), gate 1 (clamp, -, <, and, and: 5), gate 2 (2); per leaf
# the difference, the scale, the sum and the commit (4)
SMC_WALKER_OPS, SMC_LEAF_OPS = 80 + 9 + 7 + 1 + 2 + 5 + 2, 4
# AIS half (#6), a walker outside the simulator: nine words from three
# Philox calls (240) and their mantissa tricks (27), three Box-Muller
# pairs (24), the move's constants (12), the accept (10), the commit of
# lp and ll (2); per leaf the proposal of the mixture (24) and the
# commit (1)
AIS_WALKER_OPS, AIS_LEAF_OPS = 240 + 27 + 24 + 12 + 10 + 2, 25


def least_seconds(ops, nbytes):
    """The least time a launch can take on the card."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def _sim(mod, cfg):
    return int(cfg["ndraws"]) * mod.OPS_PER_DRAW + mod.REDUCE_OPS


def streaming_cost(mod, cfg, n):
    """(operations, bytes) of the streamed cost (#4) over ``n`` walkers:
    their leaves read, the moments written."""
    return (n * (int(cfg["ndraws"]) * mod.OPS_PER_DRAW),
            4 * n * (mod.NLEAVES + mod.NSTATS))


def smc_sweep(mod, cfg, n, nsim):
    """(operations, bytes) of one fused smc sweep (#3) over ``n`` walkers
    of which ``nsim`` pass the prior gate: leaves, cost and log-prior
    read and written, the alive mask read, the commit mask written."""
    k = mod.NLEAVES
    ops = (n * (SMC_WALKER_OPS + SMC_LEAF_OPS * k + mod.PRIOR_OPS)
           + nsim * _sim(mod, cfg))
    return ops, n * (8 * (k + 2) + 2)


def ais_half(mod, cfg, h, nin):
    """(operations, bytes) of one AIS half-update (#6) over ``h`` walkers
    of which ``nin`` propose inside the prior: the half's leaves, lp and
    ll read and written, the other half's leaves read."""
    k = mod.NLEAVES
    ops = (h * (AIS_WALKER_OPS + AIS_LEAF_OPS * k + mod.PRIOR_OPS)
           + nin * _sim(mod, cfg))
    return ops, h * (8 * (k + 2) + 4 * k)
