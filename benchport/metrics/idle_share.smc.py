"""The share of the profiled smc solve in which no operation ran on the
card."""
from metrics import _trace


def read(ctx):
    return _trace.idle_share(ctx)
