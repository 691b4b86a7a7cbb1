"""The share of the profiled block of AIS sweeps in which no operation ran on the
card."""
from metrics import _trace


def read(ctx):
    return _trace.idle_share(ctx)
