"""Kernel #3 (the fused smc sweep): its least time by the frozen counts
over its device time in the profiled solve, in percent."""
from metrics import _trace


def read(ctx):
    return _trace.roofline(ctx, "k3")
