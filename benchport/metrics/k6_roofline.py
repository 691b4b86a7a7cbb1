"""Kernel #6 (the fused AIS half-update): its least time by the frozen
counts over its device time in the profiled block, in percent."""
from metrics import _trace


def read(ctx):
    return _trace.roofline(ctx, "k6")
