"""Kernel #5 (the scan cost): its least time by the frozen counts of
``_scan_counts.py`` over its device time in the profiled solve, in
percent."""
from metrics import _scan_counts


def read(ctx):
    return _scan_counts.roofline(ctx)
