"""The profiled smc solve's counted operations (#4's init and #3's
sweeps) over its span, as a percent of the card's float32 peak."""
from metrics import _trace


def read(ctx):
    return _trace.step_mfu(ctx)
