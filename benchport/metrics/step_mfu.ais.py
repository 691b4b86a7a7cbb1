"""The profiled AIS block's counted operations (#6's half-updates) over
its span, as a percent of the card's float32 peak."""
from metrics import _trace


def read(ctx):
    return _trace.step_mfu(ctx)
