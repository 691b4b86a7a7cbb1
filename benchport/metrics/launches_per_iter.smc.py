"""Device operations (kernels, copies, memsets) of the profiled smc solve
over its iterations: the driver loop's launches."""
from metrics import _trace


def read(ctx):
    if not ctx.get("trace"):
        return None
    return _trace.per_unit(ctx, len(ctx["trace"]["ops"]), "iterations")
