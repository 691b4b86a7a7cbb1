"""Device milliseconds an smc iteration in kernels that are not the
port's own (PyTorch's kernels of the quantile, the resampling and the
loop): the population ops."""
from metrics import _trace


def read(ctx):
    if not ctx.get("trace"):
        return None
    ms = 1e3 * _trace.device_seconds(
        ctx, lambda n: not _trace.is_copy(n) and _trace.kernel_of(n) is None)
    return _trace.per_unit(ctx, ms, "iterations")
