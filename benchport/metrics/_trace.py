"""Arithmetic on a profiled span of the card (the union of busy
intervals as ``tools/profile_torch_smc.py`` computes it, copied here):
``ctx["trace"]`` holds the device operations ``(name, start, end)`` in
microseconds, the span's length and its busy time."""

# the port's own CUDA kernels, by the names of their __global__
# functions: the kernels of the fused smc sweep (#3), the streamed cost
# (#4) and the fused AIS sweep (#6)
PORT_KERNELS = {"k3": ("fused_smc_sweep_kernel",),
                "k4": ("streaming_moment_cost_kernel",),
                "k6": ("fused_ais_sweep_kernel",)}


def is_copy(name):
    return name.startswith(("Memcpy", "Memset"))


def kernel_of(name):
    """The port kernel (``k3``, ``k4``, ``k6``) an operation belongs to,
    or None."""
    for k, stems in PORT_KERNELS.items():
        if any(s in name for s in stems):
            return k
    return None


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_seconds(ctx, pred):
    ops = ctx["trace"]["ops"]
    return sum(e - s for n, s, e in ops if pred(n)) / 1e6


def roofline(ctx, kernel):
    """Percent of the least time of ``kernel``'s launches over their
    measured device time."""
    if not ctx.get("trace") or not ctx.get("work"):
        return None
    from . import _counts
    least = sum(_counts.least_seconds(ops, b)
                for k, ops, b in ctx["work"] if k == kernel)
    took = device_seconds(ctx, lambda n: kernel_of(n) == kernel)
    if least <= 0 or took <= 0:
        return None
    return 100.0 * least / took


def step_mfu(ctx):
    """Percent of the card's float32 peak that the profiled span's
    counted operations (every port kernel's) reach over the span."""
    if not ctx.get("trace") or not ctx.get("work"):
        return None
    from . import _counts
    ops = sum(o for _, o, _ in ctx["work"])
    span = ctx["trace"]["window_s"]
    return 100.0 * ops / span / _counts.PEAK_FLOPS if span > 0 else None


def idle_share(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]


def per_unit(ctx, value, unit):
    count = ctx.get(unit)
    if not ctx.get("trace") or not count:
        return None
    return value / count
