"""The host's own milliseconds an smc iteration: the profiled solve's
``smc.iter`` and ``smc.cond`` spans less their ``sync`` spans (the time
the host spends issuing work, not waiting for the card), over its
iterations."""
from metrics import _spans


def read(ctx):
    spans = _spans.solve()
    if spans is None:
        return None
    return _spans.per_iteration(
        1e3 * _spans.host_seconds(spans, "smc.iter", "smc.cond"), spans)
