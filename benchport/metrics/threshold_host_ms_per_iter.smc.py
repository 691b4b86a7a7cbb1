"""The host's own milliseconds an smc iteration in the threshold (the
quantile's launches, the alive mask and the evidence): the profiled
solve's ``smc.threshold`` spans less their ``sync`` spans, over its
iterations."""
from metrics import _spans


def read(ctx):
    spans = _spans.solve()
    if spans is None:
        return None
    return _spans.per_iteration(
        1e3 * _spans.host_seconds(spans, "smc.threshold"), spans)
