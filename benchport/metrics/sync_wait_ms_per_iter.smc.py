"""Milliseconds an smc iteration that the host waits for the card: the
``sync`` spans inside the profiled solve's ``smc.iter`` and
``smc.cond`` spans, over its iterations."""
from metrics import _spans


def read(ctx):
    spans = _spans.solve()
    if spans is None:
        return None
    waits = _spans.syncs_inside(spans, _spans.named(spans, "smc.iter",
                                                    "smc.cond"))
    return _spans.per_iteration(1e3 * _spans.seconds(waits), spans)
