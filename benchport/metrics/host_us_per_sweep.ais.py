"""The host's own microseconds a fused AIS sweep: the profiled block's
``ais.sweep`` spans (the words' draws and the launches of both halves)
less their ``sync`` spans, over the sweeps."""
from metrics import _spans


def read(ctx):
    spans = _spans.recorded()
    sweeps = _spans.named(spans or [], "ais.sweep")
    if not sweeps:
        return None
    return 1e6 * _spans.host_seconds(spans, "ais.sweep") / len(sweeps)
