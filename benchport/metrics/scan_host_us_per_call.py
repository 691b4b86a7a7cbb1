"""The host's own microseconds a call of the scan cost: the profiled
solve's ``scan.cost`` spans (the seed word's draw, #5's launch and
``reduce_cost``) less their ``sync`` spans, over those spans. Where the
iteration replays as CUDA graphs, the calls on the host are the init's,
the first iteration's and the capture's. A program without these spans
gives nothing to read."""
from metrics import _spans


def read(ctx):
    spans = _spans.solve()
    calls = _spans.named(spans or [], "scan.cost")
    if not calls:
        return None
    return 1e6 * _spans.host_seconds(spans, "scan.cost") / len(calls)
