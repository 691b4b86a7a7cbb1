"""The host's own milliseconds an smc iteration in the split sweep
outside its cost: the profiled solve's ``smc.propose`` and
``smc.accept`` spans (the proposal and its rotation shifts, the log
accept draw, the log-prior, the gates and the commit) less their
``sync`` spans, over its iterations. Where the iteration replays as CUDA
graphs, these phases run on the host in the first iteration and in the
capture alone. A program without these spans gives nothing to read."""
from metrics import _spans


def read(ctx):
    spans = _spans.solve()
    if spans is None or not _spans.named(spans, "smc.propose"):
        return None
    return _spans.per_iteration(
        1e3 * _spans.host_seconds(spans, "smc.propose", "smc.accept"), spans)
